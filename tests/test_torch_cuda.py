"""The port's CUDA kernels on the card (skipped without a GPU).

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

B1 and B2 are held against their plain PyTorch twins, and the engine on the
card against the engine on the CPU.  Compares only, so everything is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import rtree, select_vector
from repro_torch.kernels import ref
from repro_torch.kernels import rtree_select as kern

from conftest import uniform_rects

ROWS = ("lx", "ly", "hx", "hy", "child")


@pytest.fixture(scope="module")
def inst():
    rng = np.random.default_rng(41)
    rects = uniform_rects(rng, 2500, eps=0.002)
    lo = rng.random((4, 2)).astype(np.float32) * 0.94
    small = np.concatenate([lo, lo + np.float32(0.06)], axis=1)
    lo_big = rng.random((4, 2)).astype(np.float32) * 0.7
    big = np.concatenate([lo_big, lo_big + np.float32(0.3)], axis=1)
    return rects, small, big


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); chip_smoke.py checks the kernels on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [2048, 64])           # 64 forces overflow
def test_cuda_kernels_equal_twins(inst, cap):
    dev = _need_gpu()
    rects, small, big = inst
    tree = rtree.build_rtree(rects, fanout=16, device=dev)
    q = torch.from_numpy(big if cap == 64 else small).to(dev)
    rng = np.random.default_rng(cap)
    for lvl in tree.levels:
        ids = rng.integers(0, lvl.n_nodes, (4, 64)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.3] = -1
        ids = torch.from_numpy(ids).to(dev)
        rows = [getattr(lvl, f) for f in ROWS]
        before = kern.launch_counts()
        np.testing.assert_array_equal(
            kern.select_level_masks_cuda(ids, q, *rows).cpu().numpy(),
            ref.select_level_masks_ref(ids, q, *rows).cpu().numpy())
        for g, w in zip(kern.select_level_fused_cuda(ids, q, *rows, cap=cap),
                        ref.select_level_fused_ref(ids, q, *rows, cap=cap)):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        after = kern.launch_counts()
        for name in after:
            assert after[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_engine_equals_cpu_engine(inst, fused):
    dev = _need_gpu()
    rects, small, big = inst
    q = np.concatenate([small, big])
    outs = []
    for device in (dev, "cpu"):
        tree = rtree.build_rtree(rects, fanout=16, device=device)
        outs.append(select_vector.make_select_bfs(
            tree, result_cap=128, fused=fused)(q))
    (ci, cc, ct), (ti, tc, tt) = outs
    np.testing.assert_array_equal(ci.cpu().numpy(), ti.numpy())
    np.testing.assert_array_equal(cc.cpu().numpy(), tc.numpy())
    assert ct.asdict() == tt.asdict()
    assert int(ct.overflow) == 1           # the big queries overflow 128
