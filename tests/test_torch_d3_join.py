"""Port (repro_torch) ≡ reference (repro): the D3 spatial join.

Neither package has a kernel for it: both score the dense (F_out × F_in)
tile over the conservative dequantized boxes and re-check the exact rects
at the leaf (4 stages there, 2 above).  Held to the reference's D3 join on
the same rects and probes, made with numpy from a seed: pairs, counts,
overflow and every ``Counters`` field but ``dispatches``, with O3/O4 off
and on, O5 by gather and dense, static, adaptive and escalating caps and a
cap that overflows; on the host fleet and on the mesh path against the
reference's 1-device CPU mesh; D3's pairs, sorted, ≡ D1's where nothing
overflows; the layout's gathers bit for bit and contiguous; the kernel
backend and the fused build raise; ``serve --mode join --layout d3``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import join_vector as jjoin
from repro.core import layouts as jlayouts
from repro.core import rtree as jrtree
from repro.core import traversal as jtraversal
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro_torch.core import join_vector as tjoin
from repro_torch.core import layouts as tlayouts
from repro_torch.core import rtree as trtree
from repro_torch.core import traversal as ttraversal
from repro_torch.core.counters import Counters
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch import serve

from conftest import brute_join, uniform_rects

ENGINE_FIELDS = tuple(f.name for f in dataclasses.fields(Counters)
                      if f.name != "dispatches")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Single-threaded PyTorch in this module: its tensors are small, and
    parallel test workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inst():
    """2,500 outer and 1,500 inner rects of half-extent 0.004, fanouts 16
    and 8 (unequal heights: chain elevation), sort_key "lx", in both
    packages."""
    rng = np.random.default_rng(13)
    ra = uniform_rects(rng, 2500, eps=0.004)
    rb = uniform_rects(rng, 1500, eps=0.004)
    jt = [jrtree.build_rtree(r, fanout=f, sort_key="lx")
          for r, f in ((ra, 16), (rb, 8))]
    tt = [trtree.build_rtree(r, fanout=f, sort_key="lx", device="cpu")
          for r, f in ((ra, 16), (rb, 8))]
    return ra, rb, jt, tt


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _assert_join_equal(tout, jout, ctx):
    """(pairs, count, Counters) of the port ≡ the reference's."""
    np.testing.assert_array_equal(_np(tout[0]), _np(jout[0]), err_msg=ctx)
    assert int(tout[1]) == int(jout[1]), ctx
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tout[2], f)),
                                      _np(getattr(jout[2], f)),
                                      err_msg=f"{ctx}: {f}")


def _sorted_pairs(pairs, n):
    p = _np(pairs)[:int(n)]
    return p[np.lexsort((p[:, 1], p[:, 0]))]


PRUNING = {"none": {}, "o3o4": dict(o3=True, o4=True),
           "o5 gather": dict(o3=True, o5="gather"),
           "o5 dense": dict(o4=True, o5="dense")}


@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("pruning", sorted(PRUNING))
def test_d3_join_equals_reference_and_d1(inst, pruning, caps_mode):
    """Pairs, count, overflow and every counter but dispatches ≡ the
    reference's D3 join; the pairs, sorted, ≡ D1's and brute force."""
    ra, rb, jt, tt = inst
    kw = dict(result_cap=1 << 14, caps_mode=caps_mode, **PRUNING[pruning])
    jout = jjoin.make_join_bfs(*jt, layout="d3", **kw)()
    tout = tjoin.make_join_bfs(*tt, layout="d3", **kw)()
    _assert_join_equal(tout, jout, f"d3 {pruning} {caps_mode}")
    assert int(tout[2].overflow) == 0 and int(tout[1]) > 0
    d1 = tjoin.make_join_bfs(*tt, **kw)()
    got = _sorted_pairs(tout[0], tout[1])
    np.testing.assert_array_equal(got, _sorted_pairs(d1[0], d1[1]))
    np.testing.assert_array_equal(
        got, np.array(sorted(brute_join(ra, rb)), np.int32).reshape(-1, 2))
    if pruning != "none":
        assert int(tout[2].pruned_inner) > 0


def test_d3_join_overflow_and_escalation_equal_reference(inst):
    """A result cap that overflows, and a tight pair-cap tier that always
    overflows and escalates to the full tier: ≡ the reference, step by
    step."""
    _, _, jt, tt = inst
    kw = dict(layout="d3", o3=True, o4=True)
    jout = jjoin.make_join_bfs(*jt, result_cap=256, **kw)()
    tout = tjoin.make_join_bfs(*tt, result_cap=256, **kw)()
    _assert_join_equal(tout, jout, "d3 result cap 256")
    assert int(tout[2].overflow) == 1 and int(tout[1]) > 256
    h = max(t.height for t in tt)
    full = tjoin.default_pair_caps(h, 16, 1 << 14)
    tight = (1,) * (h - 1) + (1 << 14,)
    jesc = jtraversal.maybe_escalating(
        lambda c: jjoin.make_join_bfs(*jt, pair_caps=c, **kw), tight, full)
    tesc = ttraversal.maybe_escalating(
        lambda c: tjoin.make_join_bfs(*tt, pair_caps=c, **kw), tight, full)
    for step in range(3):
        _assert_join_equal(tesc(), jesc(), f"escalating step {step}")
        assert tesc.escalation_count() == jesc.escalation_count() == step + 1


def test_d3_gathers_bit_equal_and_contiguous(inst):
    """``_gather_children`` on the join's D3 levels (codes widened to
    int32 once by ``layouts.d3_levels_int32``, which filtered kNN shares:
    CUDA cannot index uint16, nor the CPU shift it) and the exact leaf
    re-check ≡ the reference's, bit for bit, every output contiguous (the
    layout faults the card alone would show)."""
    _, _, jt, tt = inst
    jl = jlayouts.tree_layout(jt[0], "d3")
    assert tlayouts.tree_layout(tt[0], "d3")[0].qlo.dtype == torch.uint16
    tl = tjoin.join_levels(tt[0], "d3")
    assert all(lvl.qlo.dtype == lvl.qhi.dtype == torch.int32 and
               lvl.qlo.is_contiguous() and lvl.qhi.is_contiguous()
               for lvl in tl)
    for a, b in zip(tl, tlayouts.d3_levels_int32(tt[0])):
        assert torch.equal(a.qlo, b.qlo) and torch.equal(a.qhi, b.qhi)
    rng = np.random.default_rng(3)
    for li, (jlvl, tlvl) in enumerate(zip(jl, tl)):
        ids = rng.integers(-1, tlvl.ptr.shape[0], 40).astype(np.int32)
        jg, js = jjoin._gather_children(jlvl, jnp.asarray(ids))
        tg, ts = tjoin._gather_children(tlvl, torch.from_numpy(ids))
        assert ts == js == 2
        outs = [(tg, jg, "dequantized")]
        if li == 0:
            outs.append((tjoin._exact_leaf_children(tg, tt[0].rects),
                         jjoin._exact_leaf_children(jg, jt[0].rects),
                         "exact"))
        for t_out, j_out, what in outs:
            for i, (a, b) in enumerate(zip(t_out, j_out)):
                # the exact leaf columns are views of one gather, as D1's
                assert a.is_contiguous() or what == "exact", (li, i)
                assert a.dtype == (torch.int32 if i == 4 else torch.float32)
                np.testing.assert_array_equal(
                    a.numpy().view(np.int32), np.asarray(b).view(np.int32),
                    err_msg=f"level {li} {what} output {i}")


@pytest.mark.parametrize("mesh", [False, True])
def test_d3_fleet_join_equals_reference(mesh):
    """The fleet's join on D3, host fan-out and mesh path (the reference's
    1-device CPU mesh): pairs, overflow and every counter but dispatches ≡
    the reference's; the pairs ≡ the D1 fleet's."""
    rng = np.random.default_rng(41)
    rects = uniform_rects(rng, 4000, eps=0.002)
    probe = uniform_rects(rng, 300, eps=0.01)
    kw = dict(fanout=16, sort_key="lx")
    jsh = JShards.build(rects, 4, layout="d3", **kw)
    tsh = TShards.build(rects, 4, layout="d3", device="cpu", **kw)
    if mesh:
        jsh.enable_mesh(jax.make_mesh((1,), ("model",)))
        tsh.enable_mesh()
    jp, jo = jsh.join(probe, result_cap=1 << 14, o3=True, o4=True)
    tp, to = tsh.join(probe, result_cap=1 << 14, o3=True, o4=True)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    assert to == jo is False and len(tp) > 0
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tsh.last_counters, f)),
                                      _np(getattr(jsh.last_counters, f)),
                                      err_msg=f)
    d1 = TShards.build(rects, 4, device="cpu", **kw)
    np.testing.assert_array_equal(tp, d1.join(probe, result_cap=1 << 14,
                                              o3=True, o4=True)[0])


def test_d3_kernel_backend_and_fused_raise(inst):
    """D3's join has no kernel in either package: ``backend='cuda'`` and
    ``fused=True`` raise ValueError with the reference's words; 'auto'
    and 'torch' run the PyTorch tile."""
    _, _, jt, tt = inst
    with pytest.raises(ValueError, match="requires layout d1"):
        tjoin.make_join_bfs(*tt, layout="d3", backend="cuda")
    with pytest.raises(ValueError, match="requires layout d1"):
        jjoin.make_join_bfs(*jt, layout="d3", backend="xla")
    with pytest.raises(ValueError, match="fused join"):
        tjoin.make_join_bfs(*tt, layout="d3", fused=True)
    a = tjoin.make_join_bfs(*tt, layout="d3", backend="torch")()
    b = tjoin.make_join_bfs(*tt, layout="d3")()
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


@pytest.mark.parametrize("mesh", ["off", "on"])
def test_serve_join_d3_dryrun(mesh):
    """``serve --mode join --layout d3 --dryrun --device cpu`` serves the
    D1 pairs, on the host path and the mesh path."""
    argv = ["--mode", "join", "--dryrun", "--device", "cpu", "--mesh", mesh]
    got = serve.main(argv + ["--layout", "d3"])
    want = serve.main(argv)
    assert not got["overflow"] and got["pairs"] == want["pairs"] > 0
    np.testing.assert_array_equal(got["last_pairs"], want["last_pairs"])
