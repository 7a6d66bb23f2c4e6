"""The port's CUDA kernels on the card (skipped without a GPU).

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

B1–B14 and the DFS baselines' kernels S and V are held against their
plain twins, and the select, join,
kNN and kNN-join engines on the card (D1, and D3 for all but the join)
against the same engines on the CPU; a browse session on the card (B5,
and B13 on D3) against its twin session on the card, and filtered kNN
(PyTorch ops) on the card against the same engine on the CPU.  B1–B4, B11 and B12 are compares and
integer arithmetic; B5–B10, B13 and B14 compute distances with the
roundings pinned in ``core/geometry.py`` and ``core/layouts.py``.  So
everything is exact, float bits included.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (flat, join_vector, knn_browse, knn_filtered,
                              knn_join_vector, knn_vector, layouts, rtree,
                              select_scalar, select_vector)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rtree_dfs as dkern
from repro_torch.kernels import rtree_join as jkern
from repro_torch.kernels import rtree_knn as kkern
from repro_torch.kernels import rtree_knn_join as kjkern
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
        for name in ("select_level_masks", "select_level_fused"):
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


@pytest.fixture(scope="module")
def join_inst():
    rng = np.random.default_rng(7)
    return (uniform_rects(rng, 2500, eps=0.01),
            uniform_rects(rng, 400, eps=0.01))


@pytest.mark.cuda
@pytest.mark.parametrize("pruned", [False, True])
def test_cuda_join_kernels_equal_twins(join_inst, pruned):
    """B3 and B4 ≡ twins on every level, with frontiers of all node pairs
    (shuffled, 10% of slots -1) and the pruning bounds either from the
    pre-pass or random; B4 also at a cap that overflows."""
    dev = _need_gpu()
    trees = [rtree.build_rtree(r, fanout=16, sort_key="lx", device=dev)
             for r in join_inst]
    lo, li_ = (layouts.tree_layout(t, "d1") for t in trees)
    rng = np.random.default_rng(int(pruned))
    for lvl in range(trees[0].height):
        no, ni = lo[lvl].coords.shape[0], li_[lvl].coords.shape[0]
        o, i = np.meshgrid(np.arange(no), np.arange(ni), indexing="ij")
        perm = rng.permutation(o.size)
        o, i = o.ravel()[perm].astype(np.int32), i.ravel()[perm].astype(
            np.int32)
        o[rng.random(o.size) < 0.1] = -1
        i[rng.random(i.size) < 0.1] = -1
        o, i = torch.from_numpy(o).to(dev), torch.from_numpy(i).to(dev)
        oc, icr = lo[lvl].coords, li_[lvl].coords
        if pruned:
            ac, fm = ops.join_prune_metadata(o, i, oc, icr, to=8)
        else:
            ac = torch.from_numpy(rng.integers(-1, 19, o.numel()).astype(
                np.int32)).to(dev)
            fm = torch.from_numpy(rng.integers(-1, 19, (o.numel(), 2))
                                  .astype(np.int32)).to(dev)
        before = jkern.launch_counts()
        np.testing.assert_array_equal(
            jkern.join_pair_masks_cuda(o, i, ac, fm, oc, icr).cpu().numpy(),
            ref.join_pair_masks_ref(o, i, ac, fm, oc, icr).cpu().numpy())
        for cap in (1 << 16, 7):
            args = (o, i, ac, fm, oc, icr, lo[lvl].ptr, li_[lvl].ptr)
            got = jkern.join_level_fused_cuda(*args, cap=cap)
            want = ref.join_level_fused_ref(*args, cap=cap)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(),
                                              w.cpu().numpy())
            assert bool(got[3]) == (int(want[2]) > cap)
        after = jkern.launch_counts()
        assert after["join_pair_masks"] == before["join_pair_masks"] + 1
        assert after["join_level_fused"] == before["join_level_fused"] + 2


def _seam_rows(rng, n_nodes, c=3000):
    """(6, c) frontiers at the seams of B2's and B12's chunks of 1,024
    slots (c is no multiple of it): a row all -1, a row whose only live
    slot is its last, live slots a prefix past the first chunk, live slots
    interleaved with -1, every slot live, 10% of the slots live anywhere."""
    ids = rng.integers(0, n_nodes, (6, c)).astype(np.int32)
    ids[0] = -1
    ids[1, :-1] = -1
    ids[2, 1500:] = -1
    ids[3, 1::2] = -1
    ids[5, rng.random(c) >= 0.1] = -1
    return ids


def _seam_queries(rng):
    """Six query rects: four that hold the whole unit square, so a row's
    hits run over several chunks, and two of half-extent 0.15."""
    c = rng.random((6, 2)).astype(np.float32)
    e = np.full((6, 2), 2.0, np.float32)
    e[[2, 5]] = 0.15
    return np.concatenate([c - e, c + e], axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 700, 1 << 16])
@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_cuda_fused_select_seams_equal_twins(d3_inst, layout, cap):
    """B2 (D1) and B12 (D3) ≡ their twins on frontiers at the seams of
    their chunks: rows all -1 or live only in their last slot, live slots
    a prefix or interleaved, hits across several chunks, cap 1 and a cap
    that falls inside a row's first chunk."""
    dev = _need_gpu()
    rects, _ = d3_inst
    tree = rtree.build_rtree(rects, fanout=16, device=dev)
    rng = np.random.default_rng(cap)
    q = torch.from_numpy(_seam_queries(rng)).to(dev)
    if layout == "d1":
        levels = [(lvl.n_nodes, [getattr(lvl, f) for f in ROWS])
                  for lvl in tree.levels]
        fns = (kern.select_level_fused_cuda, ref.select_level_fused_ref,
               "select_level_fused")
    else:
        levels = [(l3.qlo.shape[0], [l3.qlo, l3.qhi, l3.scale, l3.bias,
                                     l3.ptr])
                  for l3 in layouts.tree_layout(tree, "d3")[1:]]
        fns = (kern.select_level_fused_d3_cuda,
               ref.select_level_fused_d3_ref, "select_level_fused_d3")
    for n, rows in levels:
        ids = torch.from_numpy(_seam_rows(rng, n)).to(dev)
        before = kern.launch_counts()[fns[2]]
        got = fns[0](ids, q, *rows, cap=cap)
        want = fns[1](ids, q, *rows, cap=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        assert kern.launch_counts()[fns[2]] == before + 1
        counts = want[1].cpu().numpy()
        assert counts[0] == 0 and counts[4] > 1024
        assert bool(got[2].any()) == (cap < counts.max())


def _join_seam_inst(fanout, dev):
    """Two relations sorted by low x at ``fanout`` and their D1 leaf
    levels."""
    rng = np.random.default_rng(fanout)
    trees = [rtree.build_rtree(uniform_rects(rng, n, eps=0.01),
                               fanout=fanout, sort_key="lx", device=dev)
             for n in (40 * fanout, 8 * fanout)]
    return trees, [layouts.tree_layout(t, "d1")[0] for t in trees]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dead", "live", "prefix", "interleaved"])
@pytest.mark.parametrize("fanout", [16, 32, 48, 64])
def test_cuda_fused_join_seams_equal_twins(fanout, kind):
    """B4 ≡ its twin on leaf pair frontiers of P = 40,009 slots (more than
    a batch of 32 for each block of the persistent grid): every pair dead,
    every pair live, live pairs a prefix, live pairs interleaved; pruning
    bounds from the pre-pass and random; cap 1, a cap inside the run and
    one that holds it.  Fanouts 32 and 64 take the register path, 16 and
    48 the general one."""
    dev = _need_gpu()
    trees, (lo, li_) = _join_seam_inst(fanout, dev)
    rng = np.random.default_rng(fanout + 1)
    mo = trees[0].levels[0].node_mbr.cpu().numpy()
    mi = trees[1].levels[0].node_mbr.cpu().numpy()
    hit = np.argwhere((mo[:, None, 0] <= mi[None, :, 2]) &
                      (mo[:, None, 2] >= mi[None, :, 0]) &
                      (mo[:, None, 1] <= mi[None, :, 3]) &
                      (mo[:, None, 3] >= mi[None, :, 1]))
    p = 40_009
    pick = hit[rng.integers(0, len(hit), p)].astype(np.int32)
    o, i = pick[:, 0].copy(), pick[:, 1].copy()
    if kind == "dead":
        o[:] = -1
    elif kind == "prefix":
        o[p // 3:] = -1
    elif kind == "interleaved":
        i[1::2] = -1
    o, i = torch.from_numpy(o).to(dev), torch.from_numpy(i).to(dev)
    oc, icr = lo.coords, li_.coords
    bounds = [ops.join_prune_metadata(o, i, oc, icr, to=8),
              (torch.from_numpy(rng.integers(-1, fanout + 3, p).astype(
                  np.int32)).to(dev),
               torch.from_numpy(rng.integers(-1, fanout + 3,
                                             (p, fanout // 8))
                                .astype(np.int32)).to(dev))]
    for ac, fm in bounds:
        args = (o, i, ac, fm, oc, icr, lo.ptr, li_.ptr)
        for cap in (1, 777, 1 << 22):
            before = jkern.launch_counts()["join_level_fused"]
            got = jkern.join_level_fused_cuda(*args, cap=cap)
            want = ref.join_level_fused_ref(*args, cap=cap)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(),
                                              w.cpu().numpy())
            assert jkern.launch_counts()["join_level_fused"] == before + 1
            n = int(want[2])
            assert (n == 0) == (kind == "dead")
            assert bool(got[3]) == (n > cap)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("o34", [False, True])
def test_cuda_join_engine_equals_cpu_engine(join_inst, fused, o34):
    dev = _need_gpu()
    outs = []
    for device in (dev, "cpu"):
        trees = [rtree.build_rtree(r, fanout=16, sort_key="lx",
                                   device=device) for r in join_inst]
        outs.append(join_vector.make_join_bfs(
            *trees, o3=o34, o4=o34, fused=fused)())
    (cp, cn, ct), (tp, tn, tc) = outs
    np.testing.assert_array_equal(cp.cpu().numpy(), tp.numpy())
    assert int(cn) == int(tn) > 0
    assert ct.asdict() == tc.asdict()


def _bits_equal(got, want):
    """Exact equality of tensors, float bits included (+inf and DIST_PAD
    alike)."""
    g, w = got.cpu(), want.cpu()
    assert g.dtype == w.dtype and g.shape == w.shape
    if g.dtype == torch.float32:
        g, w = g.view(torch.int32), w.view(torch.int32)
    np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.fixture(scope="module")
def knn_inst():
    rng = np.random.default_rng(43)
    rects = uniform_rects(rng, 3000, eps=0.003)
    pts = (rng.random((6, 2)) * 1.4 - 0.2).astype(np.float32)
    return rects, pts


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 64])
def test_cuda_knn_kernels_equal_twins(knn_inst, k):
    """B5 (both variants), B6 (tighten on and off, a random τ_in, a cap
    that holds and one that overflows) and B7 ≡ their twins, bit for bit,
    on every level with random frontiers (shuffled, 20% of slots -1)."""
    dev = _need_gpu()
    rects, pts = knn_inst
    tree = rtree.build_rtree(rects, fanout=16, device=dev)
    p = torch.from_numpy(pts).to(dev)
    rng = np.random.default_rng(k)
    for lvl in tree.levels:
        c = min(lvl.n_nodes, 48)
        ids = np.stack([rng.permutation(lvl.n_nodes)[:c]
                        for _ in range(len(pts))]).astype(np.int32)
        ids[rng.random(ids.shape) < 0.2] = -1
        ids = torch.from_numpy(ids).to(dev)
        rows = [getattr(lvl, f) for f in ROWS]
        before = kkern.launch_counts()
        for leaf in (False, True):
            got = kkern.knn_level_dists_cuda(ids, p, *rows, leaf=leaf)
            want = ref.knn_level_dists_ref(ids, p, *rows, leaf=leaf)
            _bits_equal(got[0], want[0])
            assert (got[1] is None) == (want[1] is None) == leaf
            if not leaf:
                _bits_equal(got[1], want[1])
        tau = torch.from_numpy(rng.random(len(pts)).astype(np.float32)
                               * 0.05).to(dev)
        for tighten in ((False, True) if c * 16 >= k else (False,)):
            for cap in (3, 256):
                got = kkern.knn_level_fused_cuda(ids, p, *rows, tau,
                                                 cap=cap, k=k,
                                                 tighten=tighten)
                want = ref.knn_level_fused_ref(ids, p, *rows, tau, cap=cap,
                                               k=k, tighten=tighten)
                for g, w in zip(got, want):
                    _bits_equal(g, w)
        for g, w in zip(kkern.knn_leaf_fused_cuda(ids, p, *rows, k=k),
                        ref.knn_leaf_fused_ref(ids, p, *rows, k=k)):
            _bits_equal(g, w)
        after = kkern.launch_counts()
        n_fused = 2 * (2 if c * 16 >= k else 1)
        assert after["knn_level_dists"] == before["knn_level_dists"] + 2
        assert after["knn_level_fused"] == before["knn_level_fused"] + n_fused
        assert after["knn_leaf_fused"] == before["knn_leaf_fused"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_cuda_knn_engine_equals_cpu_engine(knn_inst, k, caps_mode, fused):
    dev = _need_gpu()
    rects, pts = knn_inst
    outs = []
    for device in (dev, "cpu"):
        tree = rtree.build_rtree(rects, fanout=16, device=device)
        outs.append(knn_vector.make_knn_bfs(tree, k, fused=fused,
                                            caps_mode=caps_mode)(pts))
    (ci, cd, ct), (ti, td, tt) = outs
    _bits_equal(ci, ti)
    _bits_equal(cd, td)
    assert ct.asdict() == tt.asdict()


@pytest.fixture(scope="module")
def knn_join_inst():
    rng = np.random.default_rng(47)
    rects = uniform_rects(rng, 3000, eps=0.003)
    c = (rng.random((6, 2)) * 1.4 - 0.2).astype(np.float32)
    e = (rng.random((6, 2)) * 0.05).astype(np.float32)
    e[0] = 0                                       # one point query
    return rects, np.concatenate([c - e, c + e], axis=1)


def _real_frontiers(tree, q, k):
    """Each level's frontier of a real descent (the B9 twin, cap 64),
    columns shuffled and 20% of slots -1."""
    rng = np.random.default_rng(k)
    ids = torch.zeros((q.shape[0], 1), dtype=torch.int32, device=q.device)
    tau = torch.full((q.shape[0],), 3.0e38, device=q.device)
    out = {}
    for li in range(tree.height - 1, -1, -1):
        lvl = tree.levels[li]
        perm = torch.from_numpy(rng.permutation(ids.shape[1])).to(q.device)
        drop = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.2)
        out[li] = torch.where(drop.to(q.device), -1,
                              ids[:, perm]).contiguous()
        if li:
            ids, tau, _, _ = ref.knn_join_level_fused_ref(
                ids, q, *[getattr(lvl, f) for f in ROWS], tau, cap=64, k=k,
                tighten=ids.shape[1] * 16 >= k)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 64])
def test_cuda_knn_join_kernels_equal_twins(knn_join_inst, k):
    """B8 (both variants), B9 (tighten on and off, a random τ_in, a cap
    that holds and one that overflows) and B10 ≡ their twins, bit for
    bit, on every level of a real descent."""
    dev = _need_gpu()
    rects, q = knn_join_inst
    tree = rtree.build_rtree(rects, fanout=16, device=dev)
    qr = torch.from_numpy(q).to(dev)
    rng = np.random.default_rng(k + 1)
    for li, ids in _real_frontiers(tree, qr, k).items():
        rows = [getattr(tree.levels[li], f) for f in ROWS]
        c = ids.shape[1]
        before = kjkern.launch_counts()
        for leaf in (False, True):
            got = kjkern.knn_join_level_dists_cuda(ids, qr, *rows, leaf=leaf)
            want = ref.knn_join_level_dists_ref(ids, qr, *rows, leaf=leaf)
            _bits_equal(got[0], want[0])
            assert (got[1] is None) == (want[1] is None) == leaf
            if not leaf:
                _bits_equal(got[1], want[1])
        tau = torch.from_numpy(rng.random(len(q)).astype(np.float32)
                               * 0.05).to(dev)
        gates = (False, True) if c * 16 >= k else (False,)
        for tighten in gates:
            for cap in (3, 256):
                got = kjkern.knn_join_level_fused_cuda(
                    ids, qr, *rows, tau, cap=cap, k=k, tighten=tighten)
                want = ref.knn_join_level_fused_ref(
                    ids, qr, *rows, tau, cap=cap, k=k, tighten=tighten)
                for g, w in zip(got, want):
                    _bits_equal(g, w)
        for g, w in zip(kjkern.knn_join_leaf_fused_cuda(ids, qr, *rows, k=k),
                        ref.knn_join_leaf_fused_ref(ids, qr, *rows, k=k)):
            _bits_equal(g, w)
        after = kjkern.launch_counts()
        assert after["knn_join_level_dists"] == \
            before["knn_join_level_dists"] + 2
        assert after["knn_join_level_fused"] == \
            before["knn_join_level_fused"] + 2 * len(gates)
        assert after["knn_join_leaf_fused"] == \
            before["knn_join_leaf_fused"] + 1


@pytest.fixture(scope="module")
def dists_trees():
    """fanout → (a tree of 20,000 rects on the card, its D3 levels), built
    at first use."""
    cache = {}

    def get(fanout, dev):
        if fanout not in cache:
            rects = uniform_rects(np.random.default_rng(fanout), 20000,
                                  eps=0.002)
            tree = rtree.build_rtree(rects, fanout=fanout, device=dev)
            cache[fanout] = tree, layouts.tree_layout(tree, "d3")
        return cache[fanout]
    return get


def _offset_copy(t):
    """A contiguous copy of ``t`` whose data starts one element (4 bytes
    for float32, 2 for uint16) past an allocation's (aligned) start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == t.element_size()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("frontier", ["dead", "live", "random", "offset"])
@pytest.mark.parametrize("level", ["d1", "d1-leaf", "d3"])
@pytest.mark.parametrize("query", ["point", "rect"])
@pytest.mark.parametrize("fanout", [13, 16, 48, 64])
def test_cuda_dists_seams_equal_twins(dists_trees, fanout, query, level,
                                      frontier):
    """B5 / B8 (D1, leaf or not) and B13 / B14 (D3) ≡ their twins, bit for
    bit, on frontiers of B = 333 rows by C = 257 slots (more slots than one
    pass of the persistent grid, and no multiple of it) at the seams of
    the slot walk: every slot dead, every slot live, 10% of the slots -1,
    and 10% -1 with lx (D1) or scale (D3) a contiguous view 4 bytes past
    an aligned address.  That view, and fanout 13, take the scalar-lane
    variant; the rest the vector one."""
    dev = _need_gpu()
    tree, d3 = dists_trees(fanout, dev)
    rng = np.random.default_rng(fanout)
    b, c = 333, 257
    if level == "d3":
        rows = [getattr(d3[1], f) for f in ("qlo", "qhi", "scale", "bias",
                                            "slack", "ptr")]
        swap, kw = 2, {}
    else:
        rows = [getattr(tree.levels[0], f) for f in ROWS]
        swap, kw = 0, dict(leaf=level == "d1-leaf")
    if frontier == "offset":
        rows[swap] = _offset_copy(rows[swap])
    ids = rng.integers(0, rows[0].shape[0], (b, c)).astype(np.int32)
    if frontier == "dead":
        ids[:] = -1
    elif frontier != "live":
        ids[rng.random(ids.shape) < 0.1] = -1
    ids = torch.from_numpy(ids).to(dev)
    q = (rng.random((b, 2)) * 1.4 - 0.2).astype(np.float32)
    if query == "rect":
        q = np.concatenate([q - np.float32(0.01), q + np.float32(0.01)], 1)
    q = torch.from_numpy(q).to(dev)
    mod, name = (kkern, "knn_level_dists") if query == "point" else \
        (kjkern, "knn_join_level_dists")
    if level == "d3":
        name += "_d3"
    fn = getattr(mod, f"{name}_cuda")
    twin = getattr(ref, f"{name}_ref")
    before = mod.launch_counts()[name]
    got, want = fn(ids, q, *rows, **kw), twin(ids, q, *rows, **kw)
    torch.cuda.synchronize()
    assert mod.launch_counts()[name] == before + 1
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _bits_equal(g, w)
    assert bool((want[0] < 1e37).any()) == (frontier != "dead")


# the seams of the emit body (B6, B7, B9, B10): see the test's docstring
EMIT_CASES = ("dead", "few", "live", "single", "fanout13", "at-budget",
              "past-budget", "cap0", "cap1", "capmax", "ties", "tau-low")


def _emit_frontier(rng, case, n_nodes, b, c):
    """(B, C) ids of one emit seam case: 10% of the slots -1 unless the
    case says otherwise."""
    ids = rng.integers(0, n_nodes, (b, c)).astype(np.int32)
    if case == "dead":
        ids[:] = -1
    elif case == "few":                    # two live slots a row
        keep = np.argsort(rng.random((b, c)), axis=1)[:, :2]
        live = np.zeros((b, c), bool)
        np.put_along_axis(live, keep, True, axis=1)
        ids[~live] = -1
    elif case == "ties":                   # one node in every slot of a row
        ids[:] = ids[:, :1]
    elif case not in ("live", "at-budget", "past-budget", "capmax"):
        ids[rng.random((b, c)) < 0.1] = -1
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("case", EMIT_CASES)
@pytest.mark.parametrize("query", ["point", "rect"])
def test_cuda_emit_seams_equal_twins(dists_trees, query, case):
    """B6 / B9 (tighten on and off where C·F >= k) and B7 / B10 ≡ their
    twins, bit for bit, on the leaf level of a 20,000-rect tree, 67 rows,
    at the seams of the staged emit body: every slot dead; two live slots
    a row with k = 64, so fewer valid lanes than k and τ = DIST_PAD; every
    slot live; C = 1; fanout 13 (the scalar-lane variant); C at the
    staging budget (rows staged whole) and one slot past it (rows walked
    in segments), every slot live; cap 0 and cap 1 (k = 1 at the leaf);
    the largest cap (and k), with over 256 survivors a row; one node
    repeated in every slot of a row, so MINDIST ties straddle the cap-th
    key; τ_in below every MINDIST, so nothing is kept."""
    dev = _need_gpu()
    fanout = 13 if case == "fanout13" else 16
    tree, _ = dists_trees(fanout, dev)
    lvl = tree.levels[0]
    rows = [getattr(lvl, f) for f in ROWS]
    rng = np.random.default_rng(EMIT_CASES.index(case))
    b = 67
    q = (rng.random((b, 2)) * 1.4 - 0.2).astype(np.float32)
    if query == "rect":
        q = np.concatenate([q - np.float32(0.01), q + np.float32(0.01)], 1)
    q = torch.from_numpy(q).to(dev)
    mod, pre = (kkern, "knn") if query == "point" else (kjkern, "knn_join")
    most = kkern._max_cap()
    k = 64 if case == "few" else 1 if case == "cap1" else 8
    cap = {"cap0": 0, "cap1": 1, "capmax": most}.get(case, 40)
    tau = torch.from_numpy(rng.random(b).astype(np.float32) * 0.5).to(dev)
    if case in ("few", "capmax", "ties"):
        tau = torch.full((b,), 3.0e38, device=dev)
    elif case == "tau-low":
        tau = torch.full((b,), -1.0, device=dev)

    def width(leaf):
        slots = kkern.emit_stage_slots(1 << 20, fanout, leaf=leaf)
        return {"single": 1, "at-budget": slots, "past-budget": slots + 1,
                "capmax": 64}.get(case, 24)

    c = width(False)
    ids = torch.from_numpy(_emit_frontier(rng, case, lvl.n_nodes, b,
                                          c)).to(dev)
    fn = getattr(mod, f"{pre}_level_fused_cuda")
    twin = getattr(ref, f"{pre}_level_fused_ref")
    for tighten in ((False, True) if c * fanout >= k else (False,)):
        kw = dict(cap=cap, k=k, tighten=tighten)
        got, want = fn(ids, q, *rows, tau, **kw), twin(ids, q, *rows, tau,
                                                      **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _bits_equal(g, w)
        if case == "few":
            assert bool((want[1] == 3.0e38).all())
        if case == "tau-low":
            assert int(want[3].sum()) == 0
        if case == "capmax" and not tighten:
            assert int(want[3].min()) > 256
        if case == "ties" and not tighten:
            assert bool((want[3] > cap).any())
    c = width(True)
    ids = torch.from_numpy(_emit_frontier(rng, case, lvl.n_nodes, b,
                                          c)).to(dev)
    kl = {"capmax": most, "ties": cap}.get(case, k)
    fn = getattr(mod, f"{pre}_leaf_fused_cuda")
    twin = getattr(ref, f"{pre}_leaf_fused_ref")
    before = mod.launch_counts()[f"{pre}_leaf_fused"]
    got, want = fn(ids, q, *rows, k=kl), twin(ids, q, *rows, k=kl)
    torch.cuda.synchronize()
    assert mod.launch_counts()[f"{pre}_leaf_fused"] == before + 1
    for g, w in zip(got, want):
        _bits_equal(g, w)
    assert bool((want[2] > 0).any()) == (case != "dead")


@pytest.mark.cuda
@pytest.mark.parametrize("frontier", ["dead", "live", "random",
                                      "offset-codes", "offset-scale"])
@pytest.mark.parametrize("fanout", [13, 16, 64])
def test_cuda_select_masks_d3_seams_equal_twin(dists_trees, fanout,
                                               frontier):
    """B11 ≡ its twin, bit for bit, on level 1 of a D3 tree with B = 333
    rows by C = 257 slots (more than one pass of the persistent grid):
    every slot dead, every slot live, 10% of the slots -1, and 10% -1
    with qlo or scale a contiguous view one element past an aligned
    address.  Those views, and fanout 13, take the scalar-lane variant;
    the rest the vector one."""
    dev = _need_gpu()
    _, d3 = dists_trees(fanout, dev)
    lvl = d3[1]
    rows = [lvl.qlo, lvl.qhi, lvl.scale, lvl.bias, lvl.ptr]
    if frontier == "offset-codes":
        rows[0] = _offset_copy(rows[0])
    elif frontier == "offset-scale":
        rows[2] = _offset_copy(rows[2])
    rng = np.random.default_rng(fanout)
    b, c = 333, 257
    ids = rng.integers(0, rows[0].shape[0], (b, c)).astype(np.int32)
    if frontier == "dead":
        ids[:] = -1
    elif frontier != "live":
        ids[rng.random(ids.shape) < 0.1] = -1
    ids = torch.from_numpy(ids).to(dev)
    lo = (rng.random((b, 2)) * 1.2 - 0.1).astype(np.float32)
    q = torch.from_numpy(np.concatenate(
        [lo, lo + rng.random((b, 2)).astype(np.float32) * 0.1], 1)).to(dev)
    before = kern.launch_counts()["select_level_masks_d3"]
    got = kern.select_level_masks_d3_cuda(ids, q, *rows)
    want = ref.select_level_masks_d3_ref(ids, q, *rows)
    torch.cuda.synchronize()
    assert kern.launch_counts()["select_level_masks_d3"] == before + 1
    _bits_equal(got, want)
    assert bool(want.any()) == (frontier != "dead")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_cuda_knn_join_engine_equals_cpu_engine(knn_join_inst, k, caps_mode,
                                                fused):
    dev = _need_gpu()
    rects, q = knn_join_inst
    outs = []
    for device in (dev, "cpu"):
        tree = rtree.build_rtree(rects, fanout=16, device=device)
        outs.append(knn_join_vector.make_knn_join_bfs(
            tree, k, fused=fused, caps_mode=caps_mode)(q))
    (ci, cd, ct), (ti, td, tt) = outs
    _bits_equal(ci, ti)
    _bits_equal(cd, td)
    assert ct.asdict() == tt.asdict()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_all_pairs_knn_join_equals_cpu(knn_join_inst, fused):
    """700 outer rects in chunks of 256 (the last one padded)."""
    dev = _need_gpu()
    rects, _ = knn_join_inst
    outer = uniform_rects(np.random.default_rng(48), 700, eps=0.004)
    outs = []
    for device in (dev, "cpu"):
        trees = [rtree.build_rtree(r, fanout=16, device=device)
                 for r in (outer, rects)]
        outs.append(knn_join_vector.knn_join(*trees, 8, fused=fused,
                                             batch=256))
    (ci, cd, ct), (ti, td, tt) = outs
    np.testing.assert_array_equal(ci, ti)
    np.testing.assert_array_equal(cd, td)
    assert ct.asdict() == tt.asdict()


# ---------------------------------------------------------------------------
# the D3 layout: B11-B14 and the D3 engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def d3_inst():
    rng = np.random.default_rng(53)
    rects = uniform_rects(rng, 4000, eps=0.002)
    c = (rng.random((6, 2)) * 1.4 - 0.2).astype(np.float32)
    e = (rng.random((6, 2)) * 0.08).astype(np.float32)
    e[0] = 0                                       # one degenerate rect
    return rects, np.concatenate([c - e, c + e], axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [2048, 16])           # 16 forces overflow
def test_cuda_d3_kernels_equal_twins(d3_inst, cap):
    """B11, B12, B13 and B14 ≡ their twins, bit for bit, on every internal
    level with random frontiers (shuffled, 20% of slots -1); the codes
    quantized on the card ≡ those quantized on the CPU."""
    dev = _need_gpu()
    rects, q = d3_inst
    tree = rtree.build_rtree(rects, fanout=16, device=dev)
    cpu_layers = layouts.tree_layout(
        rtree.build_rtree(rects, fanout=16, device="cpu"), "d3")
    q4 = torch.from_numpy(q).to(dev)
    p2 = q4[:, :2].contiguous()
    rng = np.random.default_rng(cap)
    for li, lvl3 in enumerate(layouts.tree_layout(tree, "d3")):
        for f in layouts.D3_FIELDS:
            assert torch.equal(getattr(lvl3, f).cpu(),
                               getattr(cpu_layers[li], f)), (li, f)
        if li == 0:
            continue
        n = lvl3.qlo.shape[0]
        c = min(n, 48)
        ids = np.stack([rng.permutation(n)[:c]
                        for _ in range(len(q))]).astype(np.int32)
        ids[rng.random(ids.shape) < 0.2] = -1
        ids = torch.from_numpy(ids).to(dev)
        sel = (lvl3.qlo, lvl3.qhi, lvl3.scale, lvl3.bias, lvl3.ptr)
        dist = (lvl3.qlo, lvl3.qhi, lvl3.scale, lvl3.bias, lvl3.slack,
                lvl3.ptr)
        before = (kern.launch_counts(), kkern.launch_counts(),
                  kjkern.launch_counts())
        _bits_equal(kern.select_level_masks_d3_cuda(ids, q4, *sel),
                    ref.select_level_masks_d3_ref(ids, q4, *sel))
        for g, w in zip(
                kern.select_level_fused_d3_cuda(ids, q4, *sel, cap=cap),
                ref.select_level_fused_d3_ref(ids, q4, *sel, cap=cap)):
            _bits_equal(g, w)
        for g, w in zip(kkern.knn_level_dists_d3_cuda(ids, p2, *dist),
                        ref.knn_level_dists_d3_ref(ids, p2, *dist)):
            _bits_equal(g, w)
        for g, w in zip(kjkern.knn_join_level_dists_d3_cuda(ids, q4, *dist),
                        ref.knn_join_level_dists_d3_ref(ids, q4, *dist)):
            _bits_equal(g, w)
        after = (kern.launch_counts(), kkern.launch_counts(),
                 kjkern.launch_counts())
        for name, i in (("select_level_masks_d3", 0),
                        ("select_level_fused_d3", 0),
                        ("knn_level_dists_d3", 1),
                        ("knn_join_level_dists_d3", 2)):
            assert after[i][name] == before[i][name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("op", ["select", "select_fused", "knn",
                                "knn_join"])
def test_cuda_d3_engine_equals_cpu_engine(d3_inst, op, caps_mode):
    """The D3 engines on the card ≡ the same engines on the CPU (ids,
    counts or distance bits, every counter), and their results ≡ the D1
    engine's on the card."""
    dev = _need_gpu()
    rects, q = d3_inst
    p = np.ascontiguousarray(q[:, :2])
    builds = {
        "select": lambda t, **kw: select_vector.make_select_bfs(
            t, result_cap=512, **kw)(q),
        "select_fused": lambda t, **kw: select_vector.make_select_bfs(
            t, result_cap=512, fused=True, **kw)(q),
        "knn": lambda t, **kw: knn_vector.make_knn_bfs(t, 8, **kw)(p),
        "knn_join": lambda t, **kw: knn_join_vector.make_knn_join_bfs(
            t, 8, **kw)(q),
    }
    outs = {}
    for device in (dev, "cpu"):
        tree = rtree.build_rtree(rects, fanout=16, device=device)
        outs[device] = builds[op](tree, layout="d3", caps_mode=caps_mode)
    (ca, cb, ct), (ta, tb, tt) = outs[dev], outs["cpu"]
    _bits_equal(ca, ta)
    _bits_equal(cb, tb)
    assert ct.asdict() == tt.asdict()
    da, db, _ = builds[op](rtree.build_rtree(rects, fanout=16, device=dev),
                           caps_mode=caps_mode)
    _bits_equal(ca, da)
    _bits_equal(cb, db)


# ---------------------------------------------------------------------------
# browse (B5, B13) and filtered kNN on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def a10_inst():
    rng = np.random.default_rng(47)
    rects = uniform_rects(rng, 20000, eps=0.001)
    pts = rng.random((16, 2)).astype(np.float32)
    return rects, pts


@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [13, 64])
@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_cuda_browse_equals_twin_session(a10_inst, layout, fanout):
    """A browse session on the card (B5, and B13 on D3's internal levels)
    ≡ the twin session on the card, step by step: ids, distance bits,
    overflow and the whole state, counters included."""
    dev = _need_gpu()
    rects, pts = a10_inst
    tree = rtree.build_rtree(rects, fanout=fanout, device=dev)
    cur = knn_browse.browse_knn(tree, pts, 8, layout=layout)
    twin = knn_browse.browse_knn(tree, pts, 8, layout=layout,
                                 backend="torch")
    name = "knn_level_dists_d3" if layout == "d3" else "knn_level_dists"
    before = kkern.launch_counts()
    for step in range(72):           # 576 neighbours: past the 512-slot pool
        for g, w in zip(cur.next_batch(), twin.next_batch()):
            _bits_equal(torch.from_numpy(g), torch.from_numpy(w))
        a, b = cur.state, twin.state
        for f in ("pool_ids", "pool_d", "lost", "emitted", "overflow",
                  "descents"):
            _bits_equal(getattr(a, f), getattr(b, f))
        for x, y in zip(a.def_ids + a.def_d, b.def_ids + b.def_d):
            _bits_equal(x, y)
        assert a.ctr.asdict() == b.ctr.asdict(), step
    assert int(cur.state.descents) > 1
    after = kkern.launch_counts()
    assert after[name] > before[name]
    assert after["knn_level_dists"] > before["knn_level_dists"]


@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [13, 64])
@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_cuda_knn_filtered_equals_cpu_engine(a10_inst, layout, fanout):
    """Filtered kNN on the card ≡ the same engine on the CPU: ids,
    distance bits and every counter, windows of half-extent 0.2 and
    0.05."""
    dev = _need_gpu()
    rects, pts = a10_inst
    for eps in (0.2, 0.05):
        e = np.float32(eps)
        qs = np.concatenate([pts, pts - e, pts + e], axis=1)
        outs = []
        for device in (dev, "cpu"):
            tree = rtree.build_rtree(rects, fanout=fanout, device=device)
            outs.append(knn_filtered.make_knn_filtered_bfs(
                tree, 8, layout=layout)(qs))
        (ci, cd, ct), (ti, td, tt) = outs
        assert ci.is_cuda
        _bits_equal(ci, ti)
        _bits_equal(cd, td)
        assert ct.asdict() == tt.asdict()


FLAT_ROWS = ("lx", "ly", "hx", "hy", "child", "count", "is_leaf")


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(1024, 4096), (4, 64), (1, 32)])
@pytest.mark.parametrize("fanout", [13, 16, 48, 64])
@pytest.mark.parametrize("variant", ["scalar", "vector"])
def test_cuda_dfs_kernels_equal_twins(inst, variant, fanout, caps):
    """S and V ≡ their host twins for every query (res in emit order, rc,
    nodes, predicates, overflow), F below, at and past a warp's 32 lanes,
    with a stack that overflows and a one-slot stack whose walk stops at
    ``dfs_max_steps``; one launch a call."""
    dev = _need_gpu()
    stack_cap, result_cap = caps
    rects, small, big = inst
    tables = [flat.flatten_tree(rtree.build_rtree(rects, fanout=fanout,
                                                  device=d))
              for d in (dev, "cpu")]
    steps = select_scalar.dfs_max_steps(tables[1])
    for q in np.concatenate([small, big]):
        before = dkern.launch_counts()[f"select_dfs_{variant}"]
        outs = []
        for t, backend in zip(tables, ("cuda", "torch")):
            outs.append(ops.select_dfs(
                variant, *(getattr(t, f) for f in FLAT_ROWS),
                torch.from_numpy(q).to(t.device), root=t.root,
                stack_cap=stack_cap, result_cap=result_cap,
                max_steps=steps, backend=backend))
        (kres, kstats), (tres, tstats) = outs
        torch.cuda.synchronize()
        np.testing.assert_array_equal(kres.cpu().numpy(), tres.numpy())
        np.testing.assert_array_equal(kstats.cpu().numpy(), tstats.numpy())
        assert dkern.launch_counts()[f"select_dfs_{variant}"] == before + 1
    if caps == (1, 32) and tables[1].height > 2:
        # the big queries' last walk re-reads an internal node without end
        assert int(kstats[1]) == steps and int(kstats[3]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["scalar", "vector"])
def test_cuda_dfs_engine_equals_cpu_engine(inst, variant):
    dev = _need_gpu()
    rects, small, big = inst
    make = select_scalar.make_select_dfs if variant == "scalar" else \
        select_vector.make_select_dfs_vector
    fns = [make(flat.flatten_tree(rtree.build_rtree(rects, fanout=16,
                                                    device=d)), 256)
           for d in (dev, "cpu")]
    for q in np.concatenate([small, big]):
        before = dkern.launch_counts()[f"select_dfs_{variant}"]
        (kres, krc, kctr), (tres, trc, tctr) = (f(q) for f in fns)
        assert dkern.launch_counts()[f"select_dfs_{variant}"] == before + 1
        np.testing.assert_array_equal(kres.cpu().numpy(), tres.numpy())
        assert int(krc) == int(trc)
        assert kctr.asdict() == tctr.asdict()
