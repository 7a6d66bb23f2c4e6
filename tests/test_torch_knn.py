"""Port (repro_torch) ≡ reference (repro): the kNN slice.

The distance functions and the B5 twin are held against the reference's
jitted ``ref.knn_level_dists_ref`` and its Pallas kernel run as the
reference's own tests run it on the CPU (``interpret=True``); the B6/B7
twins against the reference's jitted fused twins; the fleet against its
host path (the engine: ``test_torch_knn_engine.py``).  Inputs are made
with numpy from a seed and handed to both packages.  The port pins the
reference's FMA roundings, so every comparison is exact: ids, distance
bits, overflow and every ``Counters`` field except ``dispatches``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caps as jcaps
from repro.core import compaction as jcompaction
from repro.core import geometry as jgeometry
from repro.core import knn_vector as jknn
from repro.core import rtree as jrtree
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro.kernels import ref as jref
from repro.kernels import rtree_knn as jkern
from repro_torch.core import caps as tcaps
from repro_torch.core import compaction as tcompaction
from repro_torch.core import geometry as tgeometry
from repro_torch.core import knn_vector as tknn
from repro_torch.core import rtree as trtree
from repro_torch.core.counters import Counters
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rtree_knn as tkern
from repro_torch.launch import serve

from conftest import uniform_rects

ENGINE_FIELDS = tuple(f for f in Counters.__dataclass_fields__
                      if f != "dispatches")
ROWS = ("lx", "ly", "hx", "hy", "child")
_jit_dists = jax.jit(jref.knn_level_dists_ref, static_argnames=("leaf",))
_jit_level_fused = jax.jit(jref.knn_level_fused_ref,
                           static_argnames=("cap", "k", "tighten"))
_jit_leaf_fused = jax.jit(jref.knn_leaf_fused_ref, static_argnames=("k",))


@pytest.fixture(scope="module")
def inst():
    """20,000 small rects, fanout 16 (height 4), in both packages, and
    64 query points (a batch that overflows the adaptive tier at k = 1)."""
    rng = np.random.default_rng(3)
    rects = uniform_rects(rng, 20000, eps=0.001)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    assert ttree.height == 4
    pts = rng.random((64, 2)).astype(np.float32)
    return rects, jtree, ttree, pts


def _with_far_points(pts):
    """The batch plus 16 points outside the unit square."""
    far = np.random.default_rng(1).random((16, 2)).astype(np.float32)
    return np.concatenate([pts, far * 1.6 - 0.3])


def _bits(a):
    """A float32 array's bits (int32), so +inf and DIST_PAD compare
    exactly; other dtypes as they are."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, ctx):
    assert _bits(got).dtype == _bits(want).dtype, ctx
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


def _frontier(rng, n_nodes, b=64, c=24, pad=0.2):
    """(B, C) random node ids of a level, some slots -1."""
    ids = rng.integers(0, n_nodes, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < pad] = -1
    return ids


def _level_args(tree, li, torch_side):
    lvl = tree.levels[li]
    return [getattr(lvl, f) if torch_side else jnp.asarray(getattr(lvl, f))
            for f in ROWS]


# ---------------------------------------------------------------------------
# distances, the B5 twin, the fused twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("leaf", [False, True])
def test_distances_equal_jitted_reference(spread, leaf):
    """Random node rows and points (``spread`` 3 puts most points outside
    the unit square): the port's MINDIST/MINMAXDIST ≡ the reference's jitted
    gather trace, bit for bit."""
    rng = np.random.default_rng(int(spread * 10) + leaf)
    n, f = 300, 16
    lo = rng.random((n, f, 2)).astype(np.float32)
    ext = (rng.random((n, f, 2)) ** 3 * 0.3).astype(np.float32)
    rows = [lo[..., 0], lo[..., 1], lo[..., 0] + ext[..., 0],
            lo[..., 1] + ext[..., 1]]
    child = rng.integers(-1, 1000, (n, f)).astype(np.int32)
    ids = _frontier(rng, n, b=64, c=40)
    pts = ((rng.random((64, 2)) - 0.5) * spread + 0.5).astype(np.float32)
    want = _jit_dists(ids, pts, *rows, child, leaf=leaf)
    got = ref.knn_level_dists_ref(*map(torch.from_numpy, (ids, pts, *rows,
                                                          child)), leaf=leaf)
    _assert_same(got[0], want[0], "mindist")
    if leaf:
        assert got[1] is None and want[1] is None
    else:
        _assert_same(got[1], want[1], "minmaxdist")
    assert (got[0] < float(tgeometry.DIST_VALID_MAX)).any()


def test_fma32_rounds_once():
    """a·a + c lands on a float32 midpoint after a float64 sum (a = 1 +
    2^-12, c = 2^-60): one rounding gives the upper neighbour, a float64
    sum rounded again gives the lower one."""
    a = torch.tensor([1 + 2 ** -12, 0.75, 3.0], dtype=torch.float32)
    c = torch.tensor([2 ** -60, 0.5, -9.0], dtype=torch.float32)
    got = tgeometry.fma32(a, a, c)
    assert got.tolist() == [1 + 2 ** -11 + 2 ** -23, 1.0625, 0.0]
    naive = (a.double() * a.double() + c.double()).float()
    assert naive[0].item() == 1 + 2 ** -11


def test_numpy_oracles_equal_reference(inst):
    rects, _, _, pts = inst
    r = rects[:500].astype(np.float64)
    p = pts.astype(np.float64)
    args = (p[:, 0, None], p[:, 1, None], r[None, :, 0], r[None, :, 1],
            r[None, :, 2], r[None, :, 3])
    for name in ("mindist_np", "minmaxdist_np"):
        np.testing.assert_array_equal(getattr(tgeometry, name)(*args),
                                      getattr(jgeometry, name)(*args))
    np.testing.assert_array_equal(tgeometry.mindist_matrix_np(pts, rects),
                                  jgeometry.mindist_matrix_np(pts, rects))
    for k in (1, 8, 600):                        # 600 > 500 rects: padded
        for g, w in zip(tgeometry.brute_force_knn(rects[:500], pts, k),
                        jgeometry.brute_force_knn(rects[:500], pts, k)):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def inst13(inst):
    """3,000 small rects at fanout 13 (F no multiple of 4) in both
    packages, and the 64 query points of ``inst``."""
    rects = uniform_rects(np.random.default_rng(13), 3000, eps=0.001)
    return (rects, jrtree.build_rtree(rects, fanout=13),
            trtree.build_rtree(rects, fanout=13, device="cpu"), inst[3])


def _seam_frontier(rng, n_nodes, frontier, c=24):
    """A (64, c) frontier at a seam of the CUDA score kernel's slot walk:
    every slot -1 ("dead"), every slot live ("live"), one slot a row
    ("single"), else random with 20% of the slots -1."""
    ids = _frontier(rng, n_nodes, c=1 if frontier == "single" else c,
                    pad=0.0 if frontier in ("live", "single") else 0.2)
    if frontier == "dead":
        ids[:] = -1
    return ids


# (li, leaf, frontier): random frontiers on three levels, then the seams of
# the CUDA kernel at the leaf level: all slots dead, all live, C = 1, and
# a fanout-13 tree (its scalar-lane variant)
DISTS_CASES = [pytest.param(li, leaf, "random", id=f"{li}-{leaf}")
               for li in (0, 1, 2) for leaf in (False, True)] + \
    [pytest.param(0, leaf, frontier, id=f"{frontier}-{leaf}")
     for frontier in ("dead", "live", "single", "fanout13")
     for leaf in (False, True)]


@pytest.mark.parametrize("li,leaf,frontier", DISTS_CASES)
def test_level_dists_twin_equals_pallas(request, li, leaf, frontier):
    _, jtree, ttree, pts = request.getfixturevalue(
        "inst13" if frontier == "fanout13" else "inst")
    rng = np.random.default_rng(10 * li + leaf)
    ids = _seam_frontier(rng, ttree.levels[li].n_nodes, frontier)
    want = jkern.knn_level_dists(jnp.asarray(ids), jnp.asarray(pts),
                                 *_level_args(jtree, li, False), leaf=leaf,
                                 interpret=True)
    got = ref.knn_level_dists_ref(torch.from_numpy(ids),
                                  torch.from_numpy(pts),
                                  *_level_args(ttree, li, True), leaf=leaf)
    _assert_same(got[0], want[0], "mindist")
    if not leaf:
        _assert_same(got[1], want[1], "minmaxdist")
    valid = got[0] < float(tgeometry.DIST_VALID_MAX)
    assert bool(valid.any()) == (frontier != "dead")
    assert got[0].shape[2] == (13 if frontier == "fanout13" else 16)


def _fused_frontier(rng, n_nodes, frontier):
    """A (64, 8) frontier of a fused-twin case: random with 20% of the
    slots -1, or a seam of ``_seam_frontier`` (dead, live, one slot a
    row), or two live slots a row ("few"), or one node in every slot of a
    row ("ties")."""
    if frontier not in ("few", "ties"):
        return _seam_frontier(rng, n_nodes, frontier, c=8)
    ids = _frontier(rng, n_nodes, c=8, pad=0.0)
    if frontier == "few":
        drop = np.argsort(rng.random(ids.shape), axis=1)[:, 2:]
        np.put_along_axis(ids, drop, -1, axis=1)
    else:
        ids[:] = ids[:, :1]
    return ids


# (k, frontier): random frontiers, then the seams of the CUDA emit body:
# every slot dead, two live slots a row at k = 64 (fewer valid lanes than
# k, so τ = DIST_PAD), every slot live, C = 1, and one node in every slot
# of a row (MINDIST ties across lanes at an overflowing cap); the last two
# with τ_in = DIST_PAD
FUSED_CASES = [pytest.param(k, "random", id=str(k)) for k in (1, 8, 64)] + \
    [pytest.param(k, frontier, id=f"{frontier}-{k}")
     for k, frontier in ((8, "dead"), (64, "few"), (8, "live"),
                         (8, "single"), (8, "ties"))]


@pytest.mark.parametrize("k,frontier", FUSED_CASES)
def test_fused_twins_equal_jitted_reference(inst, k, frontier):
    """B6 (tighten on and off, random τ_in, a cap that holds and one that
    overflows) and B7 (also C·F < k) ≡ the reference's jitted twins."""
    _, jtree, ttree, pts = inst
    rng = np.random.default_rng(k)
    for li in range(ttree.height):
        ids = _fused_frontier(rng, ttree.levels[li].n_nodes, frontier)
        lanes = ids.shape[1] * 16
        jargs = [jnp.asarray(ids), jnp.asarray(pts),
                 *_level_args(jtree, li, False)]
        targs = [torch.from_numpy(ids), torch.from_numpy(pts),
                 *_level_args(ttree, li, True)]
        tau = (rng.random(64) * 0.01).astype(np.float32)
        if frontier in ("few", "ties"):
            tau[:] = np.float32(3.0e38)
        for tighten in ((False, True) if lanes >= k else (False,)):
            for cap in (4, 64):
                kw = dict(cap=cap, k=k, tighten=tighten)
                want = _jit_level_fused(*jargs, jnp.asarray(tau), **kw)
                got = ref.knn_level_fused_ref(*targs, torch.from_numpy(tau),
                                              **kw)
                for g, w, name in zip(got, want, ("next", "tau", "valid",
                                                  "keep")):
                    _assert_same(g, w, f"level {li} {kw} {name}")
                if frontier == "few":
                    assert bool((got[1] == float(tgeometry.DIST_PAD)).all())
                if frontier == "ties" and li == 0 and not tighten:
                    assert bool((got[3] > cap).any())
        for kk in (k, lanes + 72):                    # C·F < kk: padded
            want = _jit_leaf_fused(*jargs, k=kk)
            got = ref.knn_leaf_fused_ref(*targs, k=kk)
            for g, w, name in zip(got, want, ("ids", "d", "valid")):
                _assert_same(g, w, f"level {li} leaf k={kk} {name}")
        assert int((got[0] < 0).sum()) >= 64 * 72


# ---------------------------------------------------------------------------
# compaction and caps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 5, 40, 300])
def test_beam_rows_equal_reference(cap):
    """Distances drawn from few values (many ties) and a mask: the same
    beam, order, count and overflow; cap 300 > M pads."""
    rng = np.random.default_rng(cap)
    vals = rng.integers(0, 10 ** 6, (6, 200)).astype(np.int32)
    d = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0, 7.0]), (6, 200))
    mask = rng.random((6, 200)) < 0.4
    want = jcompaction.beam_rows(jnp.asarray(vals), jnp.asarray(d),
                                 jnp.asarray(mask), cap)
    got = tcompaction.beam_rows(*map(torch.from_numpy, (vals, d, mask)), cap)
    for g, w in zip(got, want):
        _assert_same(g, w, f"cap {cap}")
    assert bool(got[2].any()) == (cap < 200 * 0.3)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_knn_frontier_caps_equal_reference(inst, k):
    _, jtree, ttree, _ = inst
    for policy in ("static", "adaptive"):
        assert tknn.knn_frontier_caps(ttree, k, policy=policy) == \
            jknn.knn_frontier_caps(jtree, k, policy=policy)
    assert tcaps._distance_floor(k, 16, 4) == jcaps._distance_floor(k, 16, 4)


# ---------------------------------------------------------------------------
# the fleet and the serve entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 8])
def test_fleet_knn_equals_reference_host_path(k):
    rng = np.random.default_rng(5 + k)
    rects = uniform_rects(rng, 6000, eps=0.001)
    pts = rng.random((40, 2)).astype(np.float32)
    jshards = JShards.build(rects, 4, fanout=16)
    tshards = TShards.build(rects, 4, fanout=16, device="cpu")
    want = jshards.knn(pts, k)
    got = tshards.knn(pts, k)
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is want[2] is False
    for f in ENGINE_FIELDS + ("dispatches",):
        np.testing.assert_array_equal(
            np.asarray(getattr(tshards.last_counters, f)),
            np.asarray(getattr(jshards.last_counters, f)), err_msg=f)
    _, want_d = tgeometry.brute_force_knn(rects, pts, k)
    np.testing.assert_allclose(got[1], want_d, rtol=1e-4, atol=1e-9)
    n_engines = len(tshards._engines)
    tshards.warm("knn", 8, k=k)
    assert len(tshards._engines) == n_engines
    with pytest.raises(ValueError, match="needs k"):
        tshards.warm("knn", 8)


def test_serve_knn_dryrun_cpu():
    out = serve.main(["--mode", "knn", "--dryrun", "--device", "cpu"])
    assert out["qps"] > 0 and not out["overflow"]
    assert out["neighbors"] == 2 * 8 * 4                  # k capped at 4
    rects, qs = serve.make_knn_inputs(2000, 0, 2, 8)
    np.testing.assert_array_equal(serve.make_rects(2000, 0), rects)
    ids, d = out["first_batch"]
    want_i, want_d = tgeometry.brute_force_knn(rects, qs[0], 4)
    np.testing.assert_allclose(d, want_d, rtol=1e-4, atol=1e-9)
    assert ids.shape == (8, 4) and bool((ids >= 0).all())


def test_serve_knn_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--mode", "knn", "--dryrun"])


# ---------------------------------------------------------------------------
# no fallback: a CUDA request never quietly becomes the CPU twin
# ---------------------------------------------------------------------------

def test_cuda_backend_on_cpu_tensors_raises_for_knn(inst):
    _, _, ttree, pts = inst
    rows = _level_args(ttree, 0, True)
    ids = torch.zeros((4, 2), dtype=torch.int32)
    p = torch.from_numpy(pts[:4])
    tau = torch.full((4,), 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.knn_level_dists(ids, p, *rows, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.knn_level_fused(ids, p, *rows, tau, cap=8, k=4, tighten=True,
                            backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.knn_leaf_fused(ids, p, *rows, k=4, backend="cuda")
    for fn, kw in ((tkern.knn_level_dists_cuda, {}),
                   (tkern.knn_leaf_fused_cuda, dict(k=4))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(ids, p, *rows, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkern.knn_level_fused_cuda(ids, p, *rows, tau, cap=8, k=4,
                                   tighten=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tknn.make_knn_bfs(ttree, 8, backend="cuda")
    before = tkern.launch_counts()
    assert ops.knn_level_dists(ids, p, *rows)[0].shape == (4, 2, 16)
    assert ops.knn_leaf_fused(ids, p, *rows, k=4)[0].shape == (4, 4)
    assert tkern.launch_counts() == before
