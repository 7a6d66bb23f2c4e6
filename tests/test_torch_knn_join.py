"""Port (repro_torch) ≡ reference (repro): the kNN-join slice.

The rect distance functions and the B8 twin are held against the
reference's jitted ``ref.knn_join_level_dists_ref`` and its Pallas kernel
run as the reference's own tests run it on the CPU (``interpret=True``);
the B9/B10 twins against the reference's jitted fused twins.  The
kNN-join engine and the all-pairs ``knn_join`` against the reference's
jitted ``backend="xla"`` path, the fleet against its host path and serve
are in ``test_torch_knn_join_engines.py``, on this file's instance and
helpers.  Inputs are made with numpy from a seed and handed to both
packages.  The port pins the
reference's FMA roundings, so every comparison is exact: ids, distance
bits, overflow and every ``Counters`` field except ``dispatches``.  Only
the numpy oracles are held loosely (rtol 1e-4, float64 against float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeometry
from repro.core import rtree as jrtree
from repro.kernels import ref as jref
from repro.kernels import rtree_knn_join as jkern
from repro_torch.core import geometry as tgeometry
from repro_torch.core import rtree as trtree
from repro_torch.core.counters import Counters
from repro_torch.kernels import ref

from conftest import uniform_rects

ENGINE_FIELDS = tuple(f for f in Counters.__dataclass_fields__
                      if f != "dispatches")
ROWS = ("lx", "ly", "hx", "hy", "child")
_jit_dists = jax.jit(jref.knn_join_level_dists_ref, static_argnames=("leaf",))
_jit_level_fused = jax.jit(jref.knn_join_level_fused_ref,
                           static_argnames=("cap", "k", "tighten"))
_jit_leaf_fused = jax.jit(jref.knn_join_leaf_fused_ref,
                          static_argnames=("k",))


def _qrects(rng, n, spread=1.0, eps=0.01):
    """``n`` query rects: centres over ``spread`` times the unit square,
    half-extents up to ``eps`` (0: degenerate point queries)."""
    c = ((rng.random((n, 2)) - 0.5) * spread + 0.5).astype(np.float32)
    e = (rng.random((n, 2)) * eps).astype(np.float32)
    return np.concatenate([c - e, c + e], axis=1)


@pytest.fixture(scope="module")
def inst():
    """20,000 small rects, fanout 16 (height 4), in both packages, and 64
    query rects of half-extent up to 0.01 (a batch that overflows the
    adaptive tier at k = 1)."""
    rng = np.random.default_rng(3)
    rects = uniform_rects(rng, 20000, eps=0.001)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    assert ttree.height == 4
    return rects, jtree, ttree, _qrects(rng, 64)


def _with_far_rects(q):
    """The batch plus 16 rects outside the unit square."""
    return np.concatenate([q, _qrects(np.random.default_rng(1), 16,
                                      spread=2.5)])


def _bits(a):
    """A float32 array's bits (int32), so +inf and DIST_PAD compare
    exactly; other dtypes as they are."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, ctx):
    assert _bits(got).dtype == _bits(want).dtype, ctx
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


def _level_args(tree, li, torch_side):
    lvl = tree.levels[li]
    return [getattr(lvl, f) if torch_side else jnp.asarray(getattr(lvl, f))
            for f in ROWS]


def _real_frontiers(ttree, q, k, cap, rng):
    """Each level's (B, C) frontier of a real descent (the port's B9 twin
    with cap ``cap``), columns shuffled and 10% of slots set to -1."""
    qt = torch.from_numpy(q)
    ids = torch.zeros((len(q), 1), dtype=torch.int32)
    tau = torch.full((len(q),), 3.0e38)
    out = {}
    for li in range(ttree.height - 1, -1, -1):
        perm = torch.from_numpy(rng.permutation(ids.shape[1]))
        drop = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.1)
        out[li] = torch.where(drop, -1, ids[:, perm]).contiguous().numpy()
        if li:
            ids, tau, _, _ = ref.knn_join_level_fused_ref(
                ids, qt, *_level_args(ttree, li, True), tau, cap=cap, k=k,
                tighten=ids.shape[1] * 16 >= k)
    return out


# ---------------------------------------------------------------------------
# rect distances, the numpy oracles, the B8 twin, the fused twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spread,eps", [(1.0, 0.01), (3.0, 0.05),
                                        (1.0, 0.0), (1.0, 0.3)])
@pytest.mark.parametrize("leaf", [False, True])
def test_rect_distances_equal_jitted_reference(spread, eps, leaf):
    """Random node rows and query rects (``spread`` 3 puts most outside
    the unit square, ``eps`` 0 makes them points, 0.3 makes most overlap
    their rows): the port's rect MINDIST/MINMAXDIST ≡ the reference's
    jitted gather trace, bit for bit."""
    rng = np.random.default_rng(int(spread * 10 + eps * 100) + leaf)
    n, f = 300, 16
    lo = rng.random((n, f, 2)).astype(np.float32)
    ext = (rng.random((n, f, 2)) ** 3 * 0.3).astype(np.float32)
    rows = [lo[..., 0], lo[..., 1], lo[..., 0] + ext[..., 0],
            lo[..., 1] + ext[..., 1]]
    child = rng.integers(-1, 1000, (n, f)).astype(np.int32)
    ids = rng.integers(0, n, (64, 40)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    q = _qrects(rng, 64, spread, eps)
    want = _jit_dists(ids, q, *rows, child, leaf=leaf)
    got = ref.knn_join_level_dists_ref(
        *map(torch.from_numpy, (ids, q, *rows, child)), leaf=leaf)
    _assert_same(got[0], want[0], "mindist")
    if leaf:
        assert got[1] is None and want[1] is None
    else:
        _assert_same(got[1], want[1], "minmaxdist")
    real = got[0][got[0] < float(tgeometry.DIST_VALID_MAX)]
    assert real.numel() > 0
    if eps >= 0.3:
        assert (real == 0).float().mean() > 0.05     # overlaps score 0


def test_degenerate_rect_mindist_is_point_mindist():
    """A point query as a rect: rect MINDIST ≡ point MINDIST, bit for
    bit."""
    rng = np.random.default_rng(2)
    r = torch.from_numpy(uniform_rects(rng, 500, eps=0.05))
    p = torch.from_numpy(((rng.random((200, 2)) - 0.5) * 2 + 0.5)
                         .astype(np.float32))
    box = [r[None, :, j] for j in range(4)]
    px, py = p[:, 0, None], p[:, 1, None]
    got = tgeometry.mindist_rect(px, py, px, py, *box)
    want = tgeometry.mindist(px, py, *box)
    _assert_same(got, want, "degenerate")
    assert (got > 0).any() and (got == 0).any()


def test_numpy_oracles_equal_reference(inst):
    rects, _, _, q = inst
    r = rects[:500].astype(np.float64)
    qd = q.astype(np.float64)
    args = tuple(qd[:, j, None] for j in range(4)) + tuple(
        r[None, :, j] for j in range(4))
    for name in ("mindist_rect_np", "minmaxdist_rect_np"):
        np.testing.assert_array_equal(getattr(tgeometry, name)(*args),
                                      getattr(jgeometry, name)(*args))
    np.testing.assert_array_equal(
        tgeometry.mindist_rect_matrix_np(q, rects),
        jgeometry.mindist_rect_matrix_np(q, rects))
    np.testing.assert_array_equal(
        tgeometry.mindist_rect_matrix_np(q[0], rects),
        jgeometry.mindist_rect_matrix_np(q[0], rects))
    for k in (1, 8, 600):                        # 600 > 500 rects: padded
        for g, w in zip(tgeometry.brute_force_knn_join(q, rects[:500], k),
                        jgeometry.brute_force_knn_join(q, rects[:500], k)):
            np.testing.assert_array_equal(g, w)
    # the oracles agree with the float32 forms to rtol 1e-4
    qt, rt = torch.from_numpy(q), torch.from_numpy(rects[:500])
    qa = [qt[:, j, None] for j in range(4)]
    ra = [rt[None, :, j] for j in range(4)]
    np.testing.assert_allclose(
        tgeometry.mindist_rect(*qa, *ra).numpy(),
        tgeometry.mindist_rect_np(*args), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(
        tgeometry.minmaxdist_rect(*qa, *ra).numpy(),
        tgeometry.minmaxdist_rect_np(*args), rtol=1e-4, atol=1e-9)


@pytest.fixture(scope="module")
def inst13(inst):
    """3,000 small rects at fanout 13 (F no multiple of 4) in both
    packages, and the 64 query rects of ``inst``."""
    rects = uniform_rects(np.random.default_rng(13), 3000, eps=0.001)
    return (rects, jrtree.build_rtree(rects, fanout=13),
            trtree.build_rtree(rects, fanout=13, device="cpu"), inst[3])


def _seam_frontier(rng, n_nodes, frontier, b=16, c=24):
    """A (b, c) leaf frontier at a seam of the CUDA score kernel's slot
    walk: every slot -1 ("dead"), every slot live ("live"), one slot a row
    ("single"), else random with 20% of the slots -1."""
    ids = rng.integers(0, n_nodes, (b, 1 if frontier == "single" else c))
    if frontier == "dead":
        ids[:] = -1
    elif frontier == "fanout13":
        ids[rng.random(ids.shape) < 0.2] = -1
    return ids.astype(np.int32)


# (leaf, frontier): every level of a real descent, then the seams of the
# CUDA kernel at the leaf level: all slots dead, all live, C = 1, and a
# fanout-13 tree (its scalar-lane variant)
DISTS_CASES = [pytest.param(leaf, "descent", id=f"{leaf}")
               for leaf in (False, True)] + \
    [pytest.param(leaf, frontier, id=f"{frontier}-{leaf}")
     for frontier in ("dead", "live", "single", "fanout13")
     for leaf in (False, True)]


@pytest.mark.parametrize("leaf,frontier", DISTS_CASES)
def test_level_dists_twin_equals_pallas(request, leaf, frontier):
    """The B8 twin ≡ the Pallas kernel (interpret mode) on every level of
    a real descent, and on leaf frontiers at the CUDA kernel's seams."""
    _, jtree, ttree, q = request.getfixturevalue(
        "inst13" if frontier == "fanout13" else "inst")
    rng = np.random.default_rng(20 + leaf)
    if frontier == "descent":
        fronts = _real_frontiers(ttree, q[:16], 8, 32, rng)
    else:
        fronts = {0: _seam_frontier(rng, ttree.levels[0].n_nodes, frontier)}
    for li, ids in fronts.items():
        want = jkern.knn_join_level_dists(
            jnp.asarray(ids), jnp.asarray(q[:16]),
            *_level_args(jtree, li, False), leaf=leaf, interpret=True)
        got = ref.knn_join_level_dists_ref(
            torch.from_numpy(ids), torch.from_numpy(q[:16]),
            *_level_args(ttree, li, True), leaf=leaf)
        _assert_same(got[0], want[0], f"level {li} mindist")
        if not leaf:
            _assert_same(got[1], want[1], f"level {li} minmaxdist")
        valid = got[0] < float(tgeometry.DIST_VALID_MAX)
        assert bool(valid.any()) == (frontier != "dead")
        assert got[0].shape[2] == (13 if frontier == "fanout13" else 16)


def _fused_frontier(rng, n_nodes, frontier, b=64, c=8):
    """A (b, c) frontier at a seam of the CUDA emit body: every slot -1
    ("dead"), two live slots a row ("few"), every slot live ("live"), one
    slot a row ("single"), or one node in every slot of a row ("ties")."""
    ids = rng.integers(0, n_nodes, (b, 1 if frontier == "single" else c))
    if frontier == "dead":
        ids[:] = -1
    elif frontier == "few":
        drop = np.argsort(rng.random(ids.shape), axis=1)[:, 2:]
        np.put_along_axis(ids, drop, -1, axis=1)
    elif frontier == "ties":
        ids[:] = ids[:, :1]
    return ids.astype(np.int32)


# (k, frontier): every level of a real descent, then on every level the
# seams of the CUDA emit body: every slot dead, two live slots a row at
# k = 64 (fewer valid lanes than k, so τ = DIST_PAD), every slot live,
# C = 1, and one node in every slot of a row (MINDIST ties across lanes at
# an overflowing cap); the last two with τ_in = DIST_PAD
FUSED_CASES = [pytest.param(k, "descent", id=str(k)) for k in (1, 8, 64)] \
    + [pytest.param(k, frontier, id=f"{frontier}-{k}")
       for k, frontier in ((8, "dead"), (64, "few"), (8, "live"),
                           (8, "single"), (8, "ties"))]


@pytest.mark.parametrize("k,frontier", FUSED_CASES)
def test_fused_twins_equal_jitted_reference(inst, k, frontier):
    """B9 (tighten on and off, random τ_in, a cap that holds and one that
    overflows) and B10 (also C·F < k) ≡ the reference's jitted twins, on
    every level of a real descent and on frontiers at the CUDA emit
    body's seams."""
    _, jtree, ttree, q = inst
    rng = np.random.default_rng(k)
    if frontier == "descent":
        fronts = _real_frontiers(ttree, q, k, 64, rng)
    else:
        fronts = {li: _fused_frontier(rng, lvl.n_nodes, frontier)
                  for li, lvl in enumerate(ttree.levels)}
    for li, ids in fronts.items():
        c = ids.shape[1]
        jargs = [jnp.asarray(ids), jnp.asarray(q),
                 *_level_args(jtree, li, False)]
        targs = [torch.from_numpy(ids), torch.from_numpy(q),
                 *_level_args(ttree, li, True)]
        tau = (rng.random(64) * 0.01).astype(np.float32)
        if frontier in ("few", "ties"):
            tau[:] = np.float32(3.0e38)
        for tighten in ((False, True) if c * 16 >= k else (False,)):
            for cap in (4, 64):
                kw = dict(cap=cap, k=k, tighten=tighten)
                want = _jit_level_fused(*jargs, jnp.asarray(tau), **kw)
                got = ref.knn_join_level_fused_ref(
                    *targs, torch.from_numpy(tau), **kw)
                for g, w, name in zip(got, want, ("next", "tau", "valid",
                                                  "keep")):
                    _assert_same(g, w, f"level {li} {kw} {name}")
                if frontier == "few":
                    assert bool((got[1] == float(tgeometry.DIST_PAD)).all())
                if frontier == "ties" and li == 0 and not tighten:
                    assert bool((got[3] > cap).any())
        for kk in (k, c * 16 + 9):                    # C·F < kk: padded
            want = _jit_leaf_fused(*jargs, k=kk)
            got = ref.knn_join_leaf_fused_ref(*targs, k=kk)
            for g, w, name in zip(got, want, ("ids", "d", "valid")):
                _assert_same(g, w, f"level {li} leaf k={kk} {name}")
        assert int((got[0] < 0).sum()) >= 64 * 9
