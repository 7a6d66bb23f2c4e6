"""Port (repro_torch) ≡ reference (repro): the quantized D3 layout.

The quantization is held byte for byte against the reference's
``level_to_d3``; the D3-trace MINMAXDIST forms and the B13/B14 twins
against the reference's jitted ``knn_level_dists_d3_ref`` /
``knn_join_level_dists_d3_ref``; the B11/B12 twins and MINDIST against the
Pallas kernels run as the reference's own tests run them on the CPU
(``interpret=True``).  The D3 engines against the reference's jitted
``backend="xla"`` D3 engines, the fleet against its host path and serve
are in ``test_torch_d3_engines.py``, on this file's instance and
helpers.  Inputs are made with numpy from a seed and handed to both
packages.  Every comparison
is exact: codes, ids, counts, overflow, distance bits and every
``Counters`` field except ``dispatches``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jlayouts
from repro.core import rtree as jrtree
from repro.kernels import ref as jref
from repro.kernels import rtree_knn as jkern_knn
from repro.kernels import rtree_knn_join as jkern_kj
from repro.kernels import rtree_select as jkern_sel
from repro_torch.core import geometry as tgeometry
from repro_torch.core import knn_join_vector as tkj
from repro_torch.core import knn_vector as tknn
from repro_torch.core import layouts as tlayouts
from repro_torch.core import rtree as trtree
from repro_torch.core import select_vector as tselect
from repro_torch.core.counters import Counters
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rtree_knn as tkern_knn
from repro_torch.kernels import rtree_knn_join as tkern_kj
from repro_torch.kernels import rtree_select as tkern_sel
from repro_torch.launch import serve

from conftest import uniform_rects

ENGINE_FIELDS = tuple(f for f in Counters.__dataclass_fields__
                      if f != "dispatches")
D3_ROWS = ("qlo", "qhi", "scale", "bias", "ptr")           # select stages
D3_DIST_ROWS = ("qlo", "qhi", "scale", "bias", "slack", "ptr")
_jit_knn_d3 = jax.jit(jref.knn_level_dists_d3_ref)
_jit_kj_d3 = jax.jit(jref.knn_join_level_dists_d3_ref)


def _bits(a):
    """A float32 array's bits (int32), so DIST_PAD compares exactly; other
    dtypes as they are."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, ctx):
    assert _bits(got).dtype == _bits(want).dtype, ctx
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


def _qrects(rng, n, eps):
    c = rng.random((n, 2)).astype(np.float32)
    e = np.float32(eps)
    return np.concatenate([c - e, c + e], axis=1)


@pytest.fixture(scope="module")
def inst():
    """6,000 rects of half-extent 0.001, fanout 16 (height 4), in both
    packages, both trees' D3 levels, and a batch of 48 query rects."""
    rng = np.random.default_rng(15)
    rects = uniform_rects(rng, 6000, eps=0.001)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    assert ttree.height == 4
    jl = jlayouts.tree_layout(jtree, "d3")
    tl = tlayouts.tree_layout(ttree, "d3")
    return rects, jtree, ttree, jl, tl, rng


def _frontier(rng, n_nodes, b=4, c=16, pad=0.2):
    ids = rng.integers(0, n_nodes, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < pad] = -1
    return ids


def _rows(layer, names, torch_side):
    if torch_side:
        return [getattr(layer, f) for f in names]
    return [jnp.asarray(getattr(layer, f)) for f in names]


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,fanout,eps,scale,shift", [
    (3000, 16, 0.002, 1.0, 0.0),          # small rects in the unit square
    (5000, 64, 0.0, 1.0, 0.0),            # points, fanout 64
    (2000, 16, 0.3, 7.0, -3.5),           # wide rects, negative coordinates
    (1500, 64, 0.05, 1e4, -2e4),          # large negative coordinates
    (1000, 16, 0.0, 0.0, 0.25),           # degenerate: all points equal
    (700, 16, 0.0, 0.0, 0.0),             # zero extent at the origin
])
def test_d3_levels_byte_equal(n, fanout, eps, scale, shift):
    rng = np.random.default_rng(n + fanout)
    rects = (uniform_rects(rng, n, eps=eps) * np.float32(scale) +
             np.float32(shift)).astype(np.float32)
    jtree = jrtree.build_rtree(rects, fanout=fanout)
    ttree = trtree.build_rtree(rects, fanout=fanout, device="cpu")
    jl = jlayouts.tree_layout(jtree, "d3")
    tl = tlayouts.tree_layout(ttree, "d3")
    assert len(tl) == len(jl) == ttree.height
    for li, (a, b) in enumerate(zip(jl, tl)):
        for f in tlayouts.D3_FIELDS:
            want, got = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert got.dtype == want.dtype, (li, f)
            assert got.tobytes() == want.tobytes(), (li, f)
            # the CUDA wrappers take dense rows only
            assert getattr(b, f).is_contiguous(), (li, f)
        assert b.qlo.dtype == torch.uint16 and b.ptr is ttree.levels[li].child
    # conservative boxes: each dequantized box contains its true child box
    for lvl, b in zip(ttree.levels, tl):
        lx, ly, hx, hy = tlayouts.d3_dequantize(b.qlo, b.qhi, b.scale,
                                                b.bias)
        v = lvl.child >= 0
        assert bool((lx <= lvl.lx)[v].all() and (ly <= lvl.ly)[v].all()
                    and (hx >= lvl.hx)[v].all() and (hy >= lvl.hy)[v].all())
    assert tlayouts.layout_lanes("d3") == jlayouts.layout_lanes("d3") == 256


def test_level_d3_from_arrays_round_trips(inst):
    """The reference's D3 arrays through the carrier equal the port's own
    quantization, and read back byte for byte."""
    _, _, _, jl, tl, _ = inst
    for a, b in zip(jl, tl):
        arrays = {f: np.asarray(getattr(a, f)) for f in tlayouts.D3_FIELDS}
        c = tlayouts.level_d3_from_arrays(arrays, device="cpu")
        for f in tlayouts.D3_FIELDS:
            got = getattr(c, f)
            assert got.dtype == getattr(b, f).dtype, f
            assert torch.equal(got, getattr(b, f)), f
            assert got.numpy().tobytes() == arrays[f].tobytes(), f


def test_slacked_upper_rounds_its_square_root_once():
    """The slack correction's square root is the correctly rounded one:
    ``d3_slacked_upper`` equals the same formula on float64 (exact for these
    inputs), rounded step by step to float32."""
    rng = np.random.default_rng(2)
    m = (rng.random(200_000) * 1e-3).astype(np.float32)
    disp = (rng.random(200_000) * 1e-5).astype(np.float32)
    got = tlayouts.d3_slacked_upper(torch.from_numpy(m),
                                    torch.from_numpy(disp)).numpy()
    root = np.sqrt(m.astype(np.float64)).astype(np.float32)
    up = root + disp
    want = up * up * np.float32(1 + 2 ** -16)
    _assert_same(got, want, "slacked upper")


def test_nearest_root_settles_a_root_one_ulp_off():
    """``nearest_root`` returns the correctly rounded root from estimates
    one float32 ULP above or below it (as a library sqrt that misses in its
    last bits gives them), on the inputs of the test above, at zero and on
    both sides of powers of two."""
    rng = np.random.default_rng(3)
    m = np.concatenate([(rng.random(200_000) * 1e-3).astype(np.float32),
                        np.float32([0.0, 1.0, 4.0, 2.0 ** -20, 3e38])])
    m = np.concatenate([m, np.nextafter(m[-4:], np.float32(0)),
                        np.nextafter(m[-4:], np.float32(np.inf))])
    want = np.sqrt(m.astype(np.float64)).astype(np.float32)
    step = rng.integers(-1, 2, m.shape)
    est = np.where(step > 0, np.nextafter(want, np.float32(np.inf)),
                   np.where(step < 0, np.nextafter(want, np.float32(0)),
                            want))
    assert (est != want).sum() > 100_000
    got = tlayouts.nearest_root(torch.from_numpy(m), torch.from_numpy(est))
    _assert_same(got.numpy(), want, "nearest root")


# ---------------------------------------------------------------------------
# the D3-trace distance forms and the B13 / B14 twins
# ---------------------------------------------------------------------------

def _gather_args(rng, layer, b=64, c=40):
    ids = _frontier(rng, layer.qlo.shape[0], b=b, c=c, pad=0.1)
    return ids, [getattr(layer, f) for f in D3_DIST_ROWS]


@pytest.mark.parametrize("eps", [None, 0.0, 0.002, 0.05])
def test_d3_distance_forms_equal_jitted_reference(inst, eps):
    """On gather-shaped inputs (B, C, F): the D3 twin (B13 for points, B14
    for rects of half-extent ``eps``) ≡ the reference's jitted D3 twin, bit
    for bit, on every internal level.  The same boxes through the D1 forms
    give other slacked bounds on some lanes, so the test can fail."""
    _, _, _, _, tl, _ = inst
    rng = np.random.default_rng(7 if eps is None else int(eps * 1e4) + 8)
    d1_differs = 0
    for li in range(1, len(tl)):
        ids, rows = _gather_args(rng, tl[li])
        if eps is None:
            q = rng.random((64, 2)).astype(np.float32)
            want = _jit_knn_d3(ids, q, *(jnp.asarray(r.numpy())
                                         for r in rows))
            got = ref.knn_level_dists_d3_ref(torch.from_numpy(ids),
                                             torch.from_numpy(q), *rows)
        else:
            q = _qrects(rng, 64, eps)
            want = _jit_kj_d3(ids, q, *(jnp.asarray(r.numpy())
                                        for r in rows))
            got = ref.knn_join_level_dists_d3_ref(torch.from_numpy(ids),
                                                  torch.from_numpy(q), *rows)
        _assert_same(got[0], want[0], f"level {li} mindist")
        _assert_same(got[1], want[1], f"level {li} minmaxdist")
        # the D1 forms on the same dequantized boxes
        t_ids = torch.from_numpy(ids)
        boxes = ref._d3_gather_boxes(t_ids, *rows[:4])
        qt = torch.from_numpy(q)
        if eps is None:
            m1 = tgeometry.minmaxdist(qt[:, 0, None, None],
                                      qt[:, 1, None, None], *boxes)
        else:
            m1 = tgeometry.minmaxdist_rect(
                *(qt[:, j, None, None] for j in range(4)), *boxes)
        _, u1 = ref._d3_dists(t_ids, rows[4], rows[5], got[0], m1)
        d1_differs += int((_bits(u1) != _bits(want[1])).sum())
        assert (got[1] < float(tgeometry.DIST_VALID_MAX)).any()
    assert d1_differs > 0


@pytest.mark.parametrize("op", ["knn", "knn_join"])
def test_d3_dists_mindist_equals_pallas(inst, op):
    """MINDIST of the B13 / B14 twins ≡ the Pallas kernels (interpret
    mode) on every internal level; the bound ≡ the jitted twin."""
    _, _, _, jl, tl, _ = inst
    rng = np.random.default_rng(31 if op == "knn" else 32)
    for li in range(1, len(tl)):
        ids = _frontier(rng, tl[li].qlo.shape[0])
        if op == "knn":
            q = rng.random((4, 2)).astype(np.float32)
            pallas, twin, jit = (jkern_knn.knn_level_dists_d3,
                                 ref.knn_level_dists_d3_ref, _jit_knn_d3)
        else:
            q = _qrects(rng, 4, 0.01)
            pallas, twin, jit = (jkern_kj.knn_join_level_dists_d3,
                                 ref.knn_join_level_dists_d3_ref, _jit_kj_d3)
        jrows = _rows(jl[li], D3_DIST_ROWS, False)
        want = pallas(jnp.asarray(ids), jnp.asarray(q), *jrows,
                      interpret=True)
        got = twin(torch.from_numpy(ids), torch.from_numpy(q),
                   *_rows(tl[li], D3_DIST_ROWS, True))
        _assert_same(got[0], want[0], f"{op} level {li} mindist")
        _assert_same(got[1], jit(ids, q, *jrows)[1], f"{op} level {li} mmd")


# ---------------------------------------------------------------------------
# the B11 / B12 twins ≡ the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inst13():
    """3,000 rects at fanout 13 (F no multiple of 4) and both trees' D3
    levels."""
    rects = uniform_rects(np.random.default_rng(13), 3000, eps=0.001)
    return (jlayouts.tree_layout(jrtree.build_rtree(rects, fanout=13), "d3"),
            tlayouts.tree_layout(trtree.build_rtree(rects, fanout=13,
                                                    device="cpu"), "d3"))


# (li, frontier): random frontiers on three levels, then the seams of the
# CUDA kernel on level 1: every slot dead, every slot live, C = 1, and a
# fanout-13 tree (its scalar-lane variant)
MASKS_D3_CASES = [pytest.param(li, "random", id=str(li)) for li in (1, 2, 3)] \
    + [pytest.param(1, frontier, id=f"{frontier}-1")
       for frontier in ("dead", "live", "single", "fanout13")]


@pytest.mark.parametrize("li,frontier", MASKS_D3_CASES)
def test_select_masks_d3_twin_equals_pallas(request, li, frontier):
    if frontier == "fanout13":
        jl, tl = request.getfixturevalue("inst13")
    else:
        _, _, _, jl, tl, _ = request.getfixturevalue("inst")
    rng = np.random.default_rng(40 + li)
    n = tl[li].qlo.shape[0]
    ids = _frontier(rng, n, c=1 if frontier == "single" else min(16, n),
                    pad=0.0 if frontier in ("live", "single") else 0.2)
    if frontier == "dead":
        ids[:] = -1
    q = _qrects(rng, 4, 0.05)
    want = jkern_sel.select_level_masks_d3(
        jnp.asarray(ids), jnp.asarray(q), *_rows(jl[li], D3_ROWS, False),
        interpret=True)
    got = ref.select_level_masks_d3_ref(torch.from_numpy(ids),
                                        torch.from_numpy(q),
                                        *_rows(tl[li], D3_ROWS, True))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[2] == (13 if frontier == "fanout13" else 16)
    if frontier == "random":
        assert got.any()
    if frontier == "dead":
        assert not got.any()


def _seam_frontier(rng, n_nodes, c=20):
    """(4, c) frontier rows at the seams of the chunked CUDA kernels (and
    wider than one Pallas grid step): all -1, only the last slot live, live
    slots a prefix, and live slots interleaved with -1."""
    ids = rng.integers(0, n_nodes, (4, c)).astype(np.int32)
    ids[0] = -1
    ids[1, :-1] = -1
    ids[2, c // 2 + 1:] = -1
    ids[3, 1::2] = -1
    return ids


# (li, cap, frontier): random frontiers (16 forces overflow), then the
# seam rows at cap 1, a cap inside a row's qualifying run, and one that
# holds every row
FUSED_D3_CASES = [pytest.param(li, cap, "random", id=f"{li}-{cap}")
                  for li in (1, 2) for cap in (512, 16)] + \
    [pytest.param(li, cap, "seams", id=f"{li}-{cap}-seams")
     for li in (1, 2) for cap in (1, 5, 512)]


@pytest.mark.parametrize("li,cap,frontier", FUSED_D3_CASES)
def test_select_fused_d3_twin_equals_pallas(inst, li, cap, frontier):
    _, _, _, jl, tl, _ = inst
    rng = np.random.default_rng(50 + li)
    if frontier == "seams":
        ids = _seam_frontier(rng, tl[li].qlo.shape[0])
    else:
        ids = _frontier(rng, tl[li].qlo.shape[0],
                        c=min(16, tl[li].qlo.shape[0]))
    q = _qrects(rng, 4, 0.3 if cap == 16 or frontier == "seams" else 0.03)
    want = jkern_sel.select_level_fused_d3(
        jnp.asarray(ids), jnp.asarray(q), *_rows(jl[li], D3_ROWS, False),
        cap=cap, interpret=True)
    got = ref.select_level_fused_d3_ref(torch.from_numpy(ids),
                                        torch.from_numpy(q),
                                        *_rows(tl[li], D3_ROWS, True),
                                        cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cap == 16 and li == 1:
        assert got[2].any()                # the overflow case fired
    if frontier == "seams":
        assert int(got[1][0]) == 0         # the all -1 row
        assert bool(got[2].any()) == (cap < 512)    # cap 1, 5 overflow


def test_cuda_backend_on_cpu_tensors_raises_for_d3(inst):
    """All four D3 stages, through ``ops`` and through the wrappers, raise
    on CPU tensors when the kernels are asked for; 'auto' takes the twins
    and launches nothing."""
    _, _, ttree, _, tl, _ = inst
    lvl3 = tl[1]
    ids = torch.zeros((4, 2), dtype=torch.int32)
    q4 = torch.from_numpy(_qrects(np.random.default_rng(3), 4, 0.01))
    p2 = q4[:, :2].contiguous()
    sel = (ids, q4, *_rows(lvl3, D3_ROWS, True))
    knn = (ids, p2, *_rows(lvl3, D3_DIST_ROWS, True))
    kj = (ids, q4, *_rows(lvl3, D3_DIST_ROWS, True))
    for fn, args, kw in ((ops.select_level_masks_d3, sel, {}),
                         (ops.select_level_fused_d3, sel, dict(cap=64)),
                         (ops.knn_level_dists_d3, knn, {}),
                         (ops.knn_join_level_dists_d3, kj, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args, backend="cuda", **kw)
    for fn, args, kw in ((tkern_sel.select_level_masks_d3_cuda, sel, {}),
                         (tkern_sel.select_level_fused_d3_cuda, sel,
                          dict(cap=64)),
                         (tkern_knn.knn_level_dists_d3_cuda, knn, {}),
                         (tkern_kj.knn_join_level_dists_d3_cuda, kj, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args, **kw)
    for build in (tselect.make_select_bfs,
                  lambda t, **kw: tknn.make_knn_bfs(t, 8, **kw),
                  lambda t, **kw: tkj.make_knn_join_bfs(t, 8, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(ttree, layout="d3", backend="cuda")
    before = (tkern_sel.launch_counts(), tkern_knn.launch_counts(),
              tkern_kj.launch_counts())
    assert ops.select_level_masks_d3(*sel).shape == (4, 2, 16)
    assert ops.knn_level_dists_d3(*knn)[1].shape == (4, 2, 16)
    assert ops.knn_join_level_dists_d3(*kj)[0].shape == (4, 2, 16)
    assert (tkern_sel.launch_counts(), tkern_knn.launch_counts(),
            tkern_kj.launch_counts()) == before
