"""Port (repro_torch) ≡ reference (repro): the quantized D3 layout.

The quantization is held byte for byte against the reference's
``level_to_d3``; the D3-trace MINMAXDIST forms and the B13/B14 twins
against the reference's jitted ``knn_level_dists_d3_ref`` /
``knn_join_level_dists_d3_ref``; the B11/B12 twins and MINDIST against the
Pallas kernels run as the reference's own tests run them on the CPU
(``interpret=True``); the D3 engines against the reference's jitted
``backend="xla"`` D3 engines; the fleet against its host path.  Inputs are
made with numpy from a seed and handed to both packages.  Every comparison
is exact: codes, ids, counts, overflow, distance bits and every
``Counters`` field except ``dispatches``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_join_vector as jkj
from repro.core import knn_vector as jknn
from repro.core import layouts as jlayouts
from repro.core import rtree as jrtree
from repro.core import select_vector as jselect
from repro.distributed.spatial_shard import SpatialShards as JShards
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
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
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


# ---------------------------------------------------------------------------
# the engines ≡ the reference's jitted xla D3 engines, and ≡ the port's D1
# ---------------------------------------------------------------------------

def _assert_counters_equal(jc, tc, ctx):
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)),
                                      err_msg=f"{ctx}: {f}")


def _select_queries(rng):
    small = _qrects(rng, 12, 0.02)
    big = _qrects(rng, 4, 0.15)
    return np.concatenate([small, big])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("result_cap", [2048, 64])   # 64 forces overflow
def test_select_d3_engine_equals_reference(inst, caps_mode, fused,
                                           result_cap):
    _, jtree, ttree, _, _, _ = inst
    q = _select_queries(np.random.default_rng(60))
    kw = dict(layout="d3", result_cap=result_cap, caps_mode=caps_mode,
              fused=fused)
    ji, jc, jctr = jselect.make_select_bfs(jtree, backend="xla", **kw)(
        jnp.asarray(q))
    ti, tc, tctr = tselect.make_select_bfs(ttree, **kw)(q)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_counters_equal(jctr, tctr, f"select {kw}")
    assert int(tctr.overflow) == int(result_cap == 64)
    # D3 results ≡ the port's D1 results (counters differ)
    di, dc, dctr = tselect.make_select_bfs(
        ttree, **dict(kw, layout="d1"))(q)
    assert torch.equal(ti, di) and torch.equal(tc, dc)
    assert int(dctr.overflow) == int(tctr.overflow)


def test_select_d3_escalation_equals_reference(inst):
    """Wide queries overflow the adaptive tier (their results pass the
    result cap) and escalate once; the result equals the static engine's
    and the reference's."""
    _, jtree, ttree, _, _, _ = inst
    q = _qrects(np.random.default_rng(61), 8, 0.45)
    kw = dict(layout="d3", result_cap=4096, caps_mode="adaptive")
    jrun = jselect.make_select_bfs(jtree, backend="xla", **kw)
    trun = tselect.make_select_bfs(ttree, **kw)
    ji, jc, jctr = jrun(jnp.asarray(q))
    ti, tc, tctr = trun(q)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_counters_equal(jctr, tctr, "select escalation")
    assert int(tctr.escalations) == 1 and trun.escalation_count() == 1
    si, sc, sctr = tselect.make_select_bfs(
        ttree, **dict(kw, caps_mode="static"))(q)
    assert torch.equal(ti, si) and torch.equal(tc, sc)
    assert int(tctr.overflow) == int(sctr.overflow) == 1


def _distance_both(op, jtree, ttree, q, k, **kw):
    jmod, tmod, build = (
        (jknn, tknn, "make_knn_bfs") if op == "knn"
        else (jkj, tkj, "make_knn_join_bfs"))
    jout = getattr(jmod, build)(jtree, k, backend="xla", **kw)(
        jnp.asarray(q))
    tout = getattr(tmod, build)(ttree, k, **kw)(q)
    return jout, tout


@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("op", ["knn", "knn_join"])
def test_distance_d3_engine_equals_reference(inst, op, k, caps_mode):
    _, jtree, ttree, _, _, _ = inst
    rng = np.random.default_rng(70 + k)
    q = rng.random((48, 2)).astype(np.float32) if op == "knn" else \
        _qrects(rng, 48, 0.004)
    kw = dict(layout="d3", caps_mode=caps_mode)
    (ji, jd, jctr), (ti, td, tctr) = _distance_both(op, jtree, ttree, q, k,
                                                    **kw)
    ctx = f"{op} k={k} {caps_mode}"
    _assert_same(ti, np.asarray(ji), f"{ctx} ids")
    _assert_same(td, np.asarray(jd), f"{ctx} dists")
    _assert_counters_equal(jctr, tctr, ctx)
    assert int(tctr.overflow) == 0
    # D3 results ≡ the port's D1 results (counters differ)
    build = tknn.make_knn_bfs if op == "knn" else tkj.make_knn_join_bfs
    di, dd, _ = build(ttree, k, caps_mode=caps_mode)(q)
    _assert_same(ti, di, f"{ctx} ids vs d1")
    _assert_same(td, dd, f"{ctx} dists vs d1")


@pytest.mark.parametrize("op", ["knn", "knn_join"])
def test_distance_d3_beam_overflow_and_escalation_equal_reference(inst, op):
    """Tiny static caps overflow the beam; on a tree with 500 copies of one
    point, k = 1 queries at that point keep every leaf that holds a copy,
    which overflows the adaptive tier, so the batch escalates once.  Both
    ≡ the reference."""
    _, jtree, ttree, _, _, _ = inst
    rng = np.random.default_rng(80)
    q = rng.random((32, 2)).astype(np.float32) if op == "knn" else \
        _qrects(rng, 32, 0.004)
    (ji, jd, jctr), (ti, td, tctr) = _distance_both(
        op, jtree, ttree, q, 8, layout="d3", caps=(4, 4, 4))
    _assert_same(ti, np.asarray(ji), "beam ids")
    _assert_same(td, np.asarray(jd), "beam dists")
    _assert_counters_equal(jctr, tctr, f"{op} beam overflow")
    assert int(tctr.overflow) == 1
    rng = np.random.default_rng(16)
    dup = np.full((500, 4), 0.5, np.float32)
    rects = np.concatenate([uniform_rects(rng, 4000, eps=0.001), dup])
    jdup = jrtree.build_rtree(rects, fanout=16)
    tdup = trtree.build_rtree(rects, fanout=16, device="cpu")
    p = np.concatenate([rng.random((24, 2)),
                        [[0.5, 0.5], [0.5001, 0.4999]]]).astype(np.float32)
    q2 = p if op == "knn" else np.concatenate([p - np.float32(0.001),
                                               p + np.float32(0.001)], 1)
    (ji, jd, jctr), (ti, td, tctr) = _distance_both(
        op, jdup, tdup, q2, 1, layout="d3", caps_mode="adaptive")
    _assert_same(ti, np.asarray(ji), "escalation ids")
    _assert_same(td, np.asarray(jd), "escalation dists")
    _assert_counters_equal(jctr, tctr, f"{op} escalation")
    assert int(tctr.escalations) == 1 and int(tctr.overflow) == 0


@pytest.mark.parametrize("op", ["knn", "knn_join"])
def test_fused_d3_raises_value_error(inst, op):
    _, _, ttree, _, _, _ = inst
    build = tknn.make_knn_bfs if op == "knn" else tkj.make_knn_join_bfs
    with pytest.raises(ValueError, match="layout d1"):
        build(ttree, 8, layout="d3", fused=True)


# ---------------------------------------------------------------------------
# the fleet and the serve entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["select", "knn", "knn_join"])
def test_fleet_d3_equals_reference_host_path(op):
    rng = np.random.default_rng(90)
    rects = uniform_rects(rng, 5000, eps=0.001)
    jshards = JShards.build(rects, 4, fanout=16, layout="d3")
    tshards = TShards.build(rects, 4, fanout=16, layout="d3", device="cpu")
    assert tshards.layout == "d3"
    if op == "select":
        q = _qrects(rng, 24, 0.03)
        want, got = jshards.range_select(q), tshards.range_select(q)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    q = rng.random((24, 2)).astype(np.float32) if op == "knn" else \
        _qrects(rng, 24, 0.01)
    fn = "knn" if op == "knn" else "knn_join"
    want = getattr(jshards, fn)(q, 8)
    got = getattr(tshards, fn)(q, 8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is want[2] is False


@pytest.mark.parametrize("mode", ["spatial", "knn", "knn-join"])
def test_serve_d3_dryrun_cpu_equals_d1(mode):
    argv = ["--mode", mode, "--dryrun", "--device", "cpu"]
    d3 = serve.main(argv + ["--layout", "d3"])
    d1 = serve.main(argv)
    assert d3["qps"] > 0
    if mode == "spatial":
        for a, b in zip(d3["first_batch"], d1["first_batch"]):
            np.testing.assert_array_equal(a, b)
    else:
        assert not d3["overflow"]
        for a, b in zip(d3["first_batch"], d1["first_batch"]):
            np.testing.assert_array_equal(a, b)


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
