"""Port (repro_torch) ≡ reference (repro): filtered kNN.

The port's filtered kNN runs PyTorch ops, as the reference's runs jnp with
no kernel.  Its score stage is held against the reference's jitted score
stage on gather-shaped inputs, and its engine against the reference's
jitted ``make_knn_filtered_bfs`` in every cell of D1/D3 × static/adaptive
× k in {1, 8, 64} under windows of half-extent 0.2 and 0.05; the fleet
against the reference's host path; the serve entry point against the
reference's fleet on the same requests.  Inputs are made with numpy from a
seed and handed to both packages.  Every comparison is exact: ids,
distance bits, overflow and every ``Counters`` field except
``dispatches``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caps as jcaps
from repro.core import knn_filtered as jkf
from repro.core import rtree as jrtree
from repro.core import traversal as jtraversal
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro_torch.core import caps as tcaps
from repro_torch.core import geometry as tgeometry
from repro_torch.core import knn_filtered as tkf
from repro_torch.core import knn_vector as tknn
from repro_torch.core import rtree as trtree
from repro_torch.core import traversal as ttraversal
from repro_torch.core.counters import Counters
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch import serve

from conftest import uniform_rects

ENGINE_FIELDS = tuple(f for f in Counters.__dataclass_fields__
                      if f != "dispatches")


def _bits(a):
    """A float32 array's bits (int32), so +inf and DIST_PAD compare
    exactly; other dtypes as they are."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, ctx):
    assert _bits(got).dtype == _bits(want).dtype, ctx
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


def _windowed(pts, eps):
    """Query rows (px, py, wlx, wly, whx, why): each point with its window
    of half-extent ``eps``, as the serve runner draws them."""
    e = np.float32(eps)
    return np.concatenate([pts, pts - e, pts + e], axis=1)


@pytest.fixture(scope="module")
def inst():
    """6,000 small rects, fanout 16 (height 4), in both packages, and 64
    query points."""
    rng = np.random.default_rng(21)
    rects = uniform_rects(rng, 6000, eps=0.001)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    assert ttree.height == 4
    pts = rng.random((64, 2)).astype(np.float32)
    return rects, jtree, ttree, pts


def _assert_engine_equal(jout, tout, ctx):
    (ji, jd, jc), (ti, td, tc) = jout, tout
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    _assert_same(ti, ji, f"{ctx} ids")
    _assert_same(td, jd, f"{ctx} dists")
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tc, f)), np.asarray(getattr(jc, f)),
            err_msg=f"{ctx}: {f}")


def _brute_force_filtered(rects, qs, k):
    """Numpy oracle: the k nearest rects intersecting each row's window →
    (ids (B, k), float64 squared distances (B, k)), (-1, inf) padded."""
    d = tgeometry.mindist_matrix_np(qs[:, :2], rects)
    hit = tgeometry.intersects(qs[:, 2, None], qs[:, 3, None],
                               qs[:, 4, None], qs[:, 5, None],
                               rects[None, :, 0], rects[None, :, 1],
                               rects[None, :, 2], rects[None, :, 3])
    ids, dd = tgeometry._k_smallest(np.where(hit, d, np.inf), k)
    return np.where(np.isfinite(dd), ids, -1), dd


# ---------------------------------------------------------------------------
# the score stage and the caps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_filtered_score_equals_jitted_reference(inst, layout, monkeypatch):
    """Gather-shaped inputs (B, C, F) with real ±0.2 windows: the port's
    score stage ≡ the reference's jitted one on every level, MINDIST and
    MINMAXDIST bit for bit.  The other layout's MINMAXDIST form differs on
    some lanes, so each layout's form is pinned by this test."""
    _, jtree, ttree, _ = inst
    rng = np.random.default_rng(8 if layout == "d1" else 9)
    jctx, jscore = jkf.make_knn_filtered_score(jtree, layout, None)
    tctx, tscore = tkf.make_knn_filtered_score(ttree, layout, "torch")
    other = tgeometry.minmaxdist_d3 if layout == "d1" else \
        tgeometry.minmaxdist
    other_differs = 0
    for li in range(jtree.height):
        leaf = li == 0
        ids = rng.integers(0, jtree.levels[li].n_nodes, (64, 40)).astype(
            np.int32)
        ids[rng.random((64, 40)) < 0.1] = -1
        qs = _windowed(rng.random((64, 2)).astype(np.float32), 0.2)
        want = jax.jit(lambda i, q: jscore(jctx, li, i, q, leaf)[:3])(
            jnp.asarray(ids), jnp.asarray(qs))
        md, mmd, ptr, _ = tscore(tctx, li, torch.from_numpy(ids),
                                 torch.from_numpy(qs), leaf)
        _assert_same(md, want[0], f"level {li} mindist")
        _assert_same(ptr, want[2], f"level {li} child ids")
        if leaf:
            assert mmd is None and want[1] is None
            continue
        _assert_same(mmd, want[1], f"level {li} minmaxdist")
        live = mmd < float(tgeometry.DIST_VALID_MAX)
        with monkeypatch.context() as m:
            m.setattr(tkf, "minmaxdist", other)
            m.setattr(tkf, "minmaxdist_d3", other)
            _, alt, _, _ = tscore(tctx, li, torch.from_numpy(ids),
                                  torch.from_numpy(qs), leaf)
        other_differs += int((_bits(alt) != _bits(mmd))[live].sum())
    assert other_differs > 0


@pytest.mark.parametrize("k", [1, 8, 64])
def test_filtered_caps_equal_reference(inst, k):
    _, jtree, ttree, _ = inst
    for lanes in (128, 256):
        for policy in ("static", "adaptive"):
            assert tkf.filtered_caps(ttree, k, lanes=lanes, policy=policy) \
                == jkf.filtered_caps(jtree, k, lanes=lanes, policy=policy)
        assert tcaps.browse_caps(ttree, k, lanes=lanes) == \
            jcaps.browse_caps(jtree, k, lanes=lanes)
    assert tkf.filtered_caps(ttree, k) == jkf.filtered_caps(jtree, k)


# ---------------------------------------------------------------------------
# the engine ≡ the reference's jitted engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_make_knn_filtered_bfs_equals_reference(inst, layout, k, caps_mode):
    rects, jtree, ttree, pts = inst
    jrun = jkf.make_knn_filtered_bfs(jtree, k, layout=layout,
                                     caps_mode=caps_mode)
    trun = tkf.make_knn_filtered_bfs(ttree, k, layout=layout,
                                     caps_mode=caps_mode)
    for eps in (0.2, 0.05):
        qs = _windowed(pts, eps)
        tout = trun(qs)
        _assert_engine_equal(jrun(jnp.asarray(qs)), tout,
                             f"{layout} k={k} {caps_mode} ±{eps}")
        ti, td, tc = tout
        assert int(tc.overflow) == 0
        if caps_mode == "static":
            tc.validate_dispatches(tkf.KNN_FILTERED_SPEC.stage_model,
                                   ttree.height)
        want_i, want_d = _brute_force_filtered(rects, qs[:8], k)
        found = want_i >= 0
        assert ((ti.numpy()[:8] >= 0) == found).all()
        np.testing.assert_allclose(td.numpy()[:8][found], want_d[found],
                                   rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_filtered_escalation_equals_reference(inst, layout):
    """A tight tier of one slot a level overflows on every batch: both
    packages escalate to the full tier and pin themselves to it after
    three batches in a row."""
    _, jtree, ttree, pts = inst
    qs = _windowed(pts, 0.2)
    full = tkf.filtered_caps(ttree, 8, lanes=128 if layout == "d1" else 256)
    jesc = jtraversal.maybe_escalating(
        lambda c: jkf.make_knn_filtered_bfs(jtree, 8, layout=layout, caps=c),
        (1, 1, 1), full)
    tesc = ttraversal.maybe_escalating(
        lambda c: tkf.make_knn_filtered_bfs(ttree, 8, layout=layout,
                                            caps=c), (1, 1, 1), full)
    for batch in range(4):
        tout = tesc(qs)
        _assert_engine_equal(jesc(jnp.asarray(qs)), tout, f"batch {batch}")
        assert int(tout[2].escalations) == 1
        assert tesc.escalation_count() == jesc.escalation_count() == \
            batch + 1
        assert tesc.stuck() == jesc.stuck() == (batch >= 2)


@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_full_window_equals_plain_knn(inst, layout):
    """A window holding every rect passes every mask: with kNN's caps the
    filtered engine ≡ the port's plain kNN, ids, distance bits and every
    counter but ``dispatches``."""
    _, _, ttree, pts = inst
    qs = np.concatenate([pts, np.full((64, 2), -1, np.float32),
                         np.full((64, 2), 2, np.float32)], axis=1)
    caps = tknn.knn_frontier_caps(ttree, 8,
                                  lanes=128 if layout == "d1" else 256)
    want = tknn.make_knn_bfs(ttree, 8, layout=layout, caps=caps)(pts)
    got = tkf.make_knn_filtered_bfs(ttree, 8, layout=layout, caps=caps)(qs)
    _assert_engine_equal(want, got, f"{layout} full window")


@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_empty_window_returns_nothing(inst, layout):
    _, jtree, ttree, pts = inst
    qs = np.concatenate([pts[:8], np.full((8, 2), 5, np.float32),
                         np.full((8, 2), 5.5, np.float32)], axis=1)
    tout = tkf.make_knn_filtered_bfs(ttree, 8, layout=layout)(qs)
    _assert_engine_equal(
        jkf.make_knn_filtered_bfs(jtree, 8, layout=layout)(jnp.asarray(qs)),
        tout, f"{layout} empty window")
    assert bool((tout[0] == -1).all()) and bool(torch.isinf(tout[1]).all())


def test_kernel_backend_and_fused_raise(inst):
    """The window masks have no kernel, as in the reference: 'cuda' and
    fused builds raise ValueError; 'torch' ≡ 'auto' on the CPU."""
    _, _, ttree, pts = inst
    with pytest.raises(ValueError, match="no kernel backend"):
        tkf.make_knn_filtered_bfs(ttree, 4, backend="cuda")
    with pytest.raises(ValueError, match="no fused generation"):
        tkf.make_knn_filtered_bfs(ttree, 4, fused=True)
    with pytest.raises(ValueError, match="k must be positive"):
        tkf.make_knn_filtered_bfs(ttree, 0)
    with pytest.raises(ValueError, match="no kernel backend"):
        tkf.make_knn_filtered_bfs(ttree, 4, layout="d0", backend="cuda")
    qs = _windowed(pts, 0.2)
    a = tkf.make_knn_filtered_bfs(ttree, 8, backend="torch")(qs)
    b = ttraversal.build("knn_filtered", ttree, k=8)(qs)
    _assert_engine_equal(b, a, "torch vs auto")
    spec = ttraversal.get_spec("knn_filtered")
    assert spec.kind == "distance" and spec.query_width == 6
    assert spec.stage_model.inner == 5 and spec.stage_model.leaf == 4


# ---------------------------------------------------------------------------
# the fleet and the serve entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_fleet_knn_filtered_equals_reference_host_path(layout):
    rng = np.random.default_rng(33)
    rects = uniform_rects(rng, 5000, eps=0.001)
    qs = _windowed(rng.random((40, 2)).astype(np.float32), 0.2)
    jshards = JShards.build(rects, 2, fanout=16, layout=layout)
    tshards = TShards.build(rects, 2, fanout=16, layout=layout,
                            device="cpu")
    want = jshards.knn_filtered(qs, 8)
    got = tshards.knn_filtered(qs, 8)
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is want[2] is False
    for f in ENGINE_FIELDS + ("dispatches",):
        np.testing.assert_array_equal(
            np.asarray(getattr(tshards.last_counters, f)),
            np.asarray(getattr(jshards.last_counters, f)), err_msg=f)
    n_engines = len(tshards._engines)
    tshards.warm("knn_filtered", 40, k=8)
    assert len(tshards._engines) == n_engines


@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_serve_knn_filtered_dryrun_cpu_equals_reference(layout):
    """The served dryrun ≡ the reference's fleet on the same requests (its
    serve runner draws them so and prints only counts), and D3 ≡ D1."""
    out = serve.main(["--mode", "knn-filtered", "--layout", layout,
                      "--dryrun", "--device", "cpu"])
    assert out["qps"] > 0 and not out["overflow"]
    rects, qs = serve.make_knn_filtered_inputs(2000, 0, 2, 8, 0.2)
    jshards = JShards.build(rects, 2, fanout=16, layout=layout)
    want = [jshards.knn_filtered(q, 4) for q in qs]
    assert out["neighbors"] == sum(int((w[0] >= 0).sum()) for w in want)
    ids, d = out["first_batch"]
    np.testing.assert_array_equal(ids, want[0][0])
    np.testing.assert_array_equal(d, want[0][1])
    assert bool((ids >= 0).all())
