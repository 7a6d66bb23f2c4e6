"""Port (repro_torch) ≡ reference (repro): the kNN-join slice's engines,
on ``test_torch_knn_join.py``'s instance and helpers.

The kNN-join engine (caps, fused or not, beam overflow, escalation, k
above the rect count, distance-0 ties, the τ hooks) and the all-pairs
``knn_join`` against the reference's jitted ``backend="xla"`` path; the
fleet against its host path; serve; the CUDA backend on CPU tensors
raises.  The port pins the reference's FMA roundings, so every
comparison is exact: ids, distance bits, overflow and every ``Counters``
field except ``dispatches``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_join_vector as jkj
from repro.core import rtree as jrtree
from repro.core import traversal as jtraversal
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro_torch.core import geometry as tgeometry
from repro_torch.core import knn_join_vector as tkj
from repro_torch.core import rtree as trtree
from repro_torch.core import traversal as ttraversal
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.kernels import ops
from repro_torch.kernels import rtree_knn_join as tkern
from repro_torch.launch import serve

from conftest import uniform_rects
from test_torch_knn_join import (ENGINE_FIELDS, _assert_same,  # noqa: F401
                                 _bits, _level_args, _qrects,
                                 _with_far_rects, inst)


# ---------------------------------------------------------------------------
# the kNN-join engine ≡ the reference's jitted xla path
# ---------------------------------------------------------------------------

def _join_both(jtree, ttree, q, k, **kw):
    jout = jkj.make_knn_join_bfs(jtree, k, backend="xla", **kw)(
        jnp.asarray(q))
    tfn = tkj.make_knn_join_bfs(ttree, k, **kw)
    return jout, tfn(q), tfn


def _assert_counters_equal(jc, tc, ctx):
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tc, f)), np.asarray(getattr(jc, f)),
            err_msg=f"{ctx}: {f}")


def _assert_join_equal(jout, tout, ctx):
    (ji, jd, jc), (ti, td, tc) = jout, tout
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    _assert_same(ti, ji, f"{ctx} ids")
    _assert_same(td, jd, f"{ctx} dists")
    _assert_counters_equal(jc, tc, ctx)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_make_knn_join_bfs_equals_reference(inst, k, caps_mode, fused):
    rects, jtree, ttree, q = inst
    q = _with_far_rects(q)
    jout, tout, tfn = _join_both(jtree, ttree, q, k, caps_mode=caps_mode,
                                 fused=fused)
    _assert_join_equal(jout, tout, f"k={k} {caps_mode} fused={fused}")
    ti, td, tc = tout
    assert int(tc.overflow) == 0
    if caps_mode == "static":
        tc.validate_dispatches(tkj.KNN_JOIN_SPEC.stage_model, ttree.height,
                               fused=fused)
    rows = np.r_[0:4, 76:80]                        # near and far queries
    _, want_d = tgeometry.brute_force_knn_join(q[rows], rects, k)
    np.testing.assert_allclose(td.numpy()[rows], want_d, rtol=1e-4,
                               atol=1e-9)
    for i in rows:
        assert len(set(ti[i].tolist())) == k


@pytest.mark.parametrize("fused", [False, True])
def test_beam_overflow_equals_reference(inst, fused):
    """Caps far below the τ band: every level overflows into its
    best-first beam, identically in both packages."""
    _, jtree, ttree, q = inst
    jout, tout, _ = _join_both(jtree, ttree, q, 8, caps=(2, 3, 3),
                               fused=fused)
    _assert_join_equal(jout, tout, f"beam fused={fused}")
    assert int(tout[2].overflow) == 1
    assert bool((tout[0] >= 0).all())


@pytest.mark.parametrize("fused", [False, True])
def test_knn_join_escalation_equals_reference(inst, fused):
    """k = 1 on the adaptive tier overflows and escalates once per batch;
    with a tight tier that always overflows, the runner pins itself to
    the full tier after three batches in a row."""
    _, jtree, ttree, q = inst
    jout, tout, tfn = _join_both(jtree, ttree, q, 1, fused=fused)
    _assert_join_equal(jout, tout, f"k=1 adaptive fused={fused}")
    assert int(tout[2].escalations) == 1 and tfn.escalation_count() == 1
    full = tkj.knn_frontier_caps(ttree, 8)
    jesc = jtraversal.maybe_escalating(
        lambda c: jkj.make_knn_join_bfs(jtree, 8, caps=c, backend="xla",
                                        fused=fused), (1, 1, 1), full)
    tesc = ttraversal.maybe_escalating(
        lambda c: tkj.make_knn_join_bfs(ttree, 8, caps=c, fused=fused),
        (1, 1, 1), full)
    for batch in range(4):
        _assert_join_equal(jesc(jnp.asarray(q)), tesc(q), f"batch {batch}")
        assert tesc.escalation_count() == jesc.escalation_count() == \
            batch + 1
        assert tesc.stuck() == jesc.stuck() == (batch >= 2)
    assert tesc.host_syncs() == 3


@pytest.mark.parametrize("fused", [False, True])
def test_k_above_n_rects_equals_reference(fused):
    """k > n_rects: the missing rows are (-1, +inf) in both packages."""
    rng = np.random.default_rng(9)
    rects = uniform_rects(rng, 40, eps=0.01)
    jtree = jrtree.build_rtree(rects, fanout=4)
    ttree = trtree.build_rtree(rects, fanout=4, device="cpu")
    q = _qrects(rng, 5)
    jout, tout, _ = _join_both(jtree, ttree, q, 64, caps_mode="static",
                               fused=fused)
    _assert_join_equal(jout, tout, f"k > n fused={fused}")
    ti, td, _ = tout
    assert bool((ti[:, 40:] == -1).all()) and bool(torch.isinf(
        td[:, 40:]).all()) and bool((ti[:, :40] >= 0).all())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
def test_distance_zero_ties_equal_reference(caps_mode, fused):
    """Query rects that each contain far more than k data points: every
    answer is at distance 0, so the ids are decided by the tie order
    alone, and must still equal the reference's exactly; brute force
    holds them to distances and membership."""
    rng = np.random.default_rng(17)
    rects = uniform_rects(rng, 20000)                # points as rects
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    c = rng.random((48, 2)).astype(np.float32) * 0.9 + 0.05
    q = np.concatenate([c - 0.03, c + 0.03], axis=1)  # ~72 points inside
    jout, tout, _ = _join_both(jtree, ttree, q, 8, caps_mode=caps_mode,
                               fused=fused)
    _assert_join_equal(jout, tout, f"ties {caps_mode} fused={fused}")
    ti, td, tc = tout
    assert bool((td == 0).all()) and int(tc.overflow) == 0
    d = tgeometry.mindist_rect_matrix_np(q, rects)
    inside = d == 0
    assert int(inside.sum(axis=1).min()) > 30
    for i in range(len(q)):
        assert inside[i, ti[i].numpy()].all()
        assert len(set(ti[i].tolist())) == 8


def test_tau_init_and_active_hooks_equal_reference(inst):
    """The mesh path's hooks: a seeded τ and masked-out queries."""
    _, jtree, ttree, q = inst
    rng = np.random.default_rng(4)
    tau = (rng.random(64) * 2e-4).astype(np.float32)
    active = rng.random(64) < 0.7
    jrun = jkj.make_knn_join_bfs(jtree, 8, backend="xla", caps_mode="static")
    trun = tkj.make_knn_join_bfs(ttree, 8, caps_mode="static")
    jout = jrun(jnp.asarray(q), tau_init=jnp.asarray(tau),
                active=jnp.asarray(active))
    tout = trun(q, tau_init=torch.from_numpy(tau),
                active=torch.from_numpy(active))
    _assert_join_equal(jout, tout, "hooks")
    assert bool((tout[0][~torch.from_numpy(active)] == -1).all())


@pytest.mark.parametrize("layout", ["d0", "d2", "d3"])
def test_other_layouts_raise_naming_a9(inst, layout):
    """No layout but D1 has a fused kernel: a fused D0, D2 or D3 build
    raises ValueError, as the reference's does; D0 and D2 (ported in A9a)
    have no kernel at all, so ``backend='cuda'`` raises on them too."""
    _, _, ttree, _ = inst
    with pytest.raises(ValueError, match="layout d1"):
        tkj.make_knn_join_bfs(ttree, 8, layout=layout, fused=True)
    if layout != "d3":
        with pytest.raises(ValueError, match="layout d1 or d3"):
            tkj.make_knn_join_bfs(ttree, 8, layout=layout, backend="cuda")


def test_generic_knn_join_build_equals_wrapper(inst):
    _, _, ttree, q = inst
    a = ttraversal.build("knn_join", ttree, k=8)(q)
    b = tkj.make_knn_join_bfs(ttree, 8)(q)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    assert a[2].asdict() == b[2].asdict()
    spec = ttraversal.get_spec("knn_join")
    assert spec.kind == "distance" and spec.query_width == 4
    assert spec.stage_model == tkj.KNN_JOIN_SPEC.stage_model
    assert (spec.stage_model.inner, spec.stage_model.leaf,
            spec.stage_model.fused) == (4, 3, 1)
    with pytest.raises(ValueError, match="k must be positive"):
        tkj.make_knn_join_bfs(ttree, 0)


# ---------------------------------------------------------------------------
# the all-pairs join, the fleet and the serve entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_all_pairs_knn_join_equals_reference(fused):
    """1,000 outer rects in chunks of 256 (the last one padded) against a
    6,000-rect inner tree: ids, distances and summed counters."""
    rng = np.random.default_rng(12 + fused)
    inner = uniform_rects(rng, 6000, eps=0.002)
    outer = uniform_rects(rng, 1000, eps=0.004)
    ji, jd, jc = jkj.knn_join(jrtree.build_rtree(outer, fanout=16),
                              jrtree.build_rtree(inner, fanout=16), 8,
                              backend="xla", fused=fused, batch=256)
    tree_o = trtree.build_rtree(outer, fanout=16, device="cpu")
    ti, td, tc = tkj.knn_join(tree_o, trtree.build_rtree(
        inner, fanout=16, device="cpu"), 8, fused=fused, batch=256)
    assert ti.dtype == np.int64 and td.dtype == np.float64
    assert ti.shape == td.shape == (1000, 8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    _assert_counters_equal(jc, tc, f"all-pairs fused={fused}")
    assert int(tc.overflow) == 0
    rows = np.r_[0:8, 992:1000]                       # first and last chunk
    bi, bd = tgeometry.brute_force_knn_join(
        tree_o.rects.numpy()[rows], inner, 8)
    np.testing.assert_allclose(td[rows], bd, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("k", [1, 8])
def test_fleet_knn_join_equals_reference_host_path(k):
    rng = np.random.default_rng(5 + k)
    rects = uniform_rects(rng, 6000, eps=0.001)
    q = _qrects(rng, 40, eps=0.02)
    jshards = JShards.build(rects, 4, fanout=16)
    tshards = TShards.build(rects, 4, fanout=16, device="cpu")
    want = jshards.knn_join(q, k)
    got = tshards.knn_join(q, k)
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is want[2] is False
    for f in ENGINE_FIELDS + ("dispatches",):
        np.testing.assert_array_equal(
            np.asarray(getattr(tshards.last_counters, f)),
            np.asarray(getattr(jshards.last_counters, f)), err_msg=f)
    _, want_d = tgeometry.brute_force_knn_join(q, rects, k)
    np.testing.assert_allclose(got[1], want_d, rtol=1e-4, atol=1e-9)
    n_engines = len(tshards._engines)
    tshards.warm("knn_join", 8, k=k)
    assert len(tshards._engines) == n_engines


def test_serve_knn_join_dryrun_cpu():
    out = serve.main(["--mode", "knn-join", "--dryrun", "--device", "cpu"])
    assert out["qps"] > 0 and not out["overflow"]
    assert out["neighbors"] == 2 * 8 * 4                  # k capped at 4
    rects, qs = serve.make_knn_join_inputs(2000, 0, 2, 8, 0.002)
    np.testing.assert_array_equal(serve.make_rects(2000, 0), rects)
    np.testing.assert_allclose(qs[..., 2:] - qs[..., :2], 0.004, rtol=1e-3)
    ids, d = out["first_batch"]
    _, want_d = tgeometry.brute_force_knn_join(qs[0], rects, 4)
    np.testing.assert_allclose(d, want_d, rtol=1e-4, atol=1e-9)
    assert ids.shape == (8, 4) and bool((ids >= 0).all())


def test_serve_knn_join_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--mode", "knn-join", "--dryrun"])


# ---------------------------------------------------------------------------
# no fallback: a CUDA request never quietly becomes the CPU twin
# ---------------------------------------------------------------------------

def test_cuda_backend_on_cpu_tensors_raises_for_knn_join(inst):
    _, _, ttree, q = inst
    rows = _level_args(ttree, 0, True)
    ids = torch.zeros((4, 2), dtype=torch.int32)
    qr = torch.from_numpy(q[:4])
    tau = torch.full((4,), 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.knn_join_level_dists(ids, qr, *rows, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.knn_join_level_fused(ids, qr, *rows, tau, cap=8, k=4,
                                 tighten=True, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.knn_join_leaf_fused(ids, qr, *rows, k=4, backend="cuda")
    for fn, kw in ((tkern.knn_join_level_dists_cuda, {}),
                   (tkern.knn_join_leaf_fused_cuda, dict(k=4))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(ids, qr, *rows, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkern.knn_join_level_fused_cuda(ids, qr, *rows, tau, cap=8, k=4,
                                        tighten=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkj.make_knn_join_bfs(ttree, 8, backend="cuda")
    before = tkern.launch_counts()
    assert ops.knn_join_level_dists(ids, qr, *rows)[0].shape == (4, 2, 16)
    assert ops.knn_join_leaf_fused(ids, qr, *rows, k=4)[0].shape == (4, 4)
    assert tkern.launch_counts() == before
