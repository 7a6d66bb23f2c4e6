"""Port (repro_torch) ≡ reference (repro): the quantized D3 layout's
engines, on ``test_torch_d3.py``'s instance and helpers.

The D3 select, kNN and kNN-join engines against the reference's jitted
``backend="xla"`` D3 engines (caps, overflow, escalation) and against
the port's D1 engines; the D3 fleet against the reference's host path;
``serve`` on D3 against D1.  Every comparison is exact: ids, counts,
overflow, distance bits and every ``Counters`` field except
``dispatches``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_join_vector as jkj
from repro.core import knn_vector as jknn
from repro.core import rtree as jrtree
from repro.core import select_vector as jselect
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro_torch.core import knn_join_vector as tkj
from repro_torch.core import knn_vector as tknn
from repro_torch.core import rtree as trtree
from repro_torch.core import select_vector as tselect
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch import serve

from conftest import uniform_rects
from test_torch_d3 import ENGINE_FIELDS, _assert_same, _qrects, inst  # noqa: F401


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
