"""Port (repro_torch) ≡ reference (repro): the kNN slice's engine, on
``test_torch_knn.py``'s instance and helpers.

The kNN engine (k, caps, fused or not, beam overflow, escalation, k above
the rect count, the τ hooks, the layouts that raise, the generic build)
against the reference's jitted ``backend="xla"`` engine.  The port pins
the reference's FMA roundings, so every comparison is exact: ids,
distance bits, overflow and every ``Counters`` field except
``dispatches``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_vector as jknn
from repro.core import rtree as jrtree
from repro.core import traversal as jtraversal
from repro_torch.core import geometry as tgeometry
from repro_torch.core import knn_vector as tknn
from repro_torch.core import rtree as trtree
from repro_torch.core import traversal as ttraversal

from conftest import uniform_rects
from test_torch_knn import (ENGINE_FIELDS, _assert_same,  # noqa: F401
                            _bits, _with_far_points, inst)


# ---------------------------------------------------------------------------
# the kNN engine ≡ the reference's jitted xla path
# ---------------------------------------------------------------------------

def _knn_both(jtree, ttree, pts, k, **kw):
    jout = jknn.make_knn_bfs(jtree, k, backend="xla", **kw)(pts)
    tfn = tknn.make_knn_bfs(ttree, k, **kw)
    return jout, tfn(pts), tfn


def _assert_knn_equal(jout, tout, ctx):
    (ji, jd, jc), (ti, td, tc) = jout, tout
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    _assert_same(ti, ji, f"{ctx} ids")
    _assert_same(td, jd, f"{ctx} dists")
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tc, f)), np.asarray(getattr(jc, f)),
            err_msg=f"{ctx}: {f}")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_make_knn_bfs_equals_reference(inst, k, caps_mode, fused):
    rects, jtree, ttree, pts = inst
    pts = _with_far_points(pts)
    jout, tout, tfn = _knn_both(jtree, ttree, pts, k, caps_mode=caps_mode,
                                fused=fused)
    _assert_knn_equal(jout, tout, f"k={k} {caps_mode} fused={fused}")
    ti, td, tc = tout
    assert int(tc.overflow) == 0
    if caps_mode == "static":
        tc.validate_dispatches(tknn.KNN_SPEC.stage_model, ttree.height,
                               fused=fused)
    rows = np.r_[0:4, 76:80]                        # near and far queries
    _, want_d = tgeometry.brute_force_knn(rects, pts[rows], k)
    np.testing.assert_allclose(td.numpy()[rows], want_d, rtol=1e-4,
                               atol=1e-9)
    for i in rows:
        assert len(set(ti[i].tolist())) == k


@pytest.mark.parametrize("fused", [False, True])
def test_beam_overflow_equals_reference(inst, fused):
    """Caps far below the τ band: every level overflows into its
    best-first beam, identically in both packages."""
    _, jtree, ttree, pts = inst
    jout, tout, _ = _knn_both(jtree, ttree, pts, 8, caps=(2, 3, 3),
                              fused=fused)
    _assert_knn_equal(jout, tout, f"beam fused={fused}")
    assert int(tout[2].overflow) == 1
    assert bool((tout[0] >= 0).all())


@pytest.mark.parametrize("fused", [False, True])
def test_knn_escalation_equals_reference(inst, fused):
    """k = 1 on the adaptive tier overflows and escalates once per batch;
    with a tight tier that always overflows, the runner pins itself to
    the full tier after three batches in a row."""
    _, jtree, ttree, pts = inst
    jout, tout, tfn = _knn_both(jtree, ttree, pts, 1, fused=fused)
    _assert_knn_equal(jout, tout, f"k=1 adaptive fused={fused}")
    assert int(tout[2].escalations) == 1 and tfn.escalation_count() == 1
    full = tknn.knn_frontier_caps(ttree, 8)
    jesc = jtraversal.maybe_escalating(
        lambda c: jknn.make_knn_bfs(jtree, 8, caps=c, backend="xla",
                                    fused=fused), (1, 1, 1), full)
    tesc = ttraversal.maybe_escalating(
        lambda c: tknn.make_knn_bfs(ttree, 8, caps=c, fused=fused),
        (1, 1, 1), full)
    for batch in range(4):
        _assert_knn_equal(jesc(pts), tesc(pts), f"batch {batch}")
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
    pts = rng.random((5, 2)).astype(np.float32)
    jout, tout, _ = _knn_both(jtree, ttree, pts, 64, caps_mode="static",
                              fused=fused)
    _assert_knn_equal(jout, tout, f"k > n fused={fused}")
    ti, td, _ = tout
    assert bool((ti[:, 40:] == -1).all()) and bool(torch.isinf(
        td[:, 40:]).all()) and bool((ti[:, :40] >= 0).all())


def test_tau_init_and_active_hooks_equal_reference(inst):
    """The mesh path's hooks: a seeded τ and masked-out queries."""
    _, jtree, ttree, pts = inst
    rng = np.random.default_rng(4)
    tau = (rng.random(64) * 2e-4).astype(np.float32)
    active = rng.random(64) < 0.7
    jrun = jknn.make_knn_bfs(jtree, 8, backend="xla", caps_mode="static")
    trun = tknn.make_knn_bfs(ttree, 8, caps_mode="static")
    jout = jrun(pts, tau_init=jnp.asarray(tau), active=jnp.asarray(active))
    tout = trun(pts, tau_init=torch.from_numpy(tau),
                active=torch.from_numpy(active))
    _assert_knn_equal(jout, tout, "hooks")
    assert bool((tout[0][~torch.from_numpy(active)] == -1).all())


@pytest.mark.parametrize("layout", ["d0", "d2", "d3"])
def test_other_layouts_raise_naming_a9(inst, layout):
    """No layout but D1 has a fused kernel: a fused D0, D2 or D3 build
    raises ValueError, as the reference's does; D0 and D2 (ported in A9a)
    have no kernel at all, so ``backend='cuda'`` raises on them too."""
    _, _, ttree, _ = inst
    with pytest.raises(ValueError, match="layout d1"):
        tknn.make_knn_bfs(ttree, 8, layout=layout, fused=True)
    if layout != "d3":
        with pytest.raises(ValueError, match="layout d1 or d3"):
            tknn.make_knn_bfs(ttree, 8, layout=layout, backend="cuda")


def test_generic_knn_build_equals_wrapper(inst):
    _, _, ttree, pts = inst
    a = ttraversal.build("knn", ttree, k=8)(pts)
    b = tknn.make_knn_bfs(ttree, 8)(pts)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    assert a[2].asdict() == b[2].asdict()
    spec = ttraversal.get_spec("knn")
    assert spec.kind == "distance" and spec.query_width == 2
    with pytest.raises(ValueError, match="k must be positive"):
        tknn.make_knn_bfs(ttree, 0)
