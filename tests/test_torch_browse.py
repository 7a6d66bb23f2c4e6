"""Port (repro_torch) ≡ reference (repro): resumable distance browsing.

A port session is held against the reference's jitted
``make_browse_bfs(backend="xla")`` step by step, over more than 30
``next_batch()`` calls and several resume descents, on D1 and D3: ids,
distance bits, the lost bound, emitted counts, overflow, descents and
every ``Counters`` field except ``dispatches``.  Also: prefix consistency
with the port's fixed-k kNN, the lost-bound overflow under a tiny pool,
exhaustion padding, resuming from a moved or copied state and from a
reference session carried across, and the serve entry point.  Inputs are
made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_browse as jkb
from repro.core import rtree as jrtree
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro_torch.core import knn_browse as tkb
from repro_torch.core import knn_vector as tknn
from repro_torch.core import rtree as trtree
from repro_torch.core import traversal as ttraversal
from repro_torch.core.counters import Counters
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch import serve

from conftest import uniform_rects

ENGINE_FIELDS = tuple(f for f in Counters.__dataclass_fields__
                      if f != "dispatches")
STATE_FIELDS = ("queries", "pool_ids", "pool_d", "def_ids", "def_d", "lost",
                "emitted", "overflow", "descents")


def _bits(a):
    """A float32 array's bits (int32), so +inf and DIST_PAD compare
    exactly; other dtypes as they are."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, ctx):
    assert _bits(got).dtype == _bits(want).dtype, ctx
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


@pytest.fixture(scope="module")
def inst():
    """2,500 small rects, fanout 16 (height 3), in both packages, and 5
    query points (the reference's own browse fixture)."""
    rng = np.random.default_rng(17)
    rects = uniform_rects(rng, 2500, eps=0.002)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    assert ttree.height >= 3
    pts = rng.random((5, 2)).astype(np.float32)
    return rects, jtree, ttree, pts


def _assert_state_equal(jstate, tstate, ctx):
    """Every leaf of the two sessions' states, bit for bit (counters but
    ``dispatches``)."""
    for f in STATE_FIELDS:
        j, t = getattr(jstate, f), getattr(tstate, f)
        if isinstance(t, tuple):
            assert len(j) == len(t), f"{ctx}: {f}"
            for lj, (a, b) in enumerate(zip(j, t)):
                _assert_same(b, a, f"{ctx}: {f}[{lj}]")
        else:
            _assert_same(t, j, f"{ctx}: {f}")
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tstate.ctr, f)),
            np.asarray(getattr(jstate.ctr, f)), err_msg=f"{ctx}: {f}")


def _steps_equal(jcur, tcur, steps, ctx, first=0):
    """``steps`` next_batch() calls of both cursors: the emitted ids and
    distances and the whole state equal after each."""
    for step in range(first, first + steps):
        ji, jd = jcur.next_batch()
        ti, td = tcur.next_batch()
        assert ti.dtype == np.int32 and td.dtype == np.float32
        _assert_same(ti, ji, f"{ctx} step {step} ids")
        _assert_same(td, jd, f"{ctx} step {step} dists")
        _assert_same(tcur.overflow, jcur.overflow, f"{ctx} step {step}")
        _assert_state_equal(jcur.state, tcur.state, f"{ctx} step {step}")


def _reference_arrays(jstate):
    """A reference BrowseState's leaves as numpy arrays."""
    out = {f: (tuple(np.asarray(a) for a in getattr(jstate, f))
               if f in ("def_ids", "def_d") else
               np.asarray(getattr(jstate, f))) for f in STATE_FIELDS}
    out["ctr"] = {f: np.asarray(getattr(jstate.ctr, f))
                  for f in Counters.__dataclass_fields__}
    return out


# ---------------------------------------------------------------------------
# the session ≡ the reference's, step by step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_browse_steps_equal_reference(inst, layout, k):
    _, jtree, ttree, pts = inst
    jcur = jkb.make_browse_bfs(jtree, k, layout=layout, backend="xla")(
        jnp.asarray(pts))
    tcur = tkb.make_browse_bfs(ttree, k, layout=layout)(pts)
    steps = 30 if k == 4 else 16
    _steps_equal(jcur, tcur, steps, f"{layout} k={k}")
    descents = int(tcur.state.descents)
    assert descents > 1, "the resume path never ran"
    assert not tcur.overflow.any()
    tcur.counters.validate_dispatches(tkb.BROWSE_SPEC.stage_model,
                                      ttree.height, descents=descents)
    assert int(tcur.state.emitted.sum()) == steps * k * len(pts)


@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_prefix_consistency_with_knn(inst, layout):
    """The concatenated batches ≡ the port's fixed-k kNN for every prefix
    k, distance bits exact and ids wherever the distances are unique,
    including prefixes deep enough for several resume descents."""
    _, _, ttree, pts = inst
    cur = tkb.browse_knn(ttree, pts, 4, layout=layout)
    out = [cur.next_batch() for _ in range(30)]
    ids = np.concatenate([i for i, _ in out], axis=1)
    d = np.concatenate([x for _, x in out], axis=1)
    assert int(cur.state.descents) > 1 and not cur.overflow.any()
    for k in (1, 3, 11, 40, 120):
        fi, fd, fc = tknn.make_knn_bfs(ttree, k, layout=layout)(pts)
        assert int(fc.overflow) == 0
        _assert_same(d[:, :k], fd, f"k={k} dists")
        diff = ids[:, :k] != fi.numpy()
        if diff.any():                  # ids may differ only at ties
            np.testing.assert_array_equal(d[:, :k][diff], fd.numpy()[diff])


def test_tiny_pool_flags_overflow_where_reference_does(inst):
    """A pool of k slots drops candidates every descent: the port flags
    the same rows at the same steps, and ``Counters.overflow`` with
    them."""
    _, jtree, ttree, pts = inst
    jcur = jkb.browse_knn(jtree, jnp.asarray(pts), 4, pool_cap=4,
                          backend="xla")
    tcur = tkb.browse_knn(ttree, pts, 4, pool_cap=4)
    _steps_equal(jcur, tcur, 10, "tiny pool")
    assert tcur.overflow.any()
    assert int(tcur.counters.overflow) == 1


def test_exhaustion_pads_like_fixed_k(inst):
    """A tree smaller than the ask: every rect once, then (-1, +inf), as
    the reference emits them."""
    rects, _, _, pts = inst
    jsmall = jrtree.build_rtree(rects[:30], fanout=16)
    tsmall = trtree.build_rtree(rects[:30], fanout=16, device="cpu")
    jcur = jkb.browse_knn(jsmall, jnp.asarray(pts[:3]), 8, backend="xla")
    tcur = tkb.browse_knn(tsmall, pts[:3], 8)
    _steps_equal(jcur, tcur, 6, "exhaustion")
    ids, d = tcur.next_batch()
    assert (ids == -1).all() and np.isinf(d).all()
    assert (tcur.state.emitted.numpy() == 30).all()


# ---------------------------------------------------------------------------
# the state: moved, copied, carried over from the reference
# ---------------------------------------------------------------------------

def test_state_to_and_clone_resume_exactly(inst):
    """``to("cpu")`` and ``clone()`` of a mid-session state, assigned back,
    go on exactly as the uninterrupted session; the copy is independent."""
    _, _, ttree, pts = inst
    start = tkb.make_browse_bfs(ttree, 4)
    a, b = start(pts), start(pts)
    for step in range(12):
        ia, da = a.next_batch()
        b.state = b.state.to("cpu") if step % 2 else b.state.clone()
        ib, db = b.next_batch()
        _assert_same(ib, ia, f"step {step} ids")
        _assert_same(db, da, f"step {step} dists")
    snap = a.state.clone()
    a.next_batch()
    assert not torch.equal(snap.pool_d, a.state.pool_d)
    assert int(snap.emitted.sum()) == 12 * 4 * len(pts)
    assert isinstance(snap, ttraversal.BrowseState)


@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_reference_session_resumes_in_the_port(inst, layout):
    """A reference session advanced 5 steps, carried across by
    ``browse_state_from_arrays``, goes on ≡ the reference's next steps."""
    _, jtree, ttree, pts = inst
    jcur = jkb.make_browse_bfs(jtree, 4, layout=layout, backend="xla")(
        jnp.asarray(pts))
    for _ in range(5):
        jcur.next_batch()
    tcur = tkb.make_browse_bfs(ttree, 4, layout=layout)(pts)
    tcur.state = ttraversal.browse_state_from_arrays(
        _reference_arrays(jcur.state), device="cpu")
    _assert_state_equal(jcur.state, tcur.state, "carried")
    _steps_equal(jcur, tcur, 12, f"{layout} carried", first=5)
    assert int(tcur.state.descents) > 1


# ---------------------------------------------------------------------------
# registry, parameters, the fleet and the serve entry point
# ---------------------------------------------------------------------------

def test_browse_registered_and_bad_params(inst):
    _, _, ttree, pts = inst
    spec = ttraversal.get_spec("browse")
    assert spec.kind == "distance" and spec.query_width == 2
    assert (spec.stage_model.inner, spec.stage_model.leaf) == (8, 3)
    i, d = ttraversal.build("browse", ttree, k=4)(pts).next_batch()
    ib, db = tkb.browse_knn(ttree, pts, 4).next_batch()
    _assert_same(i, ib, "generic ids")
    _assert_same(d, db, "generic dists")
    with pytest.raises(ValueError, match="k must be positive"):
        tkb.make_browse_bfs(ttree, 0)
    with pytest.raises(ValueError, match="pool_cap"):
        tkb.make_browse_bfs(ttree, 4, pool_cap=2)
    with pytest.raises(ValueError, match="caps"):
        tkb.make_browse_bfs(ttree, 4, caps=(128,) * 7)
    with pytest.raises(ValueError, match="defer caps"):
        tkb.make_browse_bfs(ttree, 4, defer_caps=(128,))
    with pytest.raises(ValueError, match="layout d1 or d3"):
        tkb.make_browse_bfs(ttree, 4, layout="d0", backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkb.make_browse_bfs(ttree, 4, backend="cuda")


def test_fleet_browse_raises_naming_a11():
    """The distributed browse (A11) is ported: on the host path the fleet
    asks for the mesh path, as the reference's does, and names no ROADMAP
    item; on the mesh path it serves."""
    rng = np.random.default_rng(2)
    shards = TShards.build(uniform_rects(rng, 500), 2, fanout=16,
                           device="cpu")
    pts = rng.random((4, 2)).astype(np.float32)
    for call in (lambda: shards.browse(pts, 4),
                 lambda: shards.warm("browse", 4, k=4)):
        with pytest.raises(RuntimeError, match="enable_mesh") as err:
            call()
        assert "A11" not in str(err.value)
    shards.enable_mesh()
    shards.warm("browse", 4, k=4)
    ids, d = shards.browse(pts, 4).next_batch()
    assert ids.shape == d.shape == (4, 4) and (ids >= 0).all()


@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_serve_browse_dryrun_cpu_equals_reference(layout):
    """The served dryrun's first session ≡ the reference's session on the
    same tree and points (its serve runner draws them so and prints only
    counts), D3 ≡ D1, and the first 8 neighbours ≡ the fleet's kNN."""
    out = serve.main(["--mode", "browse", "--layout", layout, "--dryrun",
                      "--device", "cpu"])
    assert out["qps"] > 0 and not out["overflow"]
    assert out["neighbors"] == 2 * 8 * 2 * 4        # batches · B · steps · k
    rects, qs = serve.make_knn_inputs(2000, 0, 2, 8)
    jcur = jkb.make_browse_bfs(jrtree.build_rtree(rects, fanout=16), 4,
                               layout=layout, backend="xla")(
        jnp.asarray(qs[0]))
    want = [jcur.next_batch() for _ in range(2)]
    ids, d = out["first_batch"]
    assert ids.shape == d.shape == (8, 8)
    _assert_same(ids, np.concatenate([i for i, _ in want], axis=1), "ids")
    _assert_same(d, np.concatenate([x for _, x in want], axis=1), "dists")
    fi, fd, _ = JShards.build(rects, 1, fanout=16).knn(qs[0], 8)
    np.testing.assert_array_equal(d.astype(np.float64), fd)
