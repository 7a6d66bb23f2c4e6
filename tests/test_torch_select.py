"""Port (repro_torch) ≡ reference (repro): the D1 range-select slice.

The kernel twins are held against the Pallas kernels run as the reference's
own tests run them on the CPU (``interpret=True``); the engine against the
reference's jitted ``backend="xla"`` path; the fleet against its host
fan-out.  Inputs are made with numpy from a seed and handed to both
packages.  The path is compares and integer arithmetic only, so every
comparison is exact: ids, counts, overflow and every ``Counters`` field.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caps as jcaps
from repro.core import rtree as jrtree
from repro.core import select_vector as jselect
from repro.core import traversal as jtraversal
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro.kernels import rtree_select as jkern
from repro_torch.core import rtree as trtree
from repro_torch.core import select_vector as tselect
from repro_torch.core import traversal as ttraversal
from repro_torch.core.counters import Counters
from repro_torch.core.geometry import brute_force_select
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rtree_select as tkern
from repro_torch.launch import serve

from conftest import uniform_rects

COUNTER_FIELDS = tuple(Counters.__dataclass_fields__)


@pytest.fixture(scope="module")
def inst():
    """tests/test_fused.py's instance: 2500 rects, fanout 16, height >= 3,
    small queries (~tens of hits) and big ones (~hundreds, for overflow)."""
    rng = np.random.default_rng(41)
    rects = uniform_rects(rng, 2500, eps=0.002)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    assert ttree.height >= 3
    lo = rng.random((4, 2)).astype(np.float32) * 0.94
    small = np.concatenate([lo, lo + np.float32(0.06)], axis=1)
    lo_big = rng.random((4, 2)).astype(np.float32) * 0.7
    big = np.concatenate([lo_big, lo_big + np.float32(0.3)], axis=1)
    return rects, jtree, ttree, small, big


def _assert_counters_equal(jctr, tctr, ctx):
    for f in COUNTER_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tctr, f)), np.asarray(getattr(jctr, f)),
            err_msg=f"{ctx}: {f}")


def _frontier(rng, n_nodes, b=4, c=8, pad=0.3):
    ids = rng.integers(0, n_nodes, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < pad] = -1
    return ids


def _level_args(tree_levels, li, torch_side):
    lvl = tree_levels[li]
    names = ("lx", "ly", "hx", "hy", "child")
    if torch_side:
        return [getattr(lvl, f) for f in names]
    return [jnp.asarray(getattr(lvl, f)) for f in names]


# ---------------------------------------------------------------------------
# kernel twins ≡ the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("li", [0, 1, 2])
def test_masks_twin_equals_pallas(inst, li):
    _, jtree, ttree, small, big = inst
    rng = np.random.default_rng(li)
    ids = _frontier(rng, ttree.levels[li].n_nodes)
    q = np.concatenate([small[:2], big[:2]])
    want = jkern.select_level_masks(
        jnp.asarray(ids), jnp.asarray(q), *_level_args(jtree.levels, li, 0),
        interpret=True)
    got = ref.select_level_masks_ref(torch.from_numpy(ids),
                                     torch.from_numpy(q),
                                     *_level_args(ttree.levels, li, 1))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


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


# (li, cap, frontier): random frontiers (64 forces overflow), then the
# seam rows at cap 1, a cap that falls inside a row's qualifying run, and
# a cap that holds every row
FUSED_CASES = [pytest.param(li, cap, "random", id=f"{li}-{cap}")
               for li in (0, 1) for cap in (2048, 64)] + \
    [pytest.param(li, cap, "seams", id=f"{li}-{cap}-seams")
     for li in (0, 1) for cap in (1, 3, 2048)]


@pytest.mark.parametrize("li,cap,frontier", FUSED_CASES)
def test_fused_twin_equals_pallas(inst, li, cap, frontier):
    _, jtree, ttree, small, big = inst
    rng = np.random.default_rng(10 + li)
    if frontier == "seams":
        ids = _seam_frontier(rng, ttree.levels[li].n_nodes)
    else:
        ids = _frontier(rng, ttree.levels[li].n_nodes, c=16, pad=0.2)
    q = big if cap == 64 or frontier == "seams" else small
    want = jkern.select_level_fused(
        jnp.asarray(ids), jnp.asarray(q), *_level_args(jtree.levels, li, 0),
        cap=cap, interpret=True)
    got = ref.select_level_fused_ref(torch.from_numpy(ids),
                                     torch.from_numpy(q),
                                     *_level_args(ttree.levels, li, 1),
                                     cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cap == 64 and li == 0:
        assert got[2].any()                # the overflow case fired
    if frontier == "seams":
        assert int(got[1][0]) == 0         # the all -1 row
        assert bool(got[2].any()) == (cap < 2048)   # cap 1, 3 overflow


# ---------------------------------------------------------------------------
# the engine ≡ the reference's jitted xla path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("result_cap", [2048, 64])   # 64 forces overflow
def test_make_select_bfs_equals_reference(inst, fused, caps_mode,
                                          result_cap):
    rects, jtree, ttree, small, big = inst
    q = big if result_cap == 64 else small
    jr, jc, jt = jselect.make_select_bfs(
        jtree, result_cap=result_cap, backend="xla", fused=fused,
        caps_mode=caps_mode)(jnp.asarray(q))
    tr, tc, tt = tselect.make_select_bfs(
        ttree, result_cap=result_cap, fused=fused, caps_mode=caps_mode)(q)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_counters_equal(jt, tt, f"fused={fused} {caps_mode}")
    tt.validate_dispatches(tselect.SELECT_SPEC.stage_model, ttree.height,
                           fused=fused)
    if result_cap == 64:
        assert int(tt.overflow) == 1
    else:
        for i in range(len(q)):
            np.testing.assert_array_equal(
                np.sort(tr[i, :tc[i]].numpy()),
                brute_force_select(rects, q[i]))


def test_generic_build_equals_wrapper(inst):
    _, _, ttree, small, _ = inst
    a = ttraversal.build("select", ttree, result_cap=512)(small)
    b = tselect.make_select_bfs(ttree, result_cap=512)(small)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a[2].asdict() == b[2].asdict()
    assert ttraversal.spec_names() == ("browse", "join", "knn",
                                       "knn_filtered", "knn_join", "select")


def test_escalation_equals_reference():
    """A tight tier that always overflows escalates identically in both
    packages, pins itself to the full tier after three batches in a row
    (``stuck()``), and returns the full tier's results."""
    rng = np.random.default_rng(11)
    rects = uniform_rects(rng, 3000, eps=0.004)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    lo = rng.random((4, 2)).astype(np.float32) * 0.6
    qs = np.concatenate([lo, lo + np.float32(0.3)], axis=1)
    full = jcaps.select_frontier_caps(jtree, 4096)
    tight = (1,) * len(full)
    jesc = jtraversal.maybe_escalating(
        lambda c: jselect.make_select_bfs(jtree, caps=c, backend="xla"),
        tight, full)
    tesc = ttraversal.maybe_escalating(
        lambda c: tselect.make_select_bfs(ttree, caps=c), tight, full)
    for batch in range(4):
        jr, jc, jt = jesc(jnp.asarray(qs))
        tr, tc, tt = tesc(qs)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        _assert_counters_equal(jt, tt, f"batch {batch}")
        assert tesc.escalation_count() == jesc.escalation_count() == batch + 1
        assert tesc.stuck() == jesc.stuck() == (batch >= 2)
    assert int(tt.escalations) == 1
    # the stuck runner skips the tight tier and its overflow read-back
    assert tesc.host_syncs() == 3
    plain = ttraversal.maybe_escalating(
        lambda c: tselect.make_select_bfs(ttree, caps=c), full, full)
    assert not hasattr(plain, "escalation_count")


# ---------------------------------------------------------------------------
# the fleet and the serve entry point
# ---------------------------------------------------------------------------

def test_range_select_equals_reference_host_path():
    rng = np.random.default_rng(3)
    rects = uniform_rects(rng, 4000, eps=0.001)
    jshards = JShards.build(rects, 3, fanout=16)
    tshards = TShards.build(rects, 3, fanout=16, device="cpu")
    assert len(tshards.partitions) == len(jshards.partitions)
    for jp, tp in zip(jshards.partitions, tshards.partitions):
        np.testing.assert_array_equal(tp.ids, jp.ids)
        np.testing.assert_array_equal(tp.mbr, jp.mbr)
    lo = rng.random((6, 2)).astype(np.float32) * 0.9
    qs = np.concatenate([lo, lo + np.float32(0.08)], axis=1)
    jres = jshards.range_select(qs)
    tres = tshards.range_select(qs)
    for i, (a, b) in enumerate(zip(tres, jres)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, brute_force_select(rects, qs[i]))
    _assert_counters_equal(jshards.last_counters, tshards.last_counters,
                           "fleet")


def test_serve_dryrun_cpu():
    out = serve.main(["--dryrun", "--device", "cpu"])
    assert out["qps"] > 0 and out["results"] > 0
    rects = serve.make_rects(2000, 0)
    qs = serve.make_queries(2, 8, 0.001, 1)
    for got, q in zip(out["first_batch"], qs[0]):
        np.testing.assert_array_equal(got, brute_force_select(rects, q))


# ---------------------------------------------------------------------------
# no fallback: a CUDA request never quietly becomes the CPU twin
# ---------------------------------------------------------------------------

def test_cuda_backend_on_cpu_tensors_raises(inst):
    _, _, ttree, small, _ = inst
    lvl = ttree.levels[0]
    ids = torch.zeros((4, 1), dtype=torch.int32)
    args = (ids, torch.from_numpy(small), lvl.lx, lvl.ly, lvl.hx, lvl.hy,
            lvl.child)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.select_level_masks(*args, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.select_level_fused(*args, cap=64, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkern.select_level_masks_cuda(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        tselect.make_select_bfs(ttree, backend="cuda")
    with pytest.raises(ValueError):
        ops.select_level_masks(*args, backend="xla")
    # 'auto' on CPU tensors takes the twin, and launches nothing
    before = tkern.launch_counts()
    assert ops.select_level_masks(*args).shape == (4, 1, ttree.fanout)
    assert tkern.launch_counts() == before


def test_serve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--dryrun"])
