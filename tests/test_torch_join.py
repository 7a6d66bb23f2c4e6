"""Port (repro_torch) ≡ reference (repro): the spatial-join slice.

The kernel twins of B3 and B4 are held against the Pallas kernels run as
the reference's own tests run them on the CPU (``interpret=True``); the
join engine against the reference's jitted ``backend="xla"`` path; the
fleet against its host fan-out.  Inputs are made with numpy from a seed
and handed to both packages.  The join is compares and integer arithmetic
only, so every comparison is exact: pairs, counts, overflow and every
``Counters`` field.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caps as jcaps
from repro.core import compaction as jcompaction
from repro.core import geometry as jgeometry
from repro.core import join_vector as jjoin
from repro.core import layouts as jlayouts
from repro.core import rtree as jrtree
from repro.core import traversal as jtraversal
from repro.core.join_scalar import elevate as jelevate
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro.kernels import ops as jops
from repro.kernels import rtree_join as jkern
from repro_torch.core import caps as tcaps
from repro_torch.core import compaction as tcompaction
from repro_torch.core import join_vector as tjoin
from repro_torch.core import layouts as tlayouts
from repro_torch.core import rtree as trtree
from repro_torch.core import traversal as ttraversal
from repro_torch.core.counters import Counters
from repro_torch.core.geometry import brute_force_join
from repro_torch.core.join_scalar import elevate as televate
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rtree_join as tkern
from repro_torch.launch import serve

from conftest import uniform_rects

COUNTER_FIELDS = tuple(Counters.__dataclass_fields__)


@pytest.fixture(scope="module")
def inst():
    """A 2500-rect outer and a 400-rect inner relation, fanout 16, both
    sorted by low x (height 3 each; ~1,600 result pairs)."""
    rng = np.random.default_rng(7)
    ra = uniform_rects(rng, 2500, eps=0.01)
    rb = uniform_rects(rng, 400, eps=0.01)
    j = [jrtree.build_rtree(r, fanout=16, sort_key="lx") for r in (ra, rb)]
    t = [trtree.build_rtree(r, fanout=16, sort_key="lx", device="cpu")
         for r in (ra, rb)]
    assert t[0].height == t[1].height == 3
    return ra, rb, j, t


def _assert_counters_equal(jctr, tctr, ctx):
    for f in COUNTER_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tctr, f)), np.asarray(getattr(jctr, f)),
            err_msg=f"{ctx}: {f}")


def _d1(tree, li, torch_side):
    """Level ``li`` of ``tree`` in D1: (coords (N, 4, F), ptr (N, F))."""
    mod = tlayouts if torch_side else jlayouts
    lv = mod.tree_layout(tree, "d1")[li]
    return lv.coords, lv.ptr


def _pair_frontier(rng, tree_o, tree_i, li, p=24, pad=0.25):
    """(P,) outer and inner node ids of level ``li``: half of them pairs
    whose node MBRs intersect, half random pairs, some slots -1."""
    mo = tree_o.levels[li].node_mbr.numpy()
    mi = tree_i.levels[li].node_mbr.numpy()
    hit = np.argwhere((mo[:, None, 0] <= mi[None, :, 2]) &
                      (mo[:, None, 2] >= mi[None, :, 0]) &
                      (mo[:, None, 1] <= mi[None, :, 3]) &
                      (mo[:, None, 3] >= mi[None, :, 1]))
    near = hit[rng.integers(0, len(hit), p // 2)]
    o = np.concatenate([near[:, 0], rng.integers(0, len(mo), p - p // 2)])
    i = np.concatenate([near[:, 1], rng.integers(0, len(mi), p - p // 2)])
    o, i = o.astype(np.int32), i.astype(np.int32)
    o[rng.random(p) < pad / 2] = -1
    i[rng.random(p) < pad / 2] = -1
    return o, i


def _random_bounds(rng, p, fo, fi, to=8):
    """Random O3 / O4-O5 bounds, past both ends of the fanouts."""
    alive = rng.integers(-1, fo + 3, p).astype(np.int32)
    flip = rng.integers(-1, fi + 3, (p, fo // to)).astype(np.int32)
    return alive, flip


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# kernel twins ≡ the Pallas kernels (interpret mode), and the pre-pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("li", [0, 1])
def test_pair_masks_twin_equals_pallas(inst, li):
    _, _, (jo, ji), (to, ti) = inst
    rng = np.random.default_rng(100 + li)
    o, i = _pair_frontier(rng, to, ti, li)
    alive, flip = _random_bounds(rng, len(o), 16, 16)
    args = (o, i, alive, flip)
    want = jkern.join_pair_masks(*_j(*args), _d1(jo, li, 0)[0],
                                 _d1(ji, li, 0)[0], to=8, ti=128,
                                 interpret=True)
    got = ref.join_pair_masks_ref(*_t(*args), _d1(to, li, 1)[0],
                                  _d1(ti, li, 1)[0], to=8, ti=128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def _seam_pairs(rng, tree_o, tree_i, li, kind, p=40):
    """(P,) pair frontiers at the seams of the persistent CUDA kernels:
    live pairs a prefix, live pairs interleaved with -1, every pair dead,
    every pair live."""
    o, i = _pair_frontier(rng, tree_o, tree_i, li, p=p, pad=0.0)
    if kind == "prefix":
        o[p // 2 + 1:] = -1
    elif kind == "interleaved":
        i[1::2] = -1
    elif kind == "dead":
        o[:] = -1
    return o, i


# (li, cap, frontier): random frontiers (4 forces overflow), then the seam
# frontiers, the first two at caps that overflow (1, and one inside the
# run)
LEVEL_FUSED_CASES = [pytest.param(li, cap, "random", id=f"{li}-{cap}")
                     for li in (0, 1) for cap in (4096, 4)] + \
    [pytest.param(li, cap, kind, id=f"{li}-{cap}-{kind}")
     for li in (0, 1) for kind, cap in (("prefix", 1), ("interleaved", 3),
                                        ("dead", 4096), ("live", 4096))]


@pytest.mark.parametrize("li,cap,frontier", LEVEL_FUSED_CASES)
def test_level_fused_twin_equals_pallas(inst, li, cap, frontier):
    _, _, (jo, ji), (to, ti) = inst
    rng = np.random.default_rng(200 + li)
    if frontier == "random":
        o, i = _pair_frontier(rng, to, ti, li)
    else:
        o, i = _seam_pairs(rng, to, ti, li, frontier)
    alive, flip = _random_bounds(rng, len(o), 16, 16)
    args = (o, i, alive, flip)
    joc, jop = _d1(jo, li, 0)
    jic, jip = _d1(ji, li, 0)
    toc, top = _d1(to, li, 1)
    tic, tip = _d1(ti, li, 1)
    want = jkern.join_level_fused(*_j(*args), joc, jic, jop, jip, cap=cap,
                                  to=8, interpret=True)
    got = ref.join_level_fused_ref(*_t(*args), toc, tic, top, tip, cap=cap,
                                   to=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if frontier == "random":
        assert int(got[2]) > 4
        assert bool(got[3]) == (cap == 4)
    else:
        assert (int(got[2]) == 0) == (frontier == "dead")
        assert bool(got[3]) == (cap < 4096)


@pytest.mark.parametrize("o3,o45", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_join_prune_metadata_equals_reference(inst, o3, o45):
    _, _, (jo, ji), (to, ti) = inst
    rng = np.random.default_rng(300)
    for li in range(to.height):
        o, i = _pair_frontier(rng, to, ti, li)
        want = jops.join_prune_metadata(
            *_j(o, i), _d1(jo, li, 0)[0], _d1(ji, li, 0)[0], to=8, o3=o3,
            o45=o45)
        got = ops.join_prune_metadata(
            *_t(o, i), _d1(to, li, 1)[0], _d1(ti, li, 1)[0], to=8, o3=o3,
            o45=o45)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [400, 3000, 200])      # heights 3, 3 and 2
def test_elevate_equals_reference(n):
    rects = uniform_rects(np.random.default_rng(n), n, eps=0.003)
    jtree = jrtree.build_rtree(rects, fanout=16, sort_key="lx")
    ttree = trtree.build_rtree(rects, fanout=16, sort_key="lx",
                               device="cpu")
    for target in range(ttree.height, 6):
        je, te = jelevate(jtree, target), televate(ttree, target)
        assert te.height == je.height == target
        for jl, tl in zip(je.levels, te.levels):
            for f in trtree.LEVEL_FIELDS:
                w, g = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
    with pytest.raises(ValueError):
        televate(ttree, ttree.height - 1)


# ---------------------------------------------------------------------------
# compaction, caps and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 9, 70, 600])
def test_compact_pairs_and_1d_equal(cap):
    rng = np.random.default_rng(cap)
    a = rng.integers(-5, 1000, (1, 500)).astype(np.int32)
    b = rng.integers(-5, 1000, (1, 500)).astype(np.int32)
    mask = rng.random((1, 500)) < 0.2
    want = jcompaction.compact_pairs(*_j(a, b, mask), cap)
    got = tcompaction.compact_pairs(*_t(a, b, mask), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jcompaction.compact_1d(*_j(a[0], mask[0]), cap)
    got = tcompaction.compact_1d(*_t(a[0], mask[0]), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) == (cap < int(mask.sum()))


def test_join_pair_caps_equal():
    sizes = (40000, 900, 30, 1)
    for height in (2, 3, 4):
        for fanout in (4, 16, 64):
            for result_cap in (64, 4096, 1 << 17):
                for policy, ls in (("static", None),
                                   ("adaptive", sizes[:height])):
                    assert tcaps.join_pair_caps(
                        height, fanout, result_cap, level_sizes=ls,
                        policy=policy) == jcaps.join_pair_caps(
                        height, fanout, result_cap, level_sizes=ls,
                        policy=policy)


def test_brute_force_join_equals_reference(inst):
    ra, rb, _, _ = inst
    np.testing.assert_array_equal(brute_force_join(ra[:700], rb),
                                  jgeometry.brute_force_join(ra[:700], rb))


# ---------------------------------------------------------------------------
# the join engine ≡ the reference's jitted xla path
# ---------------------------------------------------------------------------

PRUNING = {"none": {}, "o3o4": dict(o3=True, o4=True),
           "o5dense": dict(o5="dense"), "o5gather": dict(o3=True,
                                                        o5="gather")}


def _join_both(j, t, **kw):
    jp, jn, jc = jjoin.make_join_bfs(*j, backend="xla", **kw)()
    tp, tn, tc = tjoin.make_join_bfs(*t, backend="torch", **kw)()
    return (jp, jn, jc), (tp, tn, tc)


def _assert_join_equal(jout, tout, ctx):
    (jp, jn, jc), (tp, tn, tc) = jout, tout
    assert tp.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=ctx)
    assert int(tn) == int(jn), ctx
    _assert_counters_equal(jc, tc, ctx)


def _sorted_pairs(pairs, n):
    got = pairs[:int(n)].numpy()
    return got[np.lexsort((got[:, 1], got[:, 0]))]


@pytest.mark.parametrize("pruning", sorted(PRUNING))
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
def test_make_join_bfs_equals_reference(inst, pruning, fused, caps_mode):
    ra, rb, j, t = inst
    kw = dict(PRUNING[pruning], fused=fused, caps_mode=caps_mode)
    jout, tout = _join_both(j, t, **kw)
    _assert_join_equal(jout, tout, f"{kw}")
    tp, tn, tc = tout
    tc.validate_dispatches(tjoin.JOIN_SPEC.stage_model, t[0].height,
                           fused=fused)
    assert int(tc.overflow) == 0
    np.testing.assert_array_equal(_sorted_pairs(tp, tn),
                                  brute_force_join(ra, rb))
    if pruning != "none":
        assert int(tc.pruned_inner) > 0


@pytest.mark.parametrize("fused", [False, True])
def test_join_overflow_and_heights_equal_reference(fused):
    """Unequal heights (chain elevation on the device) and a result cap
    that overflows."""
    rng = np.random.default_rng(12)
    ra = uniform_rects(rng, 3000, eps=0.01)
    rb = uniform_rects(rng, 200, eps=0.01)
    j = [jrtree.build_rtree(r, fanout=16, sort_key="lx") for r in (ra, rb)]
    t = [trtree.build_rtree(r, fanout=16, sort_key="lx", device="cpu")
         for r in (ra, rb)]
    assert (t[0].height, t[1].height) == (3, 2)
    for result_cap in (65536, 256):
        jout, tout = _join_both(j, t, o3=True, o4=True, fused=fused,
                                result_cap=result_cap)
        _assert_join_equal(jout, tout, f"cap {result_cap} fused={fused}")
        tp, tn, tc = tout
        if result_cap == 256:
            assert int(tc.overflow) == 1 and int(tn) > 256
        else:
            np.testing.assert_array_equal(_sorted_pairs(tp, tn),
                                          brute_force_join(ra, rb))


def test_join_escalation_equals_reference(inst):
    """A tight pair-cap tier that always overflows escalates identically in
    both packages and returns the full tier's results."""
    _, _, j, t = inst
    full = jjoin.default_pair_caps(3, 16, 65536)
    tight = (1, 1, 65536)
    jesc = jtraversal.maybe_escalating(
        lambda c: jjoin.make_join_bfs(*j, pair_caps=c, backend="xla",
                                      o3=True, o4=True), tight, full)
    tesc = ttraversal.maybe_escalating(
        lambda c: tjoin.make_join_bfs(*t, pair_caps=c, o3=True, o4=True),
        tight, full)
    for batch in range(4):
        jout, tout = jesc(), tesc()
        _assert_join_equal(jout, tout, f"batch {batch}")
        assert tesc.escalation_count() == jesc.escalation_count() == batch + 1
        assert tesc.stuck() == jesc.stuck() == (batch >= 2)
    assert tesc.host_syncs() == 3


def test_generic_join_build_and_instruction_model(inst):
    _, _, _, t = inst
    a = ttraversal.build("join", *t, result_cap=4096, o3=True, o4=True)()
    b = tjoin.make_join_bfs(*t, result_cap=4096, o3=True, o4=True)()
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert a[2].asdict() == b[2].asdict()
    kw = dict(fanout=64, n_pairs=8045, alive_outer=170740,
              flip_sum=14086858, inner_count_sum=500000)
    assert tjoin.join_instruction_model(**kw) == \
        jjoin.join_instruction_model(**kw)
    with pytest.raises(ValueError, match="sort_key"):
        tjoin.make_join_bfs(
            trtree.build_rtree(uniform_rects(np.random.default_rng(0), 300),
                               fanout=16, device="cpu"), t[1], o3=True)


@pytest.mark.parametrize("f", [4, 16, 64])
def test_flip_indices_gather_equals_dense(f):
    rng = np.random.default_rng(f)
    i_lx = torch.from_numpy(np.sort(rng.random((30, f)).astype(np.float32),
                                    axis=1))
    o_hx = torch.from_numpy(rng.random((30, f)).astype(np.float32))
    dense = tjoin.flip_indices_dense(i_lx, o_hx)
    np.testing.assert_array_equal(tjoin.flip_indices_gather(i_lx, o_hx),
                                  dense)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jjoin.flip_indices_dense(
            jnp.asarray(i_lx.numpy()), jnp.asarray(o_hx.numpy()))))


# ---------------------------------------------------------------------------
# the fleet and the serve entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("o34", [False, True])
def test_fleet_join_equals_reference_host_path(o34):
    rng = np.random.default_rng(5)
    rects = uniform_rects(rng, 3000, eps=0.002)
    probes = uniform_rects(rng, 400, eps=0.01)
    sk = "lx" if o34 else None
    jshards = JShards.build(rects, 3, fanout=16, sort_key=sk)
    tshards = TShards.build(rects, 3, fanout=16, sort_key=sk, device="cpu")
    jprobe = jrtree.build_rtree(probes, fanout=16, sort_key=sk)
    tprobe = trtree.build_rtree(probes, fanout=16, sort_key=sk,
                                device="cpu")
    want, wovf = jshards.join(jprobe, result_cap=4096, o3=o34, o4=o34)
    got, govf = tshards.join(tprobe, result_cap=4096, o3=o34, o4=o34)
    assert got.dtype == np.int64 and govf == wovf is False
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, brute_force_join(probes, rects))
    _assert_counters_equal(jshards.last_counters, tshards.last_counters,
                           "fleet join")
    # raw probe rects: the fleet builds the probe tree on its own device
    got, _ = tshards.join(probes, result_cap=4096, o3=o34, o4=o34)
    np.testing.assert_array_equal(got, want)
    # a second join of the same probe tree hits the engine cache
    n_engines = len(tshards._engines)
    tshards.warm("join", 8, probe=tprobe, result_cap=4096, o3=o34, o4=o34)
    assert len(tshards._engines) == n_engines
    with pytest.raises(ValueError, match="probe"):
        tshards.warm("join", 8)


def test_serve_join_dryrun_cpu():
    out = serve.main(["--mode", "join", "--dryrun", "--device", "cpu"])
    assert out["joins_per_s"] > 0 and not out["overflow"]
    rects, probes = serve.make_join_inputs(2000, 0, 0.002)
    assert len(probes) == 200
    np.testing.assert_array_equal(serve.make_rects(2000, 0), rects)
    want = brute_force_join(probes, rects)
    assert len(want) > 0 and out["pairs"] == 2 * len(want)
    np.testing.assert_array_equal(out["last_pairs"], want)


def test_serve_join_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--mode", "join", "--dryrun"])


# ---------------------------------------------------------------------------
# no fallback: a CUDA request never quietly becomes the CPU twin
# ---------------------------------------------------------------------------

def test_cuda_backend_on_cpu_tensors_raises_for_join(inst):
    _, _, _, (to, ti) = inst
    oc, op = _d1(to, 0, 1)
    ic, ip = _d1(ti, 0, 1)
    ids = torch.zeros((4,), dtype=torch.int32)
    alive = torch.full((4,), 16, dtype=torch.int32)
    flip = torch.full((4, 2), 16, dtype=torch.int32)
    args = (ids, ids, alive, flip, oc, ic)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.join_pair_masks(*args, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.join_level_fused(*args, op, ip, cap=64, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkern.join_pair_masks_cuda(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkern.join_level_fused_cuda(*args, op, ip, cap=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tjoin.make_join_bfs(to, ti, backend="cuda")
    before = tkern.launch_counts()
    assert ops.join_pair_masks(*args).shape == (4, 16, 16)
    assert ops.join_level_fused(*args, op, ip, cap=64)[0].shape == (64,)
    assert tkern.launch_counts() == before
