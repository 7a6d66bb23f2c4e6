"""Port (repro_torch) ≡ reference (repro): the fleet's single-program
(mesh) path.

The reference runs its mesh programs on a 1-device CPU mesh
(``jax.make_mesh((1,), ("model",))``); the port runs its packed forest on
the CPU.  At the reference's oracle sizes (n = 4,000, fanout 16, 4
partitions, batch 6, k = 8), for select, join, kNN, kNN-join and filtered
kNN on D1 and D3 (``test_torch_mesh_cells.py``, on this file's helpers):
the port's mesh program equals the reference's (ids, counts, distance
bits, overflow, every ``Counters`` field but ``dispatches``), equals the
port's host path, and does not change under a partition permutation.
Here: O(levels) dispatches at 2 and 4
partitions, padded partitions, the float32 forms of the router MINDIST and
the phase-2 bound pinned inside the reference's program, the join's row
blocks, and the distributed browse step by step against the reference's
cursor, each partition's descents and counters included.  Inputs are made
with numpy from a seed and handed to both packages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.distributed import forest as jforest
from repro.distributed.spatial_shard import Partition as JPartition
from repro.distributed.spatial_shard import SpatialShards as JShards
from repro.core import rtree as jrtree
from repro_torch.core import rtree as trtree
from repro_torch.core import traversal as ttraversal
from repro_torch.core.counters import Counters
from repro_torch.distributed.spatial_shard import Partition as TPartition
from repro_torch.distributed.spatial_shard import SpatialShards as TShards

from conftest import uniform_rects
from oracle import _sharded_instance, _shards_for

ENGINE_FIELDS = tuple(f.name for f in dataclasses.fields(Counters)
                      if f.name != "dispatches")
N, FANOUT, PARTS, BATCH, K = 4000, 16, 4, 6, 8


def _bits(a):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, ctx):
    assert _bits(got).dtype == _bits(want).dtype, ctx
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


def _assert_counters(tctr, jctr, ctx):
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tctr, f)), np.asarray(getattr(jctr, f)),
            err_msg=f"{ctx}: {f}")


def _keep(shards, order):
    """The fleet over the partitions ``order`` names, in that order."""
    shards.partitions = [shards.partitions[i] for i in order]
    shards.router_mbrs = np.stack([p.mbr for p in shards.partitions])
    return shards


def _port_fleet(rects, n_partitions, layout="d1", order=None, n_shards=1):
    """The port's fleet on the CPU, as ``oracle._shards_for`` builds the
    reference's: partitions permuted by ``order`` before packing."""
    s = TShards.build(rects, n_partitions, fanout=FANOUT, layout=layout,
                      device="cpu")
    if order is not None:
        _keep(s, order)
    return s.enable_mesh(n_shards=n_shards)


def _public(op, shards, inst):
    if op == "select":
        return shards.range_select(inst["queries"], result_cap=inst["cap"])
    if op == "join":
        return shards.join(inst["probe"], result_cap=inst["cap"])
    return getattr(shards, op)(inst["queries"], inst["k"])


def _assert_same_public(op, a, b, ctx):
    if op == "select":
        assert len(a) == len(b), ctx
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=ctx)
    elif op == "join":
        np.testing.assert_array_equal(a[0], b[0], err_msg=ctx)
        assert a[1] == b[1], ctx
    else:
        np.testing.assert_array_equal(a[0], b[0], err_msg=ctx)
        _assert_same(a[1], b[1], ctx)
        assert a[2] == b[2], ctx


@pytest.mark.parametrize("op,descents", [("knn", 2), ("select", 1)])
def test_mesh_dispatches_are_o_levels(op, descents):
    """One program a batch: the dispatch tally is the spec's stage model
    for one descent a phase of the forest's height, the same at 2 and at 4
    partitions."""
    rng = np.random.default_rng(7)
    rects = uniform_rects(rng, N, eps=0.002)
    lo = rng.random((BATCH, 2)).astype(np.float32) * 0.9
    qs = lo if op == "knn" else np.concatenate([lo, lo + 0.05], axis=1)
    sm = ttraversal.get_spec(op).stage_model
    got = []
    for n_partitions in (2, 4):
        shards = _port_fleet(rects, n_partitions)
        if op == "knn":
            shards.knn(qs, K)
        else:
            shards.range_select(qs)
        ctr = shards.last_counters
        ctr.validate_dispatches(sm, shards._forest.height,
                                descents=descents)
        got.append(int(ctr.dispatches))
    assert got[0] == got[1], got


@pytest.mark.parametrize("op", ["knn", "select"])
def test_padded_partitions_route_and_answer_nothing(op):
    """3 partitions (three of a 2×2 fleet) packed for 4 shards: the empty
    fourth partition changes no result, and its counters equal the
    reference's program over the same padded forest (on its 1-device
    mesh)."""
    rng, inst = _sharded_instance(op, 17, 3000, 5, K)
    tsh = _port_fleet(inst["rects"], 4, order=[0, 1, 2], n_shards=4)
    assert tsh._forest.n_real == 3 and tsh._forest.n_partitions == 4
    jsh = _keep(_shards_for(inst["rects"], 4, FANOUT, mesh=False), [0, 1, 2])
    jsh._mesh = jax.make_mesh((1,), ("model",))
    jsh._forest = jforest.pack_forest(
        [p.tree for p in jsh.partitions], [p.ids for p in jsh.partitions],
        n_shards=4).device_put(jsh._mesh)
    res = _public(op, tsh, inst)
    _assert_same_public(op, res, _public(op, jsh, inst), "vs reference")
    _assert_same_public(op, res, _public(op, tsh.host_view(), inst),
                        "vs host")
    _assert_counters(tsh.last_counters, jsh.last_counters, "padded forest")


# The float32 forms the reference's mesh program rounds in, pinned inside
# that program: each case puts a partition's router MINDIST exactly on the
# phase-2 bound in the pinned form and past it in another, so the other
# form would skip the partition's phase-2 descent and change the counters
# (not the answer).  Query (0, 0), k = 1; partition A holds the nearest
# point (a, 0); partition B's MBR has its low corner at (bx, by).
#   tau:    a² = 0.0087890625; fma(a², 1.00001f, 1e-30f) =
#           0.008789150975644588 = f32(bx²) while the two-rounding form
#           gives 0.008789150044322014.
#   router: fma(bx, bx, by·by) = 0.043236587196588516 = the bound, while
#           bx² + by² and fma(by, by, bx²) give 0.043236590921878815.
FORM_CASES = {
    "tau": dict(a=0.09375, bx=0.0937504693865776, by=0.0),
    "router": dict(a=0.20793305337429047, bx=0.18103571236133575,
                   by=0.10228714346885681),
}


def _form_fleets(a, bx, by):
    f = np.float32
    pts_a = np.array([[-0.5, 0.0], [a, 0.0]], np.float32)
    pts_b = np.array([[bx, by], [f(bx) + f(0.1), f(by) + f(0.1)]],
                     np.float32)
    fleets = []
    for mod, part_cls, shard_cls, kw in (
            (jrtree, JPartition, JShards, {}),
            (trtree, TPartition, TShards, dict(device="cpu"))):
        parts = []
        for i, pts in enumerate((pts_a, pts_b)):
            rects = np.concatenate([pts, pts], axis=1)
            parts.append(part_cls(
                tree=mod.build_rtree(rects, fanout=FANOUT, **kw),
                mbr=np.concatenate([pts.min(0), pts.max(0)]), offset=i,
                ids=np.arange(2) + 2 * i))
        fleets.append(shard_cls(parts, FANOUT).enable_mesh())
    return fleets


def _plain_tau(kth):
    c = np.float32(1.0 + 1e-5)
    return torch.where(torch.isfinite(kth), kth * float(c)
                       + float(np.float32(1e-30)), kth)


def _plain_router(spec, queries, mbrs):
    dx = torch.clamp(torch.maximum(mbrs[None, :, 0] - queries[:, 0, None],
                                   queries[:, 0, None] - mbrs[None, :, 2]),
                     min=0.0)
    dy = torch.clamp(torch.maximum(mbrs[None, :, 1] - queries[:, 1, None],
                                   queries[:, 1, None] - mbrs[None, :, 3]),
                     min=0.0)
    return dx * dx + dy * dy


@pytest.mark.parametrize("case", sorted(FORM_CASES))
def test_mesh_pins_the_reference_programs_float32_forms(case, monkeypatch):
    jsh, tsh = _form_fleets(**FORM_CASES[case])
    q = np.zeros((1, 2), np.float32)
    jres, tres = jsh.knn(q, 1), tsh.knn(q, 1)
    _assert_same_public("knn", tres, jres, case)
    assert tres[0][0, 0] == 1            # A's point, whichever form
    _assert_counters(tsh.last_counters, jsh.last_counters, case)
    # the other form skips B's phase-2 descent: the counters tell
    visited = int(tsh.last_counters.nodes_visited)
    if case == "tau":
        monkeypatch.setattr(ttraversal, "collective_tau", _plain_tau)
    else:
        monkeypatch.setattr(ttraversal, "_route_mindist", _plain_router)
    tsh._mesh_programs.clear()
    _assert_same_public("knn", tsh.knn(q, 1), jres, f"{case}, other form")
    assert int(tsh.last_counters.nodes_visited) < visited, case


def test_mesh_join_row_blocks_change_nothing():
    """The mesh join scores its partitions' pair frontiers in blocks of
    rows once a level passes the lane budget: the pairs, counts and every
    counter equal one block's."""
    from repro_torch.core import join_vector
    rng, inst = _sharded_instance("join", 3, N, BATCH, K)
    tsh = _port_fleet(inst["rects"], PARTS)
    probe = trtree.build_rtree(inst["probe"], fanout=FANOUT, device="cpu")
    forest = tsh._forest
    outs = []
    for budget in (None, 1):
        fn = join_vector.make_join_bfs(
            probe, forest.flat, result_cap=inst["cap"], caps_mode="static",
            caps_tree=forest.partition_tree, lane_budget=budget)
        parts = torch.arange(forest.n_partitions, dtype=torch.int32)
        outs.append(fn(roots=(torch.zeros_like(parts), parts)))
    (p0, c0, k0), (p1, c1, k1) = outs
    _assert_same(p1, p0, "pairs")
    _assert_same(c1, c0, "counts")
    assert int(c0.sum()) > 0
    _assert_counters(k1, k0, "row blocks")
    # the D3 mesh join (dequantized boxes, the exact rects at the leaf)
    # answers the D1 mesh join's pairs
    d3 = _port_fleet(inst["rects"], PARTS, "d3")
    got = d3.join(inst["probe"], result_cap=inst["cap"])
    want = tsh.join(inst["probe"], result_cap=inst["cap"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] is False


# ---------------------------------------------------------------------------
# the distributed browse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["d1", "d3"])
def test_sharded_browse_equals_reference_cursor(layout):
    """20 steps of k = 32 (the pools run dry, so partitions resume
    different numbers of times): ids, distance bits, overflow per row, and
    each partition's descents and counters, every step."""
    rng = np.random.default_rng(11)
    rects = uniform_rects(rng, N, eps=0.002)
    qs = rng.random((BATCH, 2)).astype(np.float32)
    jcur = _shards_for(rects, PARTS, FANOUT, layout=layout).browse(qs, 32)
    tcur = _port_fleet(rects, PARTS, layout).browse(qs, 32)
    for step in range(20):
        ctx = f"{layout} step {step}"
        ji, jd = jcur.next_batch()
        ti, td = tcur.next_batch()
        _assert_same(ti, ji, f"{ctx}: ids")
        _assert_same(td, jd, f"{ctx}: dists")
        np.testing.assert_array_equal(tcur.overflow, jcur.overflow, ctx)
        _assert_same(tcur.state.descents, jcur.states.descents,
                     f"{ctx}: descents")
        _assert_counters(tcur.state.ctr, jcur.states.ctr, ctx)
        for f in ("lost", "emitted"):
            _assert_same(getattr(tcur.state, f),
                         np.asarray(getattr(jcur.states, f)).reshape(-1),
                         f"{ctx}: {f}")
    assert len(set(np.asarray(jcur.states.descents).tolist())) > 1
    assert tcur.descents == jcur.descents


def test_sharded_browse_tied_distances_no_duplicates():
    """8-way distance ties across the pop boundary: the pop removes
    exactly the (distance, id)-selected entries, as the reference's."""
    rng = np.random.default_rng(29)
    pts = np.repeat(rng.random((200, 2)).astype(np.float32), 8, axis=0)
    rects = np.concatenate([pts, pts], axis=1)
    qs = rng.random((4, 2)).astype(np.float32)
    jcur = _shards_for(rects, PARTS, FANOUT).browse(qs, 8)
    tcur = _port_fleet(rects, PARTS).browse(qs, 8)
    got = []
    for step in range(4):
        ji, jd = jcur.next_batch()
        ti, td = tcur.next_batch()
        _assert_same(ti, ji, f"step {step}: ids")
        _assert_same(td, jd, f"step {step}: dists")
        got.append(ti)
    ids = np.concatenate(got, axis=1)
    for row in ids:
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v), "duplicate emission"


def test_sharded_browse_permutation_invariant_and_needs_the_mesh():
    rng = np.random.default_rng(13)
    rects = uniform_rects(rng, N, eps=0.002)
    qs = rng.random((4, 2)).astype(np.float32)
    a = _port_fleet(rects, PARTS).browse(qs, 8)
    b = _port_fleet(rects, PARTS, order=rng.permutation(PARTS)).browse(qs, 8)
    for _ in range(3):
        ia, da = a.next_batch()
        ib, db = b.next_batch()
        _assert_same(ib, ia, "ids")
        _assert_same(db, da, "dists")
    host = TShards.build(rects, PARTS, fanout=FANOUT, device="cpu")
    with pytest.raises(RuntimeError, match="enable_mesh"):
        host.browse(qs, 8)
