"""Port (repro_torch) ≡ reference (repro): the fleet's single-program
(mesh) path, cell by cell, on ``test_torch_mesh.py``'s helpers.

At the reference's oracle sizes (n = 4,000, fanout 16, 4 partitions,
batch 6, k = 8), for select, join, kNN, kNN-join and filtered kNN on D1
and D3: the port's mesh program equals the reference's (ids, counts,
distance bits, overflow, every ``Counters`` field but ``dispatches``),
equals the port's host path, and does not change under a partition
permutation.
"""
import jax.numpy as jnp
import pytest

from test_torch_mesh import (BATCH, FANOUT, K, N, PARTS, _assert_counters,
                             _assert_same, _assert_same_public, _port_fleet,
                             _public)
from oracle import _sharded_instance, _shards_for


CELLS = [(op, layout) for layout in ("d1", "d3")
         for op in ("select", "join", "knn", "knn_join", "knn_filtered")]


@pytest.mark.parametrize("op,layout", CELLS)
def test_mesh_equals_reference_host_and_permutation(op, layout):
    rng, inst = _sharded_instance(op, 0, N, BATCH, K)
    jsh = _shards_for(inst["rects"], PARTS, FANOUT, layout=layout)
    tsh = _port_fleet(inst["rects"], PARTS, layout)
    ctx = f"{op} {layout}"
    # the programs themselves: every output array and every counter
    if op == "join":
        jres, tres = _public(op, jsh, inst), _public(op, tsh, inst)
        _assert_same_public(op, tres, jres, f"{ctx} mesh vs reference")
        jctr, tctr = jsh.last_counters, tsh.last_counters
    else:
        params = dict(result_cap=inst["cap"]) if op == "select" \
            else dict(k=K)
        jout = jsh._mesh_program(op, **params)(jnp.asarray(inst["queries"]))
        tout = tsh._mesh_program(op, **params)(inst["queries"])
        for j, t, what in zip(jout[:2], tout[:2], ("ids", "counts/dists")):
            _assert_same(t, j, f"{ctx} mesh vs reference: {what}")
        jctr, tctr = jout[2], tout[2]
    assert int(tctr.overflow) == int(jctr.overflow), ctx
    _assert_counters(tctr, jctr, f"{ctx} mesh vs reference")
    # the public results: mesh ≡ the port's host path ≡ a permuted packing
    res = _public(op, tsh, inst)
    host = _public(op, tsh.host_view(), inst)
    _assert_same_public(op, res, host, f"{ctx} mesh vs host")
    perm = rng.permutation(len(tsh.partitions))
    permuted = _public(op, _port_fleet(inst["rects"], PARTS, layout,
                                       order=perm), inst)
    _assert_same_public(op, res, permuted, f"{ctx} permutation {perm}")
