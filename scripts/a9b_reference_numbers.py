#!/usr/bin/env python3
"""Print the reference's numbers that ``chip_smoke.py`` phase 30 holds the
port's D3 join to (``D3_JOIN_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/a9b_reference_numbers.py

Builds ``chip_smoke.py``'s join inputs with the JAX package: 2,000,000
uniform points (seed 0) in the 9 partitions of ``serve --partitions 8``
(fanout 64, sort_key "lx") and 200,000 probes of half-extent 0.002; joins
the probes with the centre partition on layout D3 (its jnp path: the
reference has no D3 join kernel) with ``result_cap`` 1,048,576, O3/O4 off
and on, static and adaptive caps, and D1 beside it.  It checks that the
kept numbers agree across the caps tiers and that D3's pairs, sorted,
equal D1's.  Prints the dict in ``chip_smoke.py``'s layout and the
seconds it took.
"""
import time

import numpy as np

from repro.core import join_vector, rtree
from repro.distributed.spatial_shard import SpatialShards
from repro_torch.launch import serve      # the served inputs (numpy only)

N, FANOUT, JOIN_CAP, QUERY_EPS, CENTRE = 2_000_000, 64, 1 << 20, 0.002, 4
KEPT = ("nodes_visited", "predicates", "vector_ops", "enqueued",
        "pruned_outer", "pruned_inner", "masked_waste")


def sorted_pairs(pairs, n):
    p = np.asarray(pairs)[:int(n)].astype(np.int64)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


def main():
    t0 = time.time()
    rects, probes = serve.make_join_inputs(N, 0, QUERY_EPS)
    shards = SpatialShards.build(rects, 8, fanout=FANOUT, sort_key="lx")
    part = shards.partitions[CENTRE]
    probe_tree = rtree.build_rtree(probes, fanout=FANOUT, sort_key="lx")
    out = {}
    for o34 in (False, True):
        d1 = None
        for layout in ("d1", "d3"):
            for caps_mode in ("static", "adaptive"):
                pairs, n, ctr = join_vector.make_join_bfs(
                    probe_tree, part.tree, layout=layout,
                    result_cap=JOIN_CAP, o3=o34, o4=o34,
                    caps_mode=caps_mode)()
                assert int(ctr.overflow) == 0, (layout, o34, caps_mode)
                p = sorted_pairs(pairs, n)
                if layout == "d1":
                    d1 = p
                    continue
                np.testing.assert_array_equal(p, d1)
                cell = dict(
                    counters={k: int(np.asarray(getattr(ctr, k)))
                              for k in KEPT},
                    live=np.asarray(ctr.lanes_live)[:3].tolist(),
                    padded=np.asarray(ctr.lanes_padded)[:3].tolist(),
                    pairs=int(n), pairs_sum=int(p.sum()))
                got = out.setdefault(("join", "d3", o34), cell)
                assert got == cell, (o34, caps_mode, got, cell)
    print(f"D3_JOIN_REF = {out!r}")
    print(f"# {time.time() - t0:.1f} s on the CPU")


if __name__ == "__main__":
    main()
