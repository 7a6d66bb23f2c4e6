#!/usr/bin/env python3
"""Print the reference's numbers that ``chip_smoke.py`` phases 27–28 hold
the port to (``BASELINE_REF``, ``LAYOUT_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/a9a_reference_numbers.py

Builds ``chip_smoke.py``'s phase-3 tree (2,000,000 uniform points, seed 0,
fanout 64) with the JAX package.

Phase 27 (the paper's baselines): the jitted DFS walks ``make_select_dfs``
(S) and ``make_select_dfs_vector`` (V) over the first served select batch
(64 queries of selectivity 0.001) with ``result_cap`` 4096 and the default
stack, and with ``stack_cap`` 8 and ``result_cap`` 64 (the forced
overflow), each summed over the queries; ``select_recursive_py`` logical
and bitwise over the first 4 queries; ``knn_best_first`` over the first 4
served kNN points and ``knn_join_best_first`` over the first 4 served
kNN-join rects, k = 8; ``join_recursive_py`` with O3 off and on at
``benchmarks/bench_join.py``'s configuration (n = 100,000 points per
side, half-extent 0.0005, fanout 64, sort_key "lx").

Phase 28 (layouts D0 and D2, the reference's jnp path): select on that
batch (result_cap 4096, static and adaptive caps), the join of the
200,000 probes (half-extent 0.002) against the centre partition of
``serve --partitions 8`` (result_cap 1,048,576, O3/O4 off and on), kNN and
kNN-join on the first served batches (k in {8, 64}, static and adaptive),
filtered kNN (windows of half-extent 0.2, k in {8, 64}) and browse
sessions of 4 and 72 steps (k = 8).  It checks that the kept numbers agree
across the caps tiers (padded slots are kept per tier).  Prints the dicts
in ``chip_smoke.py``'s layout and the seconds each part took.
"""
import sys
import time

import jax.numpy as jnp
import numpy as np

from repro.core import (flat, join_scalar, join_vector, knn_browse,
                        knn_filtered, knn_join_scalar, knn_join_vector,
                        knn_scalar, knn_vector, rtree, select_scalar,
                        select_vector)
from repro.distributed.spatial_shard import SpatialShards
from repro_torch.launch import serve      # the served inputs (numpy only)

N, FANOUT, BATCH, SELECTIVITY, RESULT_CAP, K = \
    2_000_000, 64, 64, 1e-3, 4096, 8
JOIN_CAP, QUERY_EPS, CENTRE, FILTER_EPS = 1 << 20, 0.002, 4, 0.2
SCALAR_JOIN_N, SCALAR_JOIN_EPS = 100_000, 0.0005
KEPT = ("nodes_visited", "predicates", "vector_ops", "enqueued",
        "pruned_outer", "pruned_inner", "masked_waste")


def summary(ctr, steps=4):
    return ({k: int(np.asarray(getattr(ctr, k))) for k in KEPT},
            np.asarray(ctr.lanes_live)[:steps].tolist(),
            np.asarray(ctr.lanes_padded)[:steps].tolist())


def sums(ids, d=None):
    ids = np.asarray(ids)
    found = ids >= 0
    out = dict(ids_sum=int(ids[found].astype(np.int64).sum()),
               found=int(found.sum()))
    if d is not None:
        out["d_sum"] = float(np.asarray(d)[found].astype(np.float64).sum())
    return out


def scalar_ctr(ctr):
    return {k: int(v) for k, v in ctr.asdict().items()
            if k in KEPT + ("branches", "overflow") and int(v)}


def point_rects(n, seed, eps):
    """``benchmarks.common.point_rects``: uniform points widened to rects
    of half-extent ``eps``."""
    pts = np.random.default_rng(seed).random((n, 2), dtype=np.float32)
    return np.concatenate([pts - eps, pts + eps], axis=1).astype(np.float32)


def baselines(tree, qs, pts, qrects):
    out = {}
    ft = flat.flatten_tree(tree)
    for variant, make in (("scalar", select_scalar.make_select_dfs),
                          ("vector", select_vector.make_select_dfs_vector)):
        for stack_cap, result_cap in ((1024, RESULT_CAP), (8, 64)):
            fn = make(ft, result_cap, stack_cap)
            tot = dict(rc=0, nodes_visited=0, predicates=0, overflow=0)
            for q in qs:
                _, rc, ctr = fn(jnp.asarray(q))
                tot["rc"] += int(rc)
                for k in ("nodes_visited", "predicates", "overflow"):
                    tot[k] += int(np.asarray(getattr(ctr, k)))
            out[(variant, stack_cap, result_cap)] = tot
    for variant in ("logical", "bitwise"):
        tot = {}
        for q in qs[:4]:
            ids, ctr = select_scalar.select_recursive_py(tree, q, variant)
            for k, v in dict(scalar_ctr(ctr), ids_sum=int(ids.sum()),
                             found=len(ids)).items():
                tot[k] = tot.get(k, 0) + v
        out[("recursive", variant)] = tot
    fn = knn_scalar.make_knn_best_first(tree)
    tot = {}
    for p in pts[:4]:
        ids, d, ctr = fn(p, K)
        for k, v in dict(scalar_ctr(ctr), **sums(ids, d)).items():
            tot[k] = tot.get(k, 0) + v
    out[("knn_best_first", K)] = tot
    ids, d, ctr = knn_join_scalar.knn_join_best_first(tree, qrects[:4], K)
    out[("knn_join_best_first", K)] = dict(scalar_ctr(ctr), **sums(ids, d))
    ta, tb = (rtree.build_rtree(point_rects(SCALAR_JOIN_N, s,
                                            SCALAR_JOIN_EPS),
                                fanout=FANOUT, sort_key="lx")
              for s in (0, 1))
    for o3 in (False, True):
        t0 = time.time()
        pairs, ctr = join_scalar.join_recursive_py(ta, tb, o3=o3)
        out[("join_recursive", o3)] = dict(
            scalar_ctr(ctr), pairs=len(pairs),
            pairs_sum=int(pairs.astype(np.int64).sum()))
        print(f"# join_recursive_py o3={o3}: {time.time() - t0:.1f} s",
              file=sys.stderr)
    return out


def engines(tree, qs, pts, qrects, fq):
    out = {}
    for layout in ("d0", "d2"):
        padded = {}
        for caps_mode in ("static", "adaptive"):
            ids, counts, ctr = select_vector.make_select_bfs(
                tree, layout=layout, result_cap=RESULT_CAP,
                caps_mode=caps_mode)(jnp.asarray(qs))
            c, live, pad = summary(ctr)
            assert int(ctr.overflow) == 0, (layout, caps_mode)
            cell = dict(counters=c, live=live, **sums(ids),
                        counts_sum=int(np.asarray(counts).sum()))
            got = out.setdefault(("select", layout), cell)
            assert got == cell, (layout, caps_mode, got, cell)
            padded[caps_mode] = pad
        out[("select", layout)]["padded"] = padded
        for op, make, q in (
                ("knn", knn_vector.make_knn_bfs, pts),
                ("knn_join", knn_join_vector.make_knn_join_bfs, qrects),
                ("knn_filtered", knn_filtered.make_knn_filtered_bfs, fq)):
            for k in (K, 64):
                padded = {}
                for caps_mode in ("static", "adaptive"):
                    ids, d, ctr = make(tree, k, layout=layout,
                                       caps_mode=caps_mode)(jnp.asarray(q))
                    c, live, pad = summary(ctr)
                    assert int(ctr.overflow) == 0, (op, layout, k)
                    cell = dict(counters=c, live=live, **sums(ids, d))
                    got = out.setdefault((op, layout, k), cell)
                    assert got == cell, (op, layout, k, caps_mode)
                    padded[caps_mode] = pad
                out[(op, layout, k)]["padded"] = padded
        start = knn_browse.make_browse_bfs(tree, K, layout=layout)
        for steps in (4, 72):
            cur = start(jnp.asarray(pts))
            got = [cur.next_batch() for _ in range(steps)]
            ids = np.concatenate([i for i, _ in got], axis=1)
            d = np.concatenate([x for _, x in got], axis=1)
            st = cur.state
            c, live, pad = summary(st.ctr)
            out[("browse", layout, steps)] = dict(
                counters=c, live=live, padded=pad, **sums(ids, d),
                descents=int(st.descents),
                overflow=int(np.asarray(st.overflow).sum()))
    return out


def joins(rects, probes):
    out = {}
    shards = SpatialShards.build(rects, 8, fanout=FANOUT, sort_key="lx")
    part = shards.partitions[CENTRE]
    probe_tree = rtree.build_rtree(probes, fanout=FANOUT, sort_key="lx")
    for layout in ("d0", "d2"):
        for o34 in (False, True):
            pairs, n, ctr = join_vector.make_join_bfs(
                probe_tree, part.tree, layout=layout, result_cap=JOIN_CAP,
                o3=o34, o4=o34, caps_mode="static")()
            c, live, _ = summary(ctr, steps=3)
            assert int(ctr.overflow) == 0, (layout, o34)
            p = np.asarray(pairs)[:int(n)]
            out[("join", layout, o34)] = dict(
                counters=c, live=live, pairs=int(n),
                pairs_sum=int(p.astype(np.int64).sum()))
    return out


def main():
    t0 = time.time()
    rects = serve.make_rects(N, 0)
    tree = rtree.build_rtree(rects, fanout=FANOUT)
    qs = serve.make_queries(1, BATCH, SELECTIVITY, 1)[0]
    _, pts = serve.make_knn_inputs(N, 0, 1, BATCH)
    _, qrects = serve.make_knn_join_inputs(N, 0, 1, BATCH, QUERY_EPS)
    _, fq = serve.make_knn_filtered_inputs(N, 0, 1, BATCH, FILTER_EPS)
    parts = sys.argv[1:] or ["baselines", "engines", "joins"]
    if "baselines" in parts:
        print(f"BASELINE_REF = {baselines(tree, qs, pts[0], qrects[0])!r}")
        print(f"# baselines: {time.time() - t0:.1f} s", file=sys.stderr)
    if "engines" in parts:
        t1 = time.time()
        print(f"LAYOUT_REF = {engines(tree, qs, pts[0], qrects[0], fq[0])!r}")
        print(f"# engines: {time.time() - t1:.1f} s", file=sys.stderr)
    if "joins" in parts:
        t1 = time.time()
        rects, probes = serve.make_join_inputs(N, 0, QUERY_EPS)
        print(f"LAYOUT_JOIN_REF = {joins(rects, probes)!r}")
        print(f"# joins: {time.time() - t1:.1f} s", file=sys.stderr)
    print(f"# {time.time() - t0:.1f} s on the CPU")


if __name__ == "__main__":
    main()
