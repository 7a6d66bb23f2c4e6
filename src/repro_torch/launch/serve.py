"""Spatial query service of the port: builds a spatially-partitioned
index fleet on the device (distributed/spatial_shard.py) and serves batched
range-select requests behind the straggler pool (runtime/straggler.py),
spatial joins of a probe relation against the fleet, batched exact kNN,
the batched kNN-join of query rects, filtered kNN (the k nearest inside a
per-query window), or resumable browse sessions (over one tree, or
distributed over the fleet on its mesh path).

    PYTHONPATH=src python -m repro_torch.launch.serve --n 200000 \\
        --partitions 8 --batches 20 --batch-size 64 --selectivity 0.001
    PYTHONPATH=src python -m repro_torch.launch.serve --mode join \\
        --n 200000 --join-cap 131072 --query-eps 0.002
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \\
        --n 2000000 --k 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn-join \\
        --n 2000000 --k 8 --query-eps 0.002
    PYTHONPATH=src python -m repro_torch.launch.serve --layout d3 \\
        --mode knn --n 2000000 --k 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn-filtered \\
        --n 2000000 --k 8 --filter-eps 0.2
    PYTHONPATH=src python -m repro_torch.launch.serve --mode browse \\
        --n 2000000 --k 8 --browse-steps 4
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \\
        --n 2000000 --k 8 --mesh on

Runs on ``cuda`` (the CUDA kernels) unless ``--device cpu`` is given (the
plain PyTorch twins); asking for ``cuda`` on a machine without CUDA
raises.  ``--mode spatial`` (the default), its alias ``select``, ``join``,
``knn``, ``knn-join``, ``knn-filtered`` and ``browse`` serve the spatial
fleet; ``--mode lm`` serves the LM decode path (the reduced tinyllama-1.1b
from ``--seed``: ``--batch-size`` prompts of 32 tokens, 16 new tokens
each, greedy) and prints tok/s.
``--mesh on`` serves the fleet through its single-program path (a packed
forest, one launch a level over partition × query; browse sessions are
distributed cursors over the partitions), ``--mesh off`` through the host
fan-out (browse from one tree over the whole dataset, as the reference
serves it off its mesh path); ``auto`` (the default) takes the mesh path
when more than one CUDA device is visible, so on one card the host path,
as the reference decides.  ``--layout`` picks the node layout, one of
``layout_names()``: ``d1`` (the default), the paper's ``d0`` (interleaved
entries) and ``d2`` (interleaved coordinate pairs), which have no kernel
and serve every mode with their own PyTorch math, or the quantized
``d3`` (its join, like the reference's, runs the dense tile in PyTorch
over the dequantized boxes and re-checks the leaf's exact rects).

``--queue`` serves the queueable modes (spatial/select, knn, knn-join,
knn-filtered) through the continuous-batching queue (launch/queue.py):
``--clients`` closed-loop client threads submit ``--batch-size``-row
requests that coalesce into power-of-two batches of up to ``--max-batch``
rows, ``--depth`` dispatches in flight per replica.  ``--replicas R`` on
the mesh path serves from R fleets on R devices
(``SpatialShards.replicate``), which the queue round-robins across and the
straggler pool re-issues between; R needs R visible devices of the fleet's
type, so one card takes one replica.  ``--chaos <spec>`` injects seeded
faults into the replicas (runtime/faults.py, e.g. ``kill:r1@5,crash:r0@3``)
and the run must end with no failed request, the queue degrading to the
host path when every replica's breaker is open.  ``--dryrun --queue``
holds every queued response to the direct call of the same fleet.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn --queue \
        --n 2000000 --k 8 --mesh on --clients 8 --max-batch 256
    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn --queue \
        --dryrun --device cpu --chaos crash:r0@3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import rtree, str_pack, traversal
from ..core.counters import Counters
from ..core.layouts import layout_names
from ..distributed.spatial_shard import SpatialShards
from ..runtime.straggler import ShardPool

# CLI mode → registered spec name ('spatial' is the historical alias)
MODE_TO_SPEC = {
    "spatial": "select",
    "select": "select",
    "join": "join",
    "knn": "knn",
    "knn-join": "knn_join",
    "knn-filtered": "knn_filtered",
    "browse": "browse",
}



def make_rects(n: int, seed: int) -> np.ndarray:
    """The served dataset: ``n`` uniform points as degenerate rects."""
    rng = np.random.default_rng(seed)
    return str_pack.points_to_rects(rng.random((n, 2), dtype=np.float32))


def make_join_inputs(n: int, seed: int, eps: float):
    """The served dataset and the join's probe relation, as the reference
    draws them from one generator: ``make_rects``'s ``n`` data points
    first, then ``max(n // 10, 64)`` probe points widened to rects of
    half-extent ``eps``.  Returns (rects, probes)."""
    rng = np.random.default_rng(seed)
    rects = str_pack.points_to_rects(rng.random((n, 2), dtype=np.float32))
    probe_pts = rng.random((max(n // 10, 64), 2), dtype=np.float32)
    e = np.float32(eps)
    return rects, np.concatenate([probe_pts - e, probe_pts + e], axis=-1)


def make_knn_inputs(n: int, seed: int, batches: int, batch_size: int):
    """The served dataset and the kNN query points, as the reference draws
    them from one generator: ``make_rects``'s ``n`` data points first, then
    (batches, batch_size, 2) uniform query points.  Returns (rects, qs)."""
    rng = np.random.default_rng(seed)
    rects = str_pack.points_to_rects(rng.random((n, 2), dtype=np.float32))
    return rects, rng.random((batches, batch_size, 2), dtype=np.float32)


def make_knn_join_inputs(n: int, seed: int, batches: int, batch_size: int,
                         eps: float):
    """The served dataset and the kNN-join's query rects, as the reference
    draws them from one generator: ``make_knn_inputs``' data points and
    query points, the latter as centres widened to rects of half-extent
    ``eps``.  Returns (rects, qs (batches, batch_size, 4))."""
    rects, centres = make_knn_inputs(n, seed, batches, batch_size)
    e = np.float32(eps)
    return rects, np.concatenate([centres - e, centres + e], axis=-1)


def make_knn_filtered_inputs(n: int, seed: int, batches: int,
                             batch_size: int, eps: float):
    """The served dataset and the filtered kNN's query rows, as the
    reference draws them from one generator: ``make_knn_inputs``' data and
    query points, each point followed by its window of half-extent
    ``eps``.  Returns (rects, qs (batches, batch_size, 6))."""
    rects, pts = make_knn_inputs(n, seed, batches, batch_size)
    e = np.float32(eps)
    return rects, np.concatenate([pts, pts - e, pts + e], axis=-1)


def make_queries(n: int, batch: int, selectivity: float, seed: int = 1):
    rng = np.random.default_rng(seed)
    side = float(np.sqrt(selectivity))
    lo = rng.random((n, batch, 2), dtype=np.float32) * (1 - side)
    return np.concatenate([lo, lo + side], axis=-1)


def _use_mesh(args) -> bool:
    """Serve through the mesh path?  ``--mesh on`` always, ``off`` never,
    ``auto`` when more than one CUDA device is visible (the reference's
    rule: more than one device)."""
    if args.mesh != "auto":
        return args.mesh == "on"
    return args.device == "cuda" and torch.cuda.device_count() > 1


def _build_shards(args, rects, sort_key=None):
    t0 = time.time()
    mesh = _use_mesh(args)
    shards = SpatialShards.build(rects, args.partitions, fanout=args.fanout,
                                 sort_key=sort_key, layout=args.layout,
                                 device=args.device, mesh=mesh or None)
    note = ", mesh path (one program a batch)" if mesh else ""
    print(f"built {len(shards.partitions)} partitions over {args.n} rects "
          f"on {args.device} in {time.time() - t0:.2f}s{note}")
    return shards


def _replica_fleet(args, shards):
    """The fleets the straggler pool or the serve queue dispatches over:
    ``--replicas R`` on the mesh path gives R fleets on R devices
    (``SpatialShards.replicate``), so a re-issue targets a distinct
    engine.  Off the mesh path, or with R <= 1, the one fleet serves alone
    and the pool skips the pointless self-re-issue."""
    r = args.replicas
    if r > 1 and _use_mesh(args):
        replicas = shards.replicate(replicas=r)
        print(f"replica fan-out: {r} fleets on "
              f"{', '.join(str(e.device) for e in replicas)}")
        return replicas
    return [shards]


def _serve_select(args, spec):
    """Distributed range select behind the straggler pool, one pool shard
    per replica fleet (``--replicas``): round-robin primaries, deadline
    re-issue to the next replica (with one fleet the pool never re-issues;
    its deadline and failure stats still apply).  Returns q/s, the total
    result rows, the overflow flag (any partition's frontier or result cap
    overflowed in any batch) and the first batch's results (per-query
    sorted global ids)."""
    shards = _build_shards(args, make_rects(args.n, args.seed))
    qs = make_queries(args.batches, args.batch_size, args.selectivity,
                      args.seed + 1)
    engines = _replica_fleet(args, shards)
    for e in engines:
        e.warm("select", args.batch_size)

    with ShardPool(shards=[e.range_select for e in engines],
                   deadline_s=args.deadline) as pool:
        t0 = time.time()
        total = 0
        first = None
        overflowed = False
        for b in range(args.batches):
            res = pool.query(b % len(engines), qs[b])
            first = res if first is None else first
            total += sum(len(r) for r in res)
            # a re-issue may have answered from another replica: any
            # replica's last batch overflowed (a stale flag was counted
            # when it was fresh)
            overflowed |= any(e.last_counters is not None
                              and bool(int(e.last_counters.overflow))
                              for e in engines)
        dt = time.time() - t0
    qps = args.batches * args.batch_size / dt
    print(f"served {args.batches} batches × {args.batch_size} queries in "
          f"{dt:.2f}s → {qps:,.0f} q/s, {total} result rows, "
          f"{pool.reissues} straggler re-issues, {pool.failures} failures"
          + (", WARNING: overflow — results may be truncated"
             if overflowed else ""))
    return {"qps": qps, "results": total, "overflow": overflowed,
            "first_batch": first}


def _serve_join(args, spec):
    """Spatial-join service: the probe relation joined against the
    partitioned data fleet, one pair engine per partition, with the O3/O4
    sorted-key pruning (fleet and probe tree built with sort_key='lx').
    Returns joins/s, the total pair rows, the overflow flag, and the last
    join's (K, 2) (probe id, global data id) pairs."""
    rects, probes = make_join_inputs(args.n, args.seed, args.query_eps)
    shards = _build_shards(args, rects, sort_key="lx")
    probe_tree = rtree.build_rtree(probes, fanout=args.fanout, sort_key="lx",
                                   device=args.device)
    shards.warm("join", args.batch_size, probe=probe_tree,
                result_cap=args.join_cap, o3=True, o4=True)
    t0 = time.time()
    total = 0
    overflowed = False
    merge_s = 0.0
    for _ in range(args.batches):
        pairs, ovf = shards.join(probe_tree, result_cap=args.join_cap,
                                 o3=True, o4=True)
        total += len(pairs)
        overflowed |= ovf
        merge_s += shards.last_merge_s
    dt = time.time() - t0
    jps = args.batches / dt
    print(f"served {args.batches} joins × {len(probes)} probes in {dt:.2f}s "
          f"→ {jps:,.2f} joins/s, {total} pair rows, host merge "
          f"{merge_s:.2f}s ({merge_s / dt:.1%})"
          + (", WARNING: pair-frontier overflow" if overflowed else ""))
    return {"joins_per_s": jps, "pairs": total, "overflow": overflowed,
            "merge_s": merge_s, "last_pairs": pairs}


def _serve_knn(args, spec):
    """Batched exact kNN over the partitioned fleet: each query's primary
    partition, then the partitions within its k-th distance, merged by
    (distance, global id).  One fleet and no spare replica, so batches are
    served directly (the straggler pool could only re-issue the same call).
    Returns q/s, the neighbour rows returned, the overflow flag, and the
    first batch's (ids, dists)."""
    rects, qs = make_knn_inputs(args.n, args.seed, args.batches,
                                args.batch_size)
    shards = _build_shards(args, rects)
    shards.warm("knn", args.batch_size, k=args.k)
    t0 = time.time()
    returned = 0
    overflowed = False
    first = None
    for b in range(args.batches):
        ids, dists, ovf = shards.knn(qs[b], args.k)
        first = (ids, dists) if first is None else first
        returned += int((ids >= 0).sum())
        overflowed |= ovf
    dt = time.time() - t0
    qps = args.batches * args.batch_size / dt
    print(f"served {args.batches} batches × {args.batch_size} kNN queries "
          f"(k={args.k}) in {dt:.2f}s → {qps:,.0f} q/s, {returned} neighbor "
          f"rows"
          + (", WARNING: frontier overflow — results may be approximate"
             if overflowed else ""))
    return {"qps": qps, "neighbors": returned, "overflow": overflowed,
            "first_batch": first}


def _serve_knn_join(args, spec):
    """Batched kNN-join: for each query rect (half-extent ``--query-eps``),
    its k nearest data rects across the fleet under rect-to-rect MINDIST,
    routed in two phases as kNN.  Returns q/s, the neighbour rows
    returned, the overflow flag, and the first batch's (ids, dists)."""
    rects, qs = make_knn_join_inputs(args.n, args.seed, args.batches,
                                     args.batch_size, args.query_eps)
    shards = _build_shards(args, rects)
    shards.warm("knn_join", args.batch_size, k=args.k)
    t0 = time.time()
    returned = 0
    overflowed = False
    first = None
    for b in range(args.batches):
        ids, dists, ovf = shards.knn_join(qs[b], args.k)
        first = (ids, dists) if first is None else first
        returned += int((ids >= 0).sum())
        overflowed |= ovf
    dt = time.time() - t0
    qps = args.batches * args.batch_size / dt
    print(f"served {args.batches} batches × {args.batch_size} kNN-join "
          f"queries (k={args.k}, eps={args.query_eps}) in {dt:.2f}s → "
          f"{qps:,.0f} q/s, {returned} neighbor rows"
          + (", WARNING: beam truncation — results may be approximate"
             if overflowed else ""))
    return {"qps": qps, "neighbors": returned, "overflow": overflowed,
            "first_batch": first}


def _serve_knn_filtered(args, spec):
    """Filtered kNN over the partitioned fleet: each query's k nearest
    data rects among those intersecting its window (half-extent
    ``--filter-eps``), routed in two phases on the point columns as kNN.
    Returns q/s, the neighbour rows returned, the overflow flag, and the
    first batch's (ids, dists)."""
    rects, qs = make_knn_filtered_inputs(args.n, args.seed, args.batches,
                                         args.batch_size, args.filter_eps)
    shards = _build_shards(args, rects)
    shards.warm("knn_filtered", args.batch_size, k=args.k)
    t0 = time.time()
    returned = 0
    overflowed = False
    first = None
    for b in range(args.batches):
        ids, dists, ovf = shards.knn_filtered(qs[b], args.k)
        first = (ids, dists) if first is None else first
        returned += int((ids >= 0).sum())
        overflowed |= ovf
    dt = time.time() - t0
    qps = args.batches * args.batch_size / dt
    print(f"served {args.batches} batches × {args.batch_size} filtered-kNN "
          f"queries (k={args.k}, window ±{args.filter_eps}) in {dt:.2f}s → "
          f"{qps:,.0f} q/s, {returned} neighbor rows"
          + (", WARNING: frontier overflow — results may be approximate"
             if overflowed else ""))
    return {"qps": qps, "neighbors": returned, "overflow": overflowed,
            "first_batch": first}


def _serve_browse(args, spec):
    """Browse sessions: each request opens a session over its query batch
    and takes ``--browse-steps`` batches of k neighbours.  On the mesh path
    a session is a distributed cursor over the fleet (one cursor a
    partition, a cross-partition pool merge a batch); off it, a cursor on
    one tree of the whole dataset (the reference's path off its mesh).
    Returns sessions·q/s, the neighbour rows returned, the overflow flag (a
    lost bound crossed), and the first session's (ids, dists), each (B,
    browse_steps·k)."""
    from ..core import knn_browse

    rects, qs = make_knn_inputs(args.n, args.seed, args.batches,
                                args.batch_size)
    if _use_mesh(args):
        shards = _build_shards(args, rects)

        def start(points):
            return shards.browse(points, args.k)
        kind = "distributed browse"
    else:
        t0 = time.time()
        tree = rtree.build_rtree(rects, fanout=args.fanout,
                                 device=args.device)
        print(f"built tree over {args.n} rects on {args.device} in "
              f"{time.time() - t0:.2f}s")
        start = knn_browse.make_browse_bfs(tree, args.k, layout=args.layout)
        kind = "browse"

    def session(points):
        cursor = start(points)
        out = [cursor.next_batch() for _ in range(args.browse_steps)]
        return (np.concatenate([i for i, _ in out], axis=1),
                np.concatenate([d for _, d in out], axis=1),
                bool(cursor.overflow.any()))

    session(qs[0])                  # warm: one session at the served shape
    t0 = time.time()
    returned = 0
    overflowed = False
    first = None
    for b in range(args.batches):
        ids, dists, ovf = session(qs[b])
        first = (ids, dists) if first is None else first
        returned += int((ids >= 0).sum())
        overflowed |= ovf
    dt = time.time() - t0
    qps = args.batches * args.batch_size / dt
    print(f"served {args.batches} {kind} sessions × {args.batch_size} "
          f"queries × {args.browse_steps} batches of k={args.k} in "
          f"{dt:.2f}s → {qps:,.0f} sessions·q/s, {returned} neighbor rows"
          + (", WARNING: lost-bound crossed — results may be approximate"
             if overflowed else ""))
    return {"qps": qps, "neighbors": returned, "overflow": overflowed,
            "first_batch": first}


def _queued_payloads(args, op):
    """The served dataset, the per-request query arrays and the operator
    params of the queued runner: the synchronous runners' draws, so request
    ``i`` is batch ``i`` of the mode's synchronous run.  Returns (rects,
    payloads, params)."""
    if op == "select":
        return (make_rects(args.n, args.seed),
                list(make_queries(args.batches, args.batch_size,
                                  args.selectivity, args.seed + 1)), {})
    if op == "knn":
        rects, qs = make_knn_inputs(args.n, args.seed, args.batches,
                                    args.batch_size)
    elif op == "knn_join":
        rects, qs = make_knn_join_inputs(args.n, args.seed, args.batches,
                                         args.batch_size, args.query_eps)
    elif op == "knn_filtered":
        rects, qs = make_knn_filtered_inputs(args.n, args.seed, args.batches,
                                             args.batch_size, args.filter_eps)
    else:
        raise ValueError(f"no queued payload builder for {op!r}")
    return rects, list(qs), {"k": args.k}


def _cpu_counters(ctr):
    """``ctr`` with its tensors on the host, so replicas on several
    devices can be summed."""
    return Counters(*[v.cpu() if torch.is_tensor(v) else v
                      for v in ctr.values()])


def _serve_queued(args, spec):
    """Continuous-batching service: ``--clients`` closed-loop client
    threads submit their requests through one ServeQueue
    (launch/queue.py), which coalesces concurrent arrivals into
    power-of-two batches and serves each with one dispatch, over
    ``--replicas`` fleets behind the straggler pool, ``--depth`` batches
    in flight per replica.  Returns q/s, dispatches, rows per dispatch,
    re-issues, the pool's failures, the queue's retries, dispatch
    failures, degraded dispatches and quarantines, the failed requests
    (with ``--chaos`` also the injected faults and the deadline failures),
    and ``results``: request index → response (select: the per-query id
    arrays; the distance modes: (ids, dists, overflow))."""
    import concurrent.futures as cf

    from .queue import ServeQueue

    op = spec.name
    rects, payloads, qparams = _queued_payloads(args, op)
    shards = _build_shards(args, rects)
    engines = _replica_fleet(args, shards)
    # warm every power-of-two bucket a batch can land in: the coalesced
    # ones up to --max-batch's, and a lone request's own
    bk = 1 << (args.batch_size - 1).bit_length()
    top = max(1 << (args.max_batch - 1).bit_length(), bk)
    while bk <= top:
        for e in engines:
            e.warm(op, bk, **qparams)
        bk <<= 1

    injector = None
    if args.chaos:
        from ..runtime.faults import FaultInjector, FaultPlan
        injector = FaultInjector(FaultPlan.from_spec(args.chaos,
                                                     seed=args.seed))
        print(f"chaos: injecting {injector.plan} (seed {args.seed})")

    n_clients = max(1, min(args.clients, args.batches))

    with ServeQueue(engines, op, max_batch=args.max_batch,
                    max_delay_s=args.max_delay, depth=args.depth,
                    deadline_s=args.deadline, injector=injector,
                    fallback=shards.host_view(), seed=args.seed,
                    **qparams) as q:

        errors = []

        def client(cid):
            # closed loop: each client waits for its response before
            # issuing the next request
            out = []
            for i in range(cid, args.batches, n_clients):
                try:
                    out.append((i, q.query(payloads[i])))
                except Exception as exc:     # counted as a failed request
                    errors.append((i, exc))
            return out

        t0 = time.time()
        with cf.ThreadPoolExecutor(n_clients) as ex:
            parts = list(ex.map(client, range(n_clients)))
        dt = time.time() - t0
        results = dict(pair for part in parts for pair in part)
        # settle the pool: every engine call's outcome recorded before the
        # counters are read
        q.close()
        q.pool.shutdown(wait=True)
        summary = q.summary

    if errors and not args.chaos:
        # without injection a request failure is a real bug: keep it loud
        raise errors[0][1]

    if args.dryrun:
        # bit-exact parity with direct per-request calls on the base fleet
        for i, p in enumerate(payloads):
            if i not in results:
                continue                     # failed under chaos (asserted)
            if op == "select":
                ref = shards.range_select(p)
                for got_row, ref_row in zip(results[i], ref):
                    np.testing.assert_array_equal(got_row, ref_row)
            else:
                ids, d, _ = results[i]
                ref_ids, ref_d, _ = getattr(shards, op)(p, args.k)
                np.testing.assert_array_equal(ids, ref_ids)
                np.testing.assert_array_equal(d, ref_d)

    qps = args.batches * args.batch_size / dt
    print(f"queued {args.batches} requests × {args.batch_size} rows from "
          f"{n_clients} clients over {len(engines)} replica(s) in "
          f"{dt:.2f}s → {qps:,.0f} q/s; "
          f"{summary.get('batches', 0)} dispatches, "
          f"{summary.get('rows_per_dispatch', 0):.0f} rows/dispatch, "
          f"{summary['reissues']} re-issues, {summary['failures']} failures")
    out = {"qps": qps, "dispatches": summary.get("batches", 0),
           "rows_per_dispatch": summary.get("rows_per_dispatch", 0.0),
           "reissues": summary["reissues"],
           "failures": summary["failures"],
           "failed_requests": len(errors),
           "retries": summary["retries"],
           "dispatch_failures": summary["dispatch_failures"],
           "degraded_dispatches": summary["degraded_dispatches"],
           "quarantines": summary["quarantines"],
           "results": results}
    # frontier occupancy across the fleet: each replica's last_counters
    # carries the live/padded lane tallies of its last batch
    ctrs = [_cpu_counters(e.last_counters) for e in engines
            if e.last_counters is not None]
    if ctrs:
        total = ctrs[0]
        for c in ctrs[1:]:
            total = total + c
        occ = total.occupancy()
        esc = int(torch.as_tensor(total.escalations).sum())
        out["occupancy"] = occ
        out["escalations"] = esc
        print(f"frontier occupancy {occ:.1%} "
              f"(live/(live+padded) lanes over the last batch per replica); "
              f"{esc} overflow escalation(s)")
    if args.chaos:
        print(f"chaos: {injector.injected['exceptions']} injected "
              f"exceptions, {injector.injected['delays']} injected delays "
              f"→ {summary['retries']} retries, {summary['quarantines']} "
              f"quarantine(s), {summary['degraded_dispatches']} degraded "
              f"dispatches, {summary['deadline_exceeded']} deadline "
              f"failures; health: {summary['health']}; "
              f"{out['failed_requests']} failed requests")
        out.update(
            injected_exceptions=injector.injected["exceptions"],
            injected_delays=injector.injected["delays"],
            deadline_exceeded=summary["deadline_exceeded"])
        # the robustness contract: chaos must never surface to clients
        if out["failed_requests"]:
            raise RuntimeError(f"{out['failed_requests']} requests failed "
                               f"under chaos: {errors[0][1]!r}")
        if args.dryrun and not (injector.injected["exceptions"]
                                + injector.injected["delays"]):
            # a smoke whose plan never fired proves nothing: the dryrun
            # caps (batches, max_batch) are sized so its clauses arm
            raise RuntimeError("chaos dryrun injected nothing: the plan "
                               "never armed")
    return out


def _serve_lm(args):
    """The LM decode service: the reduced tinyllama-1.1b with weights from
    ``--seed`` (drawn on the CPU, so every device serves the same model),
    ``--batch-size`` prompts of 32 tokens drawn from the same seed, 16 new
    tokens each (greedy) on ``--device``.  Returns tok/s and the generated
    tokens (B, 16)."""
    from ..configs import registry
    from ..models.model import Model
    from ..serve.serve_step import generate

    dev = torch.device(args.device)
    cfg = registry.reduced_config(registry.get("tinyllama-1.1b"))
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(args.seed),
                               device=dev)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, cfg.vocab, (args.batch_size, 32), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    t0 = time.time()
    out = generate(model, params, batch, n_new=16).cpu().numpy()
    dt = time.time() - t0
    tps = args.batch_size * 16 / dt
    print(f"LM decode service: {args.batch_size} seqs × 16 new tokens in "
          f"{dt:.2f}s → {tps:,.0f} tok/s on {args.device}; sample: "
          f"{out[0][:8]}")
    return {"tok_per_s": tps, "tokens": out}


RUNNERS = {
    "select": _serve_select,
    "join": _serve_join,
    "knn": _serve_knn,
    "knn_join": _serve_knn_join,
    "knn_filtered": _serve_knn_filtered,
    "browse": _serve_browse,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="spatial",
                    choices=sorted(MODE_TO_SPEC) + ["lm"])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--fanout", type=int, default=64)
    ap.add_argument("--layout", default="d1", choices=layout_names(),
                    help="physical node layout for the whole fleet")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--selectivity", type=float, default=0.001)
    ap.add_argument("--k", type=int, default=8,
                    help="neighbours per query (knn, knn-join, knn-filtered "
                         "modes) and per browse batch")
    ap.add_argument("--filter-eps", type=float, default=0.2,
                    help="half-extent of the per-query filter window "
                         "(knn-filtered mode)")
    ap.add_argument("--browse-steps", type=int, default=4,
                    help="next_batch() calls per browse session")
    ap.add_argument("--join-cap", type=int, default=1 << 17,
                    help="result-pair capacity (join mode)")
    ap.add_argument("--query-eps", type=float, default=0.002,
                    help="half-extent of the probe rects (join mode) and "
                         "of the query rects (knn-join mode)")
    ap.add_argument("--deadline", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="auto", choices=("auto", "on", "off"),
                    help="the fleet's single-program path (one launch a "
                         "level over partition × query) or the host "
                         "fan-out; auto: the mesh path when more than one "
                         "CUDA device is visible")
    ap.add_argument("--queue", action="store_true",
                    help="continuous batching: coalesce concurrent client "
                         "requests into power-of-two batches, one dispatch "
                         "each (launch/queue.py; spatial/select, knn, "
                         "knn-join, knn-filtered)")
    ap.add_argument("--clients", type=int, default=8,
                    help="closed-loop client threads driving the queue")
    ap.add_argument("--chaos", default="",
                    help="seeded fault-injection spec for the queued "
                         "replicas (runtime/faults.py): comma-separated "
                         "kill:rI@N, crash:rI@N, slow:rI@N:SECS, "
                         "flaky:rI:P, spike:rI:P:SECS; the run fails on "
                         "any client-visible failure")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica fleets, one a device (mesh path only); "
                         "the straggler pool re-issues across them")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="coalescing target in query rows per dispatch")
    ap.add_argument("--max-delay", type=float, default=0.002,
                    help="max seconds the queue waits to fill a batch")
    ap.add_argument("--depth", type=int, default=2,
                    help="in-flight dispatches per replica (2 = double-"
                         "buffered)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fleet lives and the queries run: cuda "
                         "runs the CUDA kernels, cpu their PyTorch twins")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny sizes: the smoke that runs serve end to end")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    if args.dryrun:
        args.n = min(args.n, 2000)
        args.partitions = min(args.partitions, 2)
        args.fanout = min(args.fanout, 16)
        # chaos smokes need enough dispatches for @N clauses to arm and for
        # the breaker to trip, and coalescing must not fold the whole run
        # into a handful of dispatches: under chaos one request a dispatch
        args.batches = min(args.batches,
                           20 if args.chaos else (4 if args.queue else 2))
        args.batch_size = min(args.batch_size, 8)
        args.join_cap = min(args.join_cap, 1 << 15)
        args.k = min(args.k, 4)
        args.browse_steps = min(args.browse_steps, 2)
        args.max_batch = min(args.max_batch,
                             args.batch_size if args.chaos else 32)
        args.clients = min(args.clients, 4)
        # slow shared smoke boxes: a lapsed deadline would only add
        # spurious re-issue work, never find a bug
        args.deadline = max(args.deadline, 60.0)

    if args.mode == "lm":
        return _serve_lm(args)
    spec = traversal.get_spec(MODE_TO_SPEC[args.mode])
    missing = set(traversal.spec_names()) - set(RUNNERS)
    assert not missing, f"registered specs without a serve runner: {missing}"
    if args.queue:
        from .queue import QUEUEABLE_OPS
        if spec.name in QUEUEABLE_OPS:
            return _serve_queued(args, spec)
        print(f"--queue: {spec.name} does not coalesce (session/query-less "
              f"operator); serving synchronously")
    return RUNNERS[spec.name](args, spec)


if __name__ == "__main__":
    main()
