"""Spatial query service of the port: builds a spatially-partitioned
index fleet on the device (distributed/spatial_shard.py) and serves batched
range-select requests behind the straggler pool (runtime/straggler.py).

    PYTHONPATH=src python -m repro_torch.launch.serve --n 200000 \\
        --partitions 8 --batches 20 --batch-size 64 --selectivity 0.001

Runs on ``cuda`` (the CUDA select kernels) unless ``--device cpu`` is given
(the plain PyTorch twins); asking for ``cuda`` on a machine without CUDA
raises.  ``--mode spatial`` (the default) and its alias ``select`` are
ported; the other modes of the reference exit with a "not ported yet"
message naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import str_pack, traversal
from ..core.layouts import layout_names
from ..distributed.spatial_shard import SpatialShards
from ..runtime.straggler import ShardPool

# CLI mode → registered spec name ('spatial' is the historical alias)
MODE_TO_SPEC = {
    "spatial": "select",
    "select": "select",
}

# modes of the reference that later slices port
NOT_PORTED = {
    "join": "A6", "knn": "A7", "knn-join": "A8", "knn-filtered": "A10",
    "browse": "A10", "lm": "A14",
}


def make_rects(n: int, seed: int) -> np.ndarray:
    """The served dataset: ``n`` uniform points as degenerate rects."""
    rng = np.random.default_rng(seed)
    return str_pack.points_to_rects(rng.random((n, 2), dtype=np.float32))


def make_queries(n: int, batch: int, selectivity: float, seed: int = 1):
    rng = np.random.default_rng(seed)
    side = float(np.sqrt(selectivity))
    lo = rng.random((n, batch, 2), dtype=np.float32) * (1 - side)
    return np.concatenate([lo, lo + side], axis=-1)


def _build_shards(args):
    rects = make_rects(args.n, args.seed)
    t0 = time.time()
    shards = SpatialShards.build(rects, args.partitions, fanout=args.fanout,
                                 layout=args.layout, device=args.device)
    print(f"built {len(shards.partitions)} partitions over {args.n} rects "
          f"on {args.device} in {time.time() - t0:.2f}s")
    return rects, shards


def _serve_select(args, spec):
    """Distributed range select behind the straggler pool (one fleet, so
    the pool never re-issues; its deadline and failure stats still
    apply).  Returns q/s, the total result rows and the first batch's
    results (per-query sorted global ids)."""
    _, shards = _build_shards(args)
    qs = make_queries(args.batches, args.batch_size, args.selectivity,
                      args.seed + 1)
    shards.warm("select", args.batch_size)

    with ShardPool(shards=[shards.range_select],
                   deadline_s=args.deadline) as pool:
        t0 = time.time()
        total = 0
        first = None
        for b in range(args.batches):
            res = pool.query(0, qs[b])
            first = res if first is None else first
            total += sum(len(r) for r in res)
        dt = time.time() - t0
    qps = args.batches * args.batch_size / dt
    print(f"served {args.batches} batches × {args.batch_size} queries in "
          f"{dt:.2f}s → {qps:,.0f} q/s, {total} result rows, "
          f"{pool.reissues} straggler re-issues, {pool.failures} failures")
    return {"qps": qps, "results": total, "first_batch": first}


RUNNERS = {
    "select": _serve_select,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="spatial",
                    choices=sorted(MODE_TO_SPEC) + sorted(NOT_PORTED))
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--fanout", type=int, default=64)
    ap.add_argument("--layout", default="d1", choices=layout_names(),
                    help="physical node layout for the whole fleet")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--selectivity", type=float, default=0.001)
    ap.add_argument("--deadline", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fleet lives and the queries run: cuda "
                         "runs the CUDA kernels, cpu their PyTorch twins")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny sizes: the smoke that runs serve end to end")
    args = ap.parse_args(argv)

    if args.mode in NOT_PORTED:
        raise SystemExit(f"--mode {args.mode} is not ported yet (ROADMAP "
                         f"item {NOT_PORTED[args.mode]}); ported modes: "
                         f"{', '.join(sorted(MODE_TO_SPEC))}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available; pass "
                           "--device cpu to serve on the CPU")
    if args.dryrun:
        args.n = min(args.n, 2000)
        args.partitions = min(args.partitions, 2)
        args.fanout = min(args.fanout, 16)
        args.batches = min(args.batches, 2)
        args.batch_size = min(args.batch_size, 8)
        # slow shared smoke boxes: a lapsed deadline would only add
        # spurious re-issue work, never find a bug
        args.deadline = max(args.deadline, 60.0)

    spec = traversal.get_spec(MODE_TO_SPEC[args.mode])
    missing = set(traversal.spec_names()) - set(RUNNERS)
    assert not missing, f"registered specs without a serve runner: {missing}"
    return RUNNERS[spec.name](args, spec)


if __name__ == "__main__":
    main()
