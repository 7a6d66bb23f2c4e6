"""Quickstart on the PyTorch/CUDA port (``quickstart.py``'s counterpart):
build a SIMD-ified R-tree, run batched vectorized range selects, inspect
the paper's counters.

    PYTHONPATH=src python examples/quickstart_torch.py               # H100
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # twins

On ``cuda`` the selects run the hand-written CUDA kernels; ``--device cpu``
runs their PyTorch twins.  ``--n`` and ``--queries`` shrink the run.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import rtree, select_scalar, select_vector


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000, help="uniform points")
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1) uniform points (the paper's workload shape), STR bulk load.
    rng = np.random.default_rng(0)
    pts = rng.random((args.n, 2), dtype=np.float32)
    tree = rtree.build_rtree_points(pts, fanout=64, device=dev)
    print(f"R-tree: {tree.n_rects} rects, height {tree.height}, "
          f"fanout {tree.fanout}, {tree.n_nodes_total()} nodes on {dev}")

    # 2) A batch of 0.1%-selectivity query rectangles.
    side = np.sqrt(0.001).astype(np.float32)
    lo = rng.random((args.queries, 2), dtype=np.float32) * (1 - side)
    queries = np.concatenate([lo, lo + side], axis=1)

    # 3) Vectorized BFS select (layout D1, queue + compress-store analogue).
    select = select_vector.make_select_bfs(tree, layout="d1", result_cap=2048)
    ids, counts, ctr = select(queries)
    hits = int(counts.sum())
    print(f"batched select: {hits} total hits over {args.queries} queries")
    print("counters:", {k: v for k, v in ctr.asdict().items() if v})

    # 4) Cross-check one query against the scalar recursive baseline.
    ids0, _ = select_scalar.select_recursive_py(tree, queries[0])
    got = np.sort(ids[0][: int(counts[0])].cpu().numpy())
    assert np.array_equal(got, ids0)
    print("scalar baseline agrees ✓")
    return {"hits": hits, "first": got}


if __name__ == "__main__":
    main()
