"""Spatial join analytics on the PyTorch/CUDA port
(``spatial_join_analytics.py``'s counterpart): join two point sets
(ε-expanded rects) with the vectorized R-tree join + sorted-key pruning
(O3+O5), then aggregate pair counts on a coarse grid — a miniature
spatial-analytics pipeline.

    PYTHONPATH=src python examples/spatial_join_analytics_torch.py  # H100
    PYTHONPATH=src python examples/spatial_join_analytics_torch.py \\
        --device cpu                                                # twins

``--n`` shrinks both datasets.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import join_vector, rtree

EPS = 0.002


def datasets(n: int):
    """Uniformly scattered sensors and events clustered around 12 centres,
    each point ε-expanded into a rect: → (sensors (n, 2), sensor rects,
    event rects), float32."""
    rng = np.random.default_rng(1)
    sensors = rng.random((n, 2), dtype=np.float32)
    centers = rng.random((12, 2), dtype=np.float32)
    events = (centers[rng.integers(0, 12, n)] +
              rng.normal(0, 0.03, (n, 2))).clip(0, 1).astype(np.float32)
    ra = np.concatenate([sensors - EPS, sensors + EPS], 1).astype(np.float32)
    rb = np.concatenate([events - EPS, events + EPS], 1).astype(np.float32)
    return sensors, ra, rb


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000,
                    help="points in each dataset")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sensors, ra, rb = datasets(args.n)

    # Sorted on low_x → the O3/O5 pruning preconditions hold.
    ta = rtree.build_rtree(ra, fanout=64, sort_key="lx", device=dev)
    tb = rtree.build_rtree(rb, fanout=64, sort_key="lx", device=dev)

    join = join_vector.make_join_bfs(ta, tb, layout="d1", o3=True,
                                     o5="dense", result_cap=1 << 21)
    pairs, n, ctr = join()
    n = int(n)
    pairs = pairs[:n].cpu().numpy()
    print(f"join: {n} (sensor, event) pairs within ε={EPS} on {dev}")
    print(f"pruning: outer entries skipped {int(ctr.pruned_outer)}, "
          f"inner skipped {int(ctr.pruned_inner)}, "
          f"predicates {int(ctr.predicates)}")

    # Aggregate: events-near-sensors density on an 8×8 grid.
    cells = (sensors[pairs[:, 0]] * 8).astype(int)
    grid = np.zeros((8, 8), int)
    np.add.at(grid, (cells[:, 1], cells[:, 0]), 1)
    print("pair density (8×8 grid, rows=y):")
    for row in grid[::-1]:
        print("  " + " ".join(f"{v:6d}" for v in row))
    return {"pairs": pairs, "grid": grid}


if __name__ == "__main__":
    main()
