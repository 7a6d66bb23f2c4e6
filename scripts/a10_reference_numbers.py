#!/usr/bin/env python3
"""Print the reference's filtered-kNN and browse numbers that
``chip_smoke.py`` holds the port to (``FILTERED_REF``, ``BROWSE_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/a10_reference_numbers.py

Builds ``chip_smoke.py``'s phase-3 tree (2,000,000 uniform points, seed 0,
fanout 64) with the JAX package.  Filtered kNN: ``make_knn_filtered_bfs``
on the first served filtered batch (64 points, windows of half-extent
0.2), D1 and D3, k in {8, 64}, static and adaptive caps; it checks that
the kept numbers agree across the caps tiers (padded slots are kept per
tier).  Browse: ``make_browse_bfs(backend="xla")`` on the first served kNN
batch (64 points), k = 8, D1 and D3, a session of 4 steps (as served) and
one of ``DEEP_STEPS``, which runs more than one descent.  Prints one dict
per operator in ``chip_smoke.py``'s layout and the seconds it took.
"""
import time

import jax.numpy as jnp
import numpy as np

from repro.core import knn_browse, knn_filtered, rtree
from repro_torch.launch import serve      # the served inputs (numpy only)

N, FANOUT, BATCH, EPS, BROWSE_K, DEEP_STEPS = 2_000_000, 64, 64, 0.2, 8, 72
KEPT = ("nodes_visited", "predicates", "vector_ops", "enqueued",
        "pruned_inner", "masked_waste")


def summary(ctr):
    return ({k: int(np.asarray(getattr(ctr, k))) for k in KEPT},
            np.asarray(ctr.lanes_live)[:4].tolist(),
            np.asarray(ctr.lanes_padded)[:4].tolist())


def sums(ids, d):
    ids, d = np.asarray(ids), np.asarray(d)
    found = ids >= 0
    return (int(ids[found].astype(np.int64).sum()),
            float(d[found].astype(np.float64).sum()), int(found.sum()))


def filtered(tree, qs):
    out = {}
    for layout in ("d1", "d3"):
        for k in (8, 64):
            padded = {}
            for caps_mode in ("static", "adaptive"):
                ids, d, ctr = knn_filtered.make_knn_filtered_bfs(
                    tree, k, layout=layout, caps_mode=caps_mode)(
                    jnp.asarray(qs))
                c, live, pad = summary(ctr)
                ids_sum, d_sum, found = sums(ids, d)
                assert int(ctr.overflow) == 0, (layout, k, caps_mode)
                cell = dict(counters=c, live=live, ids_sum=ids_sum,
                            d_sum=d_sum, found=found)
                got = out.setdefault((layout, k), cell)
                assert got == cell, (layout, k, caps_mode, got, cell)
                padded[caps_mode] = pad
            out[(layout, k)]["padded"] = padded
    return out


def browse(tree, pts):
    out = {}
    for layout in ("d1", "d3"):
        start = knn_browse.make_browse_bfs(tree, BROWSE_K, layout=layout,
                                           backend="xla")
        for steps in (4, DEEP_STEPS):
            cur = start(jnp.asarray(pts))
            got = [cur.next_batch() for _ in range(steps)]
            ids = np.concatenate([i for i, _ in got], axis=1)
            d = np.concatenate([x for _, x in got], axis=1)
            st = cur.state
            c, live, pad = summary(st.ctr)
            ids_sum, d_sum, found = sums(ids, d)
            lost = np.asarray(st.lost)
            out[(layout, steps)] = dict(
                counters=c, live=live, padded=pad, ids_sum=ids_sum,
                d_sum=d_sum, found=found, descents=int(st.descents),
                emitted=int(np.asarray(st.emitted).sum()),
                overflow=int(np.asarray(st.overflow).sum()),
                lost_finite=int(np.isfinite(lost).sum()),
                lost_sum=float(lost[np.isfinite(lost)].astype(
                    np.float64).sum()))
        assert out[(layout, DEEP_STEPS)]["descents"] > 1, layout
    return out


def main():
    t0 = time.time()
    tree = rtree.build_rtree(serve.make_rects(N, 0), fanout=FANOUT)
    _, qs = serve.make_knn_filtered_inputs(N, 0, 1, BATCH, EPS)
    _, pts = serve.make_knn_inputs(N, 0, 1, BATCH)
    print(f"FILTERED_REF = {filtered(tree, qs[0])!r}")
    print(f"BROWSE_REF = {browse(tree, pts[0])!r}")
    print(f"# {time.time() - t0:.1f} s on the CPU")


if __name__ == "__main__":
    main()
