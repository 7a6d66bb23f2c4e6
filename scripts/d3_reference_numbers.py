#!/usr/bin/env python3
"""Print the reference's D3 numbers that ``chip_smoke.py`` holds the port's
D3 engines to (``SELECT_D3_REF``, ``KNN_D3_REF``, ``KNN_JOIN_D3_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/d3_reference_numbers.py

Builds ``chip_smoke.py``'s phase-3 tree (2,000,000 uniform points, seed 0,
fanout 64) with the JAX package and runs its ``backend="xla"`` D3 engines
on the first served batches: select (``result_cap=4096``, static and
adaptive caps, unfused and fused), kNN and kNN-join (k in {8, 64}, static
and adaptive).  It checks that the counters kept in ``chip_smoke.py``
agree across caps tiers and fusion, and prints one dict per operator in
``chip_smoke.py``'s layout.  Takes ~30 s and a few GB on a CPU.
"""
import numpy as np
import jax.numpy as jnp

from repro.core import knn_join_vector, knn_vector, rtree, select_vector
from repro_torch.launch import serve      # the served inputs (numpy only)

N, FANOUT, BATCH, RESULT_CAP, EPS = 2_000_000, 64, 64, 4096, 0.002
KEPT = ("nodes_visited", "predicates", "vector_ops", "enqueued",
        "pruned_inner", "masked_waste")


def summary(ctr, keys):
    c = {k: int(np.asarray(getattr(ctr, k))) for k in keys}
    return (c, np.asarray(ctr.lanes_live)[:4].tolist(),
            np.asarray(ctr.lanes_padded)[:4].tolist())


def main():
    tree = rtree.build_rtree(serve.make_rects(N, 0), fanout=FANOUT)
    q = jnp.asarray(serve.make_queries(1, BATCH, 1e-3, 1)[0])
    out, padded = {}, {}
    for caps_mode in ("static", "adaptive"):
        for fused in (False, True):
            ids, counts, ctr = select_vector.make_select_bfs(
                tree, layout="d3", result_cap=RESULT_CAP, backend="xla",
                caps_mode=caps_mode, fused=fused)(q)
            ids, counts = np.asarray(ids), np.asarray(counts)
            c, live, pad = summary(ctr, KEPT[:4] + KEPT[5:])
            cell = dict(counters=c, live=live,
                        ids_sum=int(ids[ids >= 0].astype(np.int64).sum()),
                        counts_sum=int(counts.sum()))
            assert out.setdefault("select", cell) == cell, (caps_mode, fused)
            padded[caps_mode] = pad
    out["select"]["padded"] = dict(padded)
    _, pts = serve.make_knn_inputs(N, 0, 1, BATCH)
    _, rects = serve.make_knn_join_inputs(N, 0, 1, BATCH, EPS)
    for name, build, qs in (
            ("knn", knn_vector.make_knn_bfs, pts[0]),
            ("knn_join", knn_join_vector.make_knn_join_bfs, rects[0])):
        out[name] = {}
        for k in (8, 64):
            for caps_mode in ("static", "adaptive"):
                ids, d, ctr = build(tree, k, layout="d3", backend="xla",
                                    caps_mode=caps_mode)(jnp.asarray(qs))
                c, live, pad = summary(ctr, KEPT)
                cell = dict(counters=c, live=live,
                            ids_sum=int(np.asarray(ids).astype(
                                np.int64).sum()),
                            d_sum=float(np.asarray(d).astype(
                                np.float64).sum()))
                assert out[name].setdefault(k, cell) == cell, (k, caps_mode)
                padded[caps_mode] = pad
            out[name][k]["padded"] = dict(padded)
    for name, label in (("select", "SELECT_D3_REF"), ("knn", "KNN_D3_REF"),
                        ("knn_join", "KNN_JOIN_D3_REF")):
        print(f"{label} = {out[name]!r}")


if __name__ == "__main__":
    main()
