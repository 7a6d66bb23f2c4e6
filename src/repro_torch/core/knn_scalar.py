"""Scalar k-nearest-neighbour baseline: best-first branch-and-bound (the
reference's ``core/knn_scalar.py``).

Roussopoulos-style traversal in its optimal best-first form (Hjaltason &
Samet): a priority queue ordered by squared MINDIST holds both tree nodes
and data rects; nodes are expanded in MINDIST order, so the k-th result
popped is the k-th nearest and no node beyond the final k-th distance is
opened.  MINMAXDIST supplies the Roussopoulos upper-bound prune (drop a
child whose MINDIST exceeds the k-th smallest MINMAXDIST among its
siblings, counted in ``pruned_inner``).  Host numpy in float64 over one
copy of the tree; the heap key is (distance, is_rect, id, level), so ties
break as in the reference.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch

from .counters import Counters
from .geometry import mindist_np, minmaxdist_np
from .rtree import RTree
from .select_scalar import host_levels


def make_knn_best_first(tree: RTree, use_minmaxdist: bool = True):
    """Factory mirroring the vectorized make_* API: the float64 host copy
    of the levels is made once, so a query's time is its traversal.

    Returns fn(point, k) → (ids, sq-dists, Counters)."""
    levels = host_levels(tree, np.float64)

    def run(point, k: int):
        return best_first(levels, tree.height, point, k, use_minmaxdist,
                          point_dists)

    return run


def knn_best_first(tree: RTree, point, k: int, use_minmaxdist: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray, Counters]:
    """Exact kNN of ``point`` (2,) → (ids (k,) int64, sq-dists (k,)
    float64, Counters of Python ints).  Rows beyond the dataset size are
    (-1, inf); ties break by rect id through the heap key, as the
    brute-force oracle's stable argsort.  Copies the tree per call: use
    ``make_knn_best_first`` for many queries on one tree."""
    return best_first(host_levels(tree, np.float64), tree.height, point, k,
                      use_minmaxdist, point_dists)


def host_array(x) -> np.ndarray:
    """A query row or batch, tensor or array-like, as float64 numpy."""
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x, np.float64)


def point_dists(query, lx, ly, hx, hy):
    """(MINDIST, MINMAXDIST) of point ``query`` (px, py) to a node's
    children, float64."""
    px, py = query
    return (mindist_np(px, py, lx, ly, hx, hy),
            lambda: minmaxdist_np(px, py, lx, ly, hx, hy))


def best_first(levels, height: int, query, k: int, use_minmaxdist: bool,
               dists) -> Tuple[np.ndarray, np.ndarray, Counters]:
    """The best-first traversal shared with the kNN-join baseline:
    ``dists(query, lx, ly, hx, hy)`` → (MINDIST, a thunk of MINMAXDIST)
    over a node's valid children."""
    if k <= 0:
        raise ValueError("k must be positive")
    q = tuple(float(v) for v in host_array(query))
    ctr = Counters()
    # heap entries: (dist, is_rect, id_tiebreak, level); is_rect = 0 sorts
    # nodes before equal-distance rects, so a node that could still hold a
    # closer object is opened first
    heap = [(0.0, 0, 0, height - 1)]
    ids: list[int] = []
    out_d: list[float] = []
    while heap and len(ids) < k:
        d, is_rect, nid, li = heapq.heappop(heap)
        if is_rect:
            ids.append(nid)
            out_d.append(d)
            continue
        lv = levels[li]
        ctr.nodes_visited += 1
        n = int(lv["count"][nid])
        ch = lv["child"][nid, :n]
        md, mmd = dists(q, lv["lx"][nid, :n], lv["ly"][nid, :n],
                        lv["hx"][nid, :n], lv["hy"][nid, :n])
        ctr.predicates += 4 * n          # 2 gap ops + 2 fma per entry
        ctr.vector_ops += 4              # one dense evaluation per node
        keep = np.ones(n, bool)
        if use_minmaxdist and li > 0 and n > 0:
            ctr.predicates += 4 * n
            ctr.vector_ops += 4          # second dense evaluation per node
            kth = np.sort(mmd())[min(k, n) - 1]
            keep = md <= kth
            ctr.pruned_inner += int(n - keep.sum())
        for j in np.nonzero(keep)[0]:
            if li == 0:
                heapq.heappush(heap, (float(md[j]), 1, int(ch[j]), -1))
            else:
                heapq.heappush(heap, (float(md[j]), 0, int(ch[j]), li - 1))
            ctr.enqueued += 1
    res_ids = np.full(k, -1, np.int64)
    res_d = np.full(k, np.inf, np.float64)
    res_ids[:len(ids)] = ids
    res_d[:len(out_d)] = out_d
    return res_ids, res_d, ctr
