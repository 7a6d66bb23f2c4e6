"""Scalar kNN-join baseline: nested best-first branch-and-bound (the
reference's ``core/knn_join_scalar.py``).

For each outer rect, a Hjaltason–Samet best-first traversal of the inner
tree under squared rect-to-rect MINDIST (``geometry.mindist_rect_np``),
with the Roussopoulos sibling prune generalized to rect queries
(``minmaxdist_rect_np``): ``knn_scalar.best_first`` with rect distances.
The outer loop is plain nesting: the baseline's point is the per-query
optimal node-access count that the batched traversal amortizes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .counters import Counters
from .geometry import mindist_rect_np, minmaxdist_rect_np
from .knn_scalar import best_first, host_array
from .rtree import RTree
from .select_scalar import host_levels


def rect_dists(query, lx, ly, hx, hy):
    """(MINDIST, MINMAXDIST) of rect ``query`` (qlx, qly, qhx, qhy) to a
    node's children, float64."""
    return (mindist_rect_np(*query, lx, ly, hx, hy),
            lambda: minmaxdist_rect_np(*query, lx, ly, hx, hy))


def make_knn_join_best_first(tree: RTree, use_minmaxdist: bool = True):
    """Factory mirroring the vectorized make_* API: the float64 host copy
    of the levels is made once.  Returns fn(rect, k) → (ids, sq-dists,
    Counters) for one outer rect."""
    levels = host_levels(tree, np.float64)

    def run(rect, k: int):
        return best_first(levels, tree.height, rect, k, use_minmaxdist,
                          rect_dists)

    return run


def knn_join_best_first(tree: RTree, outer_rects, k: int,
                        use_minmaxdist: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, Counters]:
    """Exact kNN-join: outer_rects (B, 4) × ``tree`` → (ids (B, k) int64,
    sq-dists (B, k) float64, Counters summed over the rects, Python ints).
    Rows beyond the inner dataset size are (-1, inf); ties break by inner
    rect id through the heap key, as ``brute_force_knn_join``'s stable
    argsort."""
    levels = host_levels(tree, np.float64)
    outer = np.atleast_2d(host_array(outer_rects))
    ids = np.full((len(outer), k), -1, np.int64)
    dists = np.full((len(outer), k), np.inf, np.float64)
    ctr_sum = Counters()
    for i, rect in enumerate(outer):
        rid, rd, ctr = best_first(levels, tree.height, rect, k,
                                  use_minmaxdist, rect_dists)
        ids[i], dists[i] = rid, rd
        ctr_sum = ctr_sum + ctr
    return ids, dists, ctr_sum
