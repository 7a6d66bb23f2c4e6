"""Filtered k-nearest-neighbour search: the k nearest data rects among
those that intersect a per-query filter window (the reference's
``core/knn_filtered.py``).

A query row has 6 columns, a point (px, py) and a window (wlx, wly, whx,
why).  The operator is one more spec of the distance engine
(core/traversal.py); only its score stage differs from kNN's.  It folds
two window masks into the distances before τ pruning sees them:

  qualify   — a node or leaf rect whose box misses the window cannot hold
              or be an answer: its MINDIST becomes DIST_PAD.
  guarantee — MINMAXDIST tightens τ by promising one answer per child,
              which holds under the filter only for children the window
              contains, so MINMAXDIST is masked to contained children.

The score stage is PyTorch ops on the tree's device, as the reference's is
jnp with no kernel: ``backend="cuda"`` and ``fused=True`` raise.  On D3
the internal levels score the dequantized boxes (the intersect test
over-approximates, the containment test under-approximates, and
MINMAXDIST goes through the stored-slack correction
``layouts.d3_slacked_upper``); the leaf scores the exact rects.  Each
layout rounds MINMAXDIST in its own trace's form, as kNN does
(``geometry.minmaxdist`` on D1, ``minmaxdist_d3`` on D3's internal
levels), measured against the reference's jitted score stage.  With the
whole-universe window every mask passes and the operator is plain kNN.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import caps as caps_policy
from . import traversal
from .counters import StageModel
from .geometry import (DIST_PAD, intersects, mindist, minmaxdist,
                       minmaxdist_d3)
from .join_vector import _gather_children
from .knn_vector import make_distance_bfs
from .layouts import (d3_dequantize, d3_levels_int32, d3_slacked_upper,
                      level_to_d1, tree_layout)
from .rtree import RTree


def filtered_caps(tree: RTree, k: int, slack: int = 8, min_cap: int = 256,
                  lanes: Optional[int] = None,
                  policy: str = "static") -> Tuple[int, ...]:
    """kNN caps with extra headroom (core/caps.py); ``policy='adaptive'``
    selects the tight tier."""
    kw = {} if lanes is None else dict(lanes=lanes)
    return caps_policy.filtered_frontier_caps(tree, k, slack=slack,
                                              min_cap=min_cap, policy=policy,
                                              **kw)


def make_knn_filtered_score(tree: RTree, layout: str, backend: str):
    """The filtered-kNN score stage and its engine context: the contract of
    ``knn_vector.make_knn_score`` with 6-column query rows.  ``backend``
    'auto' or 'torch' (both PyTorch ops on the tree's device); 'cuda'
    raises: the window masks have no kernel."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"knn_filtered has no kernel backend (got "
                         f"{backend!r}): its window masks are PyTorch ops")
    if layout == "d3":
        layers = tuple((lvl.qlo, lvl.qhi, lvl.scale, lvl.bias, lvl.slack,
                        lvl.ptr) for lvl in d3_levels_int32(tree))
        leaf_rows = level_to_d1(tree.levels[0])     # the exact rects
    else:
        layers = tree_layout(tree, layout)
        leaf_rows = layers[0]

    def score(ctx, li, ids, queries, leaf):
        layers_, leaf_rows_, d3 = ctx
        b, c = ids.shape
        disp = None
        if d3 and not leaf:
            qlo, qhi, scale, bias, slack, ptr_ = layers_[li]
            safe = ids.clamp(min=0).long()
            ptr = ptr_[safe]
            lx, ly, hx, hy = d3_dequantize(qlo[safe], qhi[safe], scale[safe],
                                           bias[safe])
            disp = slack[safe].sum(dim=-1)[:, :, None]
            stages = 2
        else:
            layer = leaf_rows_ if leaf else layers_[li]
            (lx, ly, hx, hy, ptr), stages = _gather_children(
                layer, ids.reshape(-1))
            f = lx.shape[-1]
            lx, ly, hx, hy, ptr = (a.reshape(b, c, f)
                                   for a in (lx, ly, hx, hy, ptr))
        px, py, wlx, wly, whx, why = (queries[:, j, None, None]
                                      for j in range(6))
        valid = (ids >= 0)[:, :, None] & (ptr >= 0)
        inter = intersects(wlx, wly, whx, why, lx, ly, hx, hy)
        md = torch.where(valid & inter, mindist(px, py, lx, ly, hx, hy),
                         float(DIST_PAD))
        if leaf:
            return md, None, ptr, stages
        contained = (lx >= wlx) & (ly >= wly) & (hx <= whx) & (hy <= why)
        if disp is None:
            mmd = minmaxdist(px, py, lx, ly, hx, hy)
        else:
            mmd = d3_slacked_upper(minmaxdist_d3(px, py, lx, ly, hx, hy),
                                   disp)
        mmd = torch.where(valid & contained, mmd, float(DIST_PAD))
        return md, mmd, ptr, stages

    return (layers, leaf_rows, layout == "d3"), score


def make_knn_filtered_bfs(tree: RTree, k: int, layout: str = "d1",
                          caps: Optional[Sequence[int]] = None,
                          backend: str = "auto", fused: bool = False,
                          caps_mode: str = "adaptive",
                          caps_tree: Optional[RTree] = None):
    """Build the batched filtered kNN: queries (B, 6) rows (px, py, wlx,
    wly, whx, why) → (ids (B, k) int32, squared dists (B, k) float32,
    Counters), the k nearest data rects that intersect [wlx, wly, whx,
    why], (-1, +inf) padded.  ``caps_mode`` and ``caps_tree`` as in
    ``make_knn_bfs`` ('adaptive': the occupancy-tight tier escalating to the
    static one).
    ``backend='cuda'`` and ``fused=True`` raise ``ValueError``."""
    if k <= 0:
        raise ValueError("k must be positive")
    if fused:
        raise ValueError("knn_filtered has no fused generation")
    return make_distance_bfs(
        KNN_FILTERED_SPEC, tree, k,
        make_knn_filtered_score(tree, layout, backend), None, None,
        layout=layout, caps=caps, backend=backend, fused=False,
        caps_mode=caps_mode, caps_tree=caps_tree)


# Per unfused level: score gather + distance math, the window-mask compose
# over the (B, C, F) intermediate, τ top-k, prune + beam → 5 launches
# internal; the leaf skips τ/beam but keeps the mask compose → 4.
KNN_FILTERED_SPEC = traversal.register(traversal.OperatorSpec(
    name="knn_filtered", kind="distance",
    stage_model=StageModel(inner=5, leaf=4, fused=None),
    builder=make_knn_filtered_bfs, caps_policy=filtered_caps, query_width=6,
    description="filtered kNN: point MINDIST score composed with a filter-"
                "window predicate mask before τ pruning; τ tightens only on "
                "window-contained children"))
