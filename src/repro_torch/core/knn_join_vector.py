"""Batched kNN-join over the R-tree: the *kNN-join spec* of the distance
engine (the reference's ``core/knn_join_vector.py``).

For every rect of an outer set, its k nearest entries of an inner R-tree
under squared rect-to-rect MINDIST (``geometry.mindist_rect``; a
degenerate outer rect reduces to the point kNN).  The outer rects are the
engine's (B, 4) query rows, so the traversal is kNN's: τ tightening to the
k-th smallest rect MINMAXDIST, MINDIST <= τ pruning, the best-first beam
and the leaf top-k (core/traversal.py), built by ``knn_vector``'s
``make_distance_bfs``.  This module contributes the rect score stage and
the kernel routing:

  unfused     — per level, ``kernels/ops.knn_join_level_dists`` (kernel B8
                on the card) writes the (B, C, F) distances, and the
                engine selects in PyTorch;
  ``fused``   — per internal level one ``kernels/ops.knn_join_level_fused``
                call (kernel B9) and at the leaf one ``knn_join_leaf_fused``
                call (kernel B10).

Both give identical ids, distances and counters (except ``dispatches``).
D0 and D2 score with the layout's own PyTorch math
(``_rect_dists_for_layer``), as in ``knn_vector``.  On the D3 layout
(unfused only) internal levels score the quantized boxes through
``kernels/ops.knn_join_level_dists_d3`` (kernel B14) and the leaf rows
take B8, so D3 results equal D1's.  ``knn_join`` streams a whole
outer tree through one engine in fixed-size chunks.  Results are exact
whenever no frontier overflowed.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import traversal
from .counters import Counters, StageModel
from .geometry import (DIST_PAD, mindist_rect, mindist_rect_pairs,
                       minmaxdist_rect)
from .join_vector import _gather_children
from .knn_vector import (knn_frontier_caps, make_distance_bfs,
                         make_distance_score)
from .layouts import LevelD2
from .rtree import RTree


def _rect_dists_for_layer(layer, ids: torch.Tensor, qrects: torch.Tensor,
                          leaf: bool):
    """Score one D0 or D2 level's frontier children against the query
    rects in the layout's own PyTorch math: ``knn_vector._dists_for_layer``'s
    contract.  D2 takes rect MINDIST in its pair form (two stages); D0
    gathers through the join's ``_gather_children``; MINMAXDIST runs on
    the de-interleaved corners for both, as the reference's does."""
    b, c = ids.shape
    q = [qrects[:, j, None, None] for j in range(4)]
    if isinstance(layer, LevelD2):
        safe = ids.clamp(min=0).long()
        lo, hi = layer.lo[safe], layer.hi[safe]     # (B, C, 2F)
        f2 = lo.shape[-1]
        lo = lo.reshape(b, c, f2 // 2, 2)
        hi = hi.reshape(b, c, f2 // 2, 2)
        md = mindist_rect_pairs(qrects[:, None, None, 0:2],
                                qrects[:, None, None, 2:4], lo, hi)
        lx, ly, hx, hy = lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]
        ptr, stages = layer.ptr[safe], 2
    else:
        (lx, ly, hx, hy, ptr), stages = _gather_children(layer,
                                                         ids.reshape(-1))
        lx, ly, hx, hy, ptr = (a.reshape(b, c, -1)
                               for a in (lx, ly, hx, hy, ptr))
        md = mindist_rect(*q, lx, ly, hx, hy)
    valid = (ids >= 0)[:, :, None] & (ptr >= 0)
    pad = float(DIST_PAD)
    md = torch.where(valid, md, pad)
    if leaf:
        return md, None, ptr, stages
    mmd = torch.where(valid, minmaxdist_rect(*q, lx, ly, hx, hy), pad)
    return md, mmd, ptr, stages


def make_knn_join_score(tree: RTree, layout: str, backend: str):
    """Build the kNN-join score stage and its engine context for ``tree``:
    ``knn_vector.make_knn_score``'s contract with (B, 4) query rects: D1
    feeds B8; D3 feeds B14 on internal levels and B8 at the leaf; D0 and
    D2 score with ``_rect_dists_for_layer``."""
    return make_distance_score(tree, layout, backend,
                               ops.knn_join_level_dists,
                               ops.knn_join_level_dists_d3,
                               _rect_dists_for_layer)


def make_knn_join_bfs(tree: RTree, k: int, layout: str = "d1",
                      caps: Optional[Sequence[int]] = None,
                      backend: str = "auto", fused: bool = False,
                      caps_mode: str = "adaptive",
                      caps_tree: Optional[RTree] = None):
    """Build the batched kNN-join: rects (B, 4) → (ids (B, k) int32 inner
    rect ids by distance, -1 padded when k > n_rects; dists (B, k) float32
    squared rect MINDISTs, +inf padded; Counters).

    ``backend``, ``fused``, ``caps_mode`` and ``caps_tree`` as in
    ``make_knn_bfs``:
    unfused runs B8 per level, fused B9 inside and B10 at the leaf, on a
    tree on the card; their twins on the CPU.  ``rects`` may be any
    array-like; it is moved to the tree's device.
    """
    return make_distance_bfs(
        KNN_JOIN_SPEC, tree, k, make_knn_join_score(tree, layout, backend),
        ops.knn_join_level_fused, ops.knn_join_leaf_fused, layout=layout,
        caps=caps, backend=backend, fused=fused, caps_mode=caps_mode,
        caps_tree=caps_tree)


KNN_JOIN_SPEC = traversal.register(traversal.OperatorSpec(
    name="knn_join", kind="distance",
    stage_model=StageModel(inner=4, leaf=3, fused=1),
    builder=make_knn_join_bfs, caps_policy=knn_frontier_caps, query_width=4,
    description="batched kNN-join: rect MINDIST/MINMAXDIST score, τ top-k "
                "+ best-first beam emission (engine shared with point kNN)"))


def knn_join(tree_o: RTree, tree_i: RTree, k: int, layout: str = "d1",
             caps: Optional[Sequence[int]] = None, backend: str = "auto",
             fused: bool = False, batch: int = 4096
             ) -> Tuple[np.ndarray, np.ndarray, Counters]:
    """All-pairs kNN-join: every data rect of ``tree_o`` against its k
    nearest data rects of ``tree_i``.

    Returns (ids (N_o, k) int64, squared distances (N_o, k) float64,
    summed Counters), row i answering outer rect i (``tree_o.rects``
    order).  The outer rects stream through one ``make_knn_join_bfs``
    engine (default caps: the escalating runner) in ``batch``-row chunks;
    the last chunk is padded with copies of its first row, so padding
    cannot trip the overflow flag.  The chunk results stay on the device
    and come back in one copy at the end; the only host syncs are the
    escalating runner's one per chunk.  Counters are summed in int64, so
    a join of many chunks does not wrap.
    """
    fn = make_knn_join_bfs(tree_i, k, layout=layout, caps=caps,
                           backend=backend, fused=fused)
    outer = tree_o.rects.to(device=tree_i.device, dtype=torch.float32)
    n = outer.shape[0]
    ids, dists, ctr_sum = [], [], None
    for lo in range(0, n, batch):
        chunk = outer[lo:lo + batch]
        m = chunk.shape[0]
        if m < batch:
            chunk = torch.cat([chunk, chunk[:1].expand(batch - m, 4)])
        cid, cd, ctr = fn(chunk)
        ids.append(cid[:m])
        dists.append(cd[:m])
        ctr = Counters(*[torch.as_tensor(v, device=outer.device).long()
                         for v in ctr.values()])
        ctr_sum = ctr if ctr_sum is None else ctr_sum + ctr
    return (torch.cat(ids).cpu().numpy().astype(np.int64),
            torch.cat(dists).cpu().numpy().astype(np.float64), ctr_sum)
