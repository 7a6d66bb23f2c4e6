"""Wrappers of the CUDA kNN-join kernels (``csrc/rtree_knn.cu``, the
``RectQuery`` instantiations of the kNN kernels' bodies).

B8 ``knn_join_level_dists_cuda`` replaces the Pallas
``repro/kernels/rtree_knn_join.py:knn_join_level_dists`` (line 87); B9
``knn_join_level_fused_cuda`` replaces ``knn_join_level_fused`` (line 224)
and B10 ``knn_join_leaf_fused_cuda`` replaces ``knn_join_leaf_fused``
(line 237); on the D3 layout, B14 ``knn_join_level_dists_d3_cuda``
replaces ``knn_join_level_dists_d3`` (line 168).  The source file's header
gives each kernel's bound on the card; the plain PyTorch twins are in
``kernels/ref.py``.

The launchers of ``kernels/rtree_knn.py`` check device, dtype, shape
(``(B, 4)`` query rects here) and contiguity, allocate the outputs, launch
on the current CUDA stream and raise if the launch was refused; each
wrapper adds one to its launch count.  Nothing here falls back to the
twin: CPU tensors raise.  Nothing here waits for the device either.
"""
from __future__ import annotations

from typing import Dict

from .rtree_knn import (launch_dists, launch_dists_d3, launch_leaf_fused,
                        launch_level_fused)

# launches per kernel since the last reset (plain integers)
_launches: Dict[str, int] = {"knn_join_level_dists": 0,
                             "knn_join_level_fused": 0,
                             "knn_join_leaf_fused": 0,
                             "knn_join_level_dists_d3": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def knn_join_level_dists_cuda(ids, qrects, lx, ly, hx, hy, child, *,
                              leaf: bool = False):
    """Kernel B8: (B, C) int32 ids (-1 pad) × (B, 4) float32 query rects
    over (N, F) SoA rows → (rect mindist (B, C, F), rect minmaxdist
    (B, C, F) | None) float32, DIST_PAD on invalid lanes; ``leaf=True``
    computes MINDIST only and returns None for the bound."""
    out = launch_dists("rtree_knn_join_dists", 4, ids, qrects, lx, ly, hx,
                       hy, child, leaf)
    _launches["knn_join_level_dists"] += 1
    return out


def knn_join_level_fused_cuda(ids, qrects, lx, ly, hx, hy, child, tau, *,
                              cap: int, k: int, tighten: bool):
    """Kernel B9: B6's internal level with rect queries → (next (B, cap)
    int32 -1 padded, τ (B,) float32, valid_cnt (B,) int32, keep_cnt (B,)
    int32)."""
    out = launch_level_fused("rtree_knn_join_level_fused", 4, ids, qrects,
                             lx, ly, hx, hy, child, tau, cap, k, tighten)
    _launches["knn_join_level_fused"] += 1
    return out


def knn_join_leaf_fused_cuda(ids, qrects, lx, ly, hx, hy, child, *, k: int):
    """Kernel B10: B7's leaf with rect queries → (ids (B, k) int32, d (B, k)
    float32 with (-1, +inf) for missing rows, valid_cnt (B,) int32)."""
    out = launch_leaf_fused("rtree_knn_join_leaf_fused", 4, ids, qrects, lx,
                            ly, hx, hy, child, k)
    _launches["knn_join_leaf_fused"] += 1
    return out


def knn_join_level_dists_d3_cuda(ids, qrects, qlo, qhi, scale, bias, slack,
                                 ptr):
    """Kernel B14: B13 with (B, 4) float32 query rects → (rect MINDIST on
    the dequantized boxes, the slack-corrected D3-form rect MINMAXDIST),
    each (B, C, F) float32, DIST_PAD on invalid lanes."""
    out = launch_dists_d3("rtree_knn_join_dists_d3", 4, ids, qrects, qlo,
                          qhi, scale, bias, slack, ptr)
    _launches["knn_join_level_dists_d3"] += 1
    return out
