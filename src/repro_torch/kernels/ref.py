"""Plain PyTorch twins of the select kernels (the reference's
``kernels/ref.py`` entries for B1 and B2).

Each twin has its kernel's contract exactly — same shapes, dtypes and
padding — and runs on any device.  The CPU tests hold them against the
JAX package; ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  Both kernels are compares only, so twin and kernel agree exactly.
"""
from __future__ import annotations

import torch

from ..core.compaction import compact_rows
from ..core.geometry import intersects


def select_level_masks_ref(ids, queries, lx, ly, hx, hy, child):
    """Twin of ``select_level_masks_cuda``: (B, C) ids × (B, 4) queries →
    (B, C, F) int32 qualify mask."""
    safe = ids.clamp(min=0).long()                  # (B, C)
    glx, gly = lx[safe], ly[safe]                   # (B, C, F)
    ghx, ghy = hx[safe], hy[safe]
    qlx = queries[:, 0, None, None]
    qly = queries[:, 1, None, None]
    qhx = queries[:, 2, None, None]
    qhy = queries[:, 3, None, None]
    m = intersects(qlx, qly, qhx, qhy, glx, gly, ghx, ghy)
    m = m & (child[safe] >= 0) & (ids >= 0)[:, :, None]
    return m.to(torch.int32)


def select_level_fused_ref(ids, queries, lx, ly, hx, hy, child, *, cap: int):
    """Twin of ``select_level_fused_cuda``: masks + compress-store
    compaction of the qualifying children over the flat (C·F) level →
    (next_ids (B, cap), counts (B,), overflow (B,))."""
    b = ids.shape[0]
    mask = select_level_masks_ref(ids, queries, lx, ly, hx, hy,
                                  child).to(torch.bool)
    ptr = child[ids.clamp(min=0).long()]
    return compact_rows(ptr.reshape(b, -1), mask.reshape(b, -1), cap)
