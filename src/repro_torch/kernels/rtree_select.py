"""Wrappers of the CUDA select kernels (``csrc/rtree_select.cu``).

B1 ``select_level_masks_cuda`` replaces the Pallas
``repro/kernels/rtree_select.py:select_level_masks`` (line 64); B2
``select_level_fused_cuda`` replaces ``select_level_fused`` (line 111).
The source file's header gives each kernel's bound on the card and what its
design does about it; the plain PyTorch twins are in ``kernels/ref.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on the current CUDA stream, raises if the launch was
refused, and adds one to its launch count.  Nothing here falls back to the
twin: CPU tensors raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

_LIB = "rtree_select"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {                           # the stream pointer is appended
    "rtree_select_masks": [_P] * 8 + [_I] * 3,
    "rtree_select_fused": [_P] * 9 + [_I] * 4,
}

# launches per kernel since the last reset (plain integers)
_launches: Dict[str, int] = {"select_level_masks": 0,
                             "select_level_fused": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _check(ids, queries, lx, ly, hx, hy, child):
    tensors = dict(ids=ids, queries=queries, lx=lx, ly=ly, hx=hx, hy=hy,
                   child=child)
    dev = ids.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(
                f"CUDA select kernel: {name} must lie on the CUDA device of "
                f"ids ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA select kernel: {name} must be "
                             f"contiguous")
    for name in ("ids", "child"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{tensors[name].dtype}")
    for name in ("queries", "lx", "ly", "hx", "hy"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got "
                            f"{tensors[name].dtype}")
    if ids.ndim != 2 or 0 in ids.shape:
        raise ValueError(f"ids must be non-empty (B, C), got "
                         f"{tuple(ids.shape)}")
    b, c = ids.shape
    if tuple(queries.shape) != (b, 4):
        raise ValueError(f"queries must be {(b, 4)}, got "
                         f"{tuple(queries.shape)}")
    if lx.ndim != 2 or 0 in lx.shape:
        raise ValueError(f"level rows must be non-empty (N, F), got "
                         f"{tuple(lx.shape)}")
    for name in ("ly", "hx", "hy", "child"):
        if tensors[name].shape != lx.shape:
            raise ValueError(f"{name} must be {tuple(lx.shape)}, got "
                             f"{tuple(tensors[name].shape)}")
    return b, c, lx.shape[1]


def select_level_masks_cuda(ids, queries, lx, ly, hx, hy, child):
    """Kernel B1: (B, C) int32 ids (-1 pad) × (B, 4) float32 queries over
    (N, F) SoA rows → (B, C, F) int32 qualify mask."""
    b, c, f = _check(ids, queries, lx, ly, hx, hy, child)
    with torch.cuda.device(ids.device):
        mask = torch.empty((b, c, f), dtype=torch.int32, device=ids.device)
        _build.launch(_LIB, "rtree_select_masks",
                      _ARGTYPES["rtree_select_masks"], ids.data_ptr(),
                      queries.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                      hx.data_ptr(), hy.data_ptr(), child.data_ptr(),
                      mask.data_ptr(), b, c, f)
    _launches["select_level_masks"] += 1
    return mask


def select_level_fused_cuda(ids, queries, lx, ly, hx, hy, child, *,
                            cap: int):
    """Kernel B2: B1's predicate over the whole level plus an in-order
    compress-store → (next_ids (B, cap) int32 -1 padded, counts (B,) int32
    (may exceed cap), overflow (B,) bool) — ``compact_rows``'s contract
    over the flat C·F lanes."""
    b, c, f = _check(ids, queries, lx, ly, hx, hy, child)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    with torch.cuda.device(ids.device):
        out = torch.empty((b, cap), dtype=torch.int32, device=ids.device)
        counts = torch.empty((b,), dtype=torch.int32, device=ids.device)
        _build.launch(_LIB, "rtree_select_fused",
                      _ARGTYPES["rtree_select_fused"], ids.data_ptr(),
                      queries.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                      hx.data_ptr(), hy.data_ptr(), child.data_ptr(),
                      out.data_ptr(), counts.data_ptr(), b, c, f, cap)
    _launches["select_level_fused"] += 1
    return out, counts, counts > cap
