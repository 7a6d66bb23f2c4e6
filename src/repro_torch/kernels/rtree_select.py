"""Wrappers of the CUDA select kernels (``csrc/rtree_select.cu``).

B1 ``select_level_masks_cuda`` replaces the Pallas
``repro/kernels/rtree_select.py:select_level_masks`` (line 64); B2
``select_level_fused_cuda`` replaces ``select_level_fused`` (line 111); on
the D3 layout, B11 ``select_level_masks_d3_cuda`` replaces
``select_level_masks_d3`` (line 213) and B12 ``select_level_fused_d3_cuda``
replaces ``select_level_fused_d3`` (line 256).
The source file's header gives each kernel's bound on the card and what its
design does about it; the plain PyTorch twins are in ``kernels/ref.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (B2 and B12 also their scratch), launches on the current CUDA
stream, raises if a launch was refused, and adds one to its launch count
(B2 and B12: one for their count and scatter launches).  Nothing here
falls back to the twin: CPU tensors raise.
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
    "rtree_select_fused": [_P] * 10 + [_I] * 4,
    "rtree_select_masks_d3": [_P] * 8 + [_I] * 3,
    "rtree_select_fused_d3": [_P] * 10 + [_I] * 4,
}

# launches per kernel since the last reset (plain integers)
_launches: Dict[str, int] = {"select_level_masks": 0,
                             "select_level_fused": 0,
                             "select_level_masks_d3": 0,
                             "select_level_fused_d3": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


_INT32_ROWS, _UINT16_ROWS = ("ids", "child", "ptr"), ("qlo", "qhi")


def _check(ids, queries, rows, node_cols=()):
    """Validate one level call: (B, C) ids, (B, 4) queries and the level's
    ``rows`` (name → tensor, the first an (N, F) row; those named in
    ``node_cols`` (N, 2)); ids, child and ptr are int32, qlo and qhi
    uint16, all else float32.  Returns (B, C, F)."""
    tensors = dict(ids=ids, queries=queries, **rows)
    dev = ids.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(
                f"CUDA select kernel: {name} must lie on the CUDA device of "
                f"ids ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA select kernel: {name} must be "
                             f"contiguous")
        want = torch.int32 if name in _INT32_ROWS else \
            torch.uint16 if name in _UINT16_ROWS else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if ids.ndim != 2 or 0 in ids.shape:
        raise ValueError(f"ids must be non-empty (B, C), got "
                         f"{tuple(ids.shape)}")
    b, c = ids.shape
    if tuple(queries.shape) != (b, 4):
        raise ValueError(f"queries must be {(b, 4)}, got "
                         f"{tuple(queries.shape)}")
    first = next(iter(rows.values()))
    if first.ndim != 2 or 0 in first.shape:
        raise ValueError(f"level rows must be non-empty (N, F), got "
                         f"{tuple(first.shape)}")
    n, f = first.shape
    for name, t in rows.items():
        want = (n, 2) if name in node_cols else (n, f)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got "
                             f"{tuple(t.shape)}")
    return b, c, f


def _d1_rows(lx, ly, hx, hy, child):
    return dict(lx=lx, ly=ly, hx=hx, hy=hy, child=child)


def _d3_rows(qlo, qhi, scale, bias, ptr):
    return dict(qlo=qlo, qhi=qhi, scale=scale, bias=bias, ptr=ptr)


def _masks(entry, count, ids, queries, rows, node_cols=()):
    b, c, f = _check(ids, queries, rows, node_cols)
    with torch.cuda.device(ids.device):
        mask = torch.empty((b, c, f), dtype=torch.int32, device=ids.device)
        _build.launch(_LIB, entry, _ARGTYPES[entry], ids.data_ptr(),
                      queries.data_ptr(),
                      *(t.data_ptr() for t in rows.values()),
                      mask.data_ptr(), b, c, f)
    _launches[count] += 1
    return mask


def _fused(entry, count, ids, queries, rows, cap, node_cols=()):
    b, c, f = _check(ids, queries, rows, node_cols)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    with torch.cuda.device(ids.device):
        out = torch.empty((b, cap), dtype=torch.int32, device=ids.device)
        counts = torch.empty((b,), dtype=torch.int32, device=ids.device)
        # one qualifying total per (query, chunk of the frontier's slots)
        scratch = torch.empty(
            (_build.layout(_LIB, "rtree_select_fused_scratch", b, c),),
            dtype=torch.int32, device=ids.device)
        _build.launch(_LIB, entry, _ARGTYPES[entry], ids.data_ptr(),
                      queries.data_ptr(),
                      *(t.data_ptr() for t in rows.values()),
                      out.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
                      b, c, f, cap)
    _launches[count] += 1
    return out, counts, counts > cap


def select_level_masks_cuda(ids, queries, lx, ly, hx, hy, child):
    """Kernel B1: (B, C) int32 ids (-1 pad) × (B, 4) float32 queries over
    (N, F) SoA rows → (B, C, F) int32 qualify mask."""
    return _masks("rtree_select_masks", "select_level_masks", ids, queries,
                  _d1_rows(lx, ly, hx, hy, child))


def select_level_fused_cuda(ids, queries, lx, ly, hx, hy, child, *,
                            cap: int):
    """Kernel B2: B1's predicate over the whole level plus an in-order
    compress-store → (next_ids (B, cap) int32 -1 padded, counts (B,) int32
    (may exceed cap), overflow (B,) bool) — ``compact_rows``'s contract
    over the flat C·F lanes.  Allocates an int32 scratch of one total per
    (query, chunk of the frontier's slots) for its count pass."""
    return _fused("rtree_select_fused", "select_level_fused", ids, queries,
                  _d1_rows(lx, ly, hx, hy, child), cap)


def select_level_masks_d3_cuda(ids, queries, qlo, qhi, scale, bias, ptr):
    """Kernel B11: (B, C) int32 ids (-1 pad) × (B, 4) float32 queries over
    a D3 level — (N, F) uint16 code rows ``qlo``/``qhi``, (N, 2) float32
    ``scale``/``bias``, (N, F) int32 ``ptr`` — → (B, C, F) int32
    conservative qualify mask on the dequantized boxes."""
    return _masks("rtree_select_masks_d3", "select_level_masks_d3", ids,
                  queries, _d3_rows(qlo, qhi, scale, bias, ptr),
                  node_cols=("scale", "bias"))


def select_level_fused_d3_cuda(ids, queries, qlo, qhi, scale, bias, ptr, *,
                               cap: int):
    """Kernel B12: B11's predicate over the whole level plus B2's in-order
    compress-store, scratch included → (next_ids (B, cap), counts (B,),
    overflow (B,))."""
    return _fused("rtree_select_fused_d3", "select_level_fused_d3", ids,
                  queries, _d3_rows(qlo, qhi, scale, bias, ptr), cap,
                  node_cols=("scale", "bias"))
