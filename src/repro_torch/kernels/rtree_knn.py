"""Wrappers of the CUDA kNN kernels (``csrc/rtree_knn.cu``), and the
launchers that the kNN-join wrappers (``kernels/rtree_knn_join.py``) share.

B5 ``knn_level_dists_cuda`` replaces the Pallas
``repro/kernels/rtree_knn.py:knn_level_dists`` (line 105); B6
``knn_level_fused_cuda`` replaces ``knn_level_fused`` (line 454) and B7
``knn_leaf_fused_cuda`` replaces ``knn_leaf_fused`` (line 467); on the D3
layout, B13 ``knn_level_dists_d3_cuda`` replaces ``knn_level_dists_d3``
(line 190).  The source
file's header gives each kernel's bound on the card and what its design
does about it; the plain PyTorch twins are in ``kernels/ref.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on the current CUDA stream, raises if the launch was
refused, and adds one to its launch count.  Nothing here falls back to the
twin: CPU tensors raise.  Nothing here waits for the device either.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import _build

_LIB = "rtree_knn"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {                           # the stream pointer is appended
    "rtree_knn_dists": [_P] * 9 + [_I] * 4,
    "rtree_knn_level_fused": [_P] * 12 + [_I] * 6,
    "rtree_knn_leaf_fused": [_P] * 10 + [_I] * 4,
    "rtree_knn_join_dists": [_P] * 9 + [_I] * 4,
    "rtree_knn_join_level_fused": [_P] * 12 + [_I] * 6,
    "rtree_knn_join_leaf_fused": [_P] * 10 + [_I] * 4,
    "rtree_knn_dists_d3": [_P] * 10 + [_I] * 3,
    "rtree_knn_join_dists_d3": [_P] * 10 + [_I] * 3,
}

# launches per kernel since the last reset (plain integers)
_launches: Dict[str, int] = {"knn_level_dists": 0, "knn_level_fused": 0,
                             "knn_leaf_fused": 0, "knn_level_dists_d3": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


@functools.lru_cache(maxsize=1)
def _max_cap() -> int:
    """The largest B6 cap / B7 k of ``csrc/rtree_knn.cu`` (its survivors'
    keys live in shared memory)."""
    f = _build.load(_LIB).rtree_knn_max_cap
    f.argtypes, f.restype = [], ctypes.c_int
    return int(f())


_INT32_ROWS, _UINT16_ROWS = ("ids", "child", "ptr"), ("qlo", "qhi")


def _check(ids, queries, rows, *, width: int, node_cols=(), **extra):
    """Validate one level call with (B, ``width``) query rows over the
    level's ``rows`` (name → tensor, the first an (N, F) row; those named
    in ``node_cols`` (N, 2)); ids, child and ptr are int32, qlo and qhi
    uint16, all else float32.  Returns (B, C, F)."""
    tensors = dict(ids=ids, queries=queries, **rows, **extra)
    dev = ids.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(
                f"CUDA kNN kernel: {name} must lie on the CUDA device of "
                f"ids ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA kNN kernel: {name} must be contiguous")
        want = torch.int32 if name in _INT32_ROWS else \
            torch.uint16 if name in _UINT16_ROWS else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if ids.ndim != 2 or 0 in ids.shape:
        raise ValueError(f"ids must be non-empty (B, C), got "
                         f"{tuple(ids.shape)}")
    b, c = ids.shape
    if tuple(queries.shape) != (b, width):
        raise ValueError(f"queries must be {(b, width)}, got "
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
    if "tau" in extra and tuple(extra["tau"].shape) != (b,):
        raise ValueError(f"tau must be {(b,)}, got "
                         f"{tuple(extra['tau'].shape)}")
    if c * f >= 2 ** 31:
        raise ValueError(f"C·F = {c * f} lanes exceed the int32 lane index")
    return b, c, f


def _d1_rows(lx, ly, hx, hy, child):
    return dict(lx=lx, ly=ly, hx=hx, hy=hy, child=child)


def _check_width(name: str, width: int, least: int = 1) -> None:
    if width < least:
        raise ValueError(f"{name} must be >= {least}, got {width}")
    most = _max_cap()
    if width > most:
        raise ValueError(f"{name} = {width} exceeds the {most} "
                         f"survivors the CUDA kNN kernels keep in shared "
                         f"memory")


def emit_stage_slots(c: int, f: int, *, leaf: bool) -> int:
    """Frontier slots whose lanes one B6 / B9 block (B7 / B10 with
    ``leaf``) stages in shared memory at once, for C slots of fanout F: C
    when they fit, else fewer, and a row with more live slots is walked in
    segments (``csrc/rtree_knn.cu`` holds the budget)."""
    return _build.layout(_LIB, "rtree_knn_emit_stage_slots", c, f,
                         int(leaf))


# One launcher per kernel body, shared by the kNN (point, width 2) and the
# kNN-join (rect, width 4) entry points; the callers count the launches.

def launch_dists(entry: str, width: int, ids, queries, lx, ly, hx, hy,
                 child, leaf: bool):
    b, c, f = _check(ids, queries, _d1_rows(lx, ly, hx, hy, child),
                     width=width)
    dev = ids.device
    with torch.cuda.device(dev):
        md = torch.empty((b, c, f), dtype=torch.float32, device=dev)
        mmd = None if leaf else torch.empty_like(md)
        _build.launch(_LIB, entry, _ARGTYPES[entry], ids.data_ptr(),
                      queries.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                      hx.data_ptr(), hy.data_ptr(), child.data_ptr(),
                      md.data_ptr(), None if leaf else mmd.data_ptr(), b, c,
                      f, int(leaf))
    return md, mmd


def launch_dists_d3(entry: str, width: int, ids, queries, qlo, qhi, scale,
                    bias, slack, ptr):
    rows = dict(qlo=qlo, qhi=qhi, scale=scale, bias=bias, slack=slack,
                ptr=ptr)
    b, c, f = _check(ids, queries, rows, width=width,
                     node_cols=("scale", "bias", "slack"))
    dev = ids.device
    with torch.cuda.device(dev):
        md = torch.empty((b, c, f), dtype=torch.float32, device=dev)
        mmd = torch.empty_like(md)
        _build.launch(_LIB, entry, _ARGTYPES[entry], ids.data_ptr(),
                      queries.data_ptr(),
                      *(t.data_ptr() for t in rows.values()),
                      md.data_ptr(), mmd.data_ptr(), b, c, f)
    return md, mmd


def launch_level_fused(entry: str, width: int, ids, queries, lx, ly, hx, hy,
                       child, tau, cap: int, k: int, tighten: bool):
    b, c, f = _check(ids, queries, _d1_rows(lx, ly, hx, hy, child),
                     width=width, tau=tau)
    _check_width("cap", cap, least=0)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if tighten and c * f < k:
        raise ValueError(f"tightening needs C·F >= k lanes, got {c * f} < "
                         f"{k}")
    dev = ids.device
    i32 = dict(dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        nxt = torch.empty((b, cap), **i32)
        tau_out = torch.empty((b,), dtype=torch.float32, device=dev)
        valid_cnt = torch.empty((b,), **i32)
        keep_cnt = torch.empty((b,), **i32)
        _build.launch(_LIB, entry, _ARGTYPES[entry], ids.data_ptr(),
                      queries.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                      hx.data_ptr(), hy.data_ptr(), child.data_ptr(),
                      tau.data_ptr(), nxt.data_ptr(), tau_out.data_ptr(),
                      valid_cnt.data_ptr(), keep_cnt.data_ptr(), b, c, f,
                      cap, k, int(bool(tighten)))
    return nxt, tau_out, valid_cnt, keep_cnt


def launch_leaf_fused(entry: str, width: int, ids, queries, lx, ly, hx, hy,
                      child, k: int):
    b, c, f = _check(ids, queries, _d1_rows(lx, ly, hx, hy, child),
                     width=width)
    _check_width("k", k)
    dev = ids.device
    with torch.cuda.device(dev):
        out_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
        out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
        valid_cnt = torch.empty((b,), dtype=torch.int32, device=dev)
        _build.launch(_LIB, entry, _ARGTYPES[entry], ids.data_ptr(),
                      queries.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                      hx.data_ptr(), hy.data_ptr(), child.data_ptr(),
                      out_ids.data_ptr(), out_d.data_ptr(),
                      valid_cnt.data_ptr(), b, c, f, k)
    return out_ids, out_d, valid_cnt


def knn_level_dists_cuda(ids, points, lx, ly, hx, hy, child, *,
                         leaf: bool = False):
    """Kernel B5: (B, C) int32 ids (-1 pad) × (B, 2) float32 points over
    (N, F) SoA rows → (mindist (B, C, F), minmaxdist (B, C, F) | None)
    float32, DIST_PAD on invalid lanes; ``leaf=True`` computes MINDIST
    only and returns None for the bound."""
    out = launch_dists("rtree_knn_dists", 2, ids, points, lx, ly, hx, hy,
                       child, leaf)
    _launches["knn_level_dists"] += 1
    return out


def knn_level_fused_cuda(ids, points, lx, ly, hx, hy, child, tau, *,
                         cap: int, k: int, tighten: bool):
    """Kernel B6: one internal level — τ = min(tau, k-th smallest
    MINMAXDIST over the C·F lanes) when ``tighten``, MINDIST <= τ pruning,
    and the best-first beam → (next (B, cap) int32 -1 padded, τ (B,)
    float32, valid_cnt (B,) int32, keep_cnt (B,) int32); ``cap`` may be
    0 (the tallies and τ only)."""
    out = launch_level_fused("rtree_knn_level_fused", 2, ids, points, lx,
                             ly, hx, hy, child, tau, cap, k, tighten)
    _launches["knn_level_fused"] += 1
    return out


def knn_leaf_fused_cuda(ids, points, lx, ly, hx, hy, child, *, k: int):
    """Kernel B7: the leaf — the k valid lanes of smallest (MINDIST, lane)
    → (ids (B, k) int32, d (B, k) float32 with (-1, +inf) for missing
    rows, valid_cnt (B,) int32)."""
    out = launch_leaf_fused("rtree_knn_leaf_fused", 2, ids, points, lx, ly,
                            hx, hy, child, k)
    _launches["knn_leaf_fused"] += 1
    return out


def knn_level_dists_d3_cuda(ids, points, qlo, qhi, scale, bias, slack, ptr):
    """Kernel B13: (B, C) int32 ids (-1 pad) × (B, 2) float32 points over a
    D3 level — (N, F) uint16 code rows, (N, 2) float32 scale, bias and
    slack, (N, F) int32 ptr — → (MINDIST on the dequantized boxes, the
    slack-corrected D3-form MINMAXDIST), each (B, C, F) float32, DIST_PAD
    on invalid lanes.  Internal levels only."""
    out = launch_dists_d3("rtree_knn_dists_d3", 2, ids, points, qlo, qhi,
                          scale, bias, slack, ptr)
    _launches["knn_level_dists_d3"] += 1
    return out
