"""Wrappers of the CUDA join kernels (``csrc/rtree_join.cu``).

B3 ``join_pair_masks_cuda`` replaces the Pallas
``repro/kernels/rtree_join.py:join_pair_masks`` (line 73); B4
``join_level_fused_cuda`` replaces ``join_level_fused`` (line 129).  The
source file's header gives each kernel's bound on the card and what its
design does about it; the plain PyTorch twins are in ``kernels/ref.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch, launches on the current CUDA stream, raises if a
launch was refused, and adds one to its launch count (B4 is one count for
its count, scan and scatter launches).  Nothing here falls back to the
twin: CPU tensors raise.  Nothing here waits for the device either.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

_LIB = "rtree_join"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {                           # the stream pointer is appended
    "rtree_join_masks": [_P] * 7 + [_I] * 5,
    "rtree_join_fused": [_P] * 14 + [_I] * 4 + [ctypes.c_longlong],
}
_SMEM_LIMIT = 48 * 1024                 # dynamic shared memory without opt-in

# launches per kernel since the last reset (plain integers)
_launches: Dict[str, int] = {"join_pair_masks": 0, "join_level_fused": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _check(o_ids, i_ids, alive_cnt, flip_max, o_coords, i_coords, to,
           **ptrs):
    """Validate one pair-frontier call; returns (P, F_out, F_in, to)."""
    tensors = dict(o_ids=o_ids, i_ids=i_ids, alive_cnt=alive_cnt,
                   flip_max=flip_max, o_coords=o_coords, i_coords=i_coords,
                   **ptrs)
    dev = o_ids.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(
                f"CUDA join kernel: {name} must lie on the CUDA device of "
                f"o_ids ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA join kernel: {name} must be contiguous")
        want = torch.float32 if name.endswith("coords") else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if o_ids.ndim != 1 or o_ids.numel() == 0:
        raise ValueError(f"o_ids must be non-empty (P,), got "
                         f"{tuple(o_ids.shape)}")
    p = o_ids.shape[0]
    for name in ("i_ids", "alive_cnt"):
        if tuple(tensors[name].shape) != (p,):
            raise ValueError(f"{name} must be {(p,)}, got "
                             f"{tuple(tensors[name].shape)}")
    for name in ("o_coords", "i_coords"):
        t = tensors[name]
        if t.ndim != 3 or t.shape[1] != 4 or 0 in t.shape:
            raise ValueError(f"{name} must be non-empty (N, 4, F), got "
                             f"{tuple(t.shape)}")
    fo, fi = o_coords.shape[2], i_coords.shape[2]
    to = min(to, fo)
    if to < 1 or fo % to:
        raise ValueError(f"outer fanout {fo} not divisible by tile {to}")
    if tuple(flip_max.shape) != (p, fo // to):
        raise ValueError(f"flip_max must be {(p, fo // to)}, got "
                         f"{tuple(flip_max.shape)}")
    for name, coords in (("o_ptr", o_coords), ("i_ptr", i_coords)):
        if name in ptrs and tuple(ptrs[name].shape) != \
                (coords.shape[0], coords.shape[2]):
            raise ValueError(f"{name} must be "
                             f"{(coords.shape[0], coords.shape[2])}, got "
                             f"{tuple(ptrs[name].shape)}")
    smem = _build.layout(_LIB, "rtree_join_pair_smem", fo, fi, to,
                         int(bool(ptrs)))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fanouts ({fo}, {fi}) need {smem} bytes of shared "
                         f"memory per pair, over {_SMEM_LIMIT}")
    return p, fo, fi, to


def join_pair_masks_cuda(o_ids, i_ids, alive_cnt, flip_max, o_coords,
                         i_coords, *, to: int = 8, ti: int = 128):
    """Kernel B3: (P,) int32 outer and inner node ids (-1 pad), O3 / O4-O5
    bounds alive_cnt (P,) and flip_max (P, F_out/to), (N, 4, F) float32 D1
    coords → (P, F_out, F_in) int32 intersect mask with the tile skip."""
    p, fo, fi, to = _check(o_ids, i_ids, alive_cnt, flip_max, o_coords,
                           i_coords, to)
    ti = min(ti, fi)
    if ti < 1 or fi % ti:
        raise ValueError(f"inner fanout {fi} not divisible by tile {ti}")
    with torch.cuda.device(o_ids.device):
        mask = torch.empty((p, fo, fi), dtype=torch.int32,
                           device=o_ids.device)
        _build.launch(_LIB, "rtree_join_masks", _ARGTYPES["rtree_join_masks"],
                      o_ids.data_ptr(), i_ids.data_ptr(), alive_cnt.data_ptr(),
                      flip_max.data_ptr(), o_coords.data_ptr(),
                      i_coords.data_ptr(), mask.data_ptr(), p, fo, fi, to, ti)
    _launches["join_pair_masks"] += 1
    return mask


def join_level_fused_cuda(o_ids, i_ids, alive_cnt, flip_max, o_coords,
                          i_coords, o_ptr, i_ptr, *, cap: int, to: int = 8):
    """Kernel B4: B3's predicate (inner tile ``min(128, F_in)``) AND child
    pointers >= 0, compress-stored over the flat P·F_out·F_in lanes →
    (out_o (cap,) int32 -1 padded, out_i (cap,), count () int32 (may
    exceed cap), overflow () bool) — ``compact_pairs``'s contract.  Count
    and overflow stay on the device.  Allocates an int32 count per pair and
    an int64 scratch (offsets, scan tiles, the total and eight int32 warp
    counts a pair) sized by ``rtree_join_fused_scratch``."""
    p, fo, fi, to = _check(o_ids, i_ids, alive_cnt, flip_max, o_coords,
                           i_coords, to, o_ptr=o_ptr, i_ptr=i_ptr)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    dev = o_ids.device
    with torch.cuda.device(dev):
        out_o = torch.empty((cap,), dtype=torch.int32, device=dev)
        out_i = torch.empty((cap,), dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        overflow = torch.empty((), dtype=torch.bool, device=dev)
        counts = torch.empty((p,), dtype=torch.int32, device=dev)
        scratch = torch.empty(
            (_build.layout(_LIB, "rtree_join_fused_scratch", p),),
            dtype=torch.int64, device=dev)
        _build.launch(_LIB, "rtree_join_fused", _ARGTYPES["rtree_join_fused"],
                      o_ids.data_ptr(), i_ids.data_ptr(), alive_cnt.data_ptr(),
                      flip_max.data_ptr(), o_coords.data_ptr(),
                      i_coords.data_ptr(), o_ptr.data_ptr(), i_ptr.data_ptr(),
                      out_o.data_ptr(), out_i.data_ptr(), count.data_ptr(),
                      overflow.data_ptr(), counts.data_ptr(),
                      scratch.data_ptr(), p, fo, fi, to, cap)
    _launches["join_level_fused"] += 1
    return out_o, out_i, count, overflow
