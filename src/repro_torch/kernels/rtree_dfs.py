"""Wrappers of the CUDA DFS baselines (``csrc/rtree_dfs.cu``).

S ``select_dfs_scalar_cuda`` replaces the reference's jitted
``repro/core/select_scalar.py:make_select_dfs`` (line 95) and V
``select_dfs_vector_cuda`` its ``repro/core/select_vector.py:
make_select_dfs_vector`` (line 259): XLA ``while_loop`` programs in the
reference, not Pallas kernels.  Each walks the flat node table
(``core/flat.py``) for one query per launch.  The source file's header
gives the kernels' bound on the card and their design; the plain twins
are in ``kernels/ref.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates the
result slots and the stats, launches on the current CUDA stream, raises
if the launch was refused, and adds one to its launch count.  Nothing
here falls back to the twin (CPU tensors raise), and nothing waits for
the device.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

_LIB = "rtree_dfs"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 5        # the stream pointer is appended

# launches per kernel since the last reset (plain integers)
_launches: Dict[str, int] = {"select_dfs_scalar": 0, "select_dfs_vector": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _check(rows, q, stack_cap: int, result_cap: int):
    """Validate one walk: the flat table's (T, F) rows, (T,) count and
    is_leaf, and the (4,) query, all on one CUDA device and contiguous.
    Returns F."""
    dev = rows["lx"].device
    for name, t in dict(rows, q=q).items():
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(f"CUDA DFS kernel: {name} must lie on the "
                               f"CUDA device of lx ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA DFS kernel: {name} must be contiguous")
        want = torch.int32 if name in ("child", "count") else \
            torch.bool if name == "is_leaf" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    t_nodes, f = rows["lx"].shape
    for name in ("ly", "hx", "hy", "child"):
        if tuple(rows[name].shape) != (t_nodes, f):
            raise ValueError(f"{name} must be {(t_nodes, f)}, got "
                             f"{tuple(rows[name].shape)}")
    for name in ("count", "is_leaf"):
        if tuple(rows[name].shape) != (t_nodes,):
            raise ValueError(f"{name} must be {(t_nodes,)}, got "
                             f"{tuple(rows[name].shape)}")
    if tuple(q.shape) != (4,):
        raise ValueError(f"q must be (4,), got {tuple(q.shape)}")
    top = _build.layout(_LIB, "rtree_dfs_max_stack_cap")
    if not 1 <= stack_cap <= top:
        raise ValueError(f"stack_cap must be in [1, {top}] (the stack is "
                         f"shared memory), got {stack_cap}")
    if result_cap < 1:
        raise ValueError(f"result_cap must be >= 1, got {result_cap}")
    return f


def _walk(entry, count_name, lx, ly, hx, hy, child, count, is_leaf, q, *,
          root: int, stack_cap: int, result_cap: int, max_steps: int):
    rows = dict(lx=lx, ly=ly, hx=hx, hy=hy, child=child, count=count,
                is_leaf=is_leaf)
    f = _check(rows, q, stack_cap, result_cap)
    with torch.cuda.device(lx.device):
        res = torch.empty((result_cap,), dtype=torch.int32, device=lx.device)
        stats = torch.empty((4,), dtype=torch.int32, device=lx.device)
        _build.launch(_LIB, entry, _ARGTYPES,
                      *(t.data_ptr() for t in rows.values()), q.data_ptr(),
                      res.data_ptr(), stats.data_ptr(), root, f, stack_cap,
                      result_cap, max_steps)
    _launches[count_name] += 1
    return res, stats


def select_dfs_scalar_cuda(lx, ly, hx, hy, child, count, is_leaf, q, *,
                           root: int, stack_cap: int, result_cap: int,
                           max_steps: int):
    """Kernel S: one thread walks the flat table for the (4,) float32
    query ``q`` from node ``root`` → (res (result_cap,) int32 ids in DFS
    emit order, -1 padded; stats (4,) int32: rc (may exceed result_cap),
    nodes visited, predicates, overflow)."""
    return _walk("rtree_select_dfs_scalar", "select_dfs_scalar", lx, ly, hx,
                 hy, child, count, is_leaf, q, root=root,
                 stack_cap=stack_cap, result_cap=result_cap,
                 max_steps=max_steps)


def select_dfs_vector_cuda(lx, ly, hx, hy, child, count, is_leaf, q, *,
                           root: int, stack_cap: int, result_cap: int,
                           max_steps: int):
    """Kernel V: one warp walks the flat table, a node's F lanes tested in
    chunks of 32 and compacted in lane order → S's outputs (predicates
    0: the caller derives V's counters from the nodes visited)."""
    return _walk("rtree_select_dfs_vector", "select_dfs_vector", lx, ly, hx,
                 hy, child, count, is_leaf, q, root=root,
                 stack_cap=stack_cap, result_cap=result_cap,
                 max_steps=max_steps)
