"""Backend routing for every kernel stage (the reference's
``kernels/ops.py``).

One dispatch table, ``_KERNELS``, keyed ``(op, stage)`` like the
reference's, maps each stage to (plain PyTorch twin, CUDA kernel).
``kernel_call`` resolves the backend once for all of them:

  'torch' — the twin, on any device;
  'cuda'  — the kernel; CPU tensors raise;
  'auto'  — the kernel for tensors on a CUDA device, the twin for CPU
            tensors (the counterpart of the reference's choice of Pallas
            on a TPU).  A CUDA tensor never takes the twin silently.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from . import rtree_select as _select

BACKENDS = ("auto", "torch", "cuda")


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """'auto' → 'cuda' or 'torch' from the device of ``tensor``; 'cuda'
    with a CPU tensor raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: valid backends are "
                         f"{', '.join(BACKENDS)}")
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if backend == "cuda" and not tensor.is_cuda:
        raise RuntimeError(f"backend 'cuda' needs CUDA tensors, got a "
                           f"tensor on {tensor.device}")
    return backend


# (op, stage) → (plain PyTorch twin, CUDA kernel wrapper)
_KERNELS = {
    ("select", "score"): (_ref.select_level_masks_ref,
                          _select.select_level_masks_cuda),
    ("select", "fused"): (_ref.select_level_fused_ref,
                          _select.select_level_fused_cuda),
}


def kernel_call(op: str, stage: str, *args, backend: str = "auto",
                **kwargs):
    """Dispatch one operator stage to its twin or its CUDA kernel."""
    twin, kernel = _KERNELS[(op, stage)]
    if resolve_backend(backend, args[0]) == "cuda":
        return kernel(*args, **kwargs)
    return twin(*args, **kwargs)


def select_level_masks(ids, queries, lx, ly, hx, hy, child,
                       backend: str = "auto"):
    """BFS level-step qualify masks: (B,C) ids × (B,4) queries → (B,C,F)
    int32."""
    return kernel_call("select", "score", ids, queries, lx, ly, hx, hy,
                       child, backend=backend)


def select_level_fused(ids, queries, lx, ly, hx, hy, child, *, cap: int,
                       backend: str = "auto"):
    """Fused select level: (B,C) ids × (B,4) queries → (next_ids (B,cap),
    counts (B,), overflow (B,)) — compact_rows' contract, in one step."""
    return kernel_call("select", "fused", ids, queries, lx, ly, hx, hy,
                       child, cap=cap, backend=backend)
