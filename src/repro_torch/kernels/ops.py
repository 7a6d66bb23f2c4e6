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
from . import rtree_dfs as _dfs
from . import rtree_join as _join
from . import rtree_knn as _knn
from . import rtree_knn_join as _knn_join
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
    ("select", "score_d3"): (_ref.select_level_masks_d3_ref,
                             _select.select_level_masks_d3_cuda),
    ("select", "fused_d3"): (_ref.select_level_fused_d3_ref,
                             _select.select_level_fused_d3_cuda),
    ("join", "score"): (_ref.join_pair_masks_ref,
                        _join.join_pair_masks_cuda),
    ("join", "fused"): (_ref.join_level_fused_ref,
                        _join.join_level_fused_cuda),
    ("knn", "score"): (_ref.knn_level_dists_ref,
                       _knn.knn_level_dists_cuda),
    ("knn", "score_d3"): (_ref.knn_level_dists_d3_ref,
                          _knn.knn_level_dists_d3_cuda),
    ("knn", "fused"): (_ref.knn_level_fused_ref,
                       _knn.knn_level_fused_cuda),
    ("knn", "fused_leaf"): (_ref.knn_leaf_fused_ref,
                            _knn.knn_leaf_fused_cuda),
    ("knn_join", "score"): (_ref.knn_join_level_dists_ref,
                            _knn_join.knn_join_level_dists_cuda),
    ("knn_join", "score_d3"): (_ref.knn_join_level_dists_d3_ref,
                               _knn_join.knn_join_level_dists_d3_cuda),
    ("knn_join", "fused"): (_ref.knn_join_level_fused_ref,
                            _knn_join.knn_join_level_fused_cuda),
    ("knn_join", "fused_leaf"): (_ref.knn_join_leaf_fused_ref,
                                 _knn_join.knn_join_leaf_fused_cuda),
    ("select_dfs", "scalar"): (_ref.select_dfs_scalar_ref,
                               _dfs.select_dfs_scalar_cuda),
    ("select_dfs", "vector"): (_ref.select_dfs_vector_ref,
                               _dfs.select_dfs_vector_cuda),
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


def select_level_masks_d3(ids, queries, qlo, qhi, scale, bias, ptr,
                          backend: str = "auto"):
    """D3 level-step qualify masks: (B,C) ids × (B,4) queries over packed
    uint16 code rows → (B,C,F) int32 conservative mask (a superset of the
    D1 mask; the operators re-check leaf rows exactly)."""
    return kernel_call("select", "score_d3", ids, queries, qlo, qhi, scale,
                       bias, ptr, backend=backend)


def select_level_fused_d3(ids, queries, qlo, qhi, scale, bias, ptr, *,
                          cap: int, backend: str = "auto"):
    """Fused D3 select level: the D3 predicate and the in-order
    compress-store → (next_ids (B,cap), counts (B,), overflow (B,))."""
    return kernel_call("select", "fused_d3", ids, queries, qlo, qhi, scale,
                       bias, ptr, cap=cap, backend=backend)


def knn_level_dists(ids, points, lx, ly, hx, hy, child, *,
                    leaf: bool = False, backend: str = "auto"):
    """kNN level-step distances: (B,C) ids × (B,2) points → (mindist
    (B,C,F), minmaxdist (B,C,F) | None at the leaf) float32, DIST_PAD on
    invalid lanes."""
    return kernel_call("knn", "score", ids, points, lx, ly, hx, hy, child,
                       leaf=leaf, backend=backend)


def knn_level_dists_d3(ids, points, qlo, qhi, scale, bias, slack, ptr,
                       backend: str = "auto"):
    """D3 kNN level distances: (B,C) ids × (B,2) points → (MINDIST lower
    bound, slack-corrected MINMAXDIST upper bound), each (B,C,F) float32,
    DIST_PAD on invalid lanes.  Internal levels only."""
    return kernel_call("knn", "score_d3", ids, points, qlo, qhi, scale,
                       bias, slack, ptr, backend=backend)


def knn_level_fused(ids, points, lx, ly, hx, hy, child, tau, *, cap: int,
                    k: int, tighten: bool, backend: str = "auto"):
    """Fused kNN internal level: (B,C) ids × (B,2) points, τ (B,) →
    (next_ids (B,cap), τ (B,), valid_cnt (B,), keep_cnt (B,))."""
    return kernel_call("knn", "fused", ids, points, lx, ly, hx, hy, child,
                       tau, cap=cap, k=k, tighten=tighten, backend=backend)


def knn_leaf_fused(ids, points, lx, ly, hx, hy, child, *, k: int,
                   backend: str = "auto"):
    """Fused kNN leaf: (B,C) ids × (B,2) points → (ids (B,k), d (B,k) with
    (-1, +inf) for missing rows, valid_cnt (B,))."""
    return kernel_call("knn", "fused_leaf", ids, points, lx, ly, hx, hy,
                       child, k=k, backend=backend)


def knn_join_level_dists(ids, qrects, lx, ly, hx, hy, child, *,
                         leaf: bool = False, backend: str = "auto"):
    """kNN-join level-step distances: (B,C) ids × (B,4) rects → (mindist
    (B,C,F), minmaxdist (B,C,F) | None at the leaf) float32, DIST_PAD on
    invalid lanes."""
    return kernel_call("knn_join", "score", ids, qrects, lx, ly, hx, hy,
                       child, leaf=leaf, backend=backend)


def knn_join_level_dists_d3(ids, qrects, qlo, qhi, scale, bias, slack, ptr,
                            backend: str = "auto"):
    """D3 kNN-join level distances (rect queries): contract as
    ``knn_level_dists_d3``."""
    return kernel_call("knn_join", "score_d3", ids, qrects, qlo, qhi, scale,
                       bias, slack, ptr, backend=backend)


def knn_join_level_fused(ids, qrects, lx, ly, hx, hy, child, tau, *,
                         cap: int, k: int, tighten: bool,
                         backend: str = "auto"):
    """Fused kNN-join internal level (rect queries): contract as
    ``knn_level_fused``."""
    return kernel_call("knn_join", "fused", ids, qrects, lx, ly, hx, hy,
                       child, tau, cap=cap, k=k, tighten=tighten,
                       backend=backend)


def knn_join_leaf_fused(ids, qrects, lx, ly, hx, hy, child, *, k: int,
                        backend: str = "auto"):
    """Fused kNN-join leaf (rect queries): contract as
    ``knn_leaf_fused``."""
    return kernel_call("knn_join", "fused_leaf", ids, qrects, lx, ly, hx,
                       hy, child, k=k, backend=backend)


def select_dfs(variant: str, lx, ly, hx, hy, child, count, is_leaf, q, *,
               root: int, stack_cap: int, result_cap: int, max_steps: int,
               backend: str = "auto"):
    """One query's DFS walk over the flat node table, kernel S
    (``variant='scalar'``) or V ('vector') → (res (result_cap,) int32 in
    emit order, stats (4,) int32: rc, nodes, predicates, overflow)."""
    return kernel_call("select_dfs", variant, lx, ly, hx, hy, child, count,
                       is_leaf, q, root=root, stack_cap=stack_cap,
                       result_cap=result_cap, max_steps=max_steps,
                       backend=backend)


def join_pair_masks(o_ids, i_ids, alive_cnt, flip_max, o_coords, i_coords,
                    to: int = 8, ti: int = 128, backend: str = "auto"):
    """Pair-frontier tile masks: (P,) × (P,) node ids → (P, F_o, F_i)
    int32."""
    return kernel_call("join", "score", o_ids, i_ids, alive_cnt, flip_max,
                       o_coords, i_coords, to=to, ti=ti, backend=backend)


def join_level_fused(o_ids, i_ids, alive_cnt, flip_max, o_coords, i_coords,
                     o_ptr, i_ptr, *, cap: int, to: int = 8,
                     backend: str = "auto"):
    """Fused join level: pair frontier → (out_o (cap,), out_i (cap,), count,
    overflow) — compact_pairs' contract, in one step."""
    return kernel_call("join", "fused", o_ids, i_ids, alive_cnt, flip_max,
                       o_coords, i_coords, o_ptr, i_ptr, cap=cap, to=to,
                       backend=backend)


def join_prune_metadata(o_ids, i_ids, o_coords, i_coords, *, to: int = 8,
                        o3: bool = True, o45: bool = True):
    """The pruning bounds of the join kernels, in plain tensor ops (an XLA
    pre-pass in the reference, not a kernel).

    alive_cnt[p] — #leading outer children with low_x <= max inner high_x
                   (monotone under the sort, so a count == the O3 slice).
    flip_max[p,a] — max over the outer tile's rows of the flip index
                   (#inner children with low_x <= outer high_x).
    """
    so, si = o_ids.clamp(min=0).long(), i_ids.clamp(min=0).long()
    oc, ic = o_coords[so], i_coords[si]
    p, _, fo = oc.shape
    fi = ic.shape[2]
    to_ = min(to, fo)
    na = fo // to_
    i32 = dict(dtype=torch.int32, device=o_ids.device)
    if o3:
        max_ihx = ic[:, 2].amax(dim=1)                          # (P,)
        alive_cnt = (oc[:, 0] <= max_ihx[:, None]).sum(dim=1,
                                                       dtype=torch.int32)
    else:
        alive_cnt = torch.full((p,), fo, **i32)
    if o45:
        flip = (ic[:, 0][:, None, :] <= oc[:, 2][:, :, None]).sum(
            -1, dtype=torch.int32)
        flip_max = flip.reshape(p, na, to_).amax(dim=2)
    else:
        flip_max = torch.full((p, na), fi, **i32)
    return alive_cnt, flip_max
