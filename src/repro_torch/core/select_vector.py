"""Vectorized range select (paper §3): the *select spec* of the engine.

``make_select_bfs`` is the batched level-synchronous BFS (the paper's
V-O1 queue traversal with the per-query queue generalized to a (B, cap)
frontier).  The level loop lives in core/traversal.py; this module
contributes the D1 intersect-mask score stage, the compress-store emission
kind, the caps policy, and the kernel routing:

  unfused     — per level, ``kernels/ops.select_level_masks`` (kernel B1 on
                the card) writes the (B, C, F) mask, and
                ``compaction._scatter_compact`` packs the qualifying
                children;
  ``fused``   — per level, one ``kernels/ops.select_level_fused`` call
                (kernel B2 on the card) evaluates the predicate AND
                compress-stores the qualifying children in order.

Both produce identical ids, counts and counters (except ``dispatches``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..kernels import ops
from . import caps as caps_policy
from . import traversal
from .counters import StageModel
from .layouts import layout_lanes, tree_layout
from .rtree import RTree, RTreeLevel


def _masks_for_level(lvl: RTreeLevel, ids: torch.Tensor,
                     queries: torch.Tensor, backend: str):
    """Evaluate the select predicate for frontier ``ids`` of one D1 level.

    ids: (B, C) node ids (-1 pad); queries: (B, 4).
    Returns (mask (B, C, F) bool, child_ids (B, C, F), n_compare_stages).
    """
    mask = ops.select_level_masks(ids, queries, lvl.lx, lvl.ly, lvl.hx,
                                  lvl.hy, lvl.child, backend=backend)
    ptr = lvl.child[ids.clamp(min=0).long()]
    return mask.to(torch.bool), ptr, 4


def frontier_caps(tree: RTree, result_cap: int, slack: int = 4,
                  min_cap: int = 128, lanes: Optional[int] = None,
                  policy: str = "static") -> Tuple[int, ...]:
    """Frontier capacity entering each level (root-1 … leaf) — the unified
    policy (core/caps.py); ``policy='adaptive'`` selects the tight tier."""
    kw = {} if lanes is None else dict(lanes=lanes)
    return caps_policy.select_frontier_caps(tree, result_cap, slack=slack,
                                            min_cap=min_cap, policy=policy,
                                            **kw)


def make_select_bfs(tree: RTree, layout: str = "d1", result_cap: int = 4096,
                    caps: Optional[Sequence[int]] = None,
                    backend: str = "auto", fused: bool = False,
                    caps_mode: str = "adaptive",
                    caps_tree: Optional[RTree] = None):
    """Build the batched BFS select: queries (B, 4) → results.

    ``backend``: 'auto' runs the CUDA kernels when the tree lies on a CUDA
    device and their plain PyTorch twins when it lies on the CPU; 'cuda'
    demands the kernels (raises for CPU tensors); 'torch' runs the twins
    on any device (the reference the kernels are held against).

    ``fused=True``: one fused whole-level step per level — the predicate
    AND the in-order compress-store enqueue in one kernel, with no
    (B, C, F) mask intermediate; ``Counters.dispatches`` drops from 3 per
    level to 1 and every other result is unchanged.

    ``caps_mode`` (used only when ``caps`` is None): 'adaptive' builds the
    two-tier overflow-escalating engine (occupancy-adaptive tight caps,
    re-run on the static caps after an overflow, results equal to the
    static path); 'static' builds the single static-caps engine.

    ``caps_tree`` (default ``tree``) is the tree whose level sizes set the
    default caps: the mesh path runs over a packed forest with one padded
    partition's caps.

    Returns fn(queries, roots=None) → (ids (B, result_cap), counts (B,),
    Counters); ``queries`` may be any array-like, it is moved to the tree's
    device; ``roots`` (B,) starts each row at that node of the root level
    (default 0).
    """
    lanes = layout_lanes(layout)     # d1 and d3; d0 / d2 raise
    ops.resolve_backend(backend, tree.rects)
    # the D3 code rows, quantized on the tree's device (internal levels)
    layers = tree_layout(tree, "d3") if layout == "d3" else None
    ctx = (tree.levels, layers)

    def score(ctx, li, frontier, qargs):
        levels, layers = ctx
        ids, queries = frontier[0], qargs[0]
        b = queries.shape[0]
        if layers is not None and li > 0:
            lvl3 = layers[li]
            mask = ops.select_level_masks_d3(
                ids, queries, lvl3.qlo, lvl3.qhi, lvl3.scale, lvl3.bias,
                lvl3.ptr, backend=backend).to(torch.bool)
            ptr, stages = lvl3.ptr[ids.clamp(min=0).long()], 2
        else:
            # D1, and D3 leaf rows: level 0's SoA rows are the exact rects
            mask, ptr, stages = _masks_for_level(levels[li], ids, queries,
                                                 backend)
        f = mask.shape[-1]
        return mask.reshape(b, -1), (ptr.reshape(b, -1),), f, stages, None

    def fused_level(ctx, li, frontier, qargs, cap):
        levels, layers = ctx
        ids, queries = frontier[0], qargs[0]
        if layers is not None and li > 0:
            lvl3 = layers[li]
            nxt, qcnt, o = ops.select_level_fused_d3(
                ids, queries, lvl3.qlo, lvl3.qhi, lvl3.scale, lvl3.bias,
                lvl3.ptr, cap=cap, backend=backend)
            return (nxt,), qcnt, o, lvl3.ptr.shape[1], 2, None
        lvl = levels[li]
        nxt, qcnt, o = ops.select_level_fused(
            ids, queries, lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child,
            cap=cap, backend=backend)
        return (nxt,), qcnt, o, lvl.fanout, 4, None

    def build(caps_):
        caps_ = tuple(caps_)
        if len(caps_) != tree.height - 1:
            raise ValueError(
                f"need {tree.height - 1} caps, got {len(caps_)}")
        run = traversal.make_mask_engine(
            SELECT_SPEC, height=tree.height, caps=caps_,
            result_cap=result_cap, score=score,
            fused_level=fused_level if fused else None)

        def fn(queries, roots=None):
            q = torch.as_tensor(queries, dtype=torch.float32,
                                device=tree.device).contiguous()
            res, counts, ctr = run(ctx, q,
                                   roots=None if roots is None else (roots,))
            return res[0], counts, ctr
        return fn

    if caps is not None:
        return build(caps)
    caps_tree = tree if caps_tree is None else caps_tree
    full = frontier_caps(caps_tree, result_cap, lanes=lanes)
    if caps_mode == "static":
        return build(full)
    tight = frontier_caps(caps_tree, result_cap, lanes=lanes,
                          policy="adaptive")
    return traversal.maybe_escalating(build, tight, full)


SELECT_SPEC = traversal.register(traversal.OperatorSpec(
    name="select", kind="mask",
    stage_model=StageModel(inner=3, leaf=3, fused=1),
    builder=make_select_bfs, caps_policy=frontier_caps, query_width=4,
    description="batched range select: intersect-mask score, "
                "compress-store emission"))
