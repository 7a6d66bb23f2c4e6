"""Vectorized range select (paper §3): the *select spec* of the engine,
and the paper's V variant.

``make_select_bfs`` is the batched level-synchronous BFS (the paper's
V-O1 queue traversal with the per-query queue generalized to a (B, cap)
frontier).  The level loop lives in core/traversal.py; this module
contributes the layout-specific intersect-mask score stage, the
compress-store emission kind, the caps policy, and the kernel routing:

  unfused     — per level, ``kernels/ops.select_level_masks`` (kernel B1 on
                the card) writes the (B, C, F) mask, and
                ``compaction._scatter_compact`` packs the qualifying
                children;
  ``fused``   — per level, one ``kernels/ops.select_level_fused`` call
                (kernel B2 on the card) evaluates the predicate AND
                compress-stores the qualifying children in order.

Both produce identical ids, counts and counters (except ``dispatches``).
D0 and D2 have no kernel (nor in the reference): their levels are scored
with the layout's own PyTorch math on the tree's device, D2 in two compare
stages on interleaved pairs, D0 after the strided de-interleave.

``make_select_dfs_vector`` is the paper's V: one query's DFS with a dense
compare of each visited node's F lanes and a lane-order compaction push,
kernel V (``kernels/csrc/rtree_dfs.cu``) on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..kernels import ops
from . import caps as caps_policy
from . import traversal
from .counters import StageModel
from .flat import FlatTree
from .geometry import intersects, intersects_pairs
from .layouts import (KERNEL_LAYOUTS, LevelD0, LevelD2, d0_unpack,
                      layout_lanes, tree_layout)
from .rtree import RTree, RTreeLevel
from .select_scalar import _make_dfs


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


def _masks_for_layer(layer, ids: torch.Tensor, queries: torch.Tensor):
    """The select predicate for frontier ``ids`` of one D0 or D2 level, in
    the layout's own PyTorch math: D2 compares interleaved (x, y) pairs in
    two stages, D0 de-interleaves its entries first.  Returns (mask
    (B, C, F) bool, child_ids (B, C, F), n_compare_stages)."""
    safe = ids.clamp(min=0).long()
    if isinstance(layer, LevelD2):
        lo, hi = layer.lo[safe], layer.hi[safe]     # (B, C, 2F)
        b, c, f2 = lo.shape
        q_lo = queries[:, None, None, 0:2]
        q_hi = queries[:, None, None, 2:4]
        m = intersects_pairs(q_lo, q_hi, lo.reshape(b, c, f2 // 2, 2),
                             hi.reshape(b, c, f2 // 2, 2))
        ptr, stages = layer.ptr[safe], 2
    elif isinstance(layer, LevelD0):
        lx, ly, hx, hy, ptr = d0_unpack(layer.entries[safe])
        m = intersects(*(queries[:, j, None, None] for j in range(4)),
                       lx, ly, hx, hy)
        stages = 4
    else:
        raise TypeError(type(layer))
    return m & (ids >= 0)[:, :, None] & (ptr >= 0), ptr, stages


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
                    caps_tree: Optional[RTree] = None,
                    count_only: bool = False):
    """Build the batched BFS select: queries (B, 4) → results.

    ``backend``: 'auto' runs the CUDA kernels when the tree lies on a CUDA
    device and their plain PyTorch twins when it lies on the CPU; 'cuda'
    demands the kernels (raises for CPU tensors); 'torch' runs the twins
    on any device (the reference the kernels are held against).  On D0
    and D2, which have no kernel, 'auto' and 'torch' score with the
    layout's PyTorch math wherever the tree lies, and 'cuda' or
    ``fused=True`` raise ``ValueError``, as the reference's kernel
    backends do on them.

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
    (default 0).  ``count_only=True``: fn → (counts (B,), Counters), the
    leaf's qualifying children counted and never compacted (its overflow
    is not flagged), as the reference's ``count_only``.
    """
    lanes = layout_lanes(layout)
    own_math = layout not in KERNEL_LAYOUTS
    if own_math and backend == "cuda":
        raise ValueError("kernel backend requires layout d1 or d3")
    if own_math and fused:
        raise ValueError("fused select requires a kernel backend (layout "
                         "d1 or d3)")
    ops.resolve_backend(backend, tree.rects)
    # the D3 code rows, quantized on the tree's device (internal levels);
    # D0 and D2 levels, whose own math scores them
    layers = tree_layout(tree, layout) if layout != "d1" else None
    ctx = (tree.levels, layers)

    def score(ctx, li, frontier, qargs):
        levels, layers = ctx
        ids, queries = frontier[0], qargs[0]
        b = queries.shape[0]
        if own_math:
            mask, ptr, stages = _masks_for_layer(layers[li], ids, queries)
        elif layers is not None and li > 0:
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
            fused_level=fused_level if fused else None,
            count_only=count_only)

        def fn(queries, roots=None):
            q = torch.as_tensor(queries, dtype=torch.float32,
                                device=tree.device).contiguous()
            res, counts, ctr = run(ctx, q,
                                   roots=None if roots is None else (roots,))
            if count_only:
                return counts, ctr
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


def make_select_dfs_vector(flat: FlatTree, result_cap: int,
                           stack_cap: int = 1024, backend: str = "auto"):
    """The paper's partially vectorized variant V: recursion as an
    explicit stack, one dense compare of a visited node's F lanes and a
    lane-order compaction push.  Single query: q (4,) → (ids
    (result_cap,) int32 in DFS emit order, -1 padded; n 0-d int32;
    Counters with ``nodes_visited``, ``vector_ops`` = 4 a node,
    ``predicates`` = 4·F a node, ``overflow`` and ``dispatches`` = 1, the
    reference's one while-loop program).

    ``backend`` as in ``select_scalar.make_select_dfs``: kernel V on a
    flat table on the card, its host twin on the CPU."""
    ops.resolve_backend(backend, flat.lx)
    return _make_dfs(flat, "vector", result_cap, stack_cap, backend)
