"""Vectorized k-nearest-neighbour search over the R-tree: the *kNN spec*
of the distance engine (the reference's ``core/knn_vector.py``).

``make_knn_bfs`` is the batched level-synchronous descent: one dense
squared-MINDIST/MINMAXDIST evaluation per (query, frontier-node) lane,
τ tightening to the k-th smallest MINMAXDIST, MINDIST <= τ pruning, the
best-first beam enqueue, and the leaf top-k.  The τ/prune/beam loop lives
in core/traversal.py; this module contributes the D1 point-to-MBR score
stage, the caps policy and the kernel routing:

  unfused     — per level, ``kernels/ops.knn_level_dists`` (kernel B5 on
                the card) writes the (B, C, F) distances, and the engine
                selects in PyTorch;
  ``fused``   — per internal level one ``kernels/ops.knn_level_fused``
                call (kernel B6) and at the leaf one ``knn_leaf_fused``
                call (kernel B7): scoring and emission in one kernel.

Both give identical ids, distances and counters (except ``dispatches``).
D0 and D2 have no kernel (nor in the reference): their levels are scored
with the layout's own PyTorch math (``_dists_for_layer``: D2's pair-form
MINDIST in two stages, D0 after the de-interleave), rounded as the
reference's traces on those layouts round them, which are D1's forms, so
their ids and distances equal D1's.  On the D3 layout (unfused only, as
in the reference) the internal levels score the quantized boxes
(``kernels/ops.knn_level_dists_d3``, kernel B13: a MINDIST lower bound
and a slack-corrected MINMAXDIST upper bound, two stages) and the leaf
rows take B5 on level 0's exact SoA rows, so D3 ids and distances equal
D1's; only the counters differ.
Distances are squared Euclidean.  Results are exact whenever no frontier
overflowed (``Counters.overflow``); an overflowed level keeps its best-
first beam, so any missed neighbour lies beyond the worst kept MINDIST.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..kernels import ops
from . import caps as caps_policy
from . import traversal
from .counters import StageModel
from .geometry import DIST_PAD, mindist, mindist_pairs, minmaxdist
from .layouts import (KERNEL_LAYOUTS, LevelD0, LevelD2, d0_unpack,
                      layout_lanes, tree_layout)
from .rtree import RTree


def _dists_for_layer(layer, ids: torch.Tensor, points: torch.Tensor,
                     leaf: bool):
    """Score one D0 or D2 level's frontier children against the query
    points in the layout's own PyTorch math: (mindist (B, C, F),
    minmaxdist (B, C, F) | None at the leaf, child_ids (B, C, F), stages),
    DIST_PAD on invalid lanes.  D2 takes MINDIST in its pair form (two
    stages); MINMAXDIST has no pair form and runs on the de-interleaved
    corners, as the reference's does."""
    safe = ids.clamp(min=0).long()
    px = points[:, 0, None, None]
    py = points[:, 1, None, None]
    if isinstance(layer, LevelD2):
        lo, hi = layer.lo[safe], layer.hi[safe]     # (B, C, 2F)
        b, c, f2 = lo.shape
        lo = lo.reshape(b, c, f2 // 2, 2)
        hi = hi.reshape(b, c, f2 // 2, 2)
        md = mindist_pairs(points[:, None, None, :], lo, hi)
        lx, ly, hx, hy = lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]
        ptr, stages = layer.ptr[safe], 2
    elif isinstance(layer, LevelD0):
        lx, ly, hx, hy, ptr = d0_unpack(layer.entries[safe])
        md = mindist(px, py, lx, ly, hx, hy)
        stages = 4
    else:
        raise TypeError(type(layer))
    valid = (ids >= 0)[:, :, None] & (ptr >= 0)
    pad = float(DIST_PAD)
    md = torch.where(valid, md, pad)
    if leaf:
        return md, None, ptr, stages
    mmd = torch.where(valid, minmaxdist(px, py, lx, ly, hx, hy), pad)
    return md, mmd, ptr, stages


def knn_frontier_caps(tree: RTree, k: int, slack: int = 4,
                      min_cap: int = 64, lanes: Optional[int] = None,
                      policy: str = "static") -> Tuple[int, ...]:
    """Frontier capacity entering each level (root-1 … leaf) — the unified
    policy (core/caps.py); ``policy='adaptive'`` selects the tight tier."""
    kw = {} if lanes is None else dict(lanes=lanes)
    return caps_policy.knn_frontier_caps(tree, k, slack=slack,
                                         min_cap=min_cap, policy=policy,
                                         **kw)


def make_knn_score(tree: RTree, layout: str, backend: str):
    """Build the kNN score stage and its engine context for ``tree``.

    Returns (ctx, score) with ``score(ctx, li, ids, points, leaf)`` →
    (mindist, minmaxdist | None at the leaf, child_ids, stages), the
    distance engine's contract.  D1: the level-global SoA rows feed B5.
    D3: internal levels feed B13 the quantized rows, the leaf B5.  D0 and
    D2: the layout's own PyTorch math (``_dists_for_layer``).
    """
    return make_distance_score(tree, layout, backend, ops.knn_level_dists,
                               ops.knn_level_dists_d3, _dists_for_layer)


def make_distance_score(tree: RTree, layout: str, backend: str, dists_op,
                        dists_d3_op, layer_dists):
    """(ctx, score) of a distance operator whose level scores come from
    ``dists_op`` (a ``kernels/ops`` function: B5 for kNN, B8 for the
    kNN-join), on the internal levels of a D3 tree from ``dists_d3_op``
    (B13, B14), and on D0 and D2, which have no kernel, from
    ``layer_dists(layer, ids, queries, leaf)`` in PyTorch; there
    ``backend='cuda'`` raises ``ValueError``, as the reference's kernel
    backends do."""
    layout_lanes(layout)
    own_math = layout not in KERNEL_LAYOUTS
    if own_math and backend == "cuda":
        raise ValueError("kernel backend requires layout d1 or d3")
    ops.resolve_backend(backend, tree.rects)
    # the D3 code rows, quantized on the tree's device (internal levels);
    # the D0 and D2 levels
    layers = tree_layout(tree, layout) if layout != "d1" else None

    def score(ctx, li, ids, queries, leaf):
        levels, layers_ = ctx
        if own_math:
            return layer_dists(layers_[li], ids, queries, leaf)
        if layers_ is not None and not leaf:
            lvl3 = layers_[li]
            md, mmd = dists_d3_op(ids, queries, lvl3.qlo, lvl3.qhi,
                                  lvl3.scale, lvl3.bias, lvl3.slack,
                                  lvl3.ptr, backend=backend)
            return md, mmd, lvl3.ptr[ids.clamp(min=0).long()], 2
        # D1, and D3 leaf rows: level 0's SoA rows are the exact rects
        lvl = levels[li]
        md, mmd = dists_op(ids, queries, lvl.lx, lvl.ly, lvl.hx, lvl.hy,
                           lvl.child, leaf=leaf, backend=backend)
        return md, mmd, lvl.child[ids.clamp(min=0).long()], 4

    return (tree.levels, layers), score


def make_knn_bfs(tree: RTree, k: int, layout: str = "d1",
                 caps: Optional[Sequence[int]] = None,
                 backend: str = "auto", fused: bool = False,
                 caps_mode: str = "adaptive",
                 caps_tree: Optional[RTree] = None):
    """Build the batched kNN: points (B, 2) → (ids (B, k) int32 rect ids
    by distance, -1 padded when k > n_rects; dists (B, k) float32 squared
    distances, +inf padded; Counters).

    ``backend``: 'auto' runs the CUDA kernels when the tree lies on a CUDA
    device and their plain PyTorch twins on the CPU; 'cuda' demands the
    kernels; 'torch' runs the twins on any device.  ``fused=True``: one
    kernel per level (B6 inside, B7 at the leaf) instead of B5 plus the
    engine's PyTorch selection; ``Counters.dispatches`` drops to 1 per
    level and everything else is unchanged.  ``caps_mode`` (used only when
    ``caps`` is None): 'adaptive' builds the two-tier escalating engine,
    'static' the single static-caps engine.  ``caps_tree`` (default
    ``tree``) is the tree whose level sizes set the default caps (the mesh
    path's padded partition).  ``points`` may be any array-like; it is
    moved to the tree's device.  The engine is ``fn(points, tau_init=None,
    active=None, roots=None)``, the hooks of ``make_distance_engine``.
    """
    return make_distance_bfs(
        KNN_SPEC, tree, k, make_knn_score(tree, layout, backend),
        ops.knn_level_fused, ops.knn_leaf_fused, layout=layout, caps=caps,
        backend=backend, fused=fused, caps_mode=caps_mode,
        caps_tree=caps_tree)


def make_distance_bfs(spec: traversal.OperatorSpec, tree: RTree, k: int,
                      ctx_score, level_fused_op, leaf_fused_op, *,
                      layout: str, caps: Optional[Sequence[int]],
                      backend: str, fused: bool, caps_mode: str,
                      caps_tree: Optional[RTree] = None):
    """The builder behind ``make_knn_bfs``, the kNN-join's
    ``make_knn_join_bfs`` and ``knn_filtered.make_knn_filtered_bfs``, which
    differ only in their score stage (``ctx_score`` = (ctx, score)), fused
    kernels (``level_fused_op`` / ``leaf_fused_op``, the ``kernels/ops``
    functions; None without a fused generation) and caps policy
    (``spec.caps_policy``): the distance engine over ``tree.levels`` with
    static caps or the two-tier escalating runner."""
    if k <= 0:
        raise ValueError("k must be positive")
    if fused and layout != "d1":
        raise ValueError(f"fused {spec.name} requires layout d1")
    ctx, score = ctx_score

    def fused_level(ctx_, li, ids, queries, tau, leaf, cap):
        lvl = ctx_[0][li]
        f = lvl.lx.shape[1]
        args = (ids, queries, lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child)
        if leaf:
            return leaf_fused_op(*args, k=k, backend=backend) + (f,)
        # the τ gate of the unfused loop, C·F >= k, from the shapes
        return level_fused_op(*args, tau, cap=cap, k=k,
                              tighten=ids.shape[1] * f >= k,
                              backend=backend) + (f,)

    def build(caps_):
        caps_ = tuple(caps_)
        if len(caps_) != tree.height - 1:
            raise ValueError(
                f"need {tree.height - 1} caps, got {len(caps_)}")
        run = traversal.make_distance_engine(
            spec, height=tree.height, k=k, caps=caps_, score=score,
            fused_level=fused_level if fused else None)

        def fn(queries, tau_init=None, active=None, roots=None):
            q = torch.as_tensor(queries, dtype=torch.float32,
                                device=tree.device).contiguous()
            return run(ctx, q, tau_init=tau_init, active=active, roots=roots)
        return fn

    if caps is not None:
        return build(caps)
    lanes = layout_lanes(layout)
    caps_tree = tree if caps_tree is None else caps_tree
    full = spec.caps_policy(caps_tree, k, lanes=lanes)
    if caps_mode == "static":
        return build(full)
    tight = spec.caps_policy(caps_tree, k, lanes=lanes, policy="adaptive")
    return traversal.maybe_escalating(build, tight, full)


KNN_SPEC = traversal.register(traversal.OperatorSpec(
    name="knn", kind="distance",
    stage_model=StageModel(inner=4, leaf=3, fused=1),
    builder=make_knn_bfs, caps_policy=knn_frontier_caps, query_width=2,
    description="batched k-nearest-neighbor: point MINDIST/MINMAXDIST "
                "score, τ top-k + best-first beam emission"))
