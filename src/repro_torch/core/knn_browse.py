"""Resumable distance browsing: incremental kNN after Hjaltason and Samet,
batched over the R-tree (the reference's ``core/knn_browse.py``, single
tree).

A browse session emits neighbours k at a time in global distance order:
``next_batch()`` returns the next k nearest and can be called until the
tree is exhausted.  The traversal state (the scored candidate pool, the
per-level τ-deferred node beams, the lost bound and the summed counters)
is a ``traversal.BrowseState`` of tensors, so a session can be moved,
copied or taken over from the reference (``browse_state_from_arrays``),
and a resume re-activates only the deferred nodes whose MINDIST clears
the pool's bound instead of restarting from the root.

The score stage is kNN's (``knn_vector.make_knn_score``): on the card,
kernel B5 on D1's levels and D3's leaf, kernel B13 on D3's internal
levels.  The first k emitted neighbours equal ``make_knn_bfs(k)`` for
every k (up to distance ties) as long as no bounded beam dropped a
candidate that later emission reached; ``overflow`` reports exactly that,
per query.

The distributed cursor (``ShardedBrowseCursor``, ``make_sharded_browse``)
runs on the mesh path and arrives with it (ROADMAP A11).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import caps as caps_policy
from . import traversal
from .counters import Counters, StageModel
from .knn_vector import make_knn_score
from .layouts import layout_lanes
from .rtree import RTree


class BrowseCursor:
    """One browse session over a batch of query points.

    ``next_batch()`` → (ids (B, k) int32, squared dists (B, k) float32),
    numpy: the next k nearest per query in global distance order, (-1,
    +inf) once exhausted.  A descent runs only when the pool cannot
    provably serve the next batch (some deferred subtree could still beat
    a pooled candidate); otherwise emission is a pool slice.  ``state`` is
    the whole traversal state: assigning a moved, copied or carried-over
    state resumes the session exactly.
    """

    def __init__(self, engine, ctx, state):
        self._engine = engine
        self._ctx = ctx
        self.state = state

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._engine.needs_descent(self.state):
            self.state = self._engine.resume(self._ctx, self.state)
        ids, d, self.state = self._engine.emit(self.state)
        return ids.cpu().numpy(), d.cpu().numpy()

    @property
    def counters(self) -> Counters:
        return self.state.ctr

    @property
    def overflow(self) -> np.ndarray:
        """(B,) bool: emission crossed the lost bound, so that row's
        results may be approximate."""
        return self.state.overflow.cpu().numpy()


def make_browse_bfs(tree: RTree, k: int, layout: str = "d1",
                    caps: Optional[Sequence[int]] = None,
                    defer_caps: Optional[Sequence[int]] = None,
                    pool_cap: Optional[int] = None, backend: str = "auto"):
    """Build the browse engine over ``tree``: returns ``start(points)`` →
    ``BrowseCursor`` emitting ``k`` neighbours per ``next_batch()``.
    ``caps`` / ``defer_caps`` / ``pool_cap`` default to
    ``caps.browse_caps``; ``layout`` and ``backend`` route the score stage
    as in ``make_knn_bfs`` ('auto': the kernels on a CUDA tree, their twins
    on the CPU; 'torch': the twins anywhere; 'cuda': the kernels or raise).
    ``points`` may be any array-like; it is moved to the tree's device."""
    if k <= 0:
        raise ValueError("k must be positive")
    ctx, score = make_knn_score(tree, layout, backend)
    d_caps, d_defer, d_pool = caps_policy.browse_caps(
        tree, k, lanes=layout_lanes(layout))
    caps = tuple(caps) if caps is not None else d_caps
    defer_caps = tuple(defer_caps) if defer_caps is not None else d_defer
    pool_cap = pool_cap if pool_cap is not None else d_pool
    if len(caps) != tree.height - 1:
        raise ValueError(f"need {tree.height - 1} caps, got {len(caps)}")
    engine = traversal.make_browse_engine(
        BROWSE_SPEC, height=tree.height, batch_k=k, caps=caps,
        defer_caps=defer_caps, pool_cap=pool_cap, score=score)

    def start(points) -> BrowseCursor:
        q = torch.as_tensor(points, dtype=torch.float32,
                            device=tree.device).contiguous()
        return BrowseCursor(engine, ctx, engine.init(q))

    return start


def browse_knn(tree: RTree, points, k: int, **kwargs) -> BrowseCursor:
    """One browse session over ``points`` (B, 2), emitting ``k``
    neighbours per ``next_batch()``; ``kwargs`` as in
    ``make_browse_bfs``."""
    return make_browse_bfs(tree, k, **kwargs)(points)


# Per resume descent: every internal level runs the score kernel, the τ
# top-k and three bounded beam merges (deferred inject, frontier keep,
# reject stash) at 2 launches each → 8; the leaf the score and the pool
# merge → 3.  The reference's accounting, kept so counters compare.
BROWSE_SPEC = traversal.register(traversal.OperatorSpec(
    name="browse", kind="distance",
    stage_model=StageModel(inner=8, leaf=3, fused=None),
    builder=make_browse_bfs, caps_policy=caps_policy.browse_caps,
    query_width=2,
    description="resumable distance browsing: incremental kNN whose "
                "frontier/τ/pool state is carried between batches"))
