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
runs on the mesh path: one cursor a partition, all of them rows of one
state over a packed forest, and a cross-partition pool merge a batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import caps as caps_policy
from . import traversal
from .counters import OCC_STEPS, Counters, StageModel
from .geometry import DIST_PAD, DIST_VALID_MAX
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


# ---------------------------------------------------------------------------
# Distributed browsing — one cursor a partition + a cross-partition pool merge
# ---------------------------------------------------------------------------

class ShardedBrowseCursor:
    """One distributed browse session over a partitioned index fleet.

    ``state`` is one ``BrowseState`` over P·B rows of a packed forest (row
    ``p·B + b``: query ``b``'s cursor in partition ``p``), whose ``ctr``
    fields and ``descents`` hold one value a partition, as the reference's
    stacked state does.  ``next_batch()`` resumes the partitions whose pool
    cannot yet serve ``k`` until none needs it (one device sync a
    round), merges the partitions' pool heads by (distance, global id),
    and pops exactly the selected entries from their pools: the emitted
    stream is the single-tree cursor's global distance order.
    """

    def __init__(self, step, state, n_partitions: int):
        self._step = step
        self.state = state
        self.n_partitions = n_partitions

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        ids, d, self.state = self._step(self.state)
        return ids.cpu().numpy(), d.cpu().numpy()

    @property
    def overflow(self) -> np.ndarray:
        """(B,) bool: some emitted neighbour crossed a partition's lost
        bound, so that row may be approximate."""
        return self.state.overflow.reshape(
            self.n_partitions, -1).any(dim=0).cpu().numpy()

    @property
    def descents(self) -> int:
        """Resume descents summed over the partitions."""
        return int(self.state.descents.sum())

    @property
    def counters(self) -> Counters:
        """The partitions' counters folded: work summed, overflow any."""
        from ..distributed.collectives import merge_stacked_counters
        return merge_stacked_counters(self.state.ctr)


def make_sharded_browse(forest, k: int, *, layout: str = "d1",
                        backend: str = "auto"):
    """Build the distributed browse over a packed forest
    (``distributed/forest.pack_forest``): returns ``start(points)`` →
    :class:`ShardedBrowseCursor` emitting ``k`` neighbours a
    ``next_batch()``.  The engine is the single-tree browse's
    (``traversal.make_browse_engine`` with kNN's score stage) over
    ``forest.flat``, with one padded partition's caps; each partition's
    rows start at its own root, resume only when that partition needs it,
    and keep their own counters."""
    from ..distributed.collectives import (gather_partitions,
                                           topk_by_distance)
    if k <= 0:
        raise ValueError("k must be positive")
    tree, p = forest.flat, forest.n_partitions
    ctx, score = make_knn_score(tree, layout, backend)
    caps, defer_caps, pool_cap = caps_policy.browse_caps(
        forest.partition_tree, k, lanes=layout_lanes(layout))
    eng = traversal.make_browse_engine(
        BROWSE_SPEC, height=tree.height, batch_k=k, caps=caps,
        defer_caps=defer_caps, pool_cap=pool_cap, score=score)
    ids_flat = forest.ids_flat
    parts = torch.arange(p, dtype=torch.int32, device=tree.device)
    pad, valid_max = float(DIST_PAD), float(DIST_VALID_MAX)

    def resume_pending(st):
        """Descend the partitions that need it, until none does; the others
        keep their rows, counters and descents bit for bit."""
        while True:
            need = eng.pending(st, groups=p)                  # (P,)
            if not bool(need.any()):
                return st
            new, dctr = eng.descend(ctx, st, groups=p)
            rows = need.repeat_interleave(st.lost.shape[0] // p)

            def keep(a, b_):
                r = rows.reshape((-1,) + (1,) * (a.dim() - 1))
                return torch.where(r, a, b_)

            ctr = Counters(*[
                c + (d if isinstance(d, int) else torch.where(
                    need.reshape((-1,) + (1,) * (d.dim() - 1)), d, 0))
                for c, d in zip(st.ctr.values(), dctr.values())])
            st = dataclasses.replace(
                st, pool_ids=keep(new.pool_ids, st.pool_ids),
                pool_d=keep(new.pool_d, st.pool_d),
                def_ids=tuple(keep(a, b_) for a, b_ in
                              zip(new.def_ids, st.def_ids)),
                def_d=tuple(keep(a, b_) for a, b_ in
                            zip(new.def_d, st.def_d)),
                lost=keep(new.lost, st.lost), ctr=ctr,
                descents=st.descents + need.to(torch.int32))

    def step(st):
        st = resume_pending(st)
        rows = st.lost.shape[0]
        b = rows // p
        cl, cd = st.pool_ids[:, :k], st.pool_d[:, :k]
        cg = torch.where(cl >= 0, ids_flat[cl.clamp(min=0).long()], -1)
        cd = torch.where(cd < valid_max, cd, float("inf"))
        g_ids = gather_partitions(cg, p).transpose(0, 1).reshape(b, -1)
        g_d = gather_partitions(cd, p).transpose(0, 1).reshape(b, -1)
        sel_ids, sel_d = topk_by_distance(g_ids, g_d, k)
        # a pool entry is popped iff it is ≤ the k-th pick in (distance,
        # id) order
        thr_d = sel_d[:, k - 1].repeat(p)[:, None]
        thr_i = sel_ids[:, k - 1].repeat(p)[:, None]
        le = (cd < thr_d) | ((cd == thr_d) & (cg <= thr_i))   # (P·B, k)
        finite = torch.isfinite(cd)
        n_emit = (le & finite).sum(dim=1, dtype=torch.int32)
        crossed = (le & finite & (cd >= st.lost[:, None])).any(dim=1)
        crossed_g = crossed.reshape(p, b).any(dim=0)          # (B,)
        # drop exactly the selected positions: with distance ties they need
        # not be a prefix of the pool, and a prefix pop would re-emit an
        # unselected tie and lose a selected one
        drop = torch.cat([le, torch.zeros((rows, pool_cap - k),
                                          dtype=torch.bool,
                                          device=le.device)], dim=1)
        pd, pos = torch.sort(torch.where(drop, pad, st.pool_d), dim=1,
                             stable=True)
        pi = torch.gather(torch.where(drop, -1, st.pool_ids), 1, pos)
        live = pd < valid_max
        ctr = dataclasses.replace(
            st.ctr, overflow=st.ctr.overflow
            | crossed_g.any().to(torch.int32))
        st = dataclasses.replace(
            st, pool_ids=torch.where(live, pi, -1),
            pool_d=torch.where(live, pd, pad), emitted=st.emitted + n_emit,
            overflow=st.overflow | crossed_g.repeat(p), ctr=ctr)
        return sel_ids, sel_d, st

    def start(points) -> ShardedBrowseCursor:
        q = torch.as_tensor(points, dtype=torch.float32,
                            device=tree.device).contiguous()
        st = eng.init(q.repeat(p, 1), roots=parts.repeat_interleave(
            q.shape[0]))
        zero = torch.zeros((p,), dtype=torch.int32, device=tree.device)
        occ = torch.zeros((p, OCC_STEPS), dtype=torch.int32,
                          device=tree.device)
        st = dataclasses.replace(
            st, ctr=Counters(*([zero] * 10), lanes_live=occ,
                             lanes_padded=occ.clone(), escalations=zero),
            descents=zero)
        return ShardedBrowseCursor(step, st, p)

    return start


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
