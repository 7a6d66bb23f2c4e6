"""Spec-driven BFS traversal engine — the level loop every R-tree operator
shares (the reference's ``core/traversal.py``).

  ``OperatorSpec``       — static description of an operator: its score
                           stage kind, its per-level dispatch
                           ``StageModel``, its caps policy, its builder and
                           serve metadata, kept in a registry so the fleet
                           and the serve launcher resolve operators by name.
  ``make_mask_engine``   — the level loop of the mask operators: score →
                           compress-store compaction → descend.  Eager
                           PyTorch: one Python iteration per tree level,
                           every step a tensor op on the tree's device.
  ``make_distance_engine`` — the level loop of the distance operators
                           (kNN): score → τ tightening → MINDIST pruning →
                           best-first beam enqueue → leaf top-k.
  ``make_escalating_engine`` — the two-tier overflow-escalating runner.
  ``make_browse_engine`` — the distance level loop run from and into a
                           ``BrowseState``: the resumable browse.
  ``make_mesh_engine``   — the partitioned fleet as one program: every
                           level of every partition in one launch over
                           (partition × query) rows of a packed forest
                           (distributed/forest.py).

The select, join, kNN, kNN-join, filtered-kNN and browse specs are
registered.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .compaction import _scatter_compact, beam_rows
from .counters import OCC_STEPS, Counters, StageModel, occupancy_zeros
from .geometry import DIST_PAD, DIST_VALID_MAX


def _occ_record(occ_live, occ_padded, *, step: int, valid, width: int,
                batch: int):
    """Fold one level's frontier occupancy into the per-step vectors (in
    place): ``valid`` is the (B, width) liveness mask of the frontier the
    level scored; padded slots are the allocated-but-empty remainder."""
    slot = min(step, OCC_STEPS - 1)
    live = valid.sum(dtype=torch.int32)
    occ_live[slot] += live
    occ_padded[slot] += batch * width - live


# ---------------------------------------------------------------------------
# Operator specs + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Static description of one traversal operator.

    ``kind`` selects the engine ('mask': boolean qualify + compress-store
    emission; 'distance': MINDIST/MINMAXDIST score + τ top-k + best-first
    beam emission).  ``stage_model`` is the per-level dispatch accounting the
    engine charges.  ``builder`` is the public factory (the ``make_*_bfs``
    function), so ``build(name, ...)`` and the factory are one code path.
    ``caps_policy`` is the default frontier-caps function, ``query_width``
    the columns per query row, and ``leaf_enqueue`` marks operators whose
    leaf emission counts into ``Counters.enqueued``.
    """
    name: str
    kind: str
    stage_model: StageModel
    builder: Callable
    caps_policy: Optional[Callable] = None
    query_width: Optional[int] = None
    leaf_enqueue: bool = False
    description: str = ""


_REGISTRY: Dict[str, OperatorSpec] = {}

# modules that register specs on import — imported lazily so the registry
# is complete whenever it is consulted, without import cycles
_OPERATOR_MODULES = (
    "repro_torch.core.select_vector",
    "repro_torch.core.join_vector",
    "repro_torch.core.knn_vector",
    "repro_torch.core.knn_join_vector",
    "repro_torch.core.knn_filtered",
    "repro_torch.core.knn_browse",
)


def register(spec: OperatorSpec) -> OperatorSpec:
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_registered() -> None:
    for mod in _OPERATOR_MODULES:
        importlib.import_module(mod)


def get_spec(name: str) -> OperatorSpec:
    _ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown operator spec {name!r}; registered: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def spec_names() -> Tuple[str, ...]:
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def build(name: str, *trees, **params):
    """Generic engine entry point: build operator ``name`` over ``trees``
    with the spec's builder (identical to calling it directly)."""
    return get_spec(name).builder(*trees, **params)


# ---------------------------------------------------------------------------
# Mask-kind engine (range select, spatial join)
# ---------------------------------------------------------------------------

def _apply_delta(acc: dict, delta: Optional[dict], *, fcnt, f, stages, hits):
    """Fold one level's score-stage counter contributions into ``acc``.

    ``delta=None`` selects the dense model (every frontier node evaluates
    all F lanes over ``stages`` compare stages); a spec whose score stage
    models pruned work returns its own partial tallies instead.
    """
    if delta is None:
        n = fcnt.sum(dtype=torch.int32)
        acc["nodes_visited"] = acc["nodes_visited"] + n
        acc["predicates"] = acc["predicates"] + n * (f * stages)
        acc["vector_ops"] = acc["vector_ops"] + n * stages
        acc["masked_waste"] = acc["masked_waste"] + n * f - hits
    else:
        for key, val in delta.items():
            acc[key] = acc[key] + val


def _row_blocks(rows: int, row_lanes: int, lane_budget: Optional[int]):
    """Row ranges of at most ``lane_budget`` score lanes each (at least one
    row a block); one range when there is no budget."""
    if lane_budget is None:
        return [(0, rows)]
    step = max(1, lane_budget // max(row_lanes, 1))
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


def make_mask_engine(spec: OperatorSpec, *, height: int,
                     caps: Sequence[int], result_cap: int, score,
                     fused_level=None, n_streams: int = 1,
                     device=None, lane_budget: Optional[int] = None,
                     slot_lanes: int = 1, count_only: bool = False):
    """Build the level loop for a mask operator.

    ``score(ctx, li, frontier, qargs)`` → (mask (B, M) bool, values — an
    ``n_streams``-tuple of (B, M) int32 to compact under the mask, f,
    stages, delta).  ``fused_level(ctx, li, frontier, qargs, cap)`` → the
    whole-level alternative: (values — tuple of (B, cap), qcnt (B,),
    overflow (B,), f, stages, delta); the engine then only routes
    compacted frontiers.  Returns ``run(ctx, *qargs, roots=None)`` →
    (values, counts, Counters).  ``roots`` (an ``n_streams``-tuple of (B,)
    node ids of the root level) starts each row at its own root, the mesh
    path's hook; by default every row starts at node 0.  A query-less
    operator (the join) calls ``run(ctx)`` or ``run(ctx, roots=...)``: the
    batch is then 1 or the roots' rows, on ``device``.  With
    ``lane_budget`` an unfused level scores and compacts its rows in
    blocks of at most that many lanes (a frontier slot holds
    ``slot_lanes``), so a wide batch never materializes the whole level's
    mask; the results and counters do not change.  ``count_only``: the
    leaf's qualifying children are counted and not compacted, its
    overflow is not flagged, and ``values`` comes back None.  The loop
    reads nothing back to the host.
    """
    caps = tuple(caps)
    sm = spec.stage_model

    def score_compact(ctx, li, frontier, qargs, cap, count):
        """The unfused level in row blocks → (outs, qcnt, overflow, hits,
        f, stages, delta); ``count`` counts the hits of each row and
        compacts nothing (outs None, no overflow)."""
        parts = []
        for r0, r1 in _row_blocks(frontier[0].shape[0],
                                  frontier[0].shape[1] * slot_lanes,
                                  lane_budget):
            mask, values, f, stages, delta = score(
                ctx, li, tuple(a[r0:r1] for a in frontier),
                tuple(q[r0:r1] for q in qargs))
            if count:
                qcnt = mask.sum(dim=1, dtype=torch.int32)
                outs, o = None, torch.zeros_like(qcnt, dtype=torch.bool)
            else:
                outs, qcnt, o = _scatter_compact(values, mask, cap, -1)
            parts.append((outs, qcnt, o, mask.sum(dtype=torch.int32), delta))
        if len(parts) == 1:
            outs, qcnt, o, hits, delta = parts[0]
        else:
            outs = None if count else \
                [torch.cat(s) for s in zip(*(p[0] for p in parts))]
            qcnt = torch.cat([p[1] for p in parts])
            o = torch.cat([p[2] for p in parts])
            hits = sum(p[3] for p in parts)
            delta = None if parts[0][4] is None else {
                key: sum(p[4][key] for p in parts) for key in parts[0][4]}
        return outs, qcnt, o, hits, f, stages, delta

    def run(ctx, *qargs, roots=None):
        if qargs:
            b, dev = qargs[0].shape[0], qargs[0].device
        elif roots is not None:
            b, dev = roots[0].shape[0], roots[0].device
        elif device is None:
            raise ValueError("a query-less mask engine needs its device")
        else:
            b, dev = 1, device
        i32 = dict(dtype=torch.int32, device=dev)
        if roots is None:
            frontier = tuple(torch.zeros((b, 1), **i32)
                             for _ in range(n_streams))     # root
        else:
            frontier = tuple(r.to(**i32).reshape(b, 1) for r in roots)
        acc = {k: torch.zeros((), **i32) for k in
               ("nodes_visited", "predicates", "vector_ops", "masked_waste",
                "pruned_outer", "pruned_inner")}
        enq = torch.zeros((), **i32)
        disp = 0
        ovf = torch.zeros((b,), dtype=torch.bool, device=dev)
        counts = torch.zeros((b,), **i32)
        occ_live = occupancy_zeros(dev)
        occ_padded = occupancy_zeros(dev)
        res = None
        for li in range(height - 1, -1, -1):
            leaf = li == 0
            cap = result_cap if leaf else caps[height - 1 - li]
            fvalid = frontier[0] >= 0
            fcnt = fvalid.sum(dim=1, dtype=torch.int32)
            _occ_record(occ_live, occ_padded, step=height - 1 - li,
                        valid=fvalid, width=frontier[0].shape[1], batch=b)
            count = leaf and count_only
            if fused_level is not None:
                outs, qcnt, o, f, stages, delta = fused_level(
                    ctx, li, frontier, qargs, cap)
                hits = qcnt.sum(dtype=torch.int32)
                disp += sm.fused
            else:
                outs, qcnt, o, hits, f, stages, delta = score_compact(
                    ctx, li, frontier, qargs, cap, count)
                disp += sm.leaf if leaf else sm.inner
            if leaf:
                counts = qcnt
                res = None if count else tuple(outs)
                if spec.leaf_enqueue:
                    enq = enq + hits
            else:
                frontier = tuple(outs)
                enq = enq + hits
            if not count:
                ovf = ovf | o
            _apply_delta(acc, delta, fcnt=fcnt, f=f, stages=stages,
                         hits=hits)
        ctr = Counters(enqueued=enq, overflow=ovf.any().to(torch.int32),
                       dispatches=torch.tensor(disp, **i32),
                       lanes_live=occ_live, lanes_padded=occ_padded, **acc)
        return res, counts, ctr

    return run


# ---------------------------------------------------------------------------
# Distance-kind engine (kNN) — fixed-k descent
# ---------------------------------------------------------------------------

def distance_level_emit(md, mmd, ptr, tau, *, cap: int, k: int,
                        tighten: bool):
    """Emission of one internal distance level from its (B, C, F) MINDIST,
    MINMAXDIST and child ids: τ = min(τ, k-th smallest MINMAXDIST) when
    ``tighten`` (sound only when C·F >= k), MINDIST <= τ pruning, and the
    best-first beam of width ``cap`` → (next (B, cap), τ (B,), valid_cnt
    (B,), keep_cnt (B,)).  The unfused engine and kernel B6's twin."""
    b = md.shape[0]
    if tighten:
        kth = torch.topk(mmd.reshape(b, -1), k, dim=1, largest=False,
                         sorted=True).values[:, k - 1]
        tau = torch.minimum(tau, kth)
    valid = md < float(DIST_VALID_MAX)
    keep = valid & (md <= tau[:, None, None])
    out, _, _ = beam_rows(ptr.reshape(b, -1), md.reshape(b, -1),
                          keep.reshape(b, -1), cap)
    return (out, tau, valid.sum(dim=(1, 2), dtype=torch.int32),
            keep.sum(dim=(1, 2), dtype=torch.int32))


def distance_leaf_emit(md, ptr, *, k: int):
    """Emission of the leaf: the k smallest (distance, lane) results →
    (ids (B, k), d (B, k), valid_cnt (B,)), missing rows (-1, +inf), also
    when C·F < k.  A stable sort puts the lowest lane first among ties, as
    the reference's ``lax.top_k`` of the negated distances does.  The
    unfused engine and kernel B7's twin."""
    b = md.shape[0]
    flat_d = md.reshape(b, -1)
    flat_ptr = ptr.reshape(b, -1)
    if flat_d.shape[1] < k:                         # k > total candidates
        pad = k - flat_d.shape[1]
        flat_d = torch.cat([flat_d, flat_d.new_full((b, pad),
                                                    float(DIST_PAD))], 1)
        flat_ptr = torch.cat([flat_ptr, flat_ptr.new_full((b, pad), -1)], 1)
    res_d, pos = torch.sort(flat_d, dim=1, stable=True)
    res_d = res_d[:, :k]
    res_ids = torch.gather(flat_ptr, 1, pos[:, :k])
    found = res_d < float(DIST_VALID_MAX)
    res_ids = torch.where(found, res_ids, -1)
    res_d = torch.where(found, res_d, float("inf"))
    valid_cnt = (md < float(DIST_VALID_MAX)).sum(dim=(1, 2),
                                                 dtype=torch.int32)
    return res_ids, res_d, valid_cnt


def make_distance_engine(spec: OperatorSpec, *, height: int, k: int,
                         caps: Sequence[int], score, fused_level=None):
    """Build the level loop of a distance operator.

    ``score(ctx, li, ids, queries, leaf)`` → (mindist (B, C, F),
    minmaxdist (B, C, F) | None at the leaf, child_ids (B, C, F), stages)
    with DIST_PAD on invalid lanes; the engine then emits with
    ``distance_level_emit`` / ``distance_leaf_emit``.  τ tightens only where
    C·F >= k, decided from the shapes.  ``fused_level(ctx, li, ids,
    queries, tau, leaf, cap)`` runs a whole level — scoring and emission —
    as one kernel and returns the emission's outputs plus F.  Either way
    the engine owns the counters, which are the same except
    ``dispatches``.

    Returns ``run(ctx, queries, tau_init=None, active=None, roots=None)`` →
    (ids (B, k), dists (B, k), Counters).  ``tau_init`` (B,) seeds the
    pruning bound below DIST_PAD (sound when it upper-bounds each query's
    k-th neighbour), ``active`` (B,) bool masks queries out of the descent
    (empty root frontier, (-1, +inf) rows) and ``roots`` (B,) starts each
    row at its own node of the root level (default 0): the hooks of the
    mesh path.  The loop reads nothing back to the host.
    """
    caps = tuple(caps)
    sm = spec.stage_model

    def run(ctx, queries: torch.Tensor, tau_init=None, active=None,
            roots=None):
        b, dev = queries.shape[0], queries.device
        i32 = dict(dtype=torch.int32, device=dev)
        ids = (torch.zeros((b, 1), **i32) if roots is None      # root frontier
               else roots.to(**i32).reshape(b, 1))
        if active is not None:
            ids = torch.where(torch.as_tensor(active, device=dev)[:, None],
                              ids, -1)
        tau = torch.full((b,), float(DIST_PAD), dtype=torch.float32,
                         device=dev)
        if tau_init is not None:
            tau = torch.minimum(tau, torch.as_tensor(
                tau_init, dtype=torch.float32, device=dev))
        zero = torch.zeros((), **i32)
        nodes = preds = vops = enq = pruned = waste = zero
        disp = 0
        ovf = torch.zeros((b,), dtype=torch.bool, device=dev)
        occ_live = occupancy_zeros(dev)
        occ_padded = occupancy_zeros(dev)
        res_ids = res_d = None
        for li in range(height - 1, -1, -1):
            leaf = li == 0
            cap = k if leaf else caps[height - 1 - li]
            fvalid = ids >= 0
            n_front = fvalid.sum(dtype=torch.int32)
            nodes = nodes + n_front
            _occ_record(occ_live, occ_padded, step=height - 1 - li,
                        valid=fvalid, width=ids.shape[1], batch=b)
            if fused_level is not None:
                *out, f = fused_level(ctx, li, ids, queries, tau, leaf, cap)
                stages = 4                      # the fused kernels are D1
                disp += sm.fused
            else:
                md, mmd, ptr, stages = score(ctx, li, ids, queries, leaf)
                f = md.shape[-1]
                if leaf:
                    out = distance_leaf_emit(md, ptr, k=k)
                else:
                    out = distance_level_emit(
                        md, mmd, ptr, tau, cap=cap, k=k,
                        tighten=ids.shape[1] * f >= k)
                disp += sm.leaf if leaf else sm.inner
            # internal levels evaluate MINDIST and MINMAXDIST per lane, the
            # leaf MINDIST only
            ev = stages if leaf else 2 * stages
            preds = preds + n_front * (f * ev)
            vops = vops + n_front * ev
            if leaf:
                res_ids, res_d, valid_cnt = out
                waste = waste + n_front * f - valid_cnt.sum(
                    dtype=torch.int32)
            else:
                ids, tau, valid_cnt, keep_cnt = out
                n_valid = valid_cnt.sum(dtype=torch.int32)
                n_keep = keep_cnt.sum(dtype=torch.int32)
                waste = waste + n_front * f - n_valid
                pruned = pruned + (n_valid - n_keep)
                enq = enq + n_keep
                ovf = ovf | (keep_cnt > cap)
        ctr = Counters(nodes_visited=nodes, predicates=preds, vector_ops=vops,
                       enqueued=enq, pruned_inner=pruned, masked_waste=waste,
                       overflow=ovf.any().to(torch.int32),
                       dispatches=torch.tensor(disp, **i32),
                       lanes_live=occ_live, lanes_padded=occ_padded)
        return res_ids, res_d, ctr

    return run


# ---------------------------------------------------------------------------
# Two-tier overflow-escalating engines
# ---------------------------------------------------------------------------

def make_escalating_engine(build, tight_caps: Sequence[int],
                           full_caps: Sequence[int], *,
                           stick_after: int = 3):
    """Wrap an operator's engine builder into a two-tier overflow-escalating
    runner.

    ``build(caps)`` returns the operator's runner (``run(*args, **kw) →
    (..., Counters)``) for the given frontier caps.  The tight tier (the
    occupancy-adaptive caps) is built immediately; the full static-caps
    tier the first time a batch escalates.  Every batch runs on the tight
    tier first; its ``Counters.overflow`` flag is read back to the host
    (one ``.item()`` device sync per batch, counted by ``host_syncs()``)
    and an overflowed batch is re-run on the full tier, whose result *is*
    the static-caps result, with ``Counters.escalations`` bumped.  After
    ``stick_after`` consecutive escalations the runner pins itself to the
    full tier (``stuck()``).
    """
    tight_caps = tuple(int(c) for c in tight_caps)
    full_caps = tuple(int(c) for c in full_caps)
    tight = build(tight_caps)
    state = {"full": None, "escalations": 0, "streak": 0, "syncs": 0}

    def escalated(out):
        ctr = dataclasses.replace(out[-1],
                                  escalations=out[-1].escalations + 1)
        state["escalations"] += 1
        return out[:-1] + (ctr,)

    def run(*args, **kw):
        if state["streak"] >= stick_after:
            return escalated(state["full"](*args, **kw))
        out = tight(*args, **kw)
        state["syncs"] += 1
        if out[-1].overflow.item():
            if state["full"] is None:
                state["full"] = build(full_caps)
            state["streak"] += 1
            return escalated(state["full"](*args, **kw))
        state["streak"] = 0
        return out

    run.tight_caps = tight_caps
    run.full_caps = full_caps
    run.escalation_count = lambda: state["escalations"]
    run.stuck = lambda: state["streak"] >= stick_after
    run.host_syncs = lambda: state["syncs"]
    return run


def maybe_escalating(build, tight_caps, full_caps):
    """``make_escalating_engine`` unless the two tiers coincide — then the
    single-tier engine is returned directly."""
    tight_caps = tuple(int(c) for c in tight_caps)
    full_caps = tuple(int(c) for c in full_caps)
    if tight_caps == full_caps:
        return build(tight_caps)
    return make_escalating_engine(build, tight_caps, full_caps)


# ---------------------------------------------------------------------------
# Mesh entry point — the whole partition fan-out as one program
# ---------------------------------------------------------------------------

def _route_mindist(spec: OperatorSpec, queries: torch.Tensor,
                   mbrs: torch.Tensor) -> torch.Tensor:
    """(B, P) float32 squared MINDIST from each query to each partition MBR:
    the router step, on the device.  ``query_width`` 4 is rect-to-rect;
    otherwise the leading two columns are a point (kNN and the filtered
    kNN's 6-column rows).  Rounded as the reference's program rounds it,
    ``fma(dx, dx, dy*dy)``."""
    from .geometry import mindist, mindist_rect
    q = [queries[:, j, None] for j in range(queries.shape[1])]
    m = [mbrs[None, :, j] for j in range(4)]
    if spec.query_width == 4:
        return mindist_rect(*q[:4], *m)
    return mindist(q[0], q[1], *m)


def collective_tau(kth: torch.Tensor) -> torch.Tensor:
    """The phase-2 bound from each query's k-th phase-1 distance, widened
    by the host router's hair: ``kth * (1 + 1e-5) + 1e-30`` in float32,
    one rounding, as the reference's program contracts it into an FMA;
    +inf stays +inf."""
    from .geometry import fma32
    c = torch.full_like(kth, float(np.float32(1.0 + 1e-5)))
    e = torch.full_like(kth, float(np.float32(1e-30)))
    return torch.where(torch.isfinite(kth), fma32(kth, c, e), kth)


def make_mesh_engine(name: str, forest, *, outer_tree=None, **params):
    """Build the single-program path of any registered operator over a
    packed forest (``distributed/forest.pack_forest``).

    The reference runs the batch as one ``shard_map`` program that
    ``vmap``s the spec's engine over the partitions.  Here the spec's
    builder runs once over ``forest.flat`` with each row's caps taken from
    one padded partition (``forest.partition_tree``), and the batch runs as
    P·B rows, row ``p·B + b`` being query ``b`` in partition ``p`` from
    root ``p``: every level is one launch over partition × query, whatever
    P is.  ``outer_tree`` is the spatial join's probe tree, shared by every
    partition; it must already have the forest's height.

      mask kind     — every partition answers the full batch (a
                      partition the query misses yields no rows); local
                      ids become global through ``forest.ids_flat``.
      distance kind — two phases: phase 1 answers each query on its primary
                      partition (the smallest router MINDIST); the
                      per-query k-th distance after a (distance, id) top-k
                      merge gives the float32 bound τ; phase 2 descends
                      only the (query, partition) rows within τ, seeded
                      with τ as ``tau_init``; a final top-k merges both.

    Static caps are pinned, as the reference pins them.  Returns ``run``:
    distance kind ``run(queries)`` → (global ids (B, k) int32, dists (B,
    k) float32, Counters); select ``run(queries)`` → (global ids (P, B,
    cap), counts (P, B), Counters); join ``run()`` → (pairs (P, cap, 2)
    (probe id, global id), counts (P,), Counters).  Counters sum the work
    over partitions and keep ``overflow`` as "any"; ``dispatches`` counts
    one descent a phase.
    """
    from ..distributed import collectives as coll

    spec = get_spec(name)
    if name == "browse":
        raise ValueError("browse is resumable, not one-shot — use "
                         "knn_browse.make_sharded_browse for the "
                         "distributed cursor")
    if outer_tree is not None and outer_tree.height != forest.height:
        raise ValueError(f"outer tree height {outer_tree.height} != forest "
                         f"height {forest.height}: elevate the shorter one")
    params = dict(params)
    params.setdefault("caps_mode", "static")
    p_total = forest.n_partitions
    dev = forest.device
    trees = (forest.flat,) if outer_tree is None else \
        (outer_tree, forest.flat)
    pt = forest.partition_tree
    if spec.kind == "mask" and spec.query_width is None:
        # the join: each padding lane reads its own partition's rects
        params["inner_partition"] = (pt.levels[0].n_nodes, pt.rects.shape[0])
    fn = spec.builder(*trees, caps_tree=pt, **params)
    ids_flat = forest.ids_flat
    parts = torch.arange(p_total, dtype=torch.int32, device=dev)

    def globalize(ids):
        return torch.where(ids >= 0, ids_flat[ids.clamp(min=0).long()], -1)

    def as_rows(queries):
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=dev).contiguous()
        return q, q.repeat(p_total, 1), \
            parts.repeat_interleave(q.shape[0])

    if spec.kind == "mask" and spec.query_width is None:
        def run_join():
            pairs, counts, ctr = fn(roots=(torch.zeros_like(parts), parts))
            gpairs = torch.stack([pairs[..., 0], globalize(pairs[..., 1])],
                                 dim=-1)
            return gpairs, counts, coll.psum_counters(ctr)
        return run_join

    if spec.kind == "mask":
        def run_mask(queries):
            q, rows, roots = as_rows(queries)
            ids, counts, ctr = fn(rows, roots=roots)
            return (coll.gather_partitions(globalize(ids), p_total),
                    coll.gather_partitions(counts, p_total),
                    coll.psum_counters(ctr))
        return run_mask

    k = params["k"]

    def merge(ids, d):
        """(P·B, k) per-partition streams → (B, k) by (distance, id)."""
        g = coll.gather_partitions(globalize(ids), p_total)
        d = coll.gather_partitions(d, p_total)
        b = g.shape[1]
        return coll.topk_by_distance(g.transpose(0, 1).reshape(b, -1),
                                     d.transpose(0, 1).reshape(b, -1), k)

    def run_distance(queries):
        q, rows, roots = as_rows(queries)
        mbrs = forest.flat.levels[-1].node_mbr              # (P, 4)
        dmat = _route_mindist(spec, q, mbrs)                # (B, P)
        primary = torch.argmin(dmat, dim=1).to(torch.int32)
        # phase 1: primary partitions only
        act1 = primary[None, :] == parts[:, None]           # (P, B)
        ids1, d1, c1 = fn(rows, active=act1.reshape(-1), roots=roots)
        p1_ids, p1_d = merge(ids1, d1)
        # phase 2: the partitions within the bound, seeded with it
        tau = collective_tau(p1_d[:, k - 1])
        act2 = ~act1 & (dmat.T <= tau[None, :])
        ids2, d2, c2 = fn(rows, tau_init=tau.repeat(p_total),
                          active=act2.reshape(-1), roots=roots)
        p2_ids, p2_d = merge(ids2, d2)
        f_ids, f_d = coll.topk_by_distance(torch.cat([p1_ids, p2_ids], 1),
                                           torch.cat([p1_d, p2_d], 1), k)
        ctr = dataclasses.replace(
            c1 + c2, overflow=torch.maximum(c1.overflow, c2.overflow))
        return f_ids, f_d, coll.psum_counters(ctr)

    return run_distance


# ---------------------------------------------------------------------------
# Resumable distance browsing — the engine's resume entry point
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BrowseState:
    """The whole traversal state of a browse session, as tensors on one
    device (the reference's ``BrowseState`` pytree):

      queries   — (B, Q) query coordinates
      pool_ids/pool_d — (B, pool_cap) scored but unemitted leaf candidates,
                  ascending by distance
      def_ids/def_d — per level (0 … height-1): the τ-deferred node beams,
                  children a past descent pruned, kept with their MINDIST
                  so a later batch can re-activate them
      lost      — (B,) smallest distance any bounded beam ever dropped;
                  emission at or past it flags ``overflow``
      emitted   — (B,) neighbours emitted so far
      overflow  — (B,) bool, sticky
      ctr       — Counters summed over the descents
      descents  — resume descents run (0-d)

    ``to(device)`` moves it and ``clone()`` copies it; either resumes
    exactly where the session stood."""
    queries: torch.Tensor
    pool_ids: torch.Tensor
    pool_d: torch.Tensor
    def_ids: Tuple[torch.Tensor, ...]
    def_d: Tuple[torch.Tensor, ...]
    lost: torch.Tensor
    emitted: torch.Tensor
    overflow: torch.Tensor
    ctr: Counters
    descents: torch.Tensor

    def _map(self, fn) -> "BrowseState":
        return BrowseState(
            queries=fn(self.queries), pool_ids=fn(self.pool_ids),
            pool_d=fn(self.pool_d),
            def_ids=tuple(fn(a) for a in self.def_ids),
            def_d=tuple(fn(a) for a in self.def_d), lost=fn(self.lost),
            emitted=fn(self.emitted), overflow=fn(self.overflow),
            ctr=Counters(*[fn(v) for v in self.ctr.values()]),
            descents=fn(self.descents))

    def to(self, device) -> "BrowseState":
        return self._map(lambda a: a.to(device))

    def clone(self) -> "BrowseState":
        return self._map(torch.clone)


def browse_state_from_arrays(mapping: Mapping, device="cuda"
                             ) -> BrowseState:
    """A reference ``BrowseState``'s leaves as numpy arrays → the port's
    state on ``device``, so the port resumes a session the reference
    began.  ``mapping`` has the ``BrowseState`` field names; ``def_ids``
    and ``def_d`` are per-level sequences and ``ctr`` maps each
    ``Counters`` field to its value."""
    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(
            device)

    ctr = mapping["ctr"]
    return BrowseState(
        queries=put(mapping["queries"], np.float32),
        pool_ids=put(mapping["pool_ids"], np.int32),
        pool_d=put(mapping["pool_d"], np.float32),
        def_ids=tuple(put(a, np.int32) for a in mapping["def_ids"]),
        def_d=tuple(put(a, np.float32) for a in mapping["def_d"]),
        lost=put(mapping["lost"], np.float32),
        emitted=put(mapping["emitted"], np.int32),
        overflow=put(mapping["overflow"], np.bool_),
        ctr=Counters(*[put(ctr[f.name], np.int32)
                       for f in dataclasses.fields(Counters)]),
        descents=put(mapping["descents"], np.int32))


class BrowseEngine(NamedTuple):
    """The resumable browse's entry points (see ``make_browse_engine``)."""
    init: Callable
    needs_descent: Callable
    pending: Callable
    descend: Callable
    resume: Callable
    emit: Callable


def _beam_with_bound(ids: torch.Tensor, d: torch.Tensor, mask: torch.Tensor,
                     cap: int):
    """``compaction.beam_rows`` that also returns the kept distances and the
    smallest dropped distance (+inf when nothing was dropped): the browse's
    lost-bound bookkeeping.  The reference takes ``lax.top_k`` of the
    negated distances (lowest lane first among ties, the bound at position
    ``cap``); a stable sort gives the same order."""
    b, m = ids.shape
    pad = float(DIST_PAD)
    d = torch.where(mask, d, pad)
    v = torch.where(mask, ids, -1)
    if m < cap + 1:
        d = torch.cat([d, d.new_full((b, cap + 1 - m), pad)], dim=1)
        v = torch.cat([v, v.new_full((b, cap + 1 - m), -1)], dim=1)
    dd, pos = torch.sort(d, dim=1, stable=True)
    vv = torch.gather(v, 1, pos[:, :cap])
    kept = dd[:, :cap] < float(DIST_VALID_MAX)
    dropped = dd[:, cap]
    bound = torch.where(dropped < float(DIST_VALID_MAX), dropped,
                        float("inf"))
    return (torch.where(kept, vv, -1), torch.where(kept, dd[:, :cap], pad),
            bound)


def make_browse_engine(spec: OperatorSpec, *, height: int, batch_k: int,
                       caps: Sequence[int], defer_caps: Sequence[int],
                       pool_cap: int, score) -> BrowseEngine:
    """The resumable browse: the distance level loop, run from and into a
    ``BrowseState``.  Per resume descent, root to leaf:

      inject — merge the level's deferred nodes with MINDIST <= τ into the
               active frontier
      score  — the operator's score stage, unchanged
      τ      — starts at the ``batch_k``-th pool distance (the pool holds
               real objects) and tightens to the ``batch_k``-th smallest
               child MINMAXDIST where C·F >= batch_k
      prune  — children with MINDIST > τ are stashed in the level's
               deferred beam, not dropped
      leaf   — every valid candidate beam-merges into the pool

    Every bounded beam folds its smallest dropped distance into
    ``state.lost``; emission flags ``overflow`` where an emitted distance
    reaches it, and sets ``Counters.overflow``.

      init(queries, roots=None) → a fresh state, each row's root (node 0,
                             or its entry of ``roots``) deferred at the top
      needs_descent(state) → host bool: can the pool not yet serve
                             ``batch_k`` for sure?  (one device sync)
      pending(state, groups=None) → that test on the device, for the whole
                             batch or per group of rows
      descend(ctx, state, groups=None) → (the state after one full descent,
                             its counters and descents left as they were;
                             the descent's Counters, summed over the batch
                             or per group of rows)
      resume(ctx, state)   → the state after one full descent
      emit(state)          → (ids (B, batch_k), d (B, batch_k), state)

    ``groups`` splits the batch into that many equal runs of rows (the
    partitions of the distributed cursor, knn_browse.make_sharded_browse).
    """
    caps = tuple(caps)
    defer_caps = tuple(defer_caps)
    if len(defer_caps) != height:
        raise ValueError(f"need {height} defer caps, got {len(defer_caps)}")
    if pool_cap < batch_k:
        raise ValueError("pool_cap must be >= batch_k")
    sm = spec.stage_model
    pad, valid_max = float(DIST_PAD), float(DIST_VALID_MAX)

    def init(queries: torch.Tensor, roots=None) -> BrowseState:
        b, dev = queries.shape[0], queries.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        def_ids, def_d = [], []
        for lj in range(height):
            dc = defer_caps[lj]
            if lj == height - 1:
                # the root is the first deferred node, at distance 0
                def_ids.append(
                    torch.zeros((b, dc), **i32) if roots is None
                    else roots.to(**i32)[:, None].expand(b, dc).clone())
                def_d.append(torch.zeros((b, dc), **f32))
            else:
                def_ids.append(torch.full((b, dc), -1, **i32))
                def_d.append(torch.full((b, dc), pad, **f32))
        zero = torch.zeros((), **i32)
        return BrowseState(
            queries=queries,
            pool_ids=torch.full((b, pool_cap), -1, **i32),
            pool_d=torch.full((b, pool_cap), pad, **f32),
            def_ids=tuple(def_ids), def_d=tuple(def_d),
            lost=torch.full((b,), float("inf"), **f32),
            emitted=torch.zeros((b,), **i32),
            overflow=torch.zeros((b,), dtype=torch.bool, device=dev),
            ctr=Counters(*([zero] * 10), lanes_live=occupancy_zeros(dev),
                         lanes_padded=occupancy_zeros(dev),
                         escalations=zero),
            descents=zero)

    def pending(state: BrowseState, groups: Optional[int] = None
                ) -> torch.Tensor:
        min_def = torch.stack([d.amin(dim=1) for d in state.def_d]).amin(0)
        pool_kth = state.pool_d[:, batch_k - 1]
        pool_kth = torch.where(pool_kth < valid_max, pool_kth, float("inf"))
        rows = (min_def < valid_max) & (min_def <= pool_kth)
        return rows.any() if groups is None else \
            rows.reshape(groups, -1).any(dim=1)

    def needs_descent(state: BrowseState) -> bool:
        return bool(pending(state))

    def descend(ctx, state: BrowseState, groups: Optional[int] = None):
        queries = state.queries
        b, dev = queries.shape[0], queries.device
        i32 = dict(dtype=torch.int32, device=dev)

        def fold(rows):
            """Per-row tallies (B,) → the batch's sum or each group's."""
            return rows.sum(dtype=torch.int32) if groups is None else \
                rows.reshape(groups, -1).sum(dim=1, dtype=torch.int32)

        # τ starts at the batch_k-th pool distance: the pool holds real
        # objects, so batch_k of the next neighbours lie within it
        pool_kth = state.pool_d[:, batch_k - 1]
        tau = torch.where(pool_kth < valid_max, pool_kth, pad)
        frontier = torch.full((b, 1), -1, **i32)
        fdist = torch.full((b, 1), pad, dtype=torch.float32, device=dev)
        pool_ids, pool_d = state.pool_ids, state.pool_d
        def_ids, def_d = list(state.def_ids), list(state.def_d)
        lost = state.lost
        zero = fold(torch.zeros((b,), **i32))
        nodes = preds = vops = enq = pruned = waste = zero
        occ_live = torch.zeros(zero.shape + (OCC_STEPS,), **i32)
        occ_padded = torch.zeros_like(occ_live)
        rows_per_group = b // (groups or 1)
        disp = 0
        for li in range(height - 1, -1, -1):
            leaf = li == 0
            fcap = 1 if li == height - 1 else caps[height - 2 - li]
            # inject: activate this level's deferred nodes within τ
            act = (def_ids[li] >= 0) & (def_d[li] <= tau[:, None])
            comb_d = torch.cat([fdist, torch.where(act, def_d[li], pad)], 1)
            ids, _, bound = _beam_with_bound(
                torch.cat([frontier, def_ids[li]], 1), comb_d,
                comb_d < valid_max, fcap)
            lost = torch.minimum(lost, bound)
            def_ids[li] = torch.where(act, -1, def_ids[li])
            def_d[li] = torch.where(act, pad, def_d[li])
            # score: the operator's stage, as in the fixed-k engine
            n_front = fold((ids >= 0).sum(dim=1, dtype=torch.int32))
            nodes = nodes + n_front
            slot = min(height - 1 - li, OCC_STEPS - 1)
            occ_live[..., slot] += n_front
            occ_padded[..., slot] += rows_per_group * ids.shape[1] - n_front
            md, mmd, ptr, stages = score(ctx, li, ids, queries, leaf)
            f = md.shape[-1]
            ev = stages if leaf else 2 * stages
            preds = preds + n_front * (f * ev)
            vops = vops + n_front * ev
            entry_valid = md < valid_max
            n_valid = fold(entry_valid.sum(dim=(1, 2), dtype=torch.int32))
            waste = waste + n_front * f - n_valid
            flat_d = md.reshape(b, -1)
            flat_ptr = ptr.reshape(b, -1)
            if leaf:
                disp += sm.leaf
                # every scored candidate is a real object: pool it
                pool_d2 = torch.cat([pool_d, flat_d], 1)
                pool_ids, pool_d, bound = _beam_with_bound(
                    torch.cat([pool_ids, flat_ptr], 1), pool_d2,
                    pool_d2 < valid_max, pool_cap)
                lost = torch.minimum(lost, bound)
                continue
            disp += sm.inner
            mflat = mmd.reshape(b, -1)
            if mflat.shape[1] >= batch_k:       # the τ soundness gate
                kth = torch.topk(mflat, batch_k, dim=1, largest=False,
                                 sorted=True).values[:, batch_k - 1]
                tau = torch.minimum(tau, kth)
            keep = entry_valid & (md <= tau[:, None, None])
            n_keep = fold(keep.sum(dim=(1, 2), dtype=torch.int32))
            pruned = pruned + (n_valid - n_keep)
            frontier, fdist, bound = _beam_with_bound(
                flat_ptr, flat_d, keep.reshape(b, -1),
                caps[height - 1 - li])
            lost = torch.minimum(lost, bound)
            enq = enq + n_keep
            # stash: τ-pruned children stay reachable for later batches
            rej = (entry_valid & ~keep).reshape(b, -1)
            dj_d = torch.cat([def_d[li - 1], torch.where(rej, flat_d, pad)],
                             1)
            def_ids[li - 1], def_d[li - 1], bound = _beam_with_bound(
                torch.cat([def_ids[li - 1], flat_ptr], 1), dj_d,
                dj_d < valid_max, defer_caps[li - 1])
            lost = torch.minimum(lost, bound)
        dctr = Counters(nodes_visited=nodes, predicates=preds,
                        vector_ops=vops, enqueued=enq, pruned_inner=pruned,
                        masked_waste=waste,
                        dispatches=torch.full_like(zero, disp),
                        lanes_live=occ_live, lanes_padded=occ_padded)
        return dataclasses.replace(
            state, pool_ids=pool_ids, pool_d=pool_d,
            def_ids=tuple(def_ids), def_d=tuple(def_d), lost=lost), dctr

    def resume(ctx, state: BrowseState) -> BrowseState:
        new, dctr = descend(ctx, state)
        return dataclasses.replace(new, ctr=state.ctr + dctr,
                                   descents=state.descents + 1)

    def emit(state: BrowseState):
        d = state.pool_d[:, :batch_k]
        found = d < valid_max
        out_ids = torch.where(found, state.pool_ids[:, :batch_k], -1)
        out_d = torch.where(found, d, float("inf"))
        crossed = (found & (d >= state.lost[:, None])).any(dim=1)
        # the crossing also sets Counters.overflow, the flag every other
        # operator's callers read
        ctr = dataclasses.replace(
            state.ctr,
            overflow=state.ctr.overflow | crossed.any().to(torch.int32))
        new = dataclasses.replace(
            state,
            pool_ids=torch.cat([state.pool_ids[:, batch_k:],
                                torch.full_like(out_ids, -1)], 1),
            pool_d=torch.cat([state.pool_d[:, batch_k:],
                              torch.full_like(d, pad)], 1),
            emitted=state.emitted + found.sum(dim=1, dtype=torch.int32),
            overflow=state.overflow | crossed, ctr=ctr)
        return out_ids, out_d, new

    return BrowseEngine(init=init, needs_descent=needs_descent,
                        pending=pending, descend=descend, resume=resume,
                        emit=emit)
