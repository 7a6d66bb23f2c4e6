"""Vectorized nested-index spatial join (paper §4): the *join spec* of the
engine (the reference's ``core/join_vector.py``).

The unit of work is a *pair frontier*: (outer node, inner node) id pairs
at the same (chain-elevated) level, descended level-synchronously by the
shared mask engine (core/traversal.py) with two id streams.  For every
pair the child predicate is an (F_out × F_in) tile:

  unfused     — per level, ``kernels/ops.join_pair_masks`` (kernel B3 on
                the card) writes the (P, F_out, F_in) mask, and
                ``compaction._scatter_compact`` packs the qualifying
                (outer child, inner child) pairs;
  ``fused``   — per level, one ``kernels/ops.join_level_fused`` call
                (kernel B4 on the card) evaluates the predicate AND
                compress-stores the qualifying pairs in flat order.

Both take the O3/O4/O5 tile-skip bounds of ``ops.join_prune_metadata``.
D0, D2 and D3 have no kernel (nor in the reference): their levels give
the tile its children through the layout's own gather (D2 and D3 in two
compare stages, D0 after the de-interleave, D3 as the conservative
dequantized boxes, re-checked at the leaf against the exact data rects)
and the dense (F_out × F_in) tile predicate runs in PyTorch, unfused, on
the trees' device.
Sorted-key optimizations (``sort_key='lx'`` trees): O3 slices trailing
outer children once ``out.low_x > max(in.high_x)``; O4/O5 shrink the inner
node to ``flip`` entries per outer child.  They change the counters (the
work modelled as skipped), never the results.  O5's flip indices come
either densely (``flip_indices_dense``) or from the paper's gather/blend
binary search (``flip_indices_gather``); both are equal.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..kernels import ops
from . import caps as caps_policy
from . import traversal
from .counters import StageModel
from .join_scalar import elevate
from .layouts import (LevelD0, LevelD1, LevelD2, LevelD3, d0_unpack,
                      d3_dequantize, d3_levels_int32, layout_lanes,
                      tree_layout)
from .rtree import RTree

# pair lanes an unfused level scores at once: one 2M-point partition's leaf
# step (65,536 pairs × 64 × 64), whose int32 mask and compaction fit the
# card; the mesh path's partitions beyond it run in blocks of rows
LANE_BUDGET = 1 << 28


def _gather_children(layer, ids: torch.Tensor):
    """(P,) node ids → per-child (lx, ly, hx, hy, ptr) each (P, F) +
    stages: 4 on D1 and D0 (after its de-interleave), 2 on D2 and D3."""
    safe = ids.clamp(min=0).long()
    if isinstance(layer, LevelD1):
        c = layer.coords[safe]
        return (c[:, 0], c[:, 1], c[:, 2], c[:, 3], layer.ptr[safe]), 4
    if isinstance(layer, LevelD2):
        lo, hi = layer.lo[safe], layer.hi[safe]
        p, f2 = lo.shape
        lo, hi = lo.reshape(p, f2 // 2, 2), hi.reshape(p, f2 // 2, 2)
        return (lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1],
                layer.ptr[safe]), 2
    if isinstance(layer, LevelD0):
        return d0_unpack(layer.entries[safe]), 4
    if isinstance(layer, LevelD3):
        # conservative dequantization of codes already widened to int32
        # (``join_levels``): the enlarged boxes can only over-approximate
        # the tile predicate, and the leaf re-checks the exact rects
        # (``_exact_leaf_children``)
        lx, ly, hx, hy = d3_dequantize(layer.qlo[safe], layer.qhi[safe],
                                       layer.scale[safe], layer.bias[safe])
        return (lx, ly, hx, hy, layer.ptr[safe]), 2
    raise TypeError(type(layer))


def join_levels(tree: RTree, layout: str):
    """``tree``'s levels in ``layout`` as the join gathers them: D3's codes
    widened to int32 once."""
    return d3_levels_int32(tree) if layout == "d3" else \
        tree_layout(tree, layout)


def _exact_leaf_children(g, rects: torch.Tensor, first=0):
    """Replace dequantized leaf-child boxes with the exact rect geometry
    gathered through ptr (what D1's leaf arrays hold).  A padding lane
    (ptr -1) reads the tree's first rect, ``first``: 0, or (P, 1) row
    indices, each pair's partition's first rect in a packed forest (the
    rect the reference's per-partition gather reads).  Padding lanes are
    never live, but O3's bound and O4/O5's flip counts read them."""
    ptr = g[4]
    r = rects[torch.where(ptr >= 0, ptr, first).long()]
    return (r[..., 0], r[..., 1], r[..., 2], r[..., 3], ptr)


def dense_tile(go, gi):
    """The dense (P, F_out, F_in) tile predicate of the children of each
    pair (``_gather_children``' outputs), valid children only."""
    (olx, oly, ohx, ohy, optr), (ilx, ily, ihx, ihy, iptr) = go, gi
    m = (olx[:, :, None] <= ihx[:, None, :]) & \
        (ohx[:, :, None] >= ilx[:, None, :]) & \
        (oly[:, :, None] <= ihy[:, None, :]) & \
        (ohy[:, :, None] >= ily[:, None, :])
    return m & (optr >= 0)[:, :, None] & (iptr >= 0)[:, None, :]


def flip_indices_dense(i_lx: torch.Tensor, o_hx: torch.Tensor) -> torch.Tensor:
    """flip[p, a] = #{b : inner_lx[p, b] <= outer_hx[p, a]} via one masked
    reduction over the tile."""
    return (i_lx[:, None, :] <= o_hx[:, :, None]).sum(dim=-1,
                                                      dtype=torch.int32)


def flip_indices_gather(i_lx: torch.Tensor,
                        o_hx: torch.Tensor) -> torch.Tensor:
    """The paper's Figure-6 mechanism: per-lane binary search over the
    sorted inner ``low_x`` using gather + compare + two blends per
    iteration, log2(F)+1 iterations."""
    f = i_lx.shape[1]
    iters = int(math.ceil(math.log2(max(f, 2)))) + 1
    low = torch.zeros_like(o_hx, dtype=torch.int32)
    high = torch.full_like(low, f)
    for _ in range(iters):
        mid = (low + high) // 2
        val = torch.gather(i_lx, 1, mid.clamp(0, f - 1).long())
        ok = (val <= o_hx) & (mid < f)
        low = torch.where(ok, mid + 1, low)          # masked add
        high = torch.where(ok, high, mid)            # blend
    return low


def default_pair_caps(height: int, fanout: int, result_cap: int,
                      base: int = 1024, level_sizes=None,
                      policy: str = "static") -> Tuple[int, ...]:
    """Pair-frontier capacity after each descent step (last = result pairs)
    — the unified policy (core/caps.py).  ``policy='adaptive'`` selects the
    occupancy-adaptive tight tier, clamped to ``level_sizes`` — the
    reachable pair counts per level."""
    return caps_policy.join_pair_caps(height, fanout, result_cap, base=base,
                                      level_sizes=level_sizes, policy=policy)


def reachable_pair_counts(to: RTree, ti: RTree) -> Tuple[int, ...]:
    """Per-level reachable pair count for two chain-elevated equal-height
    trees, leaf level first: no pair frontier can hold more distinct pairs
    than the product of the two levels' node counts."""
    return tuple(o.n_nodes * i.n_nodes
                 for o, i in zip(to.levels, ti.levels))


def make_join_bfs(tree_o: RTree, tree_i: RTree, layout: str = "d1",
                  result_cap: int = 65536,
                  pair_caps: Optional[Sequence[int]] = None,
                  o3: bool = False, o4: bool = False,
                  o5: Optional[str] = None, backend: str = "auto",
                  fused: bool = False, caps_mode: str = "adaptive",
                  caps_tree: Optional[RTree] = None,
                  lane_budget: Optional[int] = LANE_BUDGET,
                  inner_partition: Optional[Tuple[int, int]] = None):
    """Build the pair-frontier join: () → (pairs (R, 2) int32, n, Counters).

    ``o5``: None | 'dense' | 'gather' — how flip indices are computed (both
    imply the O4-style inner shrink accounting).  ``backend``: 'auto' runs
    the CUDA kernels when the trees lie on a CUDA device and their plain
    PyTorch twins on the CPU; 'cuda' demands the kernels; 'torch' runs the
    twins anywhere.  ``fused=True``: one fused whole-level step per level —
    no (P, F_out, F_in) mask is materialized, and every result but
    ``Counters.dispatches`` is unchanged.  ``caps_mode`` as in
    ``make_select_bfs``; ``caps_tree`` (default ``tree_i``) stands in for
    the inner tree in the adaptive caps (the mesh path's padded partition).
    ``inner_partition``: (leaf nodes, rects) of each partition when
    ``tree_i`` is a flat forest of equal partitions (the mesh path), so
    that D3's exact leaf step reads a padding lane's own partition's first
    rect, as the reference's per-partition gather does; None for one tree.

    ``fn(roots=(outer_roots, inner_roots))`` runs one pair frontier a row
    from those root pairs (each (R,)), the mesh path's partitions: →
    (pairs (R, result_cap, 2), counts (R,), Counters), each row compacted
    into its own slots.  An unfused level scores at most ``lane_budget``
    pair lanes at once, in blocks of rows; the counters do not change.

    On D0, D2 and D3 (no kernel) 'auto' and 'torch' run the dense tile in
    PyTorch wherever the trees lie; 'cuda' and ``fused=True`` raise
    ``ValueError``, as the reference's kernel backends do on them.  D3's
    leaf step scores the exact rects of both trees (4 stages), its other
    steps the dequantized boxes (2 stages).
    """
    layout_lanes(layout)
    own_math = layout != "d1"
    if own_math and backend == "cuda":
        raise ValueError("kernel backend requires layout d1")
    if own_math and fused:
        raise ValueError("fused join requires a kernel backend (layout d1)")
    sorted_ok = tree_o.sort_key == "lx" and tree_i.sort_key == "lx"
    if (o3 or o4 or o5) and not sorted_ok:
        raise ValueError("O3/O4/O5 require trees built with sort_key='lx'")
    ops.resolve_backend(backend, tree_o.rects)
    h = max(tree_o.height, tree_i.height)
    to, ti = elevate(tree_o, h), elevate(tree_i, h)
    exact = None
    if layout == "d3":
        part, n_rects = inner_partition or (0, 0)
        exact = (to.rects, ti.rects, part, n_rects)
    ctx = (join_levels(to, layout), join_levels(ti, layout), exact)
    o45 = bool(o4 or o5)

    def _score_stage_counters(o_ids, i_ids, gathered, stages, m):
        """Shared O3/O4/O5 counter modelling for the unfused and fused
        paths; returns (delta, masked tile or None)."""
        (olx, oly, ohx, ohy, optr), (ilx, ily, ihx, ihy, iptr) = gathered
        pair_valid = (o_ids >= 0) & (i_ids >= 0)
        o_valid = (optr >= 0) & pair_valid[:, None]
        i_valid = (iptr >= 0) & pair_valid[:, None]
        ca = o_valid.sum(dim=1)
        cb = i_valid.sum(dim=1)
        base_preds = (ca * cb).sum()
        alive = o_valid
        po = pi = torch.zeros((), dtype=torch.int64, device=o_ids.device)
        if o3:
            max_ihx = ihx.amax(dim=1)           # padding hi = -PAD
            alive = o_valid & (olx <= max_ihx[:, None])
            if m is not None:
                # counter modelling only — the intersect predicate already
                # implies ``alive`` (olx <= max ihx)
                m = m & alive[:, :, None]
            po = o_valid.sum() - alive.sum()
        if o45:
            flip = (flip_indices_gather(ilx, ohx) if o5 == "gather"
                    else flip_indices_dense(ilx, ohx))
            considered = torch.minimum(flip, cb[:, None])
            pi = torch.where(alive, cb[:, None] - considered, 0).sum()
            eff_preds = torch.where(alive, considered, 0).sum()
        else:
            eff_preds = (alive.sum(dim=1) * cb).sum()
        n_pairs = pair_valid.sum()
        delta = dict(nodes_visited=2 * n_pairs,
                     predicates=eff_preds * stages,
                     masked_waste=base_preds - eff_preds,
                     vector_ops=n_pairs * stages,
                     pruned_outer=po, pruned_inner=pi)
        return {k: v.to(torch.int32) for k, v in delta.items()}, m

    def _metadata(lo, li_, o_ids, i_ids):
        oc, icr = lo.coords, li_.coords
        to_ = 8 if oc.shape[2] % 8 == 0 else oc.shape[2]
        ac, fm = ops.join_prune_metadata(o_ids, i_ids, oc, icr, to=to_,
                                         o3=o3, o45=o45)
        return oc, icr, to_, ac, fm

    def score(ctx_, li, frontier, qargs):
        layers_o, layers_i, exact_ = ctx_
        # every row's pair frontier as one flat (P,) pair list
        o_ids, i_ids = frontier[0].reshape(-1), frontier[1].reshape(-1)
        go, stages = _gather_children(layers_o[li], o_ids)
        gi, _ = _gather_children(layers_i[li], i_ids)
        if exact_ is not None and li == 0:
            rects_o, rects_i, part, n_rects = exact_
            first = 0 if not part else \
                (i_ids.clamp(min=0)[:, None] // part) * n_rects
            go = _exact_leaf_children(go, rects_o)
            gi = _exact_leaf_children(gi, rects_i, first)
            stages = 4
        optr, iptr = go[4], gi[4]
        pair_valid = (o_ids >= 0) & (i_ids >= 0)
        if own_math:
            m = dense_tile(go, gi) & pair_valid[:, None, None]
        else:
            o_valid = (optr >= 0) & pair_valid[:, None]
            i_valid = (iptr >= 0) & pair_valid[:, None]
            oc, icr, to_, ac, fm = _metadata(layers_o[li], layers_i[li],
                                             o_ids, i_ids)
            m = ops.join_pair_masks(o_ids, i_ids, ac, fm, oc, icr, to=to_,
                                    ti=min(128, icr.shape[2]),
                                    backend=backend).to(torch.bool)
            m = m & o_valid[:, :, None] & i_valid[:, None, :]
        delta, m = _score_stage_counters(o_ids, i_ids, (go, gi), stages, m)
        p, fo = optr.shape
        fi = iptr.shape[1]
        rows = frontier[0].shape[0]
        a_vals = optr[:, :, None].expand(p, fo, fi)
        b_vals = iptr[:, None, :].expand(p, fo, fi)
        return (m.reshape(rows, -1),
                (a_vals.reshape(rows, -1), b_vals.reshape(rows, -1)),
                fo, stages, delta)

    def fused_level(ctx_, li, frontier, qargs, cap):
        layers_o, layers_i, _ = ctx_
        if frontier[0].shape[0] != 1:
            raise NotImplementedError(
                "the fused join (B4) runs one pair frontier; rows of pair "
                "frontiers (the mesh path) run unfused")
        o_ids, i_ids = frontier[0][0], frontier[1][0]
        go, stages = _gather_children(layers_o[li], o_ids)
        gi, _ = _gather_children(layers_i[li], i_ids)
        # counter inputs are the (P, F) child gathers, never a
        # (P, F_out, F_in) mask
        delta, _ = _score_stage_counters(o_ids, i_ids, (go, gi), stages,
                                         None)
        oc, icr, to_, ac, fm = _metadata(layers_o[li], layers_i[li], o_ids,
                                         i_ids)
        oa, ob, n_pairs, f_ovf = ops.join_level_fused(
            o_ids, i_ids, ac, fm, oc, icr, layers_o[li].ptr,
            layers_i[li].ptr, cap=cap, to=to_, backend=backend)
        return ((oa[None], ob[None]), n_pairs[None], f_ovf[None],
                go[0].shape[1], stages, delta)

    def build(pair_caps_):
        pair_caps_ = tuple(pair_caps_)
        if len(pair_caps_) != h:
            raise ValueError(f"need {h} pair caps, got {len(pair_caps_)}")
        run = traversal.make_mask_engine(
            JOIN_SPEC, height=h, caps=pair_caps_[:-1],
            result_cap=pair_caps_[-1], score=score,
            fused_level=fused_level if fused else None, n_streams=2,
            device=to.device, lane_budget=lane_budget,
            slot_lanes=to.fanout * ti.fanout)

        def fn(roots=None):
            res, counts, ctr = run(ctx, roots=roots)
            pairs = torch.stack([res[0], res[1]], dim=-1)
            if roots is None:
                return pairs[0], counts[0], ctr
            return pairs, counts, ctr
        return fn

    if pair_caps is not None:
        return build(pair_caps)
    fanout = max(to.fanout, ti.fanout)
    full = default_pair_caps(h, fanout, result_cap)
    if caps_mode == "static":
        return build(full)
    # pair_caps[i] bounds the pair frontier at level h-2-i (the children of
    # the level scored at step i), so the adaptive clamp at e = h-1-i needs
    # the pair count one level finer: sizes[e] = pairs(e-1); the final
    # e = 0 step is the result-pair buffer, exempt from the clamp
    pc = reachable_pair_counts(
        to, ti if caps_tree is None else elevate(caps_tree, h))
    sizes = (pc[0],) + pc[:-1]
    tight = default_pair_caps(h, fanout, result_cap, level_sizes=sizes,
                              policy="adaptive")
    return traversal.maybe_escalating(build, tight, full)


JOIN_SPEC = traversal.register(traversal.OperatorSpec(
    name="join", kind="mask",
    stage_model=StageModel(inner=4, leaf=4, fused=2),
    builder=make_join_bfs, caps_policy=default_pair_caps, query_width=None,
    leaf_enqueue=True,
    description="nested-index spatial join: pair-frontier tile predicate "
                "with O3/O4/O5 sorted-key pruning, pair compress-store "
                "emission"))


def join_instruction_model(fanout: int, n_pairs: int, alive_outer: int,
                           flip_sum: int, inner_count_sum: int,
                           w: int = 16, stages: int = 4) -> dict:
    """Modeled SIMD-instruction counts for the paper's two join approaches
    (paper §4.2 cost analysis), parametric in vector width W.

    one-to-many : per pair, ``n_out,c`` broadcasts and
                  ``n_out,c * ceil(n_in,c / W)`` compares per stage.
    many-to-many: ``ceil(n_out,c / W) * (log2 F + 1)`` compares (+ a gather
                  and two blends each) for the first stage, then the
                  remaining stages on flip-qualified entries only.
    """
    log_f = int(math.ceil(math.log2(max(fanout, 2)))) + 1
    o2m_compares = alive_outer * -(-fanout // w) * stages
    o2m_broadcasts = alive_outer * stages
    o2m_o4_compares = -(-flip_sum // w) * stages  # lower bound, batched rows
    m2m_first = n_pairs * -(-fanout // w) * log_f
    m2m_rest = -(-flip_sum // w) * (stages - 1)
    return dict(
        o2m_compares=int(o2m_compares),
        o2m_broadcasts=int(o2m_broadcasts),
        o2m_o4_compares=int(o2m_o4_compares + o2m_broadcasts),
        m2m_compares=int(m2m_first + m2m_rest),
        m2m_gathers=int(m2m_first),
        m2m_blends=int(2 * m2m_first),
    )
