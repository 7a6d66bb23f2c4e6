"""Plain PyTorch twins of the select, join, kNN and kNN-join kernels (the
reference's ``kernels/ref.py`` entries for B1–B14), and the plain host
walks of the DFS baselines' kernels S and V.

Each twin has its kernel's contract exactly — same shapes, dtypes and
padding — and runs on any device.  The CPU tests hold them against the
JAX package; ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  B1–B4 are compares and integer arithmetic only; B5–B10 compute the
distances with the roundings pinned in ``core/geometry.py``, which the
kernels reproduce with explicit intrinsics.  B11–B14 run the same
predicates and distances on D3 boxes dequantized exactly
(``layouts.d3_dequantize``), B13/B14 with the D3 trace's MINMAXDIST form
and the slack correction.  So every twin and its kernel agree exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compaction import compact_pairs, compact_rows
from ..core.geometry import (DIST_PAD, intersects, mindist, mindist_rect,
                             minmaxdist, minmaxdist_d3, minmaxdist_rect,
                             minmaxdist_rect_d3)
from ..core.layouts import d3_dequantize, d3_slacked_upper
from ..core.traversal import distance_leaf_emit, distance_level_emit


def select_level_masks_ref(ids, queries, lx, ly, hx, hy, child):
    """Twin of ``select_level_masks_cuda``: (B, C) ids × (B, 4) queries →
    (B, C, F) int32 qualify mask."""
    safe = ids.clamp(min=0).long()                  # (B, C)
    glx, gly = lx[safe], ly[safe]                   # (B, C, F)
    ghx, ghy = hx[safe], hy[safe]
    qlx = queries[:, 0, None, None]
    qly = queries[:, 1, None, None]
    qhx = queries[:, 2, None, None]
    qhy = queries[:, 3, None, None]
    m = intersects(qlx, qly, qhx, qhy, glx, gly, ghx, ghy)
    m = m & (child[safe] >= 0) & (ids >= 0)[:, :, None]
    return m.to(torch.int32)


def select_level_fused_ref(ids, queries, lx, ly, hx, hy, child, *, cap: int):
    """Twin of ``select_level_fused_cuda``: masks + compress-store
    compaction of the qualifying children over the flat (C·F) level →
    (next_ids (B, cap), counts (B,), overflow (B,))."""
    b = ids.shape[0]
    mask = select_level_masks_ref(ids, queries, lx, ly, hx, hy,
                                  child).to(torch.bool)
    ptr = child[ids.clamp(min=0).long()]
    return compact_rows(ptr.reshape(b, -1), mask.reshape(b, -1), cap)


def join_pair_masks_ref(o_ids, i_ids, alive_cnt, flip_max, o_coords,
                        i_coords, *, to: int = 8, ti: int = 128):
    """Twin of ``join_pair_masks_cuda``: (P,) outer × (P,) inner node ids
    over (N, 4, F) D1 coords → (P, F_out, F_in) int32 intersect tiles,
    with the O3/O4/O5 tile skip: tile (a, b) is zero unless
    ``a*to < alive_cnt[p]`` and ``b*ti < flip_max[p, a]``."""
    fo, fi = o_coords.shape[2], i_coords.shape[2]
    to, ti = min(to, fo), min(ti, fi)
    so, si = o_ids.clamp(min=0).long(), i_ids.clamp(min=0).long()
    oc, ic = o_coords[so], i_coords[si]             # (P, 4, F)
    m = (oc[:, 0, :, None] <= ic[:, 2, None, :]) & \
        (oc[:, 2, :, None] >= ic[:, 0, None, :]) & \
        (oc[:, 1, :, None] <= ic[:, 3, None, :]) & \
        (oc[:, 3, :, None] >= ic[:, 1, None, :])
    valid = ((o_ids >= 0) & (i_ids >= 0))[:, None, None]
    a_idx = torch.arange(fo, device=o_ids.device) // to          # (F_out,)
    b_idx = torch.arange(fi, device=o_ids.device) // ti          # (F_in,)
    a_active = (a_idx[None, :] * to) < alive_cnt[:, None]        # (P, F_out)
    fm = flip_max[:, a_idx]                                      # (P, F_out)
    b_active = (b_idx[None, None, :] * ti) < fm[:, :, None]      # (P,Fo,Fi)
    return (m & valid & a_active[:, :, None] & b_active).to(torch.int32)


def join_level_fused_ref(o_ids, i_ids, alive_cnt, flip_max, o_coords,
                         i_coords, o_ptr, i_ptr, *, cap: int, to: int = 8):
    """Twin of ``join_level_fused_cuda``: the tile masks (inner tile width
    pinned to the kernel's ``min(128, F_in)``) AND child-pointer validity,
    then the pair compress-store over the flat (P·F_out·F_in) lanes →
    (out_o (cap,), out_i (cap,), count () int32 (may exceed cap),
    overflow () bool) — ``compact_pairs``' contract."""
    m = join_pair_masks_ref(o_ids, i_ids, alive_cnt, flip_max, o_coords,
                            i_coords, to=to,
                            ti=min(128, i_coords.shape[2])).to(torch.bool)
    so, si = o_ids.clamp(min=0).long(), i_ids.clamp(min=0).long()
    optr, iptr = o_ptr[so], i_ptr[si]               # (P, Fo), (P, Fi)
    pv = (o_ids >= 0) & (i_ids >= 0)
    m = m & ((optr >= 0) & pv[:, None])[:, :, None] \
          & ((iptr >= 0) & pv[:, None])[:, None, :]
    p, fo = optr.shape
    fi = iptr.shape[1]
    av = optr[:, :, None].expand(p, fo, fi)
    bv = iptr[:, None, :].expand(p, fo, fi)
    oa, ob, cnt, ovf = compact_pairs(av.reshape(1, -1), bv.reshape(1, -1),
                                     m.reshape(1, -1), cap)
    return oa[0], ob[0], cnt[0], ovf[0]



# ---------------------------------------------------------------------------
# kNN: distance scoring (B5) and the fused level / leaf steps (B6, B7)
# ---------------------------------------------------------------------------

def knn_level_dists_ref(ids, points, lx, ly, hx, hy, child, *,
                        leaf: bool = False):
    """Twin of ``knn_level_dists_cuda``: (B, C) ids × (B, 2) points →
    (mindist (B, C, F), minmaxdist (B, C, F) | None) float32, DIST_PAD on
    lanes whose frontier slot or child is -1; ``leaf=True`` skips the
    bound and returns None for it."""
    safe = ids.clamp(min=0).long()                  # (B, C)
    glx, gly = lx[safe], ly[safe]                   # (B, C, F)
    ghx, ghy = hx[safe], hy[safe]
    px = points[:, 0, None, None]
    py = points[:, 1, None, None]
    valid = (child[safe] >= 0) & (ids >= 0)[:, :, None]
    pad = float(DIST_PAD)
    md = torch.where(valid, mindist(px, py, glx, gly, ghx, ghy), pad)
    if leaf:
        return md, None
    mmd = minmaxdist(px, py, glx, gly, ghx, ghy)
    return md, torch.where(valid, mmd, pad)


def _make_distance_fused_refs(dists_ref):
    """The (internal-level, leaf) fused twins of one distance score stage:
    its scores through the distance engine's emission
    (``traversal.distance_level_emit`` / ``distance_leaf_emit``), so the
    kNN and kNN-join twins differ only in the ``dists_ref`` they compose."""
    def level_fused_ref(ids, queries, lx, ly, hx, hy, child, tau, *,
                        cap: int, k: int, tighten: bool):
        md, mmd = dists_ref(ids, queries, lx, ly, hx, hy, child)
        ptr = child[ids.clamp(min=0).long()]
        return distance_level_emit(md, mmd, ptr, tau, cap=cap, k=k,
                                   tighten=tighten)

    def leaf_fused_ref(ids, queries, lx, ly, hx, hy, child, *, k: int):
        md, _ = dists_ref(ids, queries, lx, ly, hx, hy, child, leaf=True)
        return distance_leaf_emit(md, child[ids.clamp(min=0).long()], k=k)

    return level_fused_ref, leaf_fused_ref


# twins of knn_level_fused_cuda (B6) and knn_leaf_fused_cuda (B7)
knn_level_fused_ref, knn_leaf_fused_ref = \
    _make_distance_fused_refs(knn_level_dists_ref)


# ---------------------------------------------------------------------------
# kNN-join: rect-query scoring (B8) and the fused level / leaf steps (B9,
# B10)
# ---------------------------------------------------------------------------

def knn_join_level_dists_ref(ids, qrects, lx, ly, hx, hy, child, *,
                             leaf: bool = False):
    """Twin of ``knn_join_level_dists_cuda``: (B, C) ids × (B, 4) query
    rects → (mindist (B, C, F), minmaxdist (B, C, F) | None) float32 rect
    distances, DIST_PAD on lanes whose frontier slot or child is -1;
    ``leaf=True`` skips the bound and returns None for it."""
    safe = ids.clamp(min=0).long()                  # (B, C)
    glx, gly = lx[safe], ly[safe]                   # (B, C, F)
    ghx, ghy = hx[safe], hy[safe]
    q = [qrects[:, j, None, None] for j in range(4)]
    valid = (child[safe] >= 0) & (ids >= 0)[:, :, None]
    pad = float(DIST_PAD)
    md = torch.where(valid, mindist_rect(*q, glx, gly, ghx, ghy), pad)
    if leaf:
        return md, None
    mmd = minmaxdist_rect(*q, glx, gly, ghx, ghy)
    return md, torch.where(valid, mmd, pad)


# twins of knn_join_level_fused_cuda (B9) and knn_join_leaf_fused_cuda (B10)
knn_join_level_fused_ref, knn_join_leaf_fused_ref = \
    _make_distance_fused_refs(knn_join_level_dists_ref)


# ---------------------------------------------------------------------------
# D3 quantized layout: select (B11, B12), kNN (B13) and kNN-join (B14)
# scoring of internal levels (the operators re-check leaf rows with the
# exact D1 twins, so there is no leaf variant)
# ---------------------------------------------------------------------------

def _d3_gather_boxes(ids, qlo, qhi, scale, bias):
    """Gather and dequantize the frontier's node rows of one D3 level →
    (lx, ly, hx, hy), each (B, C, F) float32.  The codes are widened to
    int32 before the gather: PyTorch's CUDA indexing has no uint16."""
    safe = ids.clamp(min=0).long()                  # (B, C)
    lo, hi = qlo.to(torch.int32), qhi.to(torch.int32)
    return d3_dequantize(lo[safe], hi[safe], scale[safe], bias[safe])


def select_level_masks_d3_ref(ids, queries, qlo, qhi, scale, bias, ptr):
    """Twin of ``select_level_masks_d3_cuda``: (B, C) ids × (B, 4) queries
    over (N, F) uint16 code rows → (B, C, F) int32 conservative mask (a
    superset of the D1 mask on the true boxes)."""
    lx, ly, hx, hy = _d3_gather_boxes(ids, qlo, qhi, scale, bias)
    q = [queries[:, j, None, None] for j in range(4)]
    m = intersects(*q, lx, ly, hx, hy)
    m = m & (ptr[ids.clamp(min=0).long()] >= 0) & (ids >= 0)[:, :, None]
    return m.to(torch.int32)


def select_level_fused_d3_ref(ids, queries, qlo, qhi, scale, bias, ptr, *,
                              cap: int):
    """Twin of ``select_level_fused_d3_cuda``: the D3 masks + compress-store
    compaction over the flat (C·F) level → (next_ids (B, cap), counts (B,),
    overflow (B,))."""
    b = ids.shape[0]
    mask = select_level_masks_d3_ref(ids, queries, qlo, qhi, scale, bias,
                                     ptr).to(torch.bool)
    p = ptr[ids.clamp(min=0).long()]
    return compact_rows(p.reshape(b, -1), mask.reshape(b, -1), cap)


def _d3_dists(ids, slack, ptr, md, mmd):
    """The D3 distance stage's tail: the slack correction of MINMAXDIST
    and DIST_PAD on invalid lanes."""
    safe = ids.clamp(min=0).long()
    disp = slack[safe].sum(dim=-1)[:, :, None]      # (B, C, 1)
    mmd = d3_slacked_upper(mmd, disp)
    valid = (ptr[safe] >= 0) & (ids >= 0)[:, :, None]
    pad = float(DIST_PAD)
    return torch.where(valid, md, pad), torch.where(valid, mmd, pad)


def knn_level_dists_d3_ref(ids, points, qlo, qhi, scale, bias, slack, ptr):
    """Twin of ``knn_level_dists_d3_cuda``: (B, C) ids × (B, 2) points →
    (MINDIST on the dequantized boxes, a lower bound; ``d3_slacked_upper``
    of their D3-form MINMAXDIST, an upper bound), each (B, C, F) float32,
    DIST_PAD on invalid lanes."""
    boxes = _d3_gather_boxes(ids, qlo, qhi, scale, bias)
    px = points[:, 0, None, None]
    py = points[:, 1, None, None]
    return _d3_dists(ids, slack, ptr, mindist(px, py, *boxes),
                     minmaxdist_d3(px, py, *boxes))


def knn_join_level_dists_d3_ref(ids, qrects, qlo, qhi, scale, bias, slack,
                                ptr):
    """Twin of ``knn_join_level_dists_d3_cuda``: ``knn_level_dists_d3_ref``
    with (B, 4) query rects and the rect distances."""
    boxes = _d3_gather_boxes(ids, qlo, qhi, scale, bias)
    q = [qrects[:, j, None, None] for j in range(4)]
    return _d3_dists(ids, slack, ptr, mindist_rect(*q, *boxes),
                     minmaxdist_rect_d3(*q, *boxes))


# ---------------------------------------------------------------------------
# The DFS baselines (kernels S and V): one query's walk over the flat node
# table, as a host loop with the kernels' state machine
# ---------------------------------------------------------------------------

def _dfs_walk(lx, ly, hx, hy, child, count, is_leaf, q, *, root: int,
              stack_cap: int, result_cap: int, max_steps: int,
              by_count: bool):
    """The walk of S (``by_count``: a lane is valid while j < count) or V
    (a lane is valid while its child id is >= 0) → (res, stats) as the
    kernels return them.  A popped node's qualifying children are pushed
    or emitted in lane order at sp, sp + 1, ... (rc, rc + 1, ...); a push
    at or past ``stack_cap`` and an emit at or past ``result_cap`` are
    dropped while sp and rc keep counting, and a pop reads
    ``stack[min(sp, stack_cap - 1)]``: the reference's clamped gathers and
    dropped scatters.  The walk stops after ``max_steps`` pops with
    overflow set, as the kernels do."""
    rows = [t.cpu().numpy() for t in (lx, ly, hx, hy, child, count,
                                      is_leaf)]
    lx_, ly_, hx_, hy_, child_, count_, leaf_ = rows
    qlx, qly, qhx, qhy = q.cpu().numpy()
    lanes = np.arange(lx_.shape[1])
    stack = np.zeros(stack_cap, np.int32)
    stack[0] = root
    res = np.full(result_cap, -1, np.int32)
    sp, rc, nodes, preds, ovf = 1, 0, 0, 0, False
    while sp > 0:
        if nodes == max_steps:
            ovf = True
            break
        sp -= 1
        nid = stack[min(sp, stack_cap - 1)]
        ch = child_[nid]
        valid = lanes < count_[nid] if by_count else ch >= 0
        hit = valid & (qlx <= hx_[nid]) & (qhx >= lx_[nid]) & \
            (qly <= hy_[nid]) & (qhy >= ly_[nid])
        ids = ch[hit]                               # lane order
        preds += 4 * int(valid.sum())
        if leaf_[nid]:
            kept = ids[:max(0, min(len(ids), result_cap - rc))]
            res[rc:rc + len(kept)] = kept
            rc += len(ids)
        else:
            kept = ids[:max(0, min(len(ids), stack_cap - sp))]
            stack[sp:sp + len(kept)] = kept
            sp += len(ids)
        ovf |= sp > stack_cap or rc > result_cap
        nodes += 1
    stats = np.array([rc, nodes, preds if by_count else 0, int(ovf)],
                     np.int32)
    return (torch.from_numpy(res).to(lx.device),
            torch.from_numpy(stats).to(lx.device))


def select_dfs_scalar_ref(lx, ly, hx, hy, child, count, is_leaf, q, *,
                          root: int, stack_cap: int, result_cap: int,
                          max_steps: int):
    """Twin of ``select_dfs_scalar_cuda`` (kernel S): the walk that tests
    the children with j < count; predicates grow by 4 for each."""
    return _dfs_walk(lx, ly, hx, hy, child, count, is_leaf, q, root=root,
                     stack_cap=stack_cap, result_cap=result_cap,
                     max_steps=max_steps, by_count=True)


def select_dfs_vector_ref(lx, ly, hx, hy, child, count, is_leaf, q, *,
                          root: int, stack_cap: int, result_cap: int,
                          max_steps: int):
    """Twin of ``select_dfs_vector_cuda`` (kernel V): the walk that tests
    the lanes whose child id is >= 0; predicates stay 0."""
    return _dfs_walk(lx, ly, hx, hy, child, count, is_leaf, q, root=root,
                     stack_cap=stack_cap, result_cap=result_cap,
                     max_steps=max_steps, by_count=False)
