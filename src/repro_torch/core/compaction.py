"""Mask → contiguous compaction: the plain-tensor compress-store.

``mask → inclusive prefix sum → scatter at positions``, with non-qualifying
and overflowing lanes parked in an extra column ``cap`` that is dropped —
the same positions, order and overflow semantics as the reference's
``core/compaction.py``.  The fused kernels (``kernels/csrc``) compute the
same positions with block-wide scans instead.  Positions are int64, so a
flat pair-lane index past 2**31 stays exact.

``beam_rows`` is the distance operators' enqueue: the best-first beam of
the reference's ``compaction.beam_rows``.
"""
from __future__ import annotations

import torch


def _scatter_compact(arrays, mask: torch.Tensor, cap: int, fill: int):
    """Compact each (B, M) tensor of ``arrays`` under one mask into ``cap``
    slots (positions computed once).  Returns (outs, count, overflow) with
    count the per-row qualifying total (may exceed cap)."""
    mask = mask.to(torch.bool)
    b, m = mask.shape
    # int64 positions (inclusive scan - 1), updated in place because the
    # join's leaf step scans 2**28 lanes; non-qualifying and overflowing
    # lanes park in the dropped column ``cap``
    pos = torch.cumsum(mask, dim=1)
    pos -= 1
    pos.masked_fill_(~mask, cap).clamp_(max=cap)
    outs = []
    for vals in arrays:
        if tuple(vals.shape) != (b, m):
            raise ValueError(f"values must be {(b, m)}, got "
                             f"{tuple(vals.shape)}")
        out = torch.full((b, cap + 1), fill, dtype=vals.dtype,
                         device=vals.device)
        out.scatter_(1, pos, torch.where(mask, vals, fill).to(vals.dtype))
        outs.append(out[:, :cap].contiguous())   # kernels take dense rows
    count = mask.sum(dim=1, dtype=torch.int32)
    return outs, count, count > cap


def compact_rows(vals: torch.Tensor, mask: torch.Tensor, cap: int,
                 fill: int = -1):
    """Row-wise compaction of ``vals`` where ``mask`` into ``cap`` slots.

    vals: (B, M) int32, mask: (B, M) bool →
      out: (B, cap) compacted values (fill-padded),
      count: (B,) number of qualifying entries (may exceed cap),
      overflow: (B,) bool — True where entries were dropped.
    """
    if vals.ndim != 2:
        raise ValueError("compact_rows expects (B, M)")
    (out,), count, ovf = _scatter_compact((vals,), mask, cap, fill)
    return out, count, ovf


def beam_rows(vals: torch.Tensor, dists: torch.Tensor, mask: torch.Tensor,
              cap: int, fill: int = -1):
    """Best-first beam compaction: per row, the ``cap`` qualifying entries
    of smallest ``dists`` in ascending (distance, lane) order, ``fill``-
    padded.  The reference takes ``lax.top_k`` of the negated distances,
    which puts the lowest lane first among ties; ``torch.topk`` promises no
    tie order, so this sorts stably instead.

    Same contract as ``compact_rows`` → (out (B, cap), count (B,) int32,
    overflow = count > cap): on overflow every dropped entry's distance is
    >= the worst kept one.  vals: (B, M) int32; dists: (B, M) float32
    (``geometry.DIST_*`` convention); mask: (B, M) bool.
    """
    from .geometry import DIST_PAD, DIST_VALID_MAX
    if vals.ndim != 2:
        raise ValueError("beam_rows expects (B, M)")
    b, m = vals.shape
    mask = mask.to(torch.bool)
    d = torch.where(mask, dists, float(DIST_PAD))
    v = torch.where(mask, vals, fill).to(vals.dtype)
    if m < cap:
        d = torch.cat([d, d.new_full((b, cap - m), float(DIST_PAD))], dim=1)
        v = torch.cat([v, v.new_full((b, cap - m), fill)], dim=1)
    d, order = torch.sort(d, dim=1, stable=True)
    out = torch.gather(v, 1, order[:, :cap])
    out = torch.where(d[:, :cap] < float(DIST_VALID_MAX), out, fill)
    count = mask.sum(dim=1, dtype=torch.int32)
    return out, count, count > cap


def compact_1d(vals: torch.Tensor, mask: torch.Tensor, cap: int,
               fill: int = -1):
    """1-D compaction (single queue): (M,) → (cap,), count, overflow."""
    out, count, ovf = compact_rows(vals[None], mask[None], cap, fill)
    return out[0], count[0], ovf[0]


def compact_pairs(a: torch.Tensor, b_: torch.Tensor, mask: torch.Tensor,
                  cap: int, fill: int = -1):
    """Compact two parallel (B, M) id arrays under one mask (join pairs)."""
    (oa, ob), count, ovf = _scatter_compact((a, b_), mask, cap, fill)
    return oa, ob, count, ovf
