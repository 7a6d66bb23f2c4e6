"""Cross-partition merges of the single-program path (the reference's
``distributed/collectives.py``, its executable half).

The reference runs these inside a ``shard_map`` over its ``model`` mesh
axis: an all-gather along the partition axis, a (distance, id) top-k
merge, and the partition and shard folds of ``Counters``.  On one card the
P partitions are rows of one batch (``forest.PackedForest.flat``), so the
gather is a reshape and the shard fold is over one shard; the names stay
so a reader finds each counterpart.  The reference's other half, the HLO
parsing of its roofline (``parse_collectives``, ``collective_seconds``),
reads XLA's compiled text and has no PyTorch counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.counters import Counters


def topk_by_distance(ids: torch.Tensor, d: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic (distance, id) top-k over the last axis.

    ids/d: (..., M) candidate streams (pad: id -1, d +inf).  Ascending
    lexicographic on (distance, id), the reference's ``jnp.lexsort((ids,
    d))``: a stable sort by id, then a stable sort by distance.  The
    result does not depend on the order of the candidate axis, so the
    merge does not depend on where the partitions lie."""
    m = d.shape[-1]
    if m < k:
        pad = d.shape[:-1] + (k - m,)
        d = torch.cat([d, d.new_full(pad, float("inf"))], -1)
        ids = torch.cat([ids, ids.new_full(pad, -1)], -1)
    order = torch.sort(ids, dim=-1, stable=True).indices
    ids = torch.gather(ids, -1, order)
    d = torch.gather(d, -1, order)
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return torch.gather(ids, -1, order), torch.gather(d, -1, order)


def gather_partitions(x: torch.Tensor, n_partitions: int) -> torch.Tensor:
    """The all-gather along the partition axis, on one card: rows of the
    flat batch (P·B, ...), partition-major, folded to (P, B, ...)."""
    return x.reshape((n_partitions, -1) + tuple(x.shape[1:]))


_SUM_MAX_FIELDS = ("overflow", "dispatches")


def merge_stacked_counters(ctr: Counters) -> Counters:
    """Fold counters stacked over a leading partition axis: work fields
    sum, ``overflow`` is sticky (max) and ``dispatches`` takes the max
    (the partitions run as one launch sequence)."""
    out = {}
    for f in dataclasses.fields(Counters):
        v = getattr(ctr, f.name)
        out[f.name] = (v.amax(dim=0) if f.name in _SUM_MAX_FIELDS
                       else v.sum(dim=0, dtype=torch.int32))
    return Counters(**out)


def psum_counters(ctr: Counters) -> Counters:
    """The cross-shard counter fold (work fields summed, ``overflow`` and
    ``dispatches`` maxed over shards), on one card: one shard, so the
    counters pass through."""
    return ctr
