"""Cross-partition merges of the single-program path (the reference's
``distributed/collectives.py``, its executable half).

The reference runs these inside a ``shard_map`` over its ``model`` mesh
axis: an all-gather along the partition axis, a (distance, id) top-k
merge, and the partition and shard folds of ``Counters``.  On one card the
P partitions are rows of one batch (``forest.PackedForest.flat``), so the
gather is a reshape and the shard fold is over one shard; the names stay
so a reader finds each counterpart.

The reference's other half reads the collectives of its roofline from
XLA's compiled text (``parse_collectives``) and prices them
(``collective_seconds``).  Here ``from_trace`` builds the same
``CollectiveStats`` from the collectives that ``trace_cost.CostMode``
recorded (the bytes by the reference's formulas), and
``collective_seconds`` prices each at the rate of the links its group
crosses, an H100's in place of the reference's 50 GB/s ICI link:

  * within one host of 8 cards, NVLink: 450 GB/s each way a card (NVIDIA
    H100 SXM data sheet: 900 GB/s bidirectional);
  * across hosts, the fabric: one 400 Gb/s NDR InfiniBand port a card,
    50 GB/s (NVIDIA DGX H100 user guide: eight ConnectX-7 ports for the
    eight cards).

A group whose ranks span more than one host takes the fabric's rate.
Ranks are laid out host by host, in the mesh's order.  On the production
meshes every axis crosses hosts: (16, 16)'s 'model' groups are 16
consecutive ranks (two hosts), its 'data' groups ranks 16 apart (sixteen
hosts), and (2, 16, 16)'s 'pod' groups ranks 256 apart.  An axis of at
most 8 consecutive ranks (the tests' (2, 4) mesh) stays on NVLink.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

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


# links an H100 reaches (see the module's docstring for the sources)
NVLINK_BW = 450e9            # bytes/s each way a card, within a host
FABRIC_BW = 50e9             # bytes/s a card across hosts (400 Gb/s NDR)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, float]
    ops: List[Tuple[str, float, int, int]]   # (kind, bytes, group, hosts)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def from_trace(report) -> CollectiveStats:
    """The collectives of a ``trace_cost.CostReport`` (each op's bytes
    already weighted by how often it runs)."""
    ops = [(c.kind, c.bytes * c.count, c.group_size, c.hosts)
           for c in report.collectives]
    return CollectiveStats(dict(report.bytes_by_collective),
                           dict(report.counts_by_collective), ops)


def collective_seconds(stats: CollectiveStats, nvlink_bw: float = NVLINK_BW,
                       fabric_bw: float = FABRIC_BW) -> float:
    """Lower-bound wire time: each op's bytes a device over the rate of
    the links its group crosses, summed (no overlap between them)."""
    return sum(b / (nvlink_bw if hosts <= 1 else fabric_bw)
               for _, b, _, hosts in stats.ops)
