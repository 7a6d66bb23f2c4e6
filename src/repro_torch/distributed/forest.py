"""Pack a partitioned R-tree fleet into one forest for the single-program
path (the reference's ``distributed/forest.py``: ``PackedForest``,
``pack_forest``).

The host fan-out (spatial_shard.py) keeps one ``RTree`` per partition and
calls each partition's engine from a Python loop.  The mesh path packs all
P partition trees into one forest instead:

  * heights are normalized by chain-elevating every tree to the tallest
    partition's height (``join_scalar.elevate``; a chain level scores one
    extra node a descent and changes no result);
  * each level is padded along its node axis to the level's largest
    partition (padded rows hold empty-MBR coordinates and child -1, and
    no pointer reaches them);
  * the partition count is padded up to a multiple of ``n_shards`` with
    structurally empty partitions (every child -1, an empty MBR) that
    route nothing and answer nothing;
  * ``ids_map`` (P, n_max_rects) maps each partition's local rect ids to
    global ids, so cross-partition merges order by global id.

The reference stacks the partitions along a leading axis and ``vmap``s the
engine over it.  On one card the kernels keep their shapes and get one
tree: ``PackedForest.flat`` lays level ``l`` of the P padded partitions end
to end, (P·n_max_l, F), with partition ``p``'s child pointers offset by
``p·n_max_{l-1}`` (leaf pointers by ``p·n_max_rects``) and its root at node
``p`` of the flat root level.  A batch of B queries then runs as P·B rows,
row ``p·B + b`` starting at root ``p``: one launch a level over partition
× query.  Each row's frontier caps are one padded partition's
(``partition_tree``, the shape the reference's vmapped builder sees), so
the mesh path's caps equal the reference's and can only be >= each
partition's own host-path caps: the mesh path never overflows where the
host path did not.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.geometry import pad_values
from ..core.join_scalar import elevate
from ..core.rtree import LEVEL_FIELDS, RTree, RTreeLevel


@dataclasses.dataclass(frozen=True)
class PackedForest:
    """P partition trees as one stacked forest and its flat view.

    ``tree`` — an ``RTree`` whose level tensors have a leading (P,)
    partition axis (P a multiple of ``n_shards``), child ids local to the
    partition, as the reference's; ``ids_map`` — (P, n_max_rects) int32
    local → global rect ids (-1 pad), on the forest's device; ``mbrs`` —
    (P, 4) partition MBRs (a host copy of the stacked root MBRs); ``n_real``
    — the number of real (non-padding) partitions; ``flat`` — the one-tree
    view the engines run on (see the module docstring).
    """
    tree: RTree
    ids_map: torch.Tensor
    mbrs: np.ndarray
    n_real: int
    flat: RTree

    @property
    def n_partitions(self) -> int:
        return self.ids_map.shape[0]

    @property
    def height(self) -> int:
        return self.tree.height

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def ids_flat(self) -> torch.Tensor:
        """(P·n_max_rects,) global id of each flat rect row (-1 pad)."""
        return self.ids_map.reshape(-1)

    @property
    def partition_tree(self) -> RTree:
        """Partition 0 as the reference's vmapped builder sees it: one
        padded partition, whose level sizes set every row's caps."""
        return RTree(
            levels=tuple(RTreeLevel(*(getattr(lvl, f)[0]
                                      for f in LEVEL_FIELDS))
                         for lvl in self.tree.levels),
            rects=self.tree.rects[0], fanout=self.tree.fanout,
            sort_key=self.tree.sort_key)

    def to(self, device) -> "PackedForest":
        """The forest on ``device`` (the reference's ``device_put``)."""
        def move(t: RTree) -> RTree:
            return RTree(
                levels=tuple(RTreeLevel(*(getattr(lvl, f).to(device)
                                          for f in LEVEL_FIELDS))
                             for lvl in t.levels),
                rects=t.rects.to(device), fanout=t.fanout,
                sort_key=t.sort_key)
        return dataclasses.replace(self, tree=move(self.tree),
                                   ids_map=self.ids_map.to(device),
                                   flat=move(self.flat))


def _pad_round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def flat_view(stacked: RTree) -> RTree:
    """The stacked forest's levels end to end: (P, n, ...) → (P·n, ...),
    each partition's child pointers offset by its first row one level
    down (its first rect row at the leaf); -1 stays -1."""
    levels = []
    for li, lvl in enumerate(stacked.levels):
        p = lvl.count.shape[0]
        below = (stacked.rects.shape[1] if li == 0
                 else stacked.levels[li - 1].count.shape[1])
        off = (torch.arange(p, dtype=torch.int32, device=lvl.child.device)
               * below)[:, None, None]
        child = torch.where(lvl.child >= 0, lvl.child + off, -1)
        levels.append(RTreeLevel(*(
            (child if f == "child" else getattr(lvl, f)).reshape(
                (-1,) + tuple(getattr(lvl, f).shape[2:]))
            for f in LEVEL_FIELDS)))
    return RTree(levels=tuple(levels), rects=stacked.rects.reshape(-1, 4),
                 fanout=stacked.fanout, sort_key=stacked.sort_key)


def pack_forest(trees: Sequence[RTree], ids: Sequence[np.ndarray],
                n_shards: int = 1, order: Optional[Sequence[int]] = None,
                min_height: Optional[int] = None) -> PackedForest:
    """Pack per-partition ``trees`` (with their global-id arrays ``ids``)
    into a :class:`PackedForest` on the trees' device, its partition count
    padded to a multiple of ``n_shards``.  ``order`` permutes the
    partitions (the permutation-invariance tests re-pack under a shuffle);
    ``min_height`` raises the normalized height (a mesh join against a
    taller probe tree elevates the forest)."""
    if order is not None:
        trees = [trees[i] for i in order]
        ids = [ids[i] for i in order]
    if not trees:
        raise ValueError("cannot pack an empty forest")
    height = max(max(t.height for t in trees), min_height or 1)
    trees = [elevate(t, height) for t in trees]
    f, dev = trees[0].fanout, trees[0].device
    dtype = trees[0].levels[0].lx.dtype
    lo_pad, hi_pad = (v.item() for v in pad_values(
        torch.empty((), dtype=dtype).numpy().dtype))
    p_real = len(trees)
    p = _pad_round_up(p_real, max(n_shards, 1))
    empty_box = torch.tensor([lo_pad, lo_pad, hi_pad, hi_pad], dtype=dtype,
                             device=dev)

    levels: List[RTreeLevel] = []
    for li in range(height):
        n_max = max(t.levels[li].n_nodes for t in trees)
        arr = dict(
            lx=torch.full((p, n_max, f), lo_pad, dtype=dtype, device=dev),
            ly=torch.full((p, n_max, f), lo_pad, dtype=dtype, device=dev),
            hx=torch.full((p, n_max, f), hi_pad, dtype=dtype, device=dev),
            hy=torch.full((p, n_max, f), hi_pad, dtype=dtype, device=dev),
            child=torch.full((p, n_max, f), -1, dtype=torch.int32,
                             device=dev),
            count=torch.zeros((p, n_max), dtype=torch.int32, device=dev),
            node_mbr=empty_box.expand(p, n_max, 4).clone())
        for pi, t in enumerate(trees):
            lvl = t.levels[li]
            for name, a in arr.items():
                a[pi, :lvl.n_nodes] = getattr(lvl, name)
        levels.append(RTreeLevel(**arr))

    n_max_rects = max(max(len(i) for i in ids),
                      max(t.rects.shape[0] for t in trees))
    ids_map = np.full((p, n_max_rects), -1, np.int32)
    for pi, gl in enumerate(ids):
        ids_map[pi, :len(gl)] = gl
    # D3's exact leaf re-check reads ``tree.rects``, so the forest carries
    # each partition's data rects padded to a shared shape (empty-box rows,
    # which no leaf pointer reaches), in the leaf level's memory order
    rects = empty_box.expand(p, n_max_rects, 4).clone()
    for pi, t in enumerate(trees):
        rects[pi, :t.rects.shape[0]] = t.rects
    stacked = RTree(levels=tuple(levels), rects=rects, fanout=f,
                    sort_key=trees[0].sort_key)
    return PackedForest(
        tree=stacked, ids_map=torch.from_numpy(ids_map).to(dev),
        mbrs=levels[-1].node_mbr[:, 0, :].cpu().numpy(), n_real=p_real,
        flat=flat_view(stacked))


def replicate_forest(packed: PackedForest, devices) -> List[PackedForest]:
    """Replica fan-out: one host-packed forest placed on each replica's
    device (``launch/mesh.replica_devices``; the reference's
    ``replicate_forest`` over replica meshes).  The packing is shared and
    only the placement differs; a replica on the pack's own device shares
    its tensors, which every engine only reads."""
    return [packed.to(d) for d in devices]
