"""Chain elevation for the nested-index spatial join (the reference's
``core/join_scalar.py``: ``elevate``).

Unequal tree heights are handled by elevating the shorter tree with
single-child chain levels, so the pair-frontier descent stays
synchronized.  The paper's scalar baseline ``join_recursive_py`` is not
ported yet (ROADMAP item A5, with the other baselines).
"""
from __future__ import annotations

import torch

from .geometry import pad_values
from .rtree import RTree, RTreeLevel


def elevate(tree: RTree, target_height: int) -> RTree:
    """Add single-node chain levels above the root until ``target_height``.
    Each chain node holds one child, the node below (id 0), with the MBR of
    the root; its other lanes carry the empty-MBR padding.  The new levels
    lie on the tree's device."""
    if target_height < tree.height:
        raise ValueError("target height below current height")
    if target_height == tree.height:
        return tree
    levels = list(tree.levels)
    lx0 = tree.levels[0].lx
    lo_pad, hi_pad = (v.item() for v in pad_values(
        torch.empty((), dtype=lx0.dtype).numpy().dtype))
    f, dev, dt = tree.fanout, lx0.device, lx0.dtype
    while len(levels) < target_height:
        nm = levels[-1].node_mbr[0]                  # (4,)

        def row(pad, v):
            r = torch.full((1, f), pad, dtype=dt, device=dev)
            r[0, 0] = v
            return r

        child = torch.full((1, f), -1, dtype=torch.int32, device=dev)
        child[0, 0] = 0
        levels.append(RTreeLevel(
            lx=row(lo_pad, nm[0]), ly=row(lo_pad, nm[1]),
            hx=row(hi_pad, nm[2]), hy=row(hi_pad, nm[3]), child=child,
            count=torch.ones((1,), dtype=torch.int32, device=dev),
            node_mbr=nm[None].clone()))
    return RTree(levels=tuple(levels), rects=tree.rects, fanout=tree.fanout,
                 sort_key=tree.sort_key)
