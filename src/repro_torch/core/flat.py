"""Flat single-table tree form (the reference's ``core/flat.py``).

Concatenates all levels into one global node table so that the
data-dependent DFS baselines (``select_scalar.make_select_dfs``,
``select_vector.make_select_dfs_vector`` and their CUDA kernels) index
nodes with one id space.  Levels are laid out leaf first; the ``child``
entries of internal nodes are globalized; leaf nodes' children stay data
rect ids and are told apart by ``is_leaf``.  The table is built on the
tree's device, every tensor contiguous (the kernels take dense rows).
"""
from __future__ import annotations

import dataclasses

import torch

from .rtree import RTree


@dataclasses.dataclass(frozen=True)
class FlatTree:
    lx: torch.Tensor       # (T, F) float32
    ly: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    child: torch.Tensor    # (T, F) int32 globalized ids; rect ids at leaves
    count: torch.Tensor    # (T,) int32
    is_leaf: torch.Tensor  # (T,) bool
    root: int              # global id of the root node
    height: int            # number of levels

    @property
    def fanout(self) -> int:
        return self.lx.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.count.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lx.device


def flatten_tree(tree: RTree) -> FlatTree:
    """Level-major concatenation (leaf level first) with globalized child
    pointers, on the tree's device."""
    offset, child, leaf = 0, [], []
    for li, lvl in enumerate(tree.levels):
        c = lvl.child
        if li > 0:
            c = torch.where(c >= 0, c + offset, -1)
            offset += tree.levels[li - 1].n_nodes
        child.append(c.to(torch.int32))
        leaf.append(torch.full((lvl.n_nodes,), li == 0, dtype=torch.bool,
                               device=c.device))

    def cat(name):
        return torch.cat([getattr(lvl, name) for lvl in tree.levels]) \
            .contiguous()

    return FlatTree(
        lx=cat("lx"), ly=cat("ly"), hx=cat("hx"), hy=cat("hy"),
        child=torch.cat(child).contiguous(), count=cat("count"),
        is_leaf=torch.cat(leaf).contiguous(),
        root=tree.n_nodes_total() - 1, height=tree.height)
