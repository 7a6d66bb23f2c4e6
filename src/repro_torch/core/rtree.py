"""RTree container: level-major SoA tensors in frozen dataclasses.

Structure (leaf level = index 0, root level = index -1)::

    RTreeLevel:
      lx, ly, hx, hy : (n_nodes, F)  child MBR key excerpts (empty-padded)
      child          : (n_nodes, F)  int32 child ids (-1 pad)
      count          : (n_nodes,)    int32 valid-children count
      node_mbr       : (n_nodes, 4)  node MBRs

The build runs on the host in numpy (``str_pack``); ``tree_from_arrays``
moves the packed arrays onto a device.  The same carrier turns the JAX
package's tree (its arrays read back as numpy) into the port's tree, so
both packages can be run on one index.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import str_pack

LEVEL_FIELDS = ("lx", "ly", "hx", "hy", "child", "count", "node_mbr")


@dataclasses.dataclass(frozen=True)
class RTreeLevel:
    lx: torch.Tensor
    ly: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    child: torch.Tensor
    count: torch.Tensor
    node_mbr: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.count.shape[0]

    @property
    def fanout(self) -> int:
        return self.lx.shape[1]


@dataclasses.dataclass(frozen=True)
class RTree:
    """Immutable bulk-loaded R-tree."""
    levels: Tuple[RTreeLevel, ...]          # leaf(0) ... root(-1)
    rects: torch.Tensor                     # (N, 4) data rects
    fanout: int = 64
    sort_key: Optional[str] = None

    @property
    def height(self) -> int:
        """Number of levels (a height-1 tree is a single root-leaf node)."""
        return len(self.levels)

    @property
    def n_rects(self) -> int:
        return self.rects.shape[0]

    @property
    def root(self) -> RTreeLevel:
        return self.levels[-1]

    @property
    def device(self) -> torch.device:
        return self.rects.device

    def n_nodes_total(self) -> int:
        return sum(lvl.n_nodes for lvl in self.levels)


def tree_from_arrays(levels: Sequence[Mapping[str, np.ndarray]],
                     rects: np.ndarray, fanout: int,
                     sort_key: Optional[str] = None,
                     device="cuda") -> RTree:
    """Packed level arrays (leaf first; each a mapping with the
    ``LEVEL_FIELDS`` keys, as ``str_pack.str_pack`` returns them or as read
    back from the JAX package's tree) → an ``RTree`` on ``device``.  Child
    ids become int32, as in the reference."""
    def put(a, dtype=None):
        # a writable C-order copy: arrays read back from JAX are read-only
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(
            device)

    out = tuple(
        RTreeLevel(lx=put(lv["lx"]), ly=put(lv["ly"]), hx=put(lv["hx"]),
                   hy=put(lv["hy"]), child=put(lv["child"], np.int32),
                   count=put(lv["count"], np.int32),
                   node_mbr=put(lv["node_mbr"]))
        for lv in levels)
    return RTree(levels=out, rects=put(np.asarray(rects)), fanout=fanout,
                 sort_key=sort_key)


def build_rtree(rects: np.ndarray, fanout: int = 64,
                sort_key: Optional[str] = None, device="cuda") -> RTree:
    """STR bulk load on the host → RTree on ``device``.  ``sort_key``
    enables the join's O3/O4/O5 preconditions."""
    rects = np.asarray(rects)
    return tree_from_arrays(str_pack.str_pack(rects, fanout, sort_key),
                            rects, fanout, sort_key, device)


def build_rtree_points(points: np.ndarray, **kw) -> RTree:
    return build_rtree(str_pack.points_to_rects(np.asarray(points)), **kw)


def validate_structure(tree: RTree) -> None:
    """Structural invariants (used by tests).

    - every child MBR is contained in its node MBR;
    - level L's children index valid nodes of level L-1 / data rects;
    - counts within (0, fanout]; root level has one node;
    - each data rect appears in exactly one leaf slot.
    """
    assert tree.root.n_nodes == 1, "root level must have exactly one node"
    seen = np.zeros(tree.n_rects, dtype=np.int64)
    for li, lvl in enumerate(tree.levels):
        lx, ly, hx, hy, child, count, nm = (
            getattr(lvl, f).cpu().numpy() for f in LEVEL_FIELDS)
        assert count.min() > 0 and count.max() <= tree.fanout
        ar = np.arange(lvl.fanout)[None, :]
        valid = ar < count[:, None]
        assert (lx[valid] >= np.repeat(nm[:, 0], count)).all()
        assert (ly[valid] >= np.repeat(nm[:, 1], count)).all()
        assert (hx[valid] <= np.repeat(nm[:, 2], count)).all()
        assert (hy[valid] <= np.repeat(nm[:, 3], count)).all()
        assert (child[~valid] == -1).all()
        n_below = tree.n_rects if li == 0 else tree.levels[li - 1].n_nodes
        ids = child[valid]
        assert ids.min() >= 0 and ids.max() < n_below
        if li == 0:
            np.add.at(seen, ids, 1)
        else:
            # every node below is referenced exactly once
            ref = np.zeros(n_below, np.int64)
            np.add.at(ref, ids, 1)
            assert (ref == 1).all()
        if tree.sort_key is not None:
            col = {"lx": lx, "ly": ly, "hx": hx, "hy": hy}[tree.sort_key]
            c = np.where(~valid, np.inf, col.astype(np.float64))
            assert (np.sort(c, axis=1) == c).all()
    assert (seen == 1).all(), "each rect must appear in exactly one leaf slot"
