"""Scalar nested-index spatial join (paper §4, scalar baseline; the
reference's ``core/join_scalar.py``).

Brinkhoff-style R-tree join: a synchronized top-down traversal of two
indexes that follows the child pairs that intersect, as host numpy over
one copy of each tree.  ``o3``/``o4`` enable the paper's sorted-key
pruning in scalar form (S-D0(O3) in Fig. 11):

  O3  break the *outer* child loop once the sorted outer ``low_x`` exceeds
      every inner child's ``high_x`` (all later outer children fail too);
  O4  break the *inner* child loop once the sorted inner ``low_x`` exceeds
      the current outer child's ``high_x``.

Unequal tree heights are handled by elevating the shorter tree with
single-child chain levels (``elevate``), so descent stays synchronized;
the vectorized join uses the same trick.
"""
from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from .counters import Counters
from .geometry import pad_values
from .rtree import RTree, RTreeLevel
from .select_scalar import host_levels


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


def join_recursive_py(tree_a: RTree, tree_b: RTree, o3: bool = False,
                      o4: bool = False) -> Tuple[np.ndarray, Counters]:
    """Host-Python scalar join → (sorted (K, 2) int64 id pairs, Counters of
    Python ints: ``nodes_visited`` 2 a pair, ``predicates`` 4 a compared
    child pair, ``pruned_outer`` / ``pruned_inner`` the children O3 / O4
    skipped).  The trees are read from their device once."""
    if (o3 or o4) and (tree_a.sort_key != "lx" or tree_b.sort_key != "lx"):
        raise ValueError("O3/O4 require trees built with sort_key='lx'")
    h = max(tree_a.height, tree_b.height)
    la = host_levels(elevate(tree_a, h))
    lb = host_levels(elevate(tree_b, h))
    out: list[tuple[int, int]] = []
    c = Counters()
    if h + 10 > sys.getrecursionlimit():
        sys.setrecursionlimit(h + 100)

    def join_nodes(li: int, na: int, nb: int) -> None:
        A, B = la[li], lb[li]
        c.nodes_visited += 2
        ca, cb = int(A["count"][na]), int(B["count"][nb])
        max_b_hx = B["hx"][nb, :cb].max() if cb else None
        for ai in range(ca):
            alx, ahx = A["lx"][na, ai], A["hx"][na, ai]
            if o3 and alx > max_b_hx:
                c.pruned_outer += ca - ai
                break
            for bi in range(cb):
                blx = B["lx"][nb, bi]
                if o4 and blx > ahx:
                    c.pruned_inner += cb - bi
                    break
                c.predicates += 4
                hit = (alx <= B["hx"][nb, bi]) and (ahx >= blx) and \
                      (A["ly"][na, ai] <= B["hy"][nb, bi]) and \
                      (A["hy"][na, ai] >= B["ly"][nb, bi])
                if hit:
                    ia, ib = int(A["child"][na, ai]), int(B["child"][nb, bi])
                    if li == 0:
                        out.append((ia, ib))
                    else:
                        join_nodes(li - 1, ia, ib)

    join_nodes(h - 1, 0, 0)
    pairs = np.array(sorted(out), dtype=np.int64).reshape(-1, 2)
    return pairs, c
