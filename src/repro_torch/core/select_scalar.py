"""Scalar range-select baselines (paper §3, scalar variants; the
reference's ``core/select_scalar.py``).

1. ``select_recursive_py`` — a host-Python recursive DFS over numpy copies
   of the level arrays, with the paper's two predicate styles: *logical*
   (short-circuit ``and``, up to 4 branches per entry) and *bitwise* (all
   four comparisons, one branch).  It is the semantic reference and the
   counter model of the scalar variants.

2. ``make_select_dfs`` — the scalar walk on the device: an explicit DFS
   stack processing one node per step and one child per inner step.  On
   the card it is kernel S (``kernels/csrc/rtree_dfs.cu``), one thread
   per query; the reference runs it as a jitted ``lax.while_loop``.  The
   same walk with a vectorized per-node step is the paper's V variant
   (``select_vector.make_select_dfs_vector``, kernel V).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import ops
from .counters import Counters
from .flat import FlatTree
from .rtree import RTree


def host_levels(tree: RTree, dtype=None):
    """numpy copies of every level's child rows and counts, each read
    from the tree's device once; ``dtype`` converts the coordinates."""
    def host(t, key=True):
        a = t.cpu().numpy()
        return a.astype(dtype) if key and dtype is not None else a

    return [dict(lx=host(lvl.lx), ly=host(lvl.ly), hx=host(lvl.hx),
                 hy=host(lvl.hy), child=host(lvl.child, False),
                 count=host(lvl.count, False))
            for lvl in tree.levels]


def select_recursive_py(tree: RTree, query, variant: str = "logical"
                        ) -> Tuple[np.ndarray, Counters]:
    """Scalar recursive DFS (the paper's baseline) → (sorted ids int64,
    Counters of Python ints).

    Counter model per entry examined, with the comparisons ordered
    (qlx <= hx, qhx >= lx, qly <= hy, qhy >= ly):
      logical: evaluated = 1 + c1 + c1·c2 + c1·c2·c3; branches = evaluated
      bitwise: evaluated = 4; branches = 1
    """
    if variant not in ("logical", "bitwise"):
        raise ValueError(variant)
    q = query.cpu().numpy() if torch.is_tensor(query) else query
    qlx, qly, qhx, qhy = (float(x) for x in np.asarray(q))
    levels = host_levels(tree)
    out: list[int] = []
    c = Counters()

    def visit(li: int, nid: int) -> None:
        lv = levels[li]
        c.nodes_visited += 1
        n = int(lv["count"][nid])
        lx, ly = lv["lx"][nid], lv["ly"][nid]
        hx, hy = lv["hx"][nid], lv["hy"][nid]
        ch = lv["child"][nid]
        for j in range(n):
            if variant == "logical":
                c1 = qlx <= hx[j]
                c2 = c1 and (qhx >= lx[j])
                c3 = c2 and (qly <= hy[j])
                hit = c3 and (qhy >= ly[j])
                ev = 1 + int(c1) + int(c2) + int(c3)
                c.predicates += ev
                c.branches += ev          # one branch per evaluated compare
            else:
                hit = (qlx <= hx[j]) & (qhx >= lx[j]) & \
                      (qly <= hy[j]) & (qhy >= ly[j])
                c.predicates += 4
                c.branches += 1           # single fused conditional
            if hit:
                if li == 0:
                    out.append(int(ch[j]))
                else:
                    visit(li - 1, int(ch[j]))

    visit(tree.height - 1, 0)
    return np.sort(np.array(out, dtype=np.int64)), c


def dfs_max_steps(flat: FlatTree) -> int:
    """Pops after which a DFS walk stops with overflow set: an overflowed
    walk can re-read its last stack slot without end, where the
    reference's loop would not end.  A walk that ends pops far fewer."""
    return flat.n_nodes * (flat.fanout + 1) + 1


def make_select_dfs(flat: FlatTree, result_cap: int, stack_cap: int = 1024,
                    backend: str = "auto"):
    """Build the single-query scalar DFS: q (4,) → (ids (result_cap,)
    int32 in DFS emit order, -1 padded; n 0-d int32, the qualifying count,
    which may exceed ``result_cap``; Counters with ``nodes_visited``,
    ``predicates`` (4 per child with j < count) and ``overflow``).

    ``backend``: 'auto' launches kernel S when ``flat`` lies on a CUDA
    device and runs its host twin when it lies on the CPU; 'cuda' demands
    the kernel; 'torch' runs the twin anywhere.  Overflow behaves as the
    reference's: pushes past ``stack_cap`` and emits past ``result_cap``
    are dropped while the counts go on."""
    ops.resolve_backend(backend, flat.lx)
    return _make_dfs(flat, "scalar", result_cap, stack_cap, backend)


def _make_dfs(flat: FlatTree, variant: str, result_cap: int, stack_cap: int,
              backend: str):
    """The walk of S or V over ``flat`` → fn(q) → (res, rc, Counters)."""
    rows = (flat.lx, flat.ly, flat.hx, flat.hy, flat.child, flat.count,
            flat.is_leaf)
    steps = dfs_max_steps(flat)
    f = flat.fanout

    def run(q):
        qt = torch.as_tensor(q, dtype=torch.float32,
                             device=flat.device).reshape(4).contiguous()
        res, stats = ops.select_dfs(variant, *rows, qt, root=flat.root,
                                    stack_cap=stack_cap,
                                    result_cap=result_cap, max_steps=steps,
                                    backend=backend)
        rc, nodes = stats[0], stats[1]
        if variant == "scalar":
            ctr = Counters(nodes_visited=nodes, predicates=stats[2],
                           overflow=stats[3])
        else:
            ctr = Counters(nodes_visited=nodes, vector_ops=nodes * 4,
                           predicates=nodes * (f * 4), overflow=stats[3],
                           dispatches=torch.ones_like(rc))
        return res, rc, ctr

    return run
