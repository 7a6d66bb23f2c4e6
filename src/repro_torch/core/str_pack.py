"""Sort-Tile-Recursive (STR) bulk loading.

Builds the R-tree bottom-up from a static rect set — the regime the paper
evaluates (10M synthetically generated uniform points, static index).  The
output is *level-major SoA*: for every level, the child-MBR key excerpts of
all nodes are stored as dense ``(n_nodes, fanout)`` arrays per excerpt.  This
is the paper's node layout **D1 generalized from node-local to level-global**
so that one breadth-first level step over many nodes (and many queries) is a
single dense kernel call.  A copy of the JAX package's packer: the port
imports nothing of that package.

Build happens on host in numpy (one-time cost, exactly like the paper's index
construction, which is not part of the measured query path).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from .geometry import pad_values


def _split_slabs(order: np.ndarray, n_slabs: int) -> List[np.ndarray]:
    """Split a permutation into ``n_slabs`` contiguous, nearly equal runs."""
    return [s for s in np.array_split(order, n_slabs) if len(s)]


def str_group(rects: np.ndarray, fanout: int) -> List[np.ndarray]:
    """One STR pass: group N rects into ceil(N/F) nodes of <= F entries.

    Returns a list of index arrays (entry ids per node).  Sort by center-x,
    cut into ~sqrt(P) vertical slabs, sort each slab by center-y, cut runs of
    F — the classic STR recipe [Leutenegger et al. 1997].
    """
    n = len(rects)
    cx = (rects[:, 0] + rects[:, 2]) * 0.5
    cy = (rects[:, 1] + rects[:, 3]) * 0.5
    n_leaves = math.ceil(n / fanout)
    n_slabs = max(1, math.ceil(math.sqrt(n_leaves)))
    x_order = np.argsort(cx, kind="stable")
    groups: List[np.ndarray] = []
    for slab in _split_slabs(x_order, n_slabs):
        y_order = slab[np.argsort(cy[slab], kind="stable")]
        for i in range(0, len(y_order), fanout):
            groups.append(y_order[i : i + fanout])
    return groups


def build_level(rects: np.ndarray, ids: np.ndarray, fanout: int,
                sort_key: str | None) -> dict:
    """Pack (rects, ids) entries into one level of nodes.

    Returns a dict of numpy arrays::

        lx, ly, hx, hy : (n_nodes, F)  child MBR key excerpts (padded empty)
        child          : (n_nodes, F)  child ids (-1 pad)
        count          : (n_nodes,)    valid children per node
        node_mbr       : (n_nodes, 4)  enclosing MBR of each node

    ``sort_key``: if 'lx' (etc.), children *within* each node are sorted on
    that key excerpt — the precondition for the paper's join optimizations
    O3/O4/O5.
    """
    dtype = rects.dtype
    lo_pad, hi_pad = pad_values(dtype)
    groups = str_group(rects, fanout)
    n_nodes = len(groups)
    lx = np.full((n_nodes, fanout), lo_pad, dtype)
    ly = np.full((n_nodes, fanout), lo_pad, dtype)
    hx = np.full((n_nodes, fanout), hi_pad, dtype)
    hy = np.full((n_nodes, fanout), hi_pad, dtype)
    child = np.full((n_nodes, fanout), -1, np.int32)
    count = np.zeros((n_nodes,), np.int32)
    node_mbr = np.empty((n_nodes, 4), dtype)
    key_col = {"lx": 0, "ly": 1, "hx": 2, "hy": 3}
    for ni, g in enumerate(groups):
        r = rects[g]
        gi = ids[g]
        if sort_key is not None:
            o = np.argsort(r[:, key_col[sort_key]], kind="stable")
            r, gi = r[o], gi[o]
        k = len(g)
        lx[ni, :k], ly[ni, :k] = r[:, 0], r[:, 1]
        hx[ni, :k], hy[ni, :k] = r[:, 2], r[:, 3]
        child[ni, :k] = gi
        count[ni] = k
        node_mbr[ni] = (r[:, 0].min(), r[:, 1].min(), r[:, 2].max(), r[:, 3].max())
    return dict(lx=lx, ly=ly, hx=hx, hy=hy, child=child, count=count,
                node_mbr=node_mbr)


def str_pack(rects: np.ndarray, fanout: int = 64,
             sort_key: str | None = None) -> List[dict]:
    """Full bottom-up STR build.

    Returns levels ordered leaf(0) → root(-1); the root level has exactly one
    node.  Level L's ``child`` ids index nodes of level L-1 (or data rects at
    the leaf level).
    """
    if rects.ndim != 2 or rects.shape[1] != 4:
        raise ValueError("rects must be (N, 4) [lx, ly, hx, hy]")
    if len(rects) == 0:
        raise ValueError("cannot build an R-tree over zero rects")
    levels = [build_level(rects, np.arange(len(rects), dtype=np.int64), fanout,
                          sort_key)]
    while len(levels[-1]["count"]) > 1:
        node_mbr = levels[-1]["node_mbr"]
        levels.append(build_level(node_mbr,
                                  np.arange(len(node_mbr), dtype=np.int64),
                                  fanout, sort_key))
    return levels


def points_to_rects(points: np.ndarray) -> np.ndarray:
    """Degenerate rects (lo == hi) from an (N, 2) point array."""
    return np.concatenate([points, points], axis=1)


def uniform_points(n: int, seed: int = 0, dtype=np.float32,
                   extent: float = 1.0) -> np.ndarray:
    """The paper's synthetic workload: uniform 2-D points."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, 2)) * extent).astype(dtype)


def uniform_rects(n: int, seed: int = 0, dtype=np.float32, extent: float = 1.0,
                  max_side: float = 0.001) -> np.ndarray:
    """Uniform small rects (for join inputs with non-degenerate MBRs)."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, 2)) * extent
    side = rng.random((n, 2)) * max_side * extent
    return np.concatenate([lo, lo + side], axis=1).astype(dtype)


def selectivity_query(selectivity: float, extent: float = 1.0,
                      rng: np.random.Generator | None = None,
                      dtype=np.float32) -> np.ndarray:
    """A square query rect whose area fraction equals ``selectivity``.

    For uniform data, area fraction ≈ result selectivity — the paper's
    default is 0.1%.
    """
    rng = rng or np.random.default_rng(0)
    side = math.sqrt(selectivity) * extent
    lo = rng.random(2) * (extent - side)
    return np.array([lo[0], lo[1], lo[0] + side, lo[1] + side], dtype=dtype)


def query_batch(n_queries: int, selectivity: float, seed: int = 1,
                extent: float = 1.0, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([
        selectivity_query(selectivity, extent, rng, dtype)
        for _ in range(n_queries)
    ])
