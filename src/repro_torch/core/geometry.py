"""MBR geometry primitives for the port.

``intersects`` works on tensors (and numpy arrays) alike: it is the D1
predicate, four compares ANDed, written exactly as the four key-excerpt
comparisons so every path agrees bit-for-bit (closed intervals, as in
Guttman's R-tree).

Padding convention: absent children carry an *empty* MBR (``low = +PAD,
high = -PAD``) so every intersection predicate is False without a separate
validity mask.
"""
from __future__ import annotations

import numpy as np

# Large-but-finite padding values (finite so int paths and fp paths behave
# the same).
_F32_PAD = np.float32(3.0e38)
_I32_PAD = np.int32(2**31 - 2)

# Distance constants of the kNN family (the distance functions arrive with
# the kNN slice; the constants are shared with the tree padding policy).
_DELTA_CLAMP = np.float32(1.0e18)      # clamp²=1e36 < f32 max, still "huge"
DIST_PAD = np.float32(3.0e38)          # distance slot for invalid lanes
# d < this ⇔ lane held a real entry: strictly between the largest computable
# real distance (2·_DELTA_CLAMP² = 2e36) and DIST_PAD.
DIST_VALID_MAX = np.float32(1.0e37)


def pad_values(dtype) -> tuple:
    """Return ``(lo_pad, hi_pad)`` such that the padded MBR is empty."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return dtype.type(_F32_PAD), dtype.type(-_F32_PAD)
    if dtype.kind == "i":
        return dtype.type(_I32_PAD), dtype.type(-_I32_PAD)
    raise TypeError(f"unsupported key dtype {dtype}")


def intersects(qlx, qly, qhx, qhy, lx, ly, hx, hy):
    """Rect/rect intersection, broadcast over tensor or array args."""
    return (qlx <= hx) & (qhx >= lx) & (qly <= hy) & (qhy >= ly)


def brute_force_select(rects, query):
    """Oracle: ids of all rects intersecting ``query`` (numpy)."""
    lx, ly, hx, hy = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    qlx, qly, qhx, qhy = query
    m = (qlx <= hx) & (qhx >= lx) & (qly <= hy) & (qhy >= ly)
    return np.nonzero(m)[0]


def brute_force_join(rects_a, rects_b):
    """Oracle: all intersecting (i, j) id pairs between two rect sets
    (numpy), sorted lexicographically.  O(N*M); for small instances."""
    alx, aly, ahx, ahy = (rects_a[:, k, None] for k in range(4))
    blx, bly, bhx, bhy = (rects_b[None, :, k] for k in range(4))
    m = (alx <= bhx) & (ahx >= blx) & (aly <= bhy) & (ahy >= bly)
    ii, jj = np.nonzero(m)
    return np.stack([ii, jj], axis=1)
