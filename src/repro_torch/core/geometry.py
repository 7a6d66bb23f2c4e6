"""MBR geometry primitives for the port.

``intersects`` works on tensors (and numpy arrays) alike: it is the D1
predicate, four compares ANDed, written exactly as the four key-excerpt
comparisons so every path agrees bit-for-bit (closed intervals, as in
Guttman's R-tree).

``intersects_pairs``, ``mindist_pairs`` and ``mindist_rect_pairs`` are the
D2 layout's forms on interleaved ``(x, y)`` pairs: two compare stages and
a pair reduction.

``mindist`` / ``minmaxdist`` are the kNN distance functions on tensors and
``mindist_rect`` / ``minmaxdist_rect`` the kNN-join's, rounded exactly as
the reference's jitted traces round them (see ``fma32``; the D3 layout's
trace rounds MINMAXDIST in another form, ``minmaxdist_d3`` and
``minmaxdist_rect_d3``); the CUDA kernels
(``kernels/csrc/rtree_knn.cu``) use the same forms through explicit
intrinsics.  The ``*_np`` functions, ``brute_force_knn`` and
``brute_force_knn_join`` are the host-side numpy oracles and the shard
router.

Padding convention: absent children carry an *empty* MBR (``low = +PAD,
high = -PAD``) so every intersection predicate is False without a separate
validity mask.
"""
from __future__ import annotations

import numpy as np
import torch

# Large-but-finite padding values (finite so int paths and fp paths behave
# the same).
_F32_PAD = np.float32(3.0e38)
_I32_PAD = np.int32(2**31 - 2)

# Distance constants of the kNN family.
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


def intersects_pairs(q_lo, q_hi, lo, hi):
    """D2-form predicate on interleaved ``(x, y)`` pairs: ``q_lo``/``q_hi``
    (..., 2) query corners, ``lo``/``hi`` (..., 2) MBR corners.  Two
    compares and a pair reduction, the paper's 2-stage D2 evaluation;
    equal to ``intersects`` on the de-interleaved corners."""
    m = (q_lo <= hi) & (q_hi >= lo)
    return m[..., 0] & m[..., 1]


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


# ---------------------------------------------------------------------------
# point-to-MBR distances (kNN), squared Euclidean
# ---------------------------------------------------------------------------

def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` with one rounding, as a fused multiply-add,
    for float32 tensors on any device.

    The reference's jitted traces contract ``x*x + y*y`` into an FMA, and
    which product is folded decides the last bit; eager PyTorch rounds both
    products.  Here the product is exact in float64 (24 + 24 bits), the sum
    ``s`` is rounded to float64 with its exact error ``e`` (TwoSum), and an
    inexact ``s`` moves to its odd float64 neighbour toward the exact value
    (round-to-odd).  Rounding that to float32 is then exactly the single
    rounding of ``a*b + c``: a plain float64 sum would round twice and can
    land on a float32 midpoint.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    step = (torch.sign(e) * torch.sign(s)).to(torch.int64)
    bits = torch.where((bits & 1) == 0, bits + step, bits)
    return bits.view(torch.float64).float()


def _axis_gap(p, lo, hi):
    """Per-axis outside gap ``max(lo - p, p - hi, 0)``, clamped finite."""
    return torch.clamp(torch.maximum(lo - p, p - hi), min=0.0,
                       max=float(_DELTA_CLAMP))


def mindist(px, py, lx, ly, hx, hy):
    """Squared MINDIST(point, rect) (Roussopoulos & Kelley), broadcast over
    float32 tensors: 0 inside the rect, else the squared distance to the
    nearest face or corner.  Rounded as ``fma(dx, dx, dy*dy)``, the form of
    every reference trace."""
    dx = _axis_gap(px, lx, hx)
    dy = _axis_gap(py, ly, hy)
    return fma32(dx, dx, dy * dy)


def mindist_pairs(p, lo, hi):
    """D2-form squared MINDIST on interleaved ``(x, y)`` pairs: ``p``
    (..., 2) query points, ``lo``/``hi`` (..., 2) MBR corners.  One gap
    stage over the pair and a pair reduction, rounded as the reference's
    D2 traces round it, ``fma(dx, dx, dy*dy)`` (``mindist``'s form)."""
    d = _axis_gap(p, lo, hi)
    dx, dy = d[..., 0], d[..., 1]
    return fma32(dx, dx, dy * dy)


def _minmax_gaps(px, py, lx, ly, hx, hy):
    """The point MINMAXDIST's four face distances (dmx, dmy: to the nearer
    face on x, y; dMx, dMy: to the farther), clamped finite (exact)."""
    cx = (lx + hx) * 0.5
    cy = (ly + hy) * 0.5
    clamp = float(_DELTA_CLAMP)
    dmx = torch.abs(px - torch.where(px <= cx, lx, hx)).clamp(max=clamp)
    dmy = torch.abs(py - torch.where(py <= cy, ly, hy)).clamp(max=clamp)
    dMx = torch.abs(px - torch.where(px >= cx, lx, hx)).clamp(max=clamp)
    dMy = torch.abs(py - torch.where(py >= cy, ly, hy)).clamp(max=clamp)
    return dmx, dmy, dMx, dMy


def minmaxdist(px, py, lx, ly, hx, hy):
    """Squared MINMAXDIST(point, rect) (Roussopoulos & Kelley): the minimum
    over axes of (distance to the nearer face on that axis)² + (distance
    to the farther face on the other)².  A non-empty rect holds an object
    within it, so the k-th smallest over a frontier bounds the k-th
    neighbour.  Rounded as ``min(fma(dMy, dMy, dmx*dmx), fma(dmy, dmy,
    dMx*dMx))``, the form of the reference's D1 gather trace and its
    Pallas kernel."""
    dmx, dmy, dMx, dMy = _minmax_gaps(px, py, lx, ly, hx, hy)
    return torch.minimum(fma32(dMy, dMy, dmx * dmx),
                         fma32(dmy, dmy, dMx * dMx))


def minmaxdist_d3(px, py, lx, ly, hx, hy):
    """``minmaxdist`` rounded as the reference's D3 trace rounds it (its
    ``knn_level_dists_d3_ref`` and the D3 kNN engine, which fold the other
    product of the first term): ``min(fma(dmx, dmx, dMy*dMy), fma(dmy,
    dmy, dMx*dMx))``.  The two forms differ by a few ULP on some lanes,
    and MINMAXDIST sets τ, so each layout keeps its own."""
    dmx, dmy, dMx, dMy = _minmax_gaps(px, py, lx, ly, hx, hy)
    return torch.minimum(fma32(dmx, dmx, dMy * dMy),
                         fma32(dmy, dmy, dMx * dMx))


# ---------------------------------------------------------------------------
# rect-to-rect distances (kNN-join), squared Euclidean
#
# The point gap becomes an interval gap: query interval [a_lo, a_hi] to MBR
# interval [b_lo, b_hi] is max(a_lo - b_hi, b_lo - a_hi, 0).  A degenerate
# (point) query reduces every rect function to its point twin.
# ---------------------------------------------------------------------------

def rect_axis_gap(a_lo, a_hi, b_lo, b_hi):
    """Per-axis interval-to-interval outside gap, clamped finite.  Exact:
    one rounded subtraction per side, then compares."""
    return torch.clamp(torch.maximum(a_lo - b_hi, b_lo - a_hi), min=0.0,
                       max=float(_DELTA_CLAMP))


def mindist_rect(qlx, qly, qhx, qhy, lx, ly, hx, hy):
    """Squared MINDIST(rect, rect), broadcast over float32 tensors: 0 when
    the rects intersect, else the squared distance between their nearest
    faces or corners.  Rounded as ``fma(dx, dx, dy*dy)``, the form of the
    reference's gather trace (every lane of it)."""
    dx = rect_axis_gap(qlx, qhx, lx, hx)
    dy = rect_axis_gap(qly, qhy, ly, hy)
    return fma32(dx, dx, dy * dy)


def mindist_rect_pairs(q_lo, q_hi, lo, hi):
    """D2-form squared MINDIST(rect, rect) on interleaved ``(x, y)`` pairs:
    ``q_lo``/``q_hi`` (..., 2) query corners, ``lo``/``hi`` (..., 2) MBR
    corners.  One gap stage over the pair and a pair reduction, rounded
    as ``mindist_rect``, ``fma(dx, dx, dy*dy)``, the reference's D2 trace's
    form."""
    d = rect_axis_gap(q_lo, q_hi, lo, hi)
    dx, dy = d[..., 0], d[..., 1]
    return fma32(dx, dx, dy * dy)


def _face_gap(a_lo, a_hi, face):
    """Gap from query interval [a_lo, a_hi] to the coordinate ``face``,
    clamped finite (exact, as ``rect_axis_gap``)."""
    return torch.clamp(torch.maximum(a_lo - face, face - a_hi), min=0.0,
                       max=float(_DELTA_CLAMP))


def _minmax_rect_gaps(qlx, qly, qhx, qhy, lx, ly, hx, hy):
    """The rect MINMAXDIST's gaps (ngx, mgx: the nearer and farther x face;
    ngy, mgy alike), exact."""
    gxl = _face_gap(qlx, qhx, lx)
    gxh = _face_gap(qlx, qhx, hx)
    gyl = _face_gap(qly, qhy, ly)
    gyh = _face_gap(qly, qhy, hy)
    return (torch.minimum(gxl, gxh), torch.maximum(gxl, gxh),
            torch.minimum(gyl, gyh), torch.maximum(gyl, gyh))


def minmaxdist_rect(qlx, qly, qhx, qhy, lx, ly, hx, hy):
    """Squared MINMAXDIST(rect, rect): the Roussopoulos bound with rect
    queries.  An object on the nearer x-face of a tight MBR lies at gap
    ``min(gap(lx), gap(hx))`` on x and at most ``max(gap(ly), gap(hy))`` on
    y; the minimum over the axis choice bounds the distance to some object
    of the MBR, so the k-th smallest over a frontier is a sound τ.  Rounded
    as ``min(fma(mgy, mgy, ngx*ngx), fma(ngy, ngy, mgx*mgx))``, the form of
    the reference's D1 gather trace (every lane of it)."""
    ngx, mgx, ngy, mgy = _minmax_rect_gaps(qlx, qly, qhx, qhy, lx, ly, hx,
                                           hy)
    return torch.minimum(fma32(mgy, mgy, ngx * ngx),
                         fma32(ngy, ngy, mgx * mgx))


def minmaxdist_rect_d3(qlx, qly, qhx, qhy, lx, ly, hx, hy):
    """``minmaxdist_rect`` rounded as the reference's D3 trace rounds it
    (its ``knn_join_level_dists_d3_ref`` and the D3 kNN-join engine):
    ``min(fma(ngx, ngx, mgy*mgy), fma(ngy, ngy, mgx*mgx))``."""
    ngx, mgx, ngy, mgy = _minmax_rect_gaps(qlx, qly, qhx, qhy, lx, ly, hx,
                                           hy)
    return torch.minimum(fma32(ngx, ngx, mgy * mgy),
                         fma32(ngy, ngy, mgx * mgx))


def mindist_np(px, py, lx, ly, hx, hy) -> np.ndarray:
    """Numpy MINDIST for host-side code (the shard router and the oracle),
    unclamped: host paths never see the padded-MBR sentinels."""
    dx = np.maximum(np.maximum(lx - px, px - hx), 0.0)
    dy = np.maximum(np.maximum(ly - py, py - hy), 0.0)
    return dx * dx + dy * dy


def minmaxdist_np(px, py, lx, ly, hx, hy) -> np.ndarray:
    """Numpy MINMAXDIST (see ``minmaxdist`` for the bound)."""
    cx = (lx + hx) * 0.5
    cy = (ly + hy) * 0.5
    dmx = np.abs(px - np.where(px <= cx, lx, hx))
    dmy = np.abs(py - np.where(py <= cy, ly, hy))
    dMx = np.abs(px - np.where(px >= cx, lx, hx))
    dMy = np.abs(py - np.where(py >= cy, ly, hy))
    return np.minimum(dmx * dmx + dMy * dMy, dmy * dmy + dMx * dMx)


def mindist_rect_np(qlx, qly, qhx, qhy, lx, ly, hx, hy) -> np.ndarray:
    """Numpy rect MINDIST (host side, unclamped; the precision of its
    arguments, float64 in the oracle and the router)."""
    dx = np.maximum(np.maximum(qlx - hx, lx - qhx), 0.0)
    dy = np.maximum(np.maximum(qly - hy, ly - qhy), 0.0)
    return dx * dx + dy * dy


def minmaxdist_rect_np(qlx, qly, qhx, qhy, lx, ly, hx, hy) -> np.ndarray:
    """Numpy rect MINMAXDIST (see ``minmaxdist_rect`` for the bound)."""
    def face_gap(a_lo, a_hi, face):
        return np.maximum(np.maximum(a_lo - face, face - a_hi), 0.0)
    gxl, gxh = face_gap(qlx, qhx, lx), face_gap(qlx, qhx, hx)
    gyl, gyh = face_gap(qly, qhy, ly), face_gap(qly, qhy, hy)
    ngx, mgx = np.minimum(gxl, gxh), np.maximum(gxl, gxh)
    ngy, mgy = np.minimum(gyl, gyh), np.maximum(gyl, gyh)
    return np.minimum(ngx * ngx + mgy * mgy, ngy * ngy + mgx * mgx)


def mindist_matrix_np(points, rects) -> np.ndarray:
    """Squared point-to-rect MINDIST matrix: points (B, 2) or (2,), rects
    (N, 4) → (B, N) float64.  The one definition behind the brute-force
    oracle and the shard router."""
    pts = np.atleast_2d(np.asarray(points, np.float64))
    r = np.asarray(rects, np.float64)
    return mindist_np(pts[:, 0, None], pts[:, 1, None], r[None, :, 0],
                      r[None, :, 1], r[None, :, 2], r[None, :, 3])


def mindist_rect_matrix_np(rects_a, rects_b) -> np.ndarray:
    """Squared rect-to-rect MINDIST matrix: rects_a (B, 4) or (4,), rects_b
    (N, 4) → (B, N) float64.  The one definition behind the kNN-join
    oracle and the shard router."""
    a = np.atleast_2d(np.asarray(rects_a, np.float64))
    b = np.asarray(rects_b, np.float64)
    return mindist_rect_np(a[:, 0, None], a[:, 1, None], a[:, 2, None],
                           a[:, 3, None], b[None, :, 0], b[None, :, 1],
                           b[None, :, 2], b[None, :, 3])


def _k_smallest(d: np.ndarray, k: int):
    """The k smallest of each row of ``d`` (B, N), ties by column →
    (ids (B, k) int64, d (B, k) float64), (-1, inf) padded when k > N."""
    b, n = d.shape
    kk = min(k, n)
    order = np.argsort(d, axis=1, kind="stable")[:, :kk]     # ties → low id
    ids = np.full((b, k), -1, np.int64)
    out = np.full((b, k), np.inf, np.float64)
    ids[:, :kk] = order
    out[:, :kk] = np.take_along_axis(d, order, axis=1)
    return ids, out


def brute_force_knn(rects, points, k):
    """Oracle: the k nearest rects to each query point (numpy, O(B·N)).

    Returns (ids (B, k) int64, squared distances (B, k) float64) sorted by
    distance, ties by id; rows are padded with (-1, inf) when k > N."""
    return _k_smallest(mindist_matrix_np(points, rects), k)


def brute_force_knn_join(outer_rects, inner_rects, k):
    """Oracle: the k nearest inner rects to each outer rect (numpy,
    O(B·N)): outer (B, 4) or (4,), inner (N, 4).  Returns (ids (B, k)
    int64, squared distances (B, k) float64) sorted by distance, ties by
    id; rows are padded with (-1, inf) when k > N."""
    return _k_smallest(mindist_rect_matrix_np(outer_rects, inner_rects), k)
