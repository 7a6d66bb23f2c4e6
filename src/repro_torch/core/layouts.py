"""Physical node layouts and frontier lane rounding.

The canonical ``RTree`` stores level-major SoA arrays (D1-global).  The
port registers the reference's four node-local layouts::

  D0  (n_nodes, F, 5)   interleaved entries (lx, ly, hx, hy, ptr)  — AoS
  D1  coords (n_nodes, 4, F) + ptr (n_nodes, F)                    — SoA
  D2  lo (n_nodes, 2F) interleaved (lx0, ly0, lx1, ly1, ...),
      hi (n_nodes, 2F) interleaved (hx0, hy0, ...), ptr (n_nodes, F)
  D3  qlo/qhi (n_nodes, F) uint16 — each value packs two 8-bit per-axis
      offset codes ((x << 8) | y) relative to the node's own MBR, plus
      per-node float32 scale/bias/slack (n_nodes, 2) and the int32 ptr.

D0 stores the int32 child pointer bit-cast into its float32 fifth column,
so the pad pointer -1 is a NaN pattern there: ``d0_unpack`` gathers and
splits entries as int32 and views the four coordinate columns as float32,
so no float operation ever touches the pointer's bits.  D2 halves the
compare stages (2 instead of 4) at half the children per vector.  Neither
has a kernel, in the reference or here: the operators score them with the
layout's own PyTorch math.

D3 stores a child MBR in 4 bytes instead of D1's 16.  Dequantization is
conservative (lo codes floor, hi codes ceil), so a dequantized box
contains the true child box: a quantized prune only over-approximates, and
the operators re-check leaf rows with the exact D1 kernels.  ``scale`` is a
power of two and codes have 8 significant bits, so ``bias + code * scale``
is exact under any contraction; ``slack`` is the measured per-axis face
displacement that turns quantized MINMAXDIST into a sound upper bound
(``d3_slacked_upper``).  The quantization is the reference's, byte for
byte, and runs on the tree's device.

Codes are ``torch.uint16``, so ``.numpy()`` gives the reference's bytes.
PyTorch's CPU kernels lack shifts, masks and compares on uint16 and its
CUDA kernels lack indexing, so every unpacking and gather widens the codes
to int32 first (``d3_levels_int32``); only the CUDA kernels read them as
they are.

The lane width stays the reference's: 128, and 256 for D3 (a D3 node row
streams 4-byte boxes).  The frontier caps decide overflow and escalation,
so changing either would change every counter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from .rtree import RTree, RTreeLevel

# frontier capacities round up to a multiple of this (kept equal to the
# reference so caps, overflow and escalation match it exactly)
LANES = 128


def round_up_to_lanes(n: int, lanes: int = LANES) -> int:
    """Smallest multiple of ``lanes`` that is >= n (n <= 0 → lanes)."""
    return max(-(-int(n) // lanes), 1) * lanes


def lane_floor(fanout: int, lanes: int = LANES) -> int:
    """Smallest frontier worth keeping: enough rows that one level step can
    fill a full lane grid of candidate children (``ceil(lanes / fanout)``)."""
    return max(-(-int(lanes) // max(int(fanout), 1)), 1)


def round_up_adaptive(n: int, lanes: int = LANES) -> int:
    """Adaptive frontier rounding: multiples of ``lanes`` at or above one
    lane row, the next power of two below it."""
    n = max(int(n), 1)
    if n >= lanes:
        return round_up_to_lanes(n, lanes)
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class LevelD0:
    entries: torch.Tensor  # (n_nodes, F, 5): lx, ly, hx, hy, ptr (bit-cast)
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LevelD1:
    coords: torch.Tensor  # (n_nodes, 4, F) rows: lx, ly, hx, hy
    ptr: torch.Tensor     # (n_nodes, F) int32
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LevelD2:
    lo: torch.Tensor      # (n_nodes, 2F) interleaved (lx, ly) pairs
    hi: torch.Tensor      # (n_nodes, 2F) interleaved (hx, hy) pairs
    ptr: torch.Tensor     # (n_nodes, F) int32
    count: torch.Tensor


def level_to_d0(lvl: RTreeLevel) -> LevelD0:
    """Interleaved entries; a float32 level carries its int32 pointer
    bit-cast into the fifth column (stacked as int32, so the bits are
    copied and never converted), any other key dtype its pointer
    converted, as the reference does."""
    if lvl.lx.dtype == torch.float32:
        cols = [c.view(torch.int32) for c in (lvl.lx, lvl.ly, lvl.hx,
                                              lvl.hy)]
        entries = torch.stack(cols + [lvl.child], dim=-1).view(torch.float32)
    else:
        entries = torch.stack([lvl.lx, lvl.ly, lvl.hx, lvl.hy,
                               lvl.child.to(lvl.lx.dtype)], dim=-1)
    return LevelD0(entries=entries, count=lvl.count)


def level_to_d1(lvl: RTreeLevel) -> LevelD1:
    coords = torch.stack([lvl.lx, lvl.ly, lvl.hx, lvl.hy], dim=1)
    return LevelD1(coords=coords, ptr=lvl.child, count=lvl.count)


def level_to_d2(lvl: RTreeLevel) -> LevelD2:
    n, f = lvl.lx.shape
    lo = torch.stack([lvl.lx, lvl.ly], dim=-1).reshape(n, 2 * f)
    hi = torch.stack([lvl.hx, lvl.hy], dim=-1).reshape(n, 2 * f)
    return LevelD2(lo=lo, hi=hi, ptr=lvl.child, count=lvl.count)


def d0_unpack(entries: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(..., F, 5) entries → (lx, ly, hx, hy, ptr int32), each (..., F).
    The strided de-interleave is why the paper calls D0 SIMD-hostile.  A
    float32 table is split as int32 and its coordinates viewed back as
    float32, so the pointer's bits (-1 is a NaN pattern) pass through no
    float operation."""
    if entries.dtype == torch.float32:
        e = entries.view(torch.int32)
        return (*(e[..., k].view(torch.float32) for k in range(4)),
                e[..., 4])
    return (*(entries[..., k] for k in range(4)),
            entries[..., 4].to(torch.int32))


@dataclasses.dataclass(frozen=True)
class LevelD3:
    qlo: torch.Tensor    # (n_nodes, F) uint16: (x_code << 8) | y_code, floored
    qhi: torch.Tensor    # (n_nodes, F) uint16: (x_code << 8) | y_code, ceiled
    scale: torch.Tensor  # (n_nodes, 2) float32 power-of-two quantization step
    bias: torch.Tensor   # (n_nodes, 2) float32 node-MBR lo corner (exact)
    slack: torch.Tensor  # (n_nodes, 2) float32 measured max face displacement
    ptr: torch.Tensor    # (n_nodes, F) int32
    count: torch.Tensor


D3_FIELDS = ("qlo", "qhi", "scale", "bias", "slack", "ptr", "count")


# ---------------------------------------------------------------------------
# D3 quantization (the reference's layouts.py:176-304, in float32 throughout)
# ---------------------------------------------------------------------------

# Fixup sweeps after the initial floor/ceil code estimate (the reference's
# constant; the 0/255 fallback after them keeps the codes sound anyway).
_D3_FIXUPS = 4


def _d3_scale(node_lo: torch.Tensor, node_hi: torch.Tensor) -> torch.Tensor:
    """Power-of-two quantization step per axis for node boxes: the extent
    over 255 steps, floored at ``max(|lo|, |hi|) * 2^-16 / 255`` and at
    2^-100 / 255, rounded up to the power of two ``2^e`` of
    ``frexp(raw) = (m, e)``, m in [0.5, 1)."""
    mag = torch.maximum(node_lo.abs(), node_hi.abs())
    raw = torch.maximum(node_hi - node_lo, mag * np.float32(2.0 ** -16))
    raw = torch.clamp(raw, min=float(np.float32(2.0 ** -100))) / \
        np.float32(255.0)
    _, e = torch.frexp(raw)
    # 2^e from its exponent bits: raw >= 2^-108 and, for finite
    # coordinates, raw < 2^127, so 2^e is a normal float32
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _d3_axis_codes(v: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                   hi_side: bool) -> torch.Tensor:
    """Conservative 8-bit codes (int32) for one axis of one corner: lo codes
    floor and are fixed down until ``bias + c * scale <= v`` (fallback 0),
    hi codes ceil and are fixed up until it is ``>= v`` (fallback 255).
    ``v`` is (n, F); ``bias`` and ``scale`` are (n, 1)."""
    t = (v - bias) / scale
    c = torch.ceil(t) if hi_side else torch.floor(t)
    c = torch.clamp(c, 0.0, 255.0)
    for _ in range(_D3_FIXUPS):
        deq = bias + c * scale
        if hi_side:
            c = torch.where(deq < v, torch.clamp(c + 1.0, max=255.0), c)
        else:
            c = torch.where(deq > v, torch.clamp(c - 1.0, min=0.0), c)
    deq = bias + c * scale
    if hi_side:
        c = torch.where(deq < v, 255.0, c)
    else:
        c = torch.where(deq > v, 0.0, c)
    return c.to(torch.int32)


def d3_quantize(lx, ly, hx, hy, node_mbr, valid):
    """Quantize child rects (n, F) against their own node boxes (n, 4) →
    (qlo, qhi (n, F) uint16 packed ``(x_code << 8) | y_code``, scale, bias,
    slack (n, 2) float32).  ``slack`` is the per-axis max displacement
    between true and dequantized faces over the ``valid`` children."""
    # a dense copy: the kernels read bias as (n, 2) rows
    bias = node_mbr[:, 0:2].to(torch.float32).contiguous()
    scale = _d3_scale(bias, node_mbr[:, 2:4].to(torch.float32))
    bx, by = bias[:, 0:1], bias[:, 1:2]
    sx, sy = scale[:, 0:1], scale[:, 1:2]
    clx = _d3_axis_codes(lx, bx, sx, hi_side=False)
    cly = _d3_axis_codes(ly, by, sy, hi_side=False)
    chx = _d3_axis_codes(hx, bx, sx, hi_side=True)
    chy = _d3_axis_codes(hy, by, sy, hi_side=True)
    qlo = ((clx << 8) | cly).to(torch.uint16)
    qhi = ((chx << 8) | chy).to(torch.uint16)

    def disp(c_lo, c_hi, v_lo, v_hi, b, s):
        d = torch.maximum(v_lo - (b + c_lo.to(torch.float32) * s),
                          (b + c_hi.to(torch.float32) * s) - v_hi)
        return torch.where(valid, d, 0.0).amax(dim=1)
    slack = torch.stack([disp(clx, chx, lx, hx, bx, sx),
                         disp(cly, chy, ly, hy, by, sy)], dim=1)
    return qlo, qhi, scale, bias, slack


def d3_dequantize(qlo, qhi, scale, bias):
    """Conservative boxes from packed codes: ``qlo``/``qhi`` (..., F) uint16
    (or already widened to int32), ``scale``/``bias`` (..., 2) → (lx, ly,
    hx, hy), each (..., F) float32, ``bias + code * scale``."""
    lo, hi = qlo.to(torch.int32), qhi.to(torch.int32)
    bx, by = bias[..., 0:1], bias[..., 1:2]
    sx, sy = scale[..., 0:1], scale[..., 1:2]
    lx = bx + (lo >> 8).to(torch.float32) * sx
    ly = by + (lo & 0xFF).to(torch.float32) * sy
    hx = bx + (hi >> 8).to(torch.float32) * sx
    hy = by + (hi & 0xFF).to(torch.float32) * sy
    return lx, ly, hx, hy


def nearest_root(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 ``x >= 0``
    from an estimate ``r`` within one float32 ULP of it: ``r`` steps to
    its upper or lower neighbour where ``x`` lies past the square of the
    midpoint between them.  A midpoint has 25 significant bits, so its
    square is exact in float64, and a float32 root is never a midpoint."""
    xd = x.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + dn.double()) * 0.5
    return torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, dn, r))


def d3_slacked_upper(sq_dist: torch.Tensor, disp: torch.Tensor
                     ) -> torch.Tensor:
    """Sound squared upper bound for the TRUE box from a squared bound
    ``sq_dist`` on the dequantized box and the node's face displacement
    ``disp`` (slack_x + slack_y): ``(sqrt(max(sq, 0)) + disp)² · (1 +
    2^-16)``, rounded left to right as the reference rounds it.  Callers
    re-mask invalid lanes.

    The square root must be the correctly rounded one (the reference's,
    and the kernels' ``__fsqrt_rn``).  PyTorch's CPU ``sqrt`` is not: its
    float32 one misses by 1 ULP on some inputs, and its float64 one, on
    the first call in a process, has returned some lanes 10^5 float64
    ULPs off.  So the root is estimated in float64 and then settled by
    ``nearest_root`` with exact float64 products, whatever the library
    sqrt's last bits."""
    x = torch.clamp(sq_dist, min=0.0)
    root = nearest_root(x, torch.sqrt(x.double()).float())
    up = root + disp
    return up * up * np.float32(1.0 + 2.0 ** -16)


def level_to_d3(lvl: RTreeLevel) -> LevelD3:
    qlo, qhi, scale, bias, slack = d3_quantize(
        lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.node_mbr, lvl.child >= 0)
    return LevelD3(qlo=qlo, qhi=qhi, scale=scale, bias=bias, slack=slack,
                   ptr=lvl.child, count=lvl.count)


def level_d3_from_arrays(arrays: Mapping[str, np.ndarray],
                         device="cuda") -> LevelD3:
    """A D3 level's arrays (a mapping with the ``D3_FIELDS`` keys, as read
    back from the JAX package's ``LevelD3``) → the port's ``LevelD3`` on
    ``device``, dtypes kept (uint16 codes, float32 rows, int32 ptr)."""
    return LevelD3(**{
        f: torch.from_numpy(np.array(arrays[f], order="C")).to(device)
        for f in D3_FIELDS})


# ---------------------------------------------------------------------------
# layout registry — valid layout names, their level converters and their
# frontier lane widths
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    name: str
    converter: Callable[[RTreeLevel], object]
    lanes: int


LAYOUTS: Dict[str, LayoutSpec] = {
    "d0": LayoutSpec("d0", level_to_d0, LANES),
    "d1": LayoutSpec("d1", level_to_d1, LANES),
    "d2": LayoutSpec("d2", level_to_d2, LANES),
    "d3": LayoutSpec("d3", level_to_d3, 2 * LANES),
}

# the layouts whose levels feed the CUDA kernels; the others are scored
# with their own PyTorch math (the reference has no kernel for them either)
KERNEL_LAYOUTS = ("d1", "d3")


def layout_names() -> Tuple[str, ...]:
    """Valid physical layout names, registry order."""
    return tuple(LAYOUTS)


def _layout_spec(layout: str) -> LayoutSpec:
    if layout in LAYOUTS:
        return LAYOUTS[layout]
    raise ValueError(f"unknown layout {layout!r}: valid layouts are "
                     f"{', '.join(LAYOUTS)}")


def layout_lanes(layout: str) -> int:
    """Frontier lane width for ``layout`` (caps round up to this)."""
    return _layout_spec(layout).lanes


def tree_layout(tree: RTree, layout: str):
    """Materialize every level of ``tree`` in the requested physical layout."""
    fn = _layout_spec(layout).converter
    return tuple(fn(lvl) for lvl in tree.levels)


def d3_levels_int32(tree: RTree) -> Tuple[LevelD3, ...]:
    """``tree``'s D3 levels with the codes widened to int32 once, for the
    PyTorch paths that gather and shift them (CUDA cannot index uint16;
    the CPU cannot shift it)."""
    return tuple(dataclasses.replace(lvl, qlo=lvl.qlo.to(torch.int32),
                                     qhi=lvl.qhi.to(torch.int32))
                 for lvl in tree_layout(tree, "d3"))
