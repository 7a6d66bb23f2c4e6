"""Physical node layouts and frontier lane rounding.

The canonical ``RTree`` stores level-major SoA arrays (D1-global).  This
slice of the port registers the D1 node-local layout only::

  D1  coords (n_nodes, 4, F) + ptr (n_nodes, F)                    — SoA

D0, D2 and the quantized D3 layout are not ported yet (ROADMAP item A9);
asking for them raises ``NotImplementedError``.

The lane width stays the reference's 128: the frontier caps decide
overflow and escalation, so changing it would change every counter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

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
class LevelD1:
    coords: torch.Tensor  # (n_nodes, 4, F) rows: lx, ly, hx, hy
    ptr: torch.Tensor     # (n_nodes, F) int32
    count: torch.Tensor


def level_to_d1(lvl: RTreeLevel) -> LevelD1:
    coords = torch.stack([lvl.lx, lvl.ly, lvl.hx, lvl.hy], dim=1)
    return LevelD1(coords=coords, ptr=lvl.child, count=lvl.count)


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
    "d1": LayoutSpec("d1", level_to_d1, LANES),
}

# layouts of the reference that the port has not reached yet
_NOT_PORTED = ("d0", "d2", "d3")


def layout_names() -> Tuple[str, ...]:
    """Valid physical layout names, registry order."""
    return tuple(LAYOUTS)


def _layout_spec(layout: str) -> LayoutSpec:
    if layout in LAYOUTS:
        return LAYOUTS[layout]
    if layout in _NOT_PORTED:
        raise NotImplementedError(
            f"layout {layout!r} is not ported yet (ROADMAP item A9); "
            f"ported layouts: {', '.join(LAYOUTS)}")
    raise ValueError(f"unknown layout {layout!r}: valid layouts are "
                     f"{', '.join(LAYOUTS)}")


def layout_lanes(layout: str) -> int:
    """Frontier lane width for ``layout`` (caps round up to this)."""
    return _layout_spec(layout).lanes


def tree_layout(tree: RTree, layout: str):
    """Materialize every level of ``tree`` in the requested physical layout."""
    fn = _layout_spec(layout).converter
    return tuple(fn(lvl) for lvl in tree.levels)
