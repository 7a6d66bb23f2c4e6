"""Frontier-capacity policies of the select, join and kNN operators (the
reference's ``core/caps.py``: ``geometric_caps``, ``adaptive_caps``,
``select_frontier_caps``, ``join_pair_caps``, ``knn_frontier_caps``,
``filtered_frontier_caps`` and ``browse_caps``).  Pure integer code,
copied so the port imports nothing of the JAX package; the caps decide
overflow and escalation, so they must equal the reference's on the same
tree.

``geometric_caps``
    The **static** policy (the escalation fallback): fixed ``min_cap``
    floors, full ``round_up_to_lanes`` rounding, and the boost re-clamp of
    a ``final="boost"`` last step to ``level_sizes[0]``.

``adaptive_caps``
    The **occupancy-adaptive** policy (the tight tier of the two-tier
    engine in core/traversal.py): every step clamps to the level's true
    node count, the floor is ``layouts.lane_floor`` and rounding is
    ``layouts.round_up_adaptive``.  The node-count clamp alone never causes
    overflow; the escalating engine repairs what the geometric terms
    under-size, so adaptive results equal the static path's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .layouts import (LANES, lane_floor, round_up_adaptive,
                      round_up_to_lanes)


def geometric_caps(n_steps: int, fanout: int, target: int, *, slack: int,
                   min_cap: Optional[int] = None,
                   max_cap: Optional[int] = None,
                   level_sizes: Optional[Sequence[int]] = None,
                   lane_round: bool = True,
                   lanes: int = LANES,
                   final: Optional[str] = None) -> Tuple[int, ...]:
    """Static geometric frontier caps, one per descent step (coarse → fine).

    Step ``i`` targets the level at distance ``e = n_steps - 1 - i`` from
    the finest step and gets ``ceil(target / fanout^e) * slack`` slots,
    clamped to ``[min_cap, max_cap]`` (max first, then min — the historical
    order) and to ``level_sizes[e]`` when given.  ``lane_round`` applies the
    lane round-up; ``lanes`` is the round-up width (``layouts.layout_lanes``),
    default the reference's 128 so caps stay bit-identical.  ``final``:

      None      — leave the last step as computed (kNN frontier policy)
      'boost'   — raise the last step to at least ``target`` (select: the
                  leaf-entering frontier must clear the result budget),
                  then re-clamp to ``level_sizes[0]`` — the boost must not
                  exceed the number of leaf nodes
      'target'  — overwrite the last step with ``target`` exactly (join:
                  the last step *is* the result-pair buffer)
    """
    caps = []
    for step in range(n_steps):
        e = n_steps - 1 - step
        cap = -(-int(target) // max(fanout ** e, 1)) * slack
        if max_cap is not None:
            cap = min(cap, max_cap)
        if min_cap is not None:
            cap = max(min_cap, cap)
        if level_sizes is not None:
            cap = min(cap, int(level_sizes[e]))
        caps.append(cap)
    if caps and final == "boost":
        # max-then-round equals round-then-max (round-up is monotone), so
        # the lane round-up still happens in exactly one place below
        caps[-1] = max(caps[-1], int(target))
    elif caps and final == "target":
        caps[-1] = int(target)
    if lane_round and final != "target":
        caps = [round_up_to_lanes(c, lanes) for c in caps]
    elif lane_round:
        caps = [round_up_to_lanes(c, lanes) for c in caps[:-1]] + [caps[-1]]
    if caps and final == "boost" and level_sizes is not None:
        # the boost re-clamp: a leaf-entering frontier holds distinct leaf
        # node ids, so level_sizes[0] is a hard bound the boost must respect
        # (applied after the round so the lane round-up stays in one place)
        caps[-1] = min(caps[-1], int(level_sizes[0]))
    return tuple(caps)


def adaptive_caps(n_steps: int, fanout: int, target: int, *, slack: int,
                  level_sizes: Optional[Sequence[int]] = None,
                  max_cap: Optional[int] = None,
                  lanes: int = LANES,
                  lane_round: bool = True,
                  final: Optional[str] = None,
                  floor: Optional[int] = None) -> Tuple[int, ...]:
    """Occupancy-adaptive frontier caps (the tight tier).

    Same geometric core as ``geometric_caps`` with three changes:

      * the floor is ``layouts.lane_floor(fanout, lanes)`` — enough rows to
        fill one lane grid of candidate children — optionally raised by
        ``floor`` (operators with a hard minimum, e.g. kNN's τ gate needs
        ``cap * fanout >= k``), instead of a fixed 128/256 ``min_cap``
      * rounding is ``layouts.round_up_adaptive`` — lane multiples at or
        above one lane row, powers of two below it
      * **every** step (including a ``final='boost'``ed one) clamps to the
        level's true node count as the outermost bound, applied after the
        single rounding pass, so no cap ever exceeds ``level_sizes[e]``

    ``final='target'`` steps (the join's result-pair buffer) are exempt
    from rounding and from the node-count clamp — they buffer rect pairs,
    not node ids.
    """
    base_floor = lane_floor(fanout, lanes)
    if floor is not None:
        base_floor = max(base_floor, int(floor))
    caps = []
    for step in range(n_steps):
        e = n_steps - 1 - step
        cap = -(-int(target) // max(fanout ** e, 1)) * slack
        if max_cap is not None:
            cap = min(cap, max_cap)
        cap = max(cap, base_floor)
        caps.append(cap)
    if caps and final == "boost":
        caps[-1] = max(caps[-1], int(target))
    elif caps and final == "target":
        caps[-1] = int(target)
    if lane_round and final != "target":
        caps = [round_up_adaptive(c, lanes) for c in caps]
    elif lane_round:
        caps = ([round_up_adaptive(c, lanes) for c in caps[:-1]]
                + [caps[-1]])
    if level_sizes is not None:
        # the node-count clamp is the outer bound on every step: a frontier
        # holds distinct nodes of its level, so this clamp can never cause
        # overflow — it only removes padded slots
        clamped = []
        for step, cap in enumerate(caps):
            e = n_steps - 1 - step
            if final == "target" and step == n_steps - 1:
                clamped.append(cap)       # result buffer, not a frontier
            else:
                clamped.append(min(cap, int(level_sizes[e])))
        caps = clamped
    return tuple(caps)


def select_frontier_caps(tree, result_cap: int, slack: int = 4,
                         min_cap: int = 128,
                         lanes: int = LANES,
                         policy: str = "static") -> Tuple[int, ...]:
    """Select frontier capacity entering each level (root-1 … leaf).

    ``policy='static'`` is the historical ``select_vector.frontier_caps``
    policy (with the boost re-clamp fix); ``policy='adaptive'`` is the
    occupancy-adaptive tight tier."""
    sizes = [lvl.n_nodes for lvl in tree.levels]
    if policy == "adaptive":
        return adaptive_caps(
            tree.height - 1, tree.fanout, result_cap, slack=slack,
            level_sizes=sizes, lanes=lanes, final="boost")
    return geometric_caps(
        tree.height - 1, tree.fanout, result_cap, slack=slack,
        min_cap=min_cap, level_sizes=sizes, lanes=lanes, final="boost")


def _distance_floor(k: int, fanout: int, slack: int) -> int:
    """Adaptive floor of τ-pruned distance frontiers: the survivors of τ
    pruning are the nodes inside the current distance band, roughly O(k)
    per level whatever the fanout, so floor at ``slack·max(k, 2)`` rows;
    and never below ``ceil(k / fanout)``, so the engine's τ gate
    (``cap · fanout >= k``) fires at the same levels in both tiers."""
    return max(int(slack) * max(int(k), 2),
               -(-int(k) // max(int(fanout), 1)))


def knn_frontier_caps(tree, k: int, slack: int = 4, min_cap: int = 64,
                      lanes: int = LANES,
                      policy: str = "static") -> Tuple[int, ...]:
    """kNN frontier capacity entering each level (root-1 … leaf).  The
    adaptive tier floors every step at ``_distance_floor`` rows (the τ band)
    instead of the static 64-row minimum."""
    sizes = [lvl.n_nodes for lvl in tree.levels]
    if policy == "adaptive":
        return adaptive_caps(
            tree.height - 1, tree.fanout, k, slack=slack,
            level_sizes=sizes, lanes=lanes,
            floor=_distance_floor(k, tree.fanout, slack))
    return geometric_caps(
        tree.height - 1, tree.fanout, k, slack=slack, min_cap=min_cap,
        level_sizes=sizes, lanes=lanes)


def join_pair_caps(height: int, fanout: int, result_cap: int,
                   base: int = 1024,
                   level_sizes: Optional[Sequence[int]] = None,
                   policy: str = "static") -> Tuple[int, ...]:
    """Pair-frontier capacity after each join descent step (last = result
    pairs).  Pair frontiers are flat (P,) buffers consumed tile-wise, so
    they skip the lane round-up.

    ``level_sizes`` for the adaptive tier are the **reachable pair counts**
    per level (outer node count × inner node count of the chain-elevated
    trees, coarse level last — the same ``e`` indexing as node counts);
    the final result-pair step buffers rect pairs and is exempt."""
    if policy == "adaptive":
        return adaptive_caps(
            height, fanout, result_cap, slack=4,
            level_sizes=level_sizes, max_cap=4 * result_cap,
            lane_round=False, final="target",
            floor=lane_floor(fanout))
    return geometric_caps(
        height, fanout, result_cap, slack=4, min_cap=base,
        max_cap=4 * result_cap, lane_round=False, final="target")


def filtered_frontier_caps(tree, k: int, slack: int = 8,
                           min_cap: int = 256, lanes: int = LANES,
                           policy: str = "static") -> Tuple[int, ...]:
    """Filtered-kNN frontier caps: the kNN policy with wider static slack
    (the window mask thins candidates and τ tightens only on contained
    children, so frontiers shrink later).  The adaptive tier uses plain
    kNN's occupancy floors; escalation covers what they under-size."""
    sizes = [lvl.n_nodes for lvl in tree.levels]
    if policy == "adaptive":
        return adaptive_caps(
            tree.height - 1, tree.fanout, k, slack=slack,
            level_sizes=sizes, lanes=lanes,
            floor=_distance_floor(k, tree.fanout, slack))
    return geometric_caps(
        tree.height - 1, tree.fanout, k, slack=slack, min_cap=min_cap,
        level_sizes=sizes, lanes=lanes)


def browse_caps(tree, k: int, slack: int = 4, pool_slack: int = 16,
                lanes: int = LANES) -> Tuple[Tuple[int, ...],
                                             Tuple[int, ...], int]:
    """Caps of the resumable browse: (frontier_caps, defer_caps,
    pool_cap).

      frontier_caps — the kNN policy for the active descent frontier
                      (root-1 … leaf).
      defer_caps    — per level (0 = leaf … height-1 = root), the deferred
                      beam of τ-pruned nodes kept across resumes, at 4× the
                      frontier slack; the root level holds the root alone.
      pool_cap      — the scored-leaf candidate pool, emitted k at a time.

    A session's state pins its buffer shapes, so browse keeps static caps
    (no escalation).  Each floor is taken in base-``LANES`` rows and then
    ``round_up_adaptive``d to the layout's lane width."""
    def fl(c: int) -> int:
        return round_up_adaptive(round_up_to_lanes(c, LANES), lanes)

    sizes = [lvl.n_nodes for lvl in tree.levels]
    frontier = tuple(fl(c) for c in geometric_caps(
        tree.height - 1, tree.fanout, k, slack=slack, min_cap=64,
        level_sizes=sizes, lane_round=False))
    deep = tuple(fl(c) for c in geometric_caps(
        tree.height - 1, tree.fanout, k, slack=4 * slack, min_cap=128,
        level_sizes=sizes, lane_round=False))
    # geometric_caps runs coarse → fine; defer caps index by level
    defer = tuple(reversed(deep)) + (1,)
    return frontier, defer, fl(max(pool_slack * k, 512))
