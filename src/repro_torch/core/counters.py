"""Algorithmic performance counters (the reference's ``core/counters.py``).

Deterministic *algorithmic* counters whose values equal the reference's on
the same inputs:

  nodes_visited      — node accesses
  predicates         — MBR comparisons issued
  vector_ops         — dense vector predicate ops
  enqueued           — frontier insertions (compress-store analogue)
  pruned_outer       — outer entries skipped by O3 slicing (join)
  pruned_inner       — inner entries skipped by O4/O5 shrinking (join)
  masked_waste       — lanes evaluated but masked off
  overflow           — frontier/result capacity overflow flag (0/1)
  branches           — conditional branch points (scalar variants only)
  dispatches         — device-program launches as the owning spec's
                       ``StageModel`` counts them.  This is the reference's
                       accounting, kept so the counters stay comparable;
                       the port's real kernel launches are counted by the
                       kernel wrappers
                       (``kernels/rtree_select.launch_counts``).
  lanes_live         — per descent step (``OCC_STEPS`` slots): frontier
                       slots that held a real node when the level was scored
  lanes_padded       — per descent step: allocated-but-empty frontier slots
  escalations        — overflow escalations taken by a two-tier engine

Engine-written fields are int32 tensors on the engine's device, as the
reference's are int32 arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# fixed per-step occupancy slots: every engine writes step s into
# min(s, OCC_STEPS - 1), so Counters from trees of different heights add
OCC_STEPS = 8


def occupancy_zeros(device="cpu") -> torch.Tensor:
    """A zeroed per-step occupancy vector (int32, ``OCC_STEPS`` slots)."""
    return torch.zeros((OCC_STEPS,), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class StageModel:
    """Per-BFS-level dispatch stage model owned by an ``OperatorSpec``:
    ``inner``/``leaf`` launches per unfused internal/leaf level, ``fused``
    per fused level (None when the operator has no fused generation)."""
    inner: int
    leaf: int
    fused: int | None = None

    def total(self, height: int, *, fused: bool = False,
              descents: int = 1) -> int:
        """Expected dispatch tally for ``descents`` full traversals of a
        ``height``-level tree."""
        if fused:
            if self.fused is None:
                raise ValueError("operator has no fused stage model")
            per = height * self.fused
        else:
            per = (height - 1) * self.inner + self.leaf
        return per * descents


@dataclasses.dataclass
class Counters:
    nodes_visited: torch.Tensor | int = 0
    predicates: torch.Tensor | int = 0
    vector_ops: torch.Tensor | int = 0
    enqueued: torch.Tensor | int = 0
    pruned_outer: torch.Tensor | int = 0
    pruned_inner: torch.Tensor | int = 0
    masked_waste: torch.Tensor | int = 0
    overflow: torch.Tensor | int = 0
    branches: torch.Tensor | int = 0
    dispatches: torch.Tensor | int = 0
    lanes_live: torch.Tensor | int = 0      # (OCC_STEPS,) from engines
    lanes_padded: torch.Tensor | int = 0
    escalations: torch.Tensor | int = 0

    def values(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def __add__(self, other: "Counters") -> "Counters":
        return Counters(*[a + b for a, b in zip(self.values(),
                                                other.values())])

    def asdict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, int):
                out[f.name] = v
            else:
                a = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                out[f.name] = a.astype(np.int64).tolist() if a.ndim \
                    else int(a)
        return out

    def occupancy(self) -> float:
        """Fraction of frontier slots that were live across all recorded
        steps (1.0 when no engine recorded occupancy)."""
        d = self.asdict()
        live = float(np.sum(d["lanes_live"]))
        total = live + float(np.sum(d["lanes_padded"]))
        return live / total if total else 1.0

    def validate_dispatches(self, stage_model: StageModel, height: int, *,
                            fused: bool = False,
                            descents: int = 1) -> "Counters":
        """Assert the recorded dispatch tally matches the owning spec's
        stage model."""
        expected = stage_model.total(height, fused=fused, descents=descents)
        got = int(self.dispatches)
        if got != expected:
            raise AssertionError(
                f"dispatch tally {got} != stage model "
                f"{expected} (height={height}, fused={fused}, "
                f"descents={descents}, model={stage_model})")
        return self


def zeros(device="cpu") -> Counters:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return Counters(*([z] * len(dataclasses.fields(Counters))))
