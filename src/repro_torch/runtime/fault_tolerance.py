"""Fault tolerance: the restartable training loop, failure injection, and
restore onto another device (the reference's
``runtime/fault_tolerance.py``).

  * ``run_with_restarts``: the crash-loop driver: run → on an injected
    failure restore the latest committed checkpoint → resume.  The data
    pipeline is a pure function of (seed, step) and the steps are
    deterministic (on the card, under deterministic algorithms), so a
    restarted run is bit-exact against an uninterrupted one.
  * ``remesh``: the reference restores onto another mesh; the port's
    checkpoints hold whole tensors, so its counterpart restores onto
    another device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from . import checkpoint as ckpt
from . import faults


@dataclasses.dataclass
class FailurePlan:
    """Deterministic failure injection: fail before the given steps (once
    each).  The schedule is a ``faults.FaultPlan`` of crash clauses (the
    serving stack's chaos engine), with the once-each memory kept here
    because a restarted training loop revisits the crashed step."""
    fail_at: Tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        self._plan = faults.FaultPlan.crash_at_steps(self.fail_at)

    def maybe_fail(self, step: int):
        if step in self._fired:
            return
        _, exc = self._plan.faults_for(0, step)
        if exc is not None:
            self._fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_with_restarts(*, ckpt_dir: str, total_steps: int, init_state,
                      step_fn: Callable[[int, Any], Any],
                      save_every: int, state_like=None, device=None,
                      failure_plan: Optional[FailurePlan] = None,
                      max_restarts: int = 10,
                      checkpointer: Optional[ckpt.AsyncCheckpointer] = None):
    """The crash-looped loop.  ``step_fn(step, state) → state``;
    ``init_state()`` builds a fresh state (also the structure a
    checkpoint is restored into, unless ``state_like`` is given).
    → (state, restarts used)."""
    cp = checkpointer or ckpt.AsyncCheckpointer(ckpt_dir)
    restarts = 0
    while True:
        try:
            last = ckpt.latest_step(ckpt_dir)
            if last is None:
                state, start = init_state(), 0
            else:
                like = state_like if state_like is not None else init_state()
                state, _ = ckpt.restore(ckpt_dir, last, like, device)
                start = last
            for step in range(start, total_steps):
                if failure_plan is not None:
                    failure_plan.maybe_fail(step)
                state = step_fn(step, state)
                if (step + 1) % save_every == 0 or step + 1 == total_steps:
                    cp.save(step + 1, state)
            cp.wait()
            return state, restarts
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError("restart budget exhausted") from e


def remesh(ckpt_dir: str, step: int, like, device):
    """Restore ``step`` onto ``device`` (elastic placement)."""
    return ckpt.restore(ckpt_dir, step, like, device)
