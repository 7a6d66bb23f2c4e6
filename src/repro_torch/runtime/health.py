"""Per-replica health tracking + circuit breaking for the serving stack (a
copy of the reference's ``runtime/health.py``: host threads, no tensors).

Before this layer, a dead replica was rediscovered on *every* dispatch:
the straggler pool would pay the full deadline (or an exception round-trip)
and re-issue, forever.  ``HealthTracker`` turns those per-dispatch signals
— success latency (EWMA) and consecutive failures — into a per-replica
circuit breaker that ``ServeQueue`` round-robin and ``ShardPool`` backup
selection both consult, so a failing replica is *skipped* after K failures
instead of paid for.

State machine (per replica)::

                  consecutive failures < K │ EWMA ≳ 3× fleet best
        ┌──────────┐ ───────────────────▶ ┌─────────┐
        │ HEALTHY  │                      │ SUSPECT │   (still serving —
        └──────────┘ ◀─────────────────── └─────────┘    a warning state)
             ▲  ▲         success              │
             │  │                              │ K-th consecutive failure
             │  │ probe success                ▼ │ EWMA > slow_factor × best
             │  │                     ┌─────────────┐
             │  └──────────────────── │ QUARANTINED │ ◀───┐
             │                        └─────────────┘     │ probe failure
             │ success                       │ cooldown   │ (cooldown ×2,
             │                               ▼ elapsed    │  capped)
             │                        ┌───────────┐       │
             └─────────────────────── │ PROBATION │ ──────┘
                                      └───────────┘
                                  (half-open: ONE probe dispatch
                                   allowed through the breaker)

Quarantine entry happens two ways: ``quarantine_after`` *consecutive*
failures (a dead/crashing replica), or a success EWMA latency exceeding
``slow_factor`` × the best other live replica's EWMA (a wedged/overloaded
replica) — the latter only when another replica remains to serve, so the
breaker never quarantines the last usable engine on latency alone.  After
``cooldown_s`` the breaker goes half-open (PROBATION): exactly one probe
dispatch is admitted; success closes the breaker (HEALTHY, cooldown
reset), failure re-opens it with the cooldown doubled (capped at
``cooldown_max_s``).

All methods are thread-safe; ``clock`` is injectable so the state machine
is testable without sleeping (tests/test_health.py).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"


@dataclasses.dataclass
class _Replica:
    state: str = HEALTHY
    consecutive_failures: int = 0
    ewma_s: Optional[float] = None
    samples: int = 0           # successful dispatches folded into the EWMA
    cooldown_s: float = 0.0    # next quarantine duration (exponential)
    quarantined_until: float = 0.0
    probe_inflight: bool = False
    dispatches: int = 0
    failures: int = 0


class HealthTracker:
    def __init__(self, n_replicas: int, *, quarantine_after: int = 3,
                 cooldown_s: float = 0.5, cooldown_max_s: float = 30.0,
                 ewma_alpha: float = 0.2, slow_factor: float = 10.0,
                 suspect_factor: float = 3.0, min_latency_samples: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.quarantine_after = quarantine_after
        self.base_cooldown_s = cooldown_s
        self.cooldown_max_s = cooldown_max_s
        self.ewma_alpha = ewma_alpha
        self.slow_factor = slow_factor
        self.suspect_factor = suspect_factor
        self.min_latency_samples = min_latency_samples
        self.quarantines = 0       # total transitions into QUARANTINED
        self.probes = 0            # half-open probe dispatches granted
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas = [_Replica(cooldown_s=cooldown_s)
                          for _ in range(n_replicas)]

    def __len__(self) -> int:
        return len(self._replicas)

    # ------------------------------------------------------------------
    # signal recording
    # ------------------------------------------------------------------

    def record_success(self, rid: int, latency_s: Optional[float] = None
                       ) -> None:
        with self._lock:
            r = self._replicas[rid]
            r.dispatches += 1
            r.consecutive_failures = 0
            r.probe_inflight = False
            r.state = HEALTHY
            r.cooldown_s = self.base_cooldown_s
            if latency_s is not None:
                r.samples += 1
                r.ewma_s = latency_s if r.ewma_s is None else (
                    self.ewma_alpha * latency_s
                    + (1.0 - self.ewma_alpha) * r.ewma_s)
                self._latency_transition(rid, r)

    def record_failure(self, rid: int) -> None:
        with self._lock:
            r = self._replicas[rid]
            r.dispatches += 1
            r.failures += 1
            r.consecutive_failures += 1
            if r.state == PROBATION:
                # failed probe: re-open the breaker with doubled cooldown
                r.probe_inflight = False
                r.cooldown_s = min(r.cooldown_s * 2.0, self.cooldown_max_s)
                self._quarantine(r)
            elif r.state == QUARANTINED:
                pass                     # late failure of an old dispatch
            elif r.consecutive_failures >= self.quarantine_after:
                self._quarantine(r)
            else:
                r.state = SUSPECT

    def _quarantine(self, r: _Replica) -> None:
        r.state = QUARANTINED
        r.quarantined_until = self._clock() + r.cooldown_s
        self.quarantines += 1

    def _latency_transition(self, rid: int, r: _Replica) -> None:
        """EWMA-driven transitions (caller holds the lock): vs the best
        other replica with enough samples, > slow_factor× → QUARANTINED
        (never the last live replica), > suspect_factor× → SUSPECT."""
        if r.samples < self.min_latency_samples:
            return
        others = [o.ewma_s for j, o in enumerate(self._replicas)
                  if j != rid and o.state != QUARANTINED
                  and o.samples >= self.min_latency_samples
                  and o.ewma_s is not None]
        if not others:
            return
        best = min(others)
        if r.ewma_s > self.slow_factor * best:
            self._quarantine(r)
        elif r.ewma_s > self.suspect_factor * best:
            r.state = SUSPECT

    # ------------------------------------------------------------------
    # dispatch admission
    # ------------------------------------------------------------------

    def acquire(self, rid: int) -> bool:
        """May a dispatch target this replica right now?  HEALTHY/SUSPECT:
        yes.  QUARANTINED past its cooldown: flips to PROBATION and grants
        the single half-open probe.  Otherwise no."""
        with self._lock:
            r = self._replicas[rid]
            if r.state in (HEALTHY, SUSPECT):
                return True
            if r.state == QUARANTINED \
                    and self._clock() >= r.quarantined_until:
                r.state = PROBATION
                r.probe_inflight = True
                self.probes += 1
                return True
            if r.state == PROBATION and not r.probe_inflight:
                r.probe_inflight = True
                self.probes += 1
                return True
            return False

    def next_replica(self, start: int = 0) -> Optional[int]:
        """Health-aware round-robin: the first serving replica scanning
        from ``start`` (HEALTHY and SUSPECT share the rotation — suspect
        still serves, that is what distinguishes it from quarantine), then
        any replica whose breaker will admit a half-open probe.  ``None``
        means every replica is quarantined inside its cooldown — the
        caller's cue to degrade to the host fallback."""
        n = len(self._replicas)
        order = [(start + i) % n for i in range(n)]
        with self._lock:
            for rid in order:
                if self._replicas[rid].state in (HEALTHY, SUSPECT):
                    return rid
        for rid in order:
            if self.acquire(rid):
                return rid
        return None

    def usable(self, rid: int) -> bool:
        """Backup-eligibility (straggler re-issue target): serving states
        only — a probationary replica is mid-probe and a quarantined one is
        exactly what the re-issue is routing around."""
        with self._lock:
            return self._replicas[rid].state in (HEALTHY, SUSPECT)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def state(self, rid: int) -> str:
        with self._lock:
            return self._replicas[rid].state

    def states(self) -> List[str]:
        with self._lock:
            return [r.state for r in self._replicas]

    def snapshot(self) -> Dict:
        """Consistent copy of the whole tracker, taken under the lock."""
        with self._lock:
            return {
                "quarantines": self.quarantines,
                "probes": self.probes,
                "replicas": [{
                    "state": r.state,
                    "consecutive_failures": r.consecutive_failures,
                    "ewma_s": r.ewma_s,
                    "dispatches": r.dispatches,
                    "failures": r.failures,
                    "cooldown_s": r.cooldown_s,
                } for r in self._replicas],
            }
