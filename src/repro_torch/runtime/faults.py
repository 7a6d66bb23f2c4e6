"""Seeded, deterministic fault injection for the serving stack and the
training loop (a copy of the reference's ``runtime/faults.py``: host
threads, no tensors).

The robustness machinery (runtime/health.py circuit breaking, the serve
queue's retry/degradation paths, the straggler pool's re-issue) is only
trustworthy if its failure modes can be *provoked on demand, repeatably*.
This module provides that: a ``FaultPlan`` is a parsed schedule of fault
clauses, and a ``FaultInjector`` wraps any replica engine callable so that
each dispatch consults the plan — raising, sleeping, or both — as a pure
function of ``(seed, replica, dispatch index)``.  Two runs of the same plan
against the same request schedule therefore inject the identical fault
sequence, which is what lets the chaos suite assert bit-exactness against
a fault-free run (tests/test_chaos.py) and what ``serve --chaos <spec>``
exposes operationally.

Spec grammar (comma-separated clauses)::

    kill:r<i>@<n>          replica i dies permanently from its n-th
                           dispatch onward (raises ReplicaDead)
    crash:r<i>@<n>         replica i raises once, on its n-th dispatch,
                           then recovers (raises InjectedFault)
    slow:r<i>@<n>:<secs>   every dispatch from the n-th onward takes
                           <secs> extra seconds (a wedged/overloaded
                           replica; floats accepted)
    flaky:r<i>:<p>         each dispatch independently raises with
                           probability p (seeded — deterministic per
                           dispatch index)
    spike:r<i>:<p>:<secs>  each dispatch independently sleeps <secs>
                           extra with probability p (seeded latency
                           spikes)

Dispatch indices are 0-based and count *that replica's* dispatches, not
global batches — ``kill:r1@5`` kills replica 1 on its own 6th dispatch
regardless of how round-robin interleaved the fleet.  Randomized clauses
(flaky/spike) draw from ``random.Random(f"{seed}:{clause}:{replica}:{n}")``,
so the outcome at any dispatch is independent of thread interleaving.

``FailurePlan`` in runtime/fault_tolerance.py (the training-side step-
indexed crash schedule) is a thin wrapper over a ``FaultPlan`` of
``crash`` clauses (``FaultPlan.crash_at_steps``): one schedule engine for
serving and training alike.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import re
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """An exception injected by a FaultPlan (never raised by real engines)."""


class ReplicaDead(InjectedFault):
    """The permanent form: every dispatch to this replica fails from the
    clause's threshold onward (a crashed / partitioned / wedged replica)."""


@dataclasses.dataclass(frozen=True)
class FaultClause:
    kind: str                  # kill | crash | slow | flaky | spike
    replica: int
    at: int = 0                # dispatch index the clause arms at
    p: float = 1.0             # per-dispatch probability (flaky / spike)
    delay_s: float = 0.0       # extra seconds per affected dispatch

    def __str__(self) -> str:
        if self.kind in ("kill", "crash"):
            return f"{self.kind}:r{self.replica}@{self.at}"
        if self.kind == "slow":
            return f"slow:r{self.replica}@{self.at}:{self.delay_s:g}"
        if self.kind == "flaky":
            return f"flaky:r{self.replica}:{self.p:g}"
        return f"spike:r{self.replica}:{self.p:g}:{self.delay_s:g}"


_CLAUSE_RES = (
    ("kill", re.compile(r"kill:r(\d+)@(\d+)$")),
    ("crash", re.compile(r"crash:r(\d+)@(\d+)$")),
    ("slow", re.compile(r"slow:r(\d+)@(\d+):([0-9.eE+-]+)$")),
    ("flaky", re.compile(r"flaky:r(\d+):([0-9.eE+-]+)$")),
    ("spike", re.compile(r"spike:r(\d+):([0-9.eE+-]+):([0-9.eE+-]+)$")),
)


def parse_clause(text: str) -> FaultClause:
    text = text.strip()
    for kind, rx in _CLAUSE_RES:
        m = rx.match(text)
        if m is None:
            continue
        g = m.groups()
        if kind in ("kill", "crash"):
            return FaultClause(kind, replica=int(g[0]), at=int(g[1]))
        if kind == "slow":
            return FaultClause(kind, replica=int(g[0]), at=int(g[1]),
                               delay_s=float(g[2]))
        if kind == "flaky":
            return FaultClause(kind, replica=int(g[0]), p=float(g[1]))
        return FaultClause(kind, replica=int(g[0]), p=float(g[1]),
                           delay_s=float(g[2]))
    raise ValueError(
        f"unparseable fault clause {text!r} — expected kill:rI@N, "
        f"crash:rI@N, slow:rI@N:SECS, flaky:rI:P, or spike:rI:P:SECS")


class FaultPlan:
    """A parsed, seeded fault schedule: ``faults_for(replica, n)`` is a pure
    function returning (extra delay seconds, exception-or-None) for that
    replica's n-th dispatch."""

    def __init__(self, clauses: Sequence[FaultClause] = (), seed: int = 0):
        self.clauses = tuple(clauses)
        self.seed = seed

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        clauses = [parse_clause(c) for c in spec.split(",") if c.strip()]
        if not clauses:
            raise ValueError(f"empty fault spec {spec!r}")
        return cls(clauses, seed=seed)

    @classmethod
    def crash_at_steps(cls, steps: Sequence[int],
                       replica: int = 0) -> "FaultPlan":
        """The training-side schedule: crash once at each given step index
        (``FailurePlan``'s contract, as crash clauses)."""
        return cls(tuple(FaultClause("crash", replica, at=s) for s in steps))

    def __str__(self) -> str:
        return ",".join(str(c) for c in self.clauses)

    def _draw(self, ci: int, replica: int, n: int) -> float:
        # stateless per-dispatch draw: deterministic under any thread
        # interleaving because nothing is consumed from a shared stream
        # (string seeds hash stably across processes, unlike tuples)
        return random.Random(f"{self.seed}:{ci}:{replica}:{n}").random()

    def faults_for(self, replica: int, n: int
                   ) -> Tuple[float, Optional[InjectedFault]]:
        delay = 0.0
        exc: Optional[InjectedFault] = None
        for ci, c in enumerate(self.clauses):
            if c.replica != replica:
                continue
            if c.kind == "kill" and n >= c.at:
                exc = exc or ReplicaDead(
                    f"replica r{replica} killed at dispatch {c.at} "
                    f"(this is dispatch {n})")
            elif c.kind == "crash" and n == c.at:
                exc = exc or InjectedFault(
                    f"replica r{replica} crashed on dispatch {n}")
            elif c.kind == "slow" and n >= c.at:
                delay += c.delay_s
            elif c.kind == "flaky" and self._draw(ci, replica, n) < c.p:
                exc = exc or InjectedFault(
                    f"replica r{replica} flaked on dispatch {n}")
            elif c.kind == "spike" and self._draw(ci, replica, n) < c.p:
                delay += c.delay_s
        return delay, exc


class FaultInjector:
    """Wraps replica engine callables with a FaultPlan.

    ``wrap(replica, fn)`` returns a callable that, per dispatch, bumps the
    replica's dispatch counter, sleeps any injected delay, raises any
    injected exception, and otherwise calls through to ``fn``.  The
    ``dispatches`` counter is the chaos suite's observability hook: a
    quarantined replica's count must stop growing (tests/test_chaos.py).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.dispatches: Dict[int, int] = collections.defaultdict(int)
        self.injected: Dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def wrap(self, replica: int, fn: Callable) -> Callable:
        def call(payload, _fn=fn, _rid=replica):
            self.before_dispatch(_rid)
            return _fn(payload)
        return call

    def before_dispatch(self, replica: int) -> None:
        with self._lock:
            n = self.dispatches[replica]
            self.dispatches[replica] = n + 1
        delay, exc = self.plan.faults_for(replica, n)
        if delay > 0.0:
            with self._lock:
                self.injected["delays"] += 1
            time.sleep(delay)
        if exc is not None:
            with self._lock:
                self.injected["exceptions"] += 1
            raise exc
