"""Straggler mitigation for the spatial query service (a copy of the
reference's ``runtime/straggler.py``: host threads, no tensors).

Queries are idempotent reads over an immutable index, so the cheap and
correct mitigation is **deadline re-issue**: dispatch a query micro-batch
to its home shard; if the deadline lapses — or the shard *raises* — re-issue
to a hot-spare replica and take whichever answer lands first.  A raised
shard exception is a re-issue trigger exactly like a missed deadline (the
``failures`` stat counts them); the pool only propagates an error once every
engine that could serve the payload has failed.

``shards`` are callables (the serve launcher passes one range-select call
per fleet).  Re-issue only happens when a *distinct* engine exists to
re-issue to: with a single shard and no spares, a "re-issue" would resubmit
the identical callable to the same engine — the pool skips it and simply
waits the primary out.

Health integration (``health=`` — an object with ``record_success``,
``record_failure`` and ``usable``): every dispatch outcome is recorded via
a done-callback, and backup selection skips unusable replicas.  The serve
queue (launch/queue.py) passes its ``runtime/health.HealthTracker``.

Counters are lock-guarded; ``stats()`` returns a *consistent snapshot*
taken under the lock, with failures/re-issues broken out per engine label
(``r<i>`` for shards, ``spare<j>`` for spares).

``ShardPool`` is a context manager; ``shutdown()`` runs on scope exit even
when the serving loop raises.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class ShardPool:
    def __init__(self, shards: Sequence[Callable[[Any], Any]],
                 spares: Sequence[Callable[[Any], Any]] = (),
                 deadline_s: float = 1.0,
                 max_workers: Optional[int] = None,
                 health=None):
        self.shards = list(shards)
        self.spares = list(spares)
        self.deadline = deadline_s
        self.health = health
        self._lock = threading.Lock()
        self._reissues = 0
        self._failures = 0
        self._by_shard: Dict[str, Dict[str, int]] = {}
        self._pool = cf.ThreadPoolExecutor(
            max_workers=max_workers
            or len(self.shards) + max(len(self.spares), 1))

    def __enter__(self) -> "ShardPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # stats — totals stay attribute-compatible; stats() is the consistent
    # snapshot (taken under one lock, per-shard rows included)
    # ------------------------------------------------------------------

    @property
    def reissues(self) -> int:
        with self._lock:
            return self._reissues

    @property
    def failures(self) -> int:
        with self._lock:
            return self._failures

    def _count(self, stat: str, label: str) -> None:
        with self._lock:
            if stat == "reissues":
                self._reissues += 1
            else:
                self._failures += 1
            row = self._by_shard.setdefault(
                label, {"failures": 0, "reissues": 0})
            row[stat] += 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"reissues": self._reissues, "failures": self._failures,
                    "by_shard": {k: dict(v)
                                 for k, v in self._by_shard.items()}}

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _submit(self, label: str, rid: Optional[int],
                fn: Callable[[Any], Any], payload) -> cf.Future:
        """Submit one engine call; the done-callback records the outcome —
        failure stats here, plus health signals (true latency even when the
        answer lands after the race was already won elsewhere)."""
        t0 = time.perf_counter()
        fut = self._pool.submit(fn, payload)

        def _record(f: cf.Future) -> None:
            if f.cancelled():
                return
            if f.exception() is None:
                if self.health is not None and rid is not None:
                    self.health.record_success(
                        rid, time.perf_counter() - t0)
            else:
                self._count("failures", label)
                if self.health is not None and rid is not None:
                    self.health.record_failure(rid)

        fut.add_done_callback(_record)
        return fut

    def _backup_for(self, shard_id: int
                    ) -> Optional[Tuple[str, Optional[int], Callable]]:
        """The distinct engine a re-issue may target — (label, health id,
        callable) — or None when no such engine exists (single shard and no
        spares, or every other replica's breaker is open)."""
        if self.spares:
            j = shard_id % len(self.spares)
            return (f"spare{j}", None, self.spares[j])
        if len(self.shards) > 1:
            for step in range(1, len(self.shards)):
                cand = (shard_id + step) % len(self.shards)
                if self.health is None or self.health.usable(cand):
                    return (f"r{cand}", cand, self.shards[cand])
        return None

    def query(self, shard_id: int, payload) -> Any:
        primary = self._submit(f"r{shard_id}", shard_id,
                               self.shards[shard_id], payload)
        primary_failed = False
        try:
            return primary.result(timeout=self.deadline)
        except cf.TimeoutError:
            pass
        except Exception:
            # a crashed shard is a re-issue trigger, not a fatal answer —
            # the module contract is "take whichever answer lands first"
            # (the failure itself is counted by the done-callback)
            primary_failed = True
        backup_ref = self._backup_for(shard_id)
        if backup_ref is None:
            # no distinct engine: re-issuing would resubmit the identical
            # callable to the same shard (and inflate ``reissues``); wait
            # the primary out instead, propagating its eventual outcome
            return primary.result()
        blabel, brid, bfn = backup_ref
        # the re-issue is attributed to the primary that forced it
        self._count("reissues", f"r{shard_id}")
        backup = self._submit(blabel, brid, bfn, payload)
        # race the survivors: the first *successful* completion wins;
        # FIRST_COMPLETED alone could hand back a failed primary (or an
        # arbitrary member when both already completed) whose .result()
        # re-raises even though the other future succeeded
        pending = {backup} if primary_failed else {primary, backup}
        last_exc: Optional[BaseException] = None
        while pending:
            done, pending = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
            for fut in done:
                exc = fut.exception()
                if exc is None:
                    return fut.result()
                last_exc = exc
        assert last_exc is not None
        raise last_exc

    def query_many(self, payloads: Sequence[Tuple[int, Any]]) -> List[Any]:
        return [self.query(sid, p) for sid, p in payloads]

    def shutdown(self, wait: bool = False):
        """Stop the workers and cancel calls not yet started; ``wait``
        also joins the running ones, so that every done-callback (and the
        stats and health signals it records) has run on return."""
        self._pool.shutdown(wait=wait, cancel_futures=True)
