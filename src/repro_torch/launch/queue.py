"""Continuous-batching admission queue for the spatial query service (the
reference's ``launch/queue.py`` over the port's fleet).

Concurrent client requests for any batched ``OperatorSpec`` are admitted
into one queue, coalesced into power-of-two buckets (the
``SpatialShards._bucket`` padding the fleet's engines are warmed at, so
coalescing adds no new batch shapes), and served with ONE engine dispatch
per coalesced batch: on the mesh path one program over partition × query
rows, so the per-dispatch host cost is paid once for many requests.

Pipeline shape (``depth`` in-flight batches per replica)::

    clients ──submit(rows, deadline=…)──▶ inbox ──┐
                                │  runner thread: drain ≤ max_batch rows
                                │  (waiting ≤ max_delay_s for stragglers,
                                │  never past the earliest request
                                │  deadline), assemble + pow2-pad  ── host
                                ▼
                   dispatch workers (depth × R threads)
                                │  health-aware replica pick (skip
                                │  quarantined — runtime/health.py), then
                                │  ShardPool.query: deadline re-issue to a
                                │  DIFFERENT replica; on failure, bounded
                                │  exponential backoff + jitter retries
                                │  (safe — queries are read-only), and
                                │  when EVERY replica is quarantined the
                                │  batch degrades to the host-loop
                                │  fallback engine                ── device
                                ▼
                   per-request slices → response futures

Double-buffering falls out of the split: while a dispatch worker blocks on
device traversal compute, the runner thread is already assembling the next
batch (and with ``depth ≥ 2`` a second dispatch per replica is admitted
before the first returns, so the device never waits on host-side batch
assembly).  Replica fan-out comes from ``SpatialShards.replicate`` — the
round-robin across R replicas multiplies throughput by the data-axis size
and gives the straggler pool genuinely distinct engines to re-issue to.

Fault model (the robustness contract, exercised by tests/test_torch_chaos.py
under ``runtime/faults.py`` injection):

  * a replica dispatch failure is retried — first by the straggler pool's
    in-flight re-issue to a distinct healthy replica, then by this queue's
    bounded exponential-backoff retry loop (``max_retries``, jittered,
    capped at ``backoff_max_s`` and at the earliest live deadline);
  * per-replica health (EWMA latency + consecutive failures) feeds a
    circuit breaker: after ``quarantine_after`` consecutive failures the
    replica is quarantined and *receives no further dispatches* until its
    timed half-open probe, so a dead replica is skipped, not paid for;
  * when every replica is quarantined, batches transparently fall back to
    the host-loop ``fallback`` engine (``degraded_dispatches`` counts
    them) — the service degrades in latency, never in availability or
    correctness;
  * a request past its deadline fails fast with ``DeadlineExceeded``
    instead of occupying a dispatch;
  * ``close()`` fails every request it can no longer serve with
    ``QueueClosed`` — a blocked client is always unblocked, even when the
    runner thread itself dies.

Responses are bit-exact with direct per-request ``SpatialShards`` calls
on the same path regardless of arrival interleaving *and* of which replica
served the batch: every replica answers identically and every operator the
queue admits scores queries row-independently (asserted by the schedule
sweeps of tests/test_torch_serving.py and the chaos parity runs of
tests/test_torch_chaos.py).  A host-path fallback behind mesh-path replicas
returns the same neighbours and distance bits, but may order ids within a
run of tied distances differently (the host path keeps a lone partition's
lane order at a tie, as the reference's does).  The batch-level
``overflow`` flag is conservative — a request reports overflow if any
request in its coalesced batch overflowed.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import queue as queue_mod
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from ..core import traversal
from ..distributed.spatial_shard import SpatialShards
from ..runtime.health import HealthTracker
from ..runtime.straggler import ShardPool

# browse is resumable (a session, not a one-shot request) and the join is
# query-less — neither coalesces into a shared query batch
QUEUEABLE_OPS = ("select", "knn", "knn_join", "knn_filtered")

_STOP = object()


class QueueClosed(RuntimeError):
    """The queue was closed before this request could be served."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline lapsed before a result was available."""


@dataclasses.dataclass(eq=False)
class _Request:
    rows: np.ndarray            # (m, W) query rows
    future: cf.Future           # resolves to this request's sliced result
    deadline: Optional[float]   # absolute time.monotonic() bound, or None
    off: int = 0                # row offset inside its coalesced batch


class ServeQueue:
    """Continuous-batching front end over one fleet or a replica list.

    ``engines`` — a ``SpatialShards`` or a sequence of them (the replicas
    from ``SpatialShards.replicate``; each must serve operator ``op``).
    ``op`` — a registered batched operator (``QUEUEABLE_OPS``).
    ``k`` / ``result_cap`` — the operator's parameters.
    ``max_batch`` — coalescing target in query rows (a single larger
    request still dispatches whole); the assembled batch is padded to its
    power-of-two bucket with ``SpatialShards._bucket``.
    ``max_delay_s`` — how long the runner waits for more requests once one
    is pending (the latency price of a fuller batch); a pending request's
    deadline always cuts the wait short (``deadline_slack_s`` early).
    ``depth`` — in-flight dispatches per replica (2 = double-buffered).
    ``deadline_s`` — straggler deadline per dispatch (ShardPool re-issue).
    ``max_retries`` / ``backoff_s`` / ``backoff_max_s`` — the bounded
    exponential-backoff retry policy for failed dispatches (jitter seeded
    from ``seed``).
    ``injector`` — optional ``runtime/faults.FaultInjector``; wraps every
    replica's dispatch callable for deterministic chaos testing.
    ``fallback`` — optional host-loop engine (a ``SpatialShards``) that
    serves batches when every replica is quarantined or the retry budget
    is exhausted (graceful degradation).
    ``health`` — optional pre-built ``HealthTracker`` (defaults to one
    tracker over the replica list with standard thresholds).
    """

    def __init__(self, engines: Union[SpatialShards,
                                      Sequence[SpatialShards]],
                 op: str, *, k: Optional[int] = None,
                 result_cap: int = 4096, max_batch: int = 256,
                 max_delay_s: float = 0.002, depth: int = 2,
                 deadline_s: float = 30.0, max_retries: int = 3,
                 backoff_s: float = 0.05, backoff_max_s: float = 1.0,
                 deadline_slack_s: float = 0.05,
                 injector=None, fallback: Optional[SpatialShards] = None,
                 health: Optional[HealthTracker] = None, seed: int = 0):
        if isinstance(engines, SpatialShards):
            engines = [engines]
        if not engines:
            raise ValueError("need at least one engine")
        spec = traversal.get_spec(op)
        if op not in QUEUEABLE_OPS:
            raise ValueError(
                f"operator {op!r} does not admit request coalescing "
                f"(queueable: {QUEUEABLE_OPS})")
        if spec.kind == "distance" and k is None:
            raise ValueError(f"queueing {op!r} needs k")
        if depth < 1 or max_batch < 1:
            raise ValueError("depth and max_batch must be >= 1")
        self.op = op
        self.spec = spec
        self.k = k
        self.result_cap = result_cap
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.depth = depth
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.deadline_slack_s = deadline_slack_s
        self.replicas = list(engines)
        self.health = health or HealthTracker(len(self.replicas))
        if len(self.health) != len(self.replicas):
            raise ValueError("health tracker size != replica count")
        calls = []
        for rid, rep in enumerate(self.replicas):
            call = self._engine_call(rep)
            if injector is not None:
                call = injector.wrap(rid, call)
            calls.append(call)
        self.pool = ShardPool(
            calls, deadline_s=deadline_s,
            max_workers=depth * len(self.replicas) + 1,
            health=self.health)
        # the degradation target is deliberately NOT fault-injected: it is
        # the trusted host loop of last resort
        self._fallback_call = None if fallback is None \
            else self._engine_call(fallback)
        self._rng = random.Random(seed)
        self.stats: Dict[str, int] = collections.defaultdict(int)
        self._slock = threading.Lock()
        self._inbox: "queue_mod.Queue" = queue_mod.Queue()
        self._inflight: collections.deque = collections.deque()
        self._outstanding: set = set()
        self._carry: Optional[_Request] = None
        self._rr = 0
        self._closed = False
        self._draining = True
        self._lock = threading.Lock()
        self._exec = cf.ThreadPoolExecutor(
            max_workers=depth * len(self.replicas),
            thread_name_prefix="serve-queue-dispatch")
        self._runner = threading.Thread(target=self._serve_loop,
                                        name="serve-queue-runner",
                                        daemon=True)
        self._runner.start()

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------

    def submit(self, rows: np.ndarray,
               deadline: Optional[float] = None) -> cf.Future:
        """Admit one request of ``rows`` (m, W) query rows; returns a
        future resolving to the per-request result — distance operators:
        (ids (m, k), dists (m, k), overflow), select: list of m id arrays.
        ``deadline`` (seconds from now) bounds the request end-to-end:
        coalescing never waits past it, and once it lapses the future fails
        fast with ``DeadlineExceeded`` instead of occupying a dispatch."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[0] < 1 \
                or rows.shape[1] != self.spec.query_width:
            raise ValueError(
                f"request rows must be (m >= 1, {self.spec.query_width}), "
                f"got {rows.shape}")
        fut: cf.Future = cf.Future()
        req = _Request(rows=rows, future=fut,
                       deadline=None if deadline is None
                       else time.monotonic() + deadline)
        with self._lock:
            if self._closed:
                raise QueueClosed("queue is closed")
            self._outstanding.add(req)
            self._inbox.put(req)
        return fut

    def query(self, rows: np.ndarray,
              deadline: Optional[float] = None):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(rows, deadline=deadline).result()

    def query_many(self, requests: Sequence[np.ndarray]) -> List[Any]:
        """Admit many requests at once; results come back in submission
        order regardless of how the batches coalesce."""
        return [f.result() for f in [self.submit(r) for r in requests]]

    def close(self, drain: bool = True) -> None:
        """Shut the pipeline down.  With ``drain=True`` (default) every
        request admitted so far is flushed first; with ``drain=False``
        queued requests are abandoned.  Either way, any future that can no
        longer be served fails with ``QueueClosed`` — a blocked client is
        never left hanging.  Safe to call twice; runs on scope exit when
        used as a context manager (including on exceptions)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._draining = drain
        self._inbox.put(_STOP)
        self._runner.join()
        self._exec.shutdown(wait=True)
        self.pool.shutdown()
        self._fail_outstanding(QueueClosed(
            "queue closed before the request was served"))

    def __enter__(self) -> "ServeQueue":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ------------------------------------------------------------------
    # future resolution — every path funnels through these so the
    # outstanding set stays exact and double-resolution is impossible
    # ------------------------------------------------------------------

    def _resolve(self, req: _Request, result) -> None:
        with self._lock:
            self._outstanding.discard(req)
        try:
            req.future.set_result(result)
        except cf.InvalidStateError:
            pass

    def _resolve_exc(self, req: _Request, exc: BaseException) -> None:
        with self._lock:
            self._outstanding.discard(req)
        try:
            req.future.set_exception(exc)
        except cf.InvalidStateError:
            pass

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Fail every unresolved future (queued, carried, or orphaned by a
        dead dispatch) — the close()/crash path's client-unblocking."""
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue_mod.Empty:
                break
            if item is not _STOP:
                self._resolve_exc(item, exc)
        if self._carry is not None:
            self._resolve_exc(self._carry, exc)
            self._carry = None
        with self._lock:
            pending = list(self._outstanding)
        for req in pending:
            self._resolve_exc(req, exc)

    def _bump(self, stat: str, by: int = 1) -> None:
        with self._slock:
            self.stats[stat] += by

    def _expired(self, req: _Request) -> bool:
        return req.deadline is not None \
            and time.monotonic() >= req.deadline

    def _fail_deadline(self, req: _Request) -> None:
        self._bump("deadline_exceeded")
        self._resolve_exc(req, DeadlineExceeded(
            "request deadline lapsed before a result was available"))

    # ------------------------------------------------------------------
    # pipeline internals
    # ------------------------------------------------------------------

    def _engine_call(self, shards: SpatialShards):
        """The dispatch callable of one replica.  A CUDA replica's calls
        run under ``torch.cuda.device(its device)``: a dispatch worker's
        current stream is then that device's default stream, the one the
        kernels launch on, and not device 0's."""
        if self.op == "select":
            def run(batch, s=shards):
                return s.range_select(batch, result_cap=self.result_cap)
        else:
            def run(batch, s=shards):
                return getattr(s, self.op)(batch, self.k)
        dev = getattr(shards, "device", None)
        if dev is None or dev.type != "cuda":
            return run

        def call(batch):
            with torch.cuda.device(dev):
                return run(batch)
        return call

    def _gather(self) -> Optional[List[_Request]]:
        """Drain the inbox into one coalesced batch: block for the first
        request, then keep admitting until ``max_batch`` rows are pending,
        ``max_delay_s`` has elapsed, or the earliest request deadline is
        ``deadline_slack_s`` away (coalescing must never wait a request
        past its own deadline).  A request that would push the batch past
        the ``max_batch`` power-of-two bucket is *carried* into the next
        batch instead (so coalescing never creates trace shapes beyond the
        warmed buckets; a single over-sized request still dispatches whole,
        in its own bucket).  Returns None on shutdown."""
        if self._closed and not self._draining:
            return None
        bucket_cap = 1 << (self.max_batch - 1).bit_length()
        if self._carry is not None:
            reqs, self._carry = [self._carry], None
            rows = len(reqs[0].rows)
        else:
            try:
                first = self._inbox.get(timeout=0.05)
            except queue_mod.Empty:
                return []
            if first is _STOP:
                return None
            reqs = [first]
            rows = len(first.rows)
        deadline = time.monotonic() + self.max_delay_s

        def _limit() -> float:
            dls = [r.deadline for r in reqs if r.deadline is not None]
            if not dls:
                return deadline
            return min(deadline, min(dls) - self.deadline_slack_s)

        while rows < self.max_batch:
            wait = _limit() - time.monotonic()
            try:
                nxt = self._inbox.get(timeout=wait) if wait > 0 \
                    else self._inbox.get_nowait()
            except queue_mod.Empty:
                break
            if nxt is _STOP:
                # re-post so the loop exits once the inbox (and any carry)
                # is drained; when not draining, abandon the batch in hand
                # (close() fails its futures with QueueClosed)
                self._inbox.put(_STOP)
                if not self._draining:
                    return None
                break
            if rows + len(nxt.rows) > bucket_cap:
                self._carry = nxt
                break
            reqs.append(nxt)
            rows += len(nxt.rows)
        return reqs

    def _serve_loop(self) -> None:
        try:
            while True:
                reqs = self._gather()
                if reqs is None:
                    break
                # fail-fast: a request already past its deadline never
                # occupies a dispatch slot
                live = []
                for r in reqs:
                    if self._expired(r):
                        self._fail_deadline(r)
                    else:
                        live.append(r)
                if not live:
                    continue
                # host-side assembly: concatenate + pow2-bucket pad —
                # overlaps the device compute of the in-flight dispatches
                off = 0
                for r in live:
                    r.off = off
                    off += len(r.rows)
                batch = SpatialShards._bucket(
                    np.concatenate([r.rows for r in live], axis=0))
                while len(self._inflight) >= self.depth * len(self.replicas):
                    self._inflight.popleft().result()
                start = self._rr % len(self.replicas)
                self._rr += 1
                self._inflight.append(
                    self._exec.submit(self._run_batch, start, batch, live))
            for fut in self._inflight:
                fut.result()
            self._inflight.clear()
        except BaseException:
            # the runner must never die leaving clients blocked on futures
            # nobody will ever resolve
            self._fail_outstanding(QueueClosed("serve queue runner crashed"))
            raise

    def _dispatch(self, start: int, batch: np.ndarray,
                  reqs: List[_Request]):
        """One coalesced dispatch under the full fault policy: health-aware
        replica pick → ShardPool deadline/failure re-issue → bounded
        exponential-backoff retries → host-fallback degradation.  Returns
        the engine output, or None when every request expired mid-retry."""
        attempt = 0
        while True:
            if not any(not r.future.done() and not self._expired(r)
                       for r in reqs):
                for r in reqs:
                    if not r.future.done():
                        self._fail_deadline(r)
                return None
            rid = self.health.next_replica(start)
            if rid is None:
                # every breaker is open: degrade rather than wait out a
                # cooldown the client can feel
                return self._degraded(batch, None)
            try:
                return self.pool.query(rid, batch)
            except Exception as exc:
                attempt += 1
                self._bump("dispatch_failures")
                if attempt > self.max_retries:
                    return self._degraded(batch, exc)
                self._bump("retries")
                # bounded exponential backoff + jitter — safe to retry
                # blindly because every queueable operator is a read
                delay = min(self.backoff_s * (2 ** (attempt - 1)),
                            self.backoff_max_s)
                delay *= 0.5 + 0.5 * self._rng.random()
                dls = [r.deadline for r in reqs
                       if r.deadline is not None and not r.future.done()]
                if dls:
                    delay = min(delay,
                                max(min(dls) - time.monotonic(), 0.0))
                if delay > 0:
                    time.sleep(delay)

    def _degraded(self, batch: np.ndarray,
                  last_exc: Optional[BaseException]):
        """Graceful degradation: serve the batch on the host-loop fallback
        engine.  Degrades latency, never availability — unless no fallback
        was configured, in which case the last replica error propagates."""
        if self._fallback_call is None:
            if last_exc is not None:
                raise last_exc
            raise RuntimeError(
                "every replica is quarantined and no fallback engine is "
                "configured")
        self._bump("degraded_dispatches")
        return self._fallback_call(batch)

    def _run_batch(self, start: int, batch: np.ndarray,
                   reqs: List[_Request]) -> None:
        """One coalesced dispatch, then per-request slicing and future
        resolution.  Any exception — engine, retry-budget, slicing — lands
        in the request futures, never in the worker thread."""
        try:
            out = self._dispatch(start, batch, reqs)
        except Exception as exc:
            for r in reqs:
                self._resolve_exc(r, exc)
            return
        if out is None:              # every request expired mid-retry
            return
        with self._slock:
            self.stats["batches"] += 1
            self.stats["requests"] += len(reqs)
            self.stats["rows"] += sum(len(r.rows) for r in reqs)
            self.stats["padded_rows"] += len(batch)
        for r in reqs:
            if r.future.done():
                continue
            if self._expired(r):
                # the result arrived, but after the client's deadline —
                # the deadline is a contract, not a hint
                self._fail_deadline(r)
                continue
            m = len(r.rows)
            if self.op == "select":
                self._resolve(r, out[r.off:r.off + m])
            else:
                ids, d, ovf = out
                self._resolve(r, (ids[r.off:r.off + m],
                                  d[r.off:r.off + m], ovf))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def summary(self) -> Dict[str, Any]:
        """Coalescing + robustness stats: dispatched batches, admitted
        requests/rows, mean rows per dispatch, straggler re-issues and
        engine failures (with per-shard rows from the backing ShardPool),
        retry/deadline/degradation counts, and the health tracker's
        quarantine/probe totals + current per-replica states."""
        with self._slock:
            s: Dict[str, Any] = dict(self.stats)
        for key in ("retries", "dispatch_failures", "deadline_exceeded",
                    "degraded_dispatches"):
            s.setdefault(key, 0)
        pool = self.pool.stats()
        s["reissues"] = pool["reissues"]
        s["failures"] = pool["failures"]
        s["pool_by_shard"] = pool["by_shard"]
        s["replicas"] = len(self.replicas)
        health = self.health.snapshot()
        s["quarantines"] = health["quarantines"]
        s["probes"] = health["probes"]
        s["health"] = [r["state"] for r in health["replicas"]]
        if s.get("batches"):
            s["rows_per_dispatch"] = s["rows"] / s["batches"]
        return s
