"""Port (repro_torch) ≡ reference (repro): the serving stack — the health
tracker, the fault plan, the continuous-batching serve queue and replica
fan-out (``serve --queue`` through the CLI:
``test_torch_serving_cli.py``).

``HealthTracker`` of both packages is driven by the same seeded script of
successes, failures, latencies, clock steps and admission calls on fake
clocks, and their snapshots and answers must be equal after every event;
``FaultPlan.faults_for`` and ``FaultInjector`` draw the same faults.  The
queue serves select, kNN, kNN-join and filtered kNN (D1; kNN also D3) on
the host path and the mesh path of the reference's chaos fleet (5,000
points, 4 partitions, fanout 64) under shuffled request sizes and
interleavings, and every response equals the direct port call and the
reference's ``SpatialShards`` answer (ids, distance bits, select id
arrays, overflow).  Inputs are made with numpy from a seed and handed to
both packages.  No test reads a clock: engines that must block wait on an
event, and every future is waited on with a timeout.
"""
import concurrent.futures as cf
import sys
import threading

import numpy as np
import pytest
import torch

from repro.runtime import faults as jfaults
from repro.runtime import health as jhealth
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.queue import (QUEUEABLE_OPS, DeadlineExceeded,
                                      QueueClosed, ServeQueue)
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import health as thealth

from conftest import uniform_rects
from oracle import _shards_for

WAIT_S = 30.0            # every future's timeout
K = 4


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# HealthTracker
# ---------------------------------------------------------------------------

def _trackers(n, **kw):
    jc, tc = FakeClock(), FakeClock()
    return (jhealth.HealthTracker(n, clock=jc, **kw), jc,
            thealth.HealthTracker(n, clock=tc, **kw), tc)


def _drive(script, n, **kw):
    """Run ``script`` — (method, args) events, ``("advance", dt)`` a clock
    step — on both trackers; every answer and every snapshot equal.
    Returns the port's tracker."""
    jt, jc, tt, tc = _trackers(n, **kw)
    for i, (name, *args) in enumerate(script):
        if name == "advance":
            jc.advance(args[0])
            tc.advance(args[0])
            continue
        got = getattr(tt, name)(*args)
        want = getattr(jt, name)(*args)
        assert got == want, f"event {i} {name}{tuple(args)}"
        assert tt.snapshot() == jt.snapshot(), f"event {i} {name}{args}"
    return tt


def _random_script(seed, n, length=300):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(length):
        rid = int(rng.integers(n))
        u = rng.random()
        if u < 0.35:
            lat = None if rng.random() < 0.1 else \
                float(rng.lognormal(-4.0, 1.5))
            script.append(("record_success", rid, lat))
        elif u < 0.6:
            script.append(("record_failure", rid))
        elif u < 0.7:
            script.append(("advance", float(rng.exponential(0.8))))
        elif u < 0.8:
            script.append(("acquire", rid))
        elif u < 0.9:
            script.append(("next_replica", rid))
        elif u < 0.95:
            script.append(("usable", rid))
        else:
            script.append(("states",))
    return script


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 2), (3, 3),
                                    (4, 3), (5, 4)])
def test_health_tracker_equals_reference_on_a_seeded_script(seed, n):
    rng = np.random.default_rng(100 + seed)
    kw = dict(quarantine_after=int(rng.integers(1, 4)),
              cooldown_s=float(rng.uniform(0.2, 1.5)),
              cooldown_max_s=float(rng.uniform(2.0, 6.0)),
              slow_factor=float(rng.uniform(3.0, 12.0)),
              suspect_factor=float(rng.uniform(1.5, 3.0)),
              min_latency_samples=int(rng.integers(1, 4)))
    tt = _drive(_random_script(seed, n), n, **kw)
    snap = tt.snapshot()
    # the script reached the breaker's states, not only HEALTHY
    assert snap["quarantines"] > 0 and sum(
        r["dispatches"] for r in snap["replicas"]) > 0


def _fail(rid, times):
    return [("record_failure", rid)] * times


TRANSITIONS = {
    # name: (n, tracker kwargs, script, final states)
    "suspect_then_healthy": (2, {}, _fail(0, 1) + [
        ("state", 0), ("next_replica", 0), ("usable", 0),
        ("record_success", 0, None)], ["healthy", "healthy"]),
    "kth_failure_quarantines": (2, {}, _fail(0, 3) + [
        ("usable", 0), ("next_replica", 0), ("acquire", 0)],
        ["quarantined", "healthy"]),
    "nonconsecutive_failures_stay_healthy": (2, {}, [
        ("record_failure", 0), ("record_success", 0, 0.01)] * 5,
        ["healthy", "healthy"]),
    "all_quarantined_degrade": (2, {}, _fail(0, 3) + _fail(1, 3) + [
        ("next_replica", 0)], ["quarantined", "quarantined"]),
    "cooldown_grants_one_probe": (2, {}, _fail(0, 3) + [
        ("advance", 1.5), ("acquire", 0), ("acquire", 0), ("state", 0)],
        ["probation", "healthy"]),
    "probe_success_closes": (2, {}, _fail(0, 3) + [
        ("advance", 1.5), ("acquire", 0), ("record_success", 0, 0.02)],
        ["healthy", "healthy"]),
    "failed_probe_doubles_capped_cooldown": (
        2, {"cooldown_max_s": 3.0}, _fail(0, 3) + [
            ("advance", 10.0), ("acquire", 0), ("record_failure", 0),
            ("acquire", 0)] * 3, ["quarantined", "healthy"]),
    "late_failure_keeps_the_clock": (2, {}, _fail(0, 4) + [
        ("advance", 0.5), ("acquire", 0)], ["quarantined", "healthy"]),
    "slow_replica_quarantined": (2, {"slow_factor": 10.0}, [
        ("record_success", 0, 0.01), ("record_success", 1, 0.5)] * 4,
        ["healthy", "quarantined"]),
    "moderately_slow_is_suspect": (2, {"slow_factor": 10.0}, [
        ("record_success", 0, 0.01), ("record_success", 1, 0.05)] * 4,
        ["healthy", "suspect"]),
    "last_live_replica_never_latency_quarantined": (
        2, {"slow_factor": 10.0}, _fail(0, 3) + [
            ("record_success", 1, 5.0)] * 6 + [("next_replica", 0)],
        ["quarantined", "healthy"]),
}


@pytest.mark.parametrize("name", sorted(TRANSITIONS))
def test_health_tracker_named_transitions_equal_reference(name):
    n, kw, script, final = TRANSITIONS[name]
    kw = dict({"quarantine_after": 3, "cooldown_s": 1.0}, **kw)
    assert _drive(script, n, **kw).states() == final


def test_health_tracker_rejects_an_empty_fleet():
    for mod in (jhealth, thealth):
        with pytest.raises(ValueError, match="at least one replica"):
            mod.HealthTracker(0)


# ---------------------------------------------------------------------------
# FaultPlan and FaultInjector
# ---------------------------------------------------------------------------

def _fault(plan, replica, n):
    delay, exc = plan.faults_for(replica, n)
    return delay, None if exc is None else (type(exc).__name__, str(exc))


@pytest.mark.parametrize("spec", [
    "kill:r1@2", "crash:r0@3", "slow:r1@4:0.25", "flaky:r0:0.3",
    "spike:r1:0.5:0.01", "flaky:r0:0.4,flaky:r1:0.3,kill:r1@7,crash:r0@5",
    "spike:r0:0.2:0.5,slow:r0@1:0.1,flaky:r0:0.9"])
@pytest.mark.parametrize("seed", [0, 9, 12345])
def test_fault_plan_draws_equal_reference(spec, seed):
    jp = jfaults.FaultPlan.from_spec(spec, seed=seed)
    tp = tfaults.FaultPlan.from_spec(spec, seed=seed)
    assert str(tp) == str(jp)
    assert [str(c) for c in tp.clauses] == [str(c) for c in jp.clauses]
    seq = [(r, n) for r in range(3) for n in range(60)]
    got = [_fault(tp, r, n) for r, n in seq]
    assert got == [_fault(jp, r, n) for r, n in seq]
    assert any(g != (0.0, None) for g in got)


@pytest.mark.parametrize("bad", ["", "kill:r1", "kill:1@5", "slow:r0@1",
                                 "flaky:r0", "explode:r0@1",
                                 "kill:r1@5 trailing"])
def test_parse_clause_rejects_what_the_reference_rejects(bad):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match="unparseable"):
            mod.parse_clause(bad)


@pytest.mark.parametrize("spec", ["kill:r1@3,crash:r0@2",
                                  "flaky:r0:0.5,flaky:r1:0.25"])
def test_fault_injector_counts_equal_reference(spec):
    def run(mod):
        inj = mod.FaultInjector(mod.FaultPlan.from_spec(spec, seed=3))
        calls = [inj.wrap(r, lambda x: x + 1) for r in (0, 1)]
        out = []
        for i in range(40):
            try:
                out.append(calls[i % 2](i))
            except mod.InjectedFault as exc:
                out.append(type(exc).__name__)
        return out, dict(inj.dispatches), dict(inj.injected)
    assert run(tfaults) == run(jfaults)


# ---------------------------------------------------------------------------
# the serve queue against the reference's fleet answers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rects():
    return uniform_rects(np.random.default_rng(21), 5000, eps=0.0)


@pytest.fixture(scope="module")
def fleets(rects):
    """(path, layout) → (the port's fleet, the reference's fleet)."""
    cache = {}

    def get(path, layout):
        if (path, layout) not in cache:
            t = TShards.build(rects, 4, fanout=64, layout=layout,
                              device="cpu")
            j = _shards_for(rects, 4, 64, layout=layout,
                            mesh=None if path == "mesh" else False)
            if path == "mesh":
                t.enable_mesh()
            cache[path, layout] = (t, j)
        return cache[path, layout]
    return get


def make_rows(op, rng, m):
    """``m`` query rows of ``op``, as the serve runners shape them."""
    if op == "select":
        lo = rng.random((m, 2)).astype(np.float32) * 0.9
        return np.concatenate([lo, lo + 0.05], axis=1)
    pts = rng.random((m, 2)).astype(np.float32)
    if op == "knn":
        return pts
    e = np.float32(0.2 if op == "knn_filtered" else 0.002)
    if op == "knn_join":
        return np.concatenate([pts - e, pts + e], axis=1)
    return np.concatenate([pts, pts - e, pts + e], axis=1)


def call(shards, op, rows):
    if op == "select":
        return shards.range_select(rows)
    return getattr(shards, op)(rows, K)


def assert_same(op, got, want, ctx):
    if op == "select":
        assert len(got) == len(want), ctx
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, ctx
            np.testing.assert_array_equal(g, w, err_msg=ctx)
        return
    np.testing.assert_array_equal(got[0], want[0], err_msg=ctx)
    np.testing.assert_array_equal(
        np.asarray(got[1], np.float64).view(np.int64),
        np.asarray(want[1], np.float64).view(np.int64), err_msg=ctx)
    assert bool(got[2]) == bool(want[2]), ctx


def run_schedule(q, reqs, schedule):
    """Serve ``reqs`` through ``q``: ``sequential`` one at a time, ``burst``
    all submitted before any is read, ``clients`` from three threads."""
    if schedule == "sequential":
        return [q.submit(r).result(timeout=WAIT_S) for r in reqs]
    if schedule == "burst":
        futs = [q.submit(r) for r in reqs]
        return [f.result(timeout=WAIT_S) for f in futs]
    out = [None] * len(reqs)

    def client(cid):
        for i in range(cid, len(reqs), 3):
            out[i] = q.submit(reqs[i]).result(timeout=WAIT_S)
    with cf.ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(client, c) for c in range(3)]:
            f.result(timeout=WAIT_S)
    return out


QUEUE_CELLS = [(op, path, "d1") for op in QUEUEABLE_OPS
               for path in ("host", "mesh")] + \
    [("knn", path, "d3") for path in ("host", "mesh")]


SCHEDULES = ("sequential", "burst", "clients")


@pytest.fixture(scope="module")
def cell_requests(fleets):
    """(op, path, layout) → (requests, the reference's answer to each).
    The reference answers every request's rows in one call: each row is
    answered on its own, so slices of it are the per-request answers."""
    cache = {}

    def get(op, path, layout):
        key = (op, path, layout)
        if key not in cache:
            rng = np.random.default_rng(QUEUE_CELLS.index(key))
            sizes = rng.permutation([1, 2, 3, 5, 8, 11, 1, 4])
            reqs = [make_rows(op, rng, int(m)) for m in sizes]
            want = call(fleets(path, layout)[1], op, np.concatenate(reqs))
            offs = np.cumsum([0] + [len(r) for r in reqs])
            cache[key] = (reqs, [
                want[a:b] if op == "select" else
                (want[0][a:b], want[1][a:b], want[2])
                for a, b in zip(offs[:-1], offs[1:])])
        return cache[key]
    return get


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("op,path,layout", QUEUE_CELLS)
def test_queued_responses_equal_direct_and_reference(fleets, cell_requests,
                                                     op, path, layout,
                                                     schedule):
    """Each schedule submits the cell's requests in its own shuffled
    order, so the coalesced batches differ from schedule to schedule."""
    tsh, _ = fleets(path, layout)
    reqs, refs = cell_requests(op, path, layout)
    order = np.random.default_rng(SCHEDULES.index(schedule)).permutation(
        len(reqs))
    with ServeQueue(tsh, op, k=K if op != "select" else None, max_batch=8,
                    max_delay_s=0.002) as q:
        res = run_schedule(q, [reqs[i] for i in order], schedule)
        q.close()
        summary = q.summary
    assert summary["requests"] == len(reqs)
    assert summary["rows"] == sum(len(r) for r in reqs)
    assert summary["failures"] == summary["retries"] == 0
    for i, got in zip(order, res):
        ctx = f"{op} {path} {layout} {schedule} request {i}"
        assert_same(op, got, call(tsh, op, reqs[i]), ctx + " vs direct")
        assert_same(op, got, refs[i], ctx + " vs reference")


class BlockingEngine:
    """A row-independent fake 'knn' whose calls wait for ``release``:
    dispatches in flight without reading a clock."""

    def __init__(self):
        self.release = threading.Event()
        self.started = threading.Event()
        self.calls = 0

    def knn(self, batch, k):
        self.calls += 1
        self.started.set()
        assert self.release.wait(WAIT_S)
        b = np.asarray(batch, np.float32)
        ids = (b[:, 0] * 1e6).astype(np.int64)[:, None] + np.arange(k)
        return ids, b[:, 1:2].astype(np.float64) + np.arange(k), False


def test_queue_rejects_uncoalescable_ops(fleets):
    tsh, _ = fleets("host", "d1")
    assert QUEUEABLE_OPS == ("select", "knn", "knn_join", "knn_filtered")
    for op, kw in (("join", {}), ("browse", {"k": 4}), ("knn", {})):
        with pytest.raises(ValueError):
            ServeQueue(tsh, op, **kw)
    with pytest.raises(ValueError, match="at least one engine"):
        ServeQueue([], "knn", k=4)


def test_queue_oversized_request_is_served_whole(fleets):
    tsh, _ = fleets("host", "d1")
    rng = np.random.default_rng(41)
    big, small = make_rows("knn", rng, 23), make_rows("knn", rng, 2)
    with ServeQueue(tsh, "knn", k=K, max_batch=8) as q:
        res = [f.result(timeout=WAIT_S)
               for f in [q.submit(big), q.submit(small)]]
        q.close()
        summary = q.summary
    assert summary["padded_rows"] >= 32      # the big one's own bucket
    for rows, got in zip((big, small), res):
        assert_same("knn", got, tsh.knn(rows, K), "oversized")


def test_queue_close_fails_pending_requests_with_queue_closed():
    eng = BlockingEngine()
    rng = np.random.default_rng(53)
    reqs = [rng.random((1, 2)).astype(np.float32) for _ in range(5)]
    q = ServeQueue([eng], "knn", k=3, max_batch=1, depth=1)
    futs = [q.submit(r) for r in reqs]
    assert eng.started.wait(WAIT_S)          # the first dispatch is in flight
    closer = threading.Thread(target=q.close, kwargs={"drain": False})
    closer.start()
    eng.release.set()
    closer.join(WAIT_S)
    assert not closer.is_alive()
    served = closed = 0
    for rows, f in zip(reqs, futs):
        assert f.done()
        try:
            got = f.result(timeout=0)
        except QueueClosed:
            closed += 1
            continue
        served += 1
        assert_same("knn", got, eng.knn(rows, 3), "served before close")
    assert served >= 1 and closed >= 1
    with pytest.raises(QueueClosed):
        q.submit(reqs[0])


def test_queue_close_drains_admitted_requests():
    eng = BlockingEngine()
    eng.release.set()
    rng = np.random.default_rng(59)
    reqs = [rng.random((1, 2)).astype(np.float32) for _ in range(4)]
    q = ServeQueue([eng], "knn", k=3, max_batch=1, depth=1)
    futs = [q.submit(r) for r in reqs]
    q.close()
    for rows, f in zip(reqs, futs):
        assert_same("knn", f.result(timeout=0), eng.knn(rows, 3), "drained")


def test_expired_request_is_never_dispatched():
    eng = BlockingEngine()
    eng.release.set()
    with ServeQueue([eng], "knn", k=3) as q:
        fut = q.submit(np.zeros((2, 2), np.float32), deadline=0.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=WAIT_S)
        q.close()
        summary = q.summary
    assert eng.calls == 0
    assert summary.get("batches", 0) == 0
    assert summary["deadline_exceeded"] == 1


def test_queue_counts_every_request_under_many_threads():
    """A lost update in the queue's stats or its outstanding set would
    show: 16 client threads (more than cores), a short switch interval."""
    eng = BlockingEngine()
    eng.release.set()
    rng = np.random.default_rng(61)
    reqs = [rng.random((int(rng.integers(1, 4)), 2)).astype(np.float32)
            for _ in range(160)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServeQueue([eng, eng], "knn", k=2, max_batch=8, depth=3,
                        max_delay_s=0.0005) as q:
            def client(cid):
                return [(i, q.submit(reqs[i]).result(timeout=WAIT_S))
                        for i in range(cid, len(reqs), 16)]
            with cf.ThreadPoolExecutor(16) as ex:
                parts = [f.result(timeout=WAIT_S) for f in
                         [ex.submit(client, c) for c in range(16)]]
            q.close()
            summary = q.summary
            outstanding = len(q._outstanding)
    finally:
        sys.setswitchinterval(old)
    assert summary["requests"] == len(reqs)
    assert summary["rows"] == sum(len(r) for r in reqs)
    assert outstanding == 0
    for part in parts:
        for i, got in part:
            assert_same("knn", got, eng.knn(reqs[i], 2), f"request {i}")


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["knn", "select"])
def test_replicate_on_named_devices_equals_the_fleet(fleets, op):
    tsh, _ = fleets("host", "d1")
    rows = make_rows(op, np.random.default_rng(43), 8)
    reps = tsh.replicate(devices=["cpu", "cpu"])
    assert len(reps) == 2 and not tsh.mesh_enabled     # self untouched
    assert reps[0]._forest is not reps[1]._forest
    assert reps[0].partitions is tsh.partitions
    want = call(fleets("mesh", "d1")[1], op, rows)     # the reference's mesh
    for rep in reps:
        assert rep.mesh_enabled and rep.device.type == "cpu"
        assert_same(op, call(rep, op, rows), want, f"replica {op}")
    if op == "knn":          # host path: the same neighbours, in id order
        hi, hd, _ = tsh.knn(rows, K)
        gi, gd, _ = reps[0].knn(rows, K)
        np.testing.assert_array_equal(np.sort(gi, 1), np.sort(hi, 1))
        np.testing.assert_array_equal(gd, hd)


def test_replica_devices_follow_the_reference_rule(fleets, monkeypatch):
    tsh, _ = fleets("host", "d1")
    assert tsh.replicate(replicas=1)[0].device.type == "cpu"
    with pytest.raises(ValueError,
                       match="2 replicas need at least 2 devices, have 1"):
        tsh.replicate(replicas=2)
    assert tmesh.replica_devices(None, "cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.replica_devices(2, "cuda") == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    assert len(tmesh.replica_devices(4, "cuda:0")) == 4
    with pytest.raises(ValueError,
                       match="4 devices do not divide into 3 replica"):
        tmesh.replica_devices(3, "cuda")
    with pytest.raises(ValueError, match="5 replicas need at least 5"):
        tmesh.replica_devices(5, "cuda")


def test_queue_over_replicas_round_robins_and_equals_the_fleet(fleets):
    tsh, _ = fleets("mesh", "d1")
    reps = tsh.replicate(devices=["cpu", "cpu"])
    rng = np.random.default_rng(47)
    reqs = [make_rows("knn", rng, m) for m in (2, 3, 1, 4, 2, 5)]
    with ServeQueue(reps, "knn", k=K, max_batch=4) as q:
        res = [q.submit(r).result(timeout=WAIT_S) for r in reqs]
        q.close()
        summary = q.summary
    assert summary["replicas"] == 2 and summary["failures"] == 0
    assert summary["batches"] == len(reqs)
    assert sorted(summary["health"]) == ["healthy", "healthy"]
    for rows, got in zip(reqs, res):
        assert_same("knn", got, tsh.knn(rows, K), "replica queue")
