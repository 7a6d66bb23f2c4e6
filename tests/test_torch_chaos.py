"""Port (repro_torch) ≡ reference (repro): the serve queue under seeded
fault injection.

The reference's chaos fleet (5,000 points, 4 partitions, fanout 64) serves
kNN through two logical replicas — one fleet listed twice, on the host
path and on the mesh path — under kill, crash, every-replica-dead and
no-fallback plans, requests submitted one at a time so that routing is a
function of the plan alone.  The health trackers run on fake clocks with
the latency transitions off (a JAX compile's first-call latency would
otherwise mark a replica suspect), so no wall-clock latency decides one.
The port's ``summary`` counters must equal the reference's on the same
plan and schedule, for every counter on which two runs of the reference
agree; no request may fail; every response must equal the fault-free
run's.  Inputs are made with numpy from a seed and handed to both
packages; every future is waited on with a timeout.
"""
import numpy as np
import pytest

from repro.launch.queue import ServeQueue as JQueue
from repro.runtime import faults as jfaults
from repro.runtime import health as jhealth
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch.queue import ServeQueue as TQueue
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import health as thealth

from conftest import uniform_rects
from oracle import _shards_for

WAIT_S = 60.0
K = 4
# summary keys a deterministic schedule fixes (the per-replica states are
# compared as ``health``)
COUNTERS = ("batches", "requests", "rows", "padded_rows", "retries",
            "dispatch_failures", "deadline_exceeded", "degraded_dispatches",
            "reissues", "failures", "pool_by_shard", "replicas",
            "quarantines", "probes", "health", "rows_per_dispatch")


class FrozenClock:
    """A health clock that never advances: a quarantine lasts the run."""

    def __call__(self):
        return 0.0


@pytest.fixture(scope="module")
def fleets():
    rects = uniform_rects(np.random.default_rng(21), 5000, eps=0.0)
    tsh = TShards.build(rects, 4, fanout=64, device="cpu")
    return {"host": (tsh, _shards_for(rects, 4, 64, mesh=False)),
            "mesh": (TShards(tsh.partitions, 64).enable_mesh(),
                     _shards_for(rects, 4, 64))}


def make_requests(n, seed=31, m=2):
    rng = np.random.default_rng(seed)
    return [rng.random((m, 2)).astype(np.float32) for _ in range(n)]


def run(pkg, shards, reqs, spec, *, replicas=2, fallback=True,
        quarantine_after=3, **qkw):
    """Serve ``reqs`` one at a time through ``pkg``'s queue over
    ``replicas`` copies of ``shards`` under the plan ``spec`` (None: no
    injection).  Returns (responses, or the exception each raised;
    summary; injector)."""
    queue_cls, faults, health = pkg
    injector = None if spec is None else faults.FaultInjector(
        faults.FaultPlan.from_spec(spec, seed=0))
    tracker = health.HealthTracker(replicas,
                                   quarantine_after=quarantine_after,
                                   cooldown_s=1000.0, slow_factor=1e9,
                                   suspect_factor=1e9, clock=FrozenClock())
    q = queue_cls([shards] * replicas, "knn", k=K, max_batch=8,
                  max_delay_s=0.002, injector=injector, health=tracker,
                  fallback=shards.host_view() if fallback else None, **qkw)
    out = []
    try:
        for r in reqs:
            try:
                out.append(q.submit(r).result(timeout=WAIT_S))
            except faults.InjectedFault as exc:
                out.append(exc)
    finally:
        q.close()
    # settle the pool: every engine call's outcome recorded
    q.pool._pool.shutdown(wait=True)
    return out, q.summary, injector


JAX = (JQueue, jfaults, jhealth)
TORCH = (TQueue, tfaults, thealth)


def assert_counters_equal_reference(shards_pair, reqs, spec, **kw):
    """The port's summary against two runs of the reference: every
    counter the two reference runs agree on must be the port's too.
    Returns the port's (responses, summary, injector)."""
    tsh, jsh = shards_pair
    ref1 = run(JAX, jsh, reqs, spec, **kw)
    ref2 = run(JAX, jsh, reqs, spec, **kw)
    got = run(TORCH, tsh, reqs, spec, **kw)
    agreed = [c for c in COUNTERS
              if ref1[1].get(c) == ref2[1].get(c)]
    # what the plan fixes: if the reference disagreed with itself here,
    # the schedule would not be a function of the plan
    assert {"requests", "failures", "reissues", "retries", "quarantines",
            "degraded_dispatches", "health"} <= set(agreed)
    for c in agreed:
        assert got[1].get(c) == ref1[1].get(c), (c, got[1], ref1[1])
    if spec is not None:
        assert dict(got[2].dispatches) == dict(ref1[2].dispatches)
        assert dict(got[2].injected) == dict(ref1[2].injected)
    return got


def assert_same_responses(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert not isinstance(g, BaseException), (i, g)
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"request {i}")
        np.testing.assert_array_equal(
            g[1].view(np.int64), w[1].view(np.int64), err_msg=f"req {i}")


PLANS = {
    # name: (spec, run kwargs, expected port summary entries)
    "kill": ("kill:r1@2", {}, {
        "failures": 3, "reissues": 3, "quarantines": 1,
        "degraded_dispatches": 0, "health": ["healthy", "quarantined"]}),
    "crash": ("crash:r0@1", {}, {
        "failures": 1, "reissues": 1, "quarantines": 0,
        "health": ["healthy", "healthy"]}),
    "all_dead": ("kill:r0@0,kill:r1@0",
                 {"quarantine_after": 1, "max_retries": 1,
                  "backoff_s": 0.001}, {
                     "quarantines": 2,
                     "health": ["quarantined", "quarantined"]}),
}


@pytest.mark.parametrize("path", ["host", "mesh"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_chaos_counters_equal_reference_and_no_request_fails(fleets, plan,
                                                             path):
    spec, kw, expect = PLANS[plan]
    reqs = make_requests(12)
    clean = run(TORCH, fleets[path][0], reqs, None, **kw)[0]
    res, summary, inj = assert_counters_equal_reference(
        fleets[path], reqs, spec, **kw)
    for key, want in expect.items():
        assert summary[key] == want, (key, summary)
    assert summary["requests"] == len(reqs)
    assert summary["failures"] == inj.injected["exceptions"]
    if plan == "all_dead":
        assert summary["degraded_dispatches"] == len(reqs)
    if plan == "kill":
        assert inj.dispatches[1] == 5        # none after the quarantine
    assert_same_responses(res, clean)
    for rows, got in zip(reqs, res):         # and the direct fleet call
        assert_same_responses([got], [fleets[path][0].knn(rows, K)])


@pytest.mark.parametrize("path", ["host", "mesh"])
def test_no_fallback_propagates_the_injected_error_as_the_reference(
        fleets, path):
    """No fallback: once the retry budget is spent the injected error
    reaches the client's future, in both packages alike."""
    reqs = make_requests(3, seed=37)
    kw = dict(replicas=1, fallback=False, quarantine_after=100,
              max_retries=1, backoff_s=0.001)
    res, summary, inj = assert_counters_equal_reference(
        fleets[path], reqs, "kill:r0@1", **kw)
    assert not isinstance(res[0], BaseException)
    assert all(isinstance(r, tfaults.ReplicaDead) for r in res[1:])
    assert summary["dispatch_failures"] == 4 and summary["retries"] == 2
    assert summary["failures"] == inj.injected["exceptions"] == 4


def test_seeded_flaky_sweep_is_deterministic_and_exact(fleets):
    reqs = make_requests(10, seed=41)
    spec = "flaky:r0:0.4,flaky:r1:0.3"
    kw = dict(quarantine_after=100, backoff_s=0.001)
    res, summary, inj = assert_counters_equal_reference(
        fleets["host"], reqs, spec, **kw)
    assert inj.injected["exceptions"] > 0
    assert summary["failures"] == inj.injected["exceptions"]
    assert_same_responses(res, run(TORCH, fleets["host"][0], reqs, None,
                                   **kw)[0])
