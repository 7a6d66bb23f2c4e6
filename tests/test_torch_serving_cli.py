"""Port (repro_torch) ≡ reference (repro): ``serve --queue``,
``--chaos`` and ``--replicas`` through ``launch.serve.main`` at the
``--dryrun`` sizes on the CPU: every queued response equals the direct
runner's, no chaos plan fails a request, the modes that do not coalesce
serve synchronously, replicas beyond the devices raise as the
reference's do, and the flags keep the reference's defaults."""
import numpy as np
import pytest

from repro_torch.launch import serve


# ---------------------------------------------------------------------------
# serve --queue / --chaos / --replicas
# ---------------------------------------------------------------------------

QUEUED_MODES = ("spatial", "knn", "knn-join", "knn-filtered")


@pytest.mark.parametrize("mesh", ["off", "on"])
@pytest.mark.parametrize("mode", QUEUED_MODES)
def test_serve_queue_dryrun_equals_the_direct_runner(mode, mesh):
    """``--queue --dryrun`` holds every response to the direct call; its
    first response is the synchronous runner's first batch."""
    argv = ["--mode", mode, "--dryrun", "--device", "cpu", "--mesh", mesh]
    out = serve.main(argv + ["--queue"])
    sync = serve.main(argv)
    assert out["failed_requests"] == out["failures"] == 0
    assert out["retries"] == out["degraded_dispatches"] == 0
    assert sorted(out["results"]) == [0, 1, 2, 3]
    assert 1 <= out["dispatches"] <= 4
    first = out["results"][0]
    if mode == "spatial":
        for a, b in zip(first, sync["first_batch"]):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(first[0], sync["first_batch"][0])
        np.testing.assert_array_equal(first[1], sync["first_batch"][1])


@pytest.mark.parametrize("mode,chaos", [("knn", "crash:r0@3"),
                                        ("spatial", "kill:r0@2"),
                                        ("knn-join", "flaky:r0:0.3")])
def test_serve_queue_chaos_dryrun_has_no_failed_request(mode, chaos):
    out = serve.main(["--mode", mode, "--dryrun", "--device", "cpu",
                      "--queue", "--chaos", chaos])
    assert out["failed_requests"] == 0 and len(out["results"]) == 20
    assert out["injected_exceptions"] > 0
    assert out["failures"] == out["injected_exceptions"]
    if chaos.startswith("kill"):          # one replica: the host fallback
        assert out["degraded_dispatches"] > 0


@pytest.mark.parametrize("mode", ["join", "browse"])
def test_serve_queue_on_an_uncoalescable_mode_serves_synchronously(
        mode, capsys):
    out = serve.main(["--mode", mode, "--dryrun", "--device", "cpu",
                      "--queue"])
    assert "does not coalesce" in capsys.readouterr().out
    assert "results" not in out and not out["overflow"]


def test_serve_replicas_beyond_the_devices_raise():
    for extra in ([], ["--queue", "--mode", "knn"]):
        with pytest.raises(ValueError, match="2 replicas need at least 2"):
            serve.main(["--dryrun", "--device", "cpu", "--mesh", "on",
                        "--replicas", "2"] + extra)
    # off the mesh path the one fleet serves alone, as in the reference
    out = serve.main(["--mode", "knn", "--dryrun", "--device", "cpu",
                      "--queue", "--replicas", "2", "--mesh", "off"])
    assert out["failed_requests"] == 0


def test_serve_flags_have_the_reference_defaults(monkeypatch):
    seen = {}

    def runner(args, spec):
        seen.update(vars(args))
        return {}
    monkeypatch.setattr(serve, "_serve_queued", runner)
    serve.main(["--queue", "--device", "cpu"])
    assert {k: seen[k] for k in ("queue", "clients", "chaos", "replicas",
                                 "max_batch", "max_delay", "depth",
                                 "device")} == dict(
        queue=True, clients=8, chaos="", replicas=1, max_batch=256,
        max_delay=0.002, depth=2, device="cpu")
