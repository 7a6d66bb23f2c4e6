"""The port's four examples (``examples/*_torch.py``) on the CPU at tiny
sizes, asserting what their JAX counterparts assert: the quickstart's
batched select agrees with the scalar recursive baseline, the served
fleet answers (q/s > 0), the join analytics' pairs equal a brute-force
numpy join of the same ε-expanded points, and training's loss falls
across a checkpoint resume.  On a box without CUDA each example's default
``--device cuda`` raises instead of running on the CPU."""
import importlib.util
import os

import numpy as np
import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
NAMES = ("quickstart", "serve_spatial", "spatial_join_analytics", "train_lm")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and a
    training loop's thread pools oversubscribed by them ran ~40× slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name: str):
    path = os.path.join(EXAMPLES, f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_select_agrees_with_scalar_baseline():
    out = _example("quickstart").main(["--device", "cpu", "--n", "4000",
                                       "--queries", "8"])
    assert out["hits"] > 0 and len(out["first"]) > 0


def test_serve_spatial_answers():
    out = _example("serve_spatial").main([
        "--device", "cpu", "--n", "4000", "--partitions", "2",
        "--batches", "2", "--batch-size", "8"])
    assert out["qps"] > 0 and out["results"] > 0


def test_spatial_join_pairs_equal_brute_force():
    mod = _example("spatial_join_analytics")
    n = 2000
    out = mod.main(["--device", "cpu", "--n", str(n)])
    _, ra, rb = mod.datasets(n)
    hit = ((ra[:, None, 0] <= rb[None, :, 2]) &
           (ra[:, None, 2] >= rb[None, :, 0]) &
           (ra[:, None, 1] <= rb[None, :, 3]) &
           (ra[:, None, 3] >= rb[None, :, 1]))
    want = np.argwhere(hit)
    got = out["pairs"]
    assert len(want) > 0 and len(got) == len(want)
    assert np.array_equal(got[np.lexsort((got[:, 1], got[:, 0]))], want)
    assert out["grid"].sum() == len(want)


def test_train_lm_loss_falls_across_resume():
    out = _example("train_lm").main(["--device", "cpu", "--steps", "20",
                                     "--batch", "4", "--seq", "64"])
    assert out["start_step"] == 10
    assert out["last_loss"] < out["first_loss"]


@pytest.mark.parametrize("name", NAMES)
def test_default_device_refuses_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a box without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([])
