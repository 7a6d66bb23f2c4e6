"""Port (repro_torch) ≡ reference (repro): the train step, checkpointed
restarts and the training CLI (ROADMAP A14c).

- three train steps on the reduced float32 tinyllama-1.1b from the same
  weights and ``SyntheticLM`` batches as the reference's jitted step:
  AdamW; Adafactor over 2 microbatches, without and with int8
  error-feedback compression; AdamW over 2 microbatches with compression.
  Losses and metrics each step within 1e-5 relative; after the third step
  every leaf's params, optimizer state and error state within 1e-4
  norm-relative (``train_parity``), with two exceptions held instead by
  the share of their elements (over every leaf) more than 1e-5 from the
  reference, bounded by 1e-3.  The error state: it is the small residual g -
  deq(q(g)), whose cancellation turns a last-bit difference of g into a
  large relative one.  And AdamW with compression: a grad element at an
  int8 rounding boundary rounds to 0 in one package and to ±scale in the
  other when the two differ in its last bits, and Adam turns that into 0
  or ±lr (measured: at most 21 elements in a leaf of 196,608 and 4 in one
  of 16,384; 75 of the model's 820,352, a share of 9.1e-5);
- ``run_with_restarts`` with ``FailurePlan(fail_at=(6, 9))`` ≡ an
  uninterrupted run, bit for bit; ``FaultPlan.crash_at_steps`` ≡ the
  reference's clauses;
- ``python -m repro_torch.launch.train --reduced --device cpu`` trains,
  resumes from its latest committed checkpoint with ``--resume``, and
  raises without CUDA unless ``--device cpu`` is given.
"""
import jax
import numpy as np
import pytest
import torch

from lm_parity import rel
from repro.runtime import fault_tolerance as jft
from repro.runtime import faults as jfaults
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import faults as tfaults
from repro_torch.train import compression as tcomp
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from train_parity import GRAD_TOL, LOSS_TOL, batches, models, paths, \
    port_leaves, worst

ARCH, B, S, STEPS = "tinyllama-1.1b", 2, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Single-threaded PyTorch in this module: its tensors are small, and
    parallel test workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLIP_ABS, FLIP_SHARE = 1e-5, 1e-3


def _flip_share(got: dict, want: dict) -> float:
    """The share of all the leaves' elements more than ``FLIP_ABS`` from
    the reference."""
    assert set(got) == set(want)
    apart = sum(int((np.abs(got[k].detach().numpy() - want[k])
                     > FLIP_ABS).sum()) for k in want)
    return apart / sum(want[k].size for k in want)


@pytest.mark.parametrize("kind,microbatches,compress", (
    ("adamw", 1, False), ("adafactor", 2, False), ("adafactor", 2, True),
    ("adamw", 2, True)))
def test_train_steps_equal_reference(kind, microbatches, compress):
    jcfg, tcfg, jm, tm, jp, tp = models(ARCH)
    kw = dict(kind=kind, lr=1e-2, warmup_steps=1, total_steps=10)
    joc, oc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jstep = jts.make_train_step(jm, joc, microbatches=microbatches,
                                compress=compress, donate=False)
    step = tts.make_train_step(tm, oc, microbatches=microbatches,
                               compress=compress)
    leaves = TT.leaf_map(tcfg, tp)
    jo, to = jopt.init_opt(joc, jp), topt.init_opt(oc, leaves)
    je = jts.comp.init_error(jp) if compress else None
    te = tcomp.init_error(leaves) if compress else None
    pipe = tdata.SyntheticLM(jcfg.vocab, S, B, seed=3)
    for s in range(STEPS):
        jb, tb = batches(pipe.batch_at(s))
        jp, jo, je, jm_ = jstep(jp, jo, je, jb)
        tp, to, te, tm_ = step(tp, to, te, tb)
        assert set(tm_) == set(jm_)
        for name in tm_:
            assert rel(tm_[name], jm_[name]) < LOSS_TOL, (s, name)
    by_key = {leaf.key: leaf.path for leaf in leaves}
    fields = ("mu", "nu") if kind == "adamw" else ("vr", "vc")
    flips = kind == "adamw" and compress
    pairs = [(port_leaves(leaves), paths(jp), flips)] + [
        ({by_key[k]: v for k, v in getattr(to, f).items()},
         paths(getattr(jo, f)), flips) for f in fields]
    if compress:
        pairs.append(({by_key[k]: v for k, v in te.items()}, paths(je),
                      True))
    for got, want, by_share in pairs:
        if by_share:
            share = _flip_share(got, want)
            assert share <= FLIP_SHARE, share
        else:
            key, err = worst(got, want)
            assert err < GRAD_TOL, (key, err)
    assert int(to.step) == int(jo.step) == STEPS


def test_restarts_bit_exact_and_crash_schedule(tmp_path):
    """Training interrupted before steps 6 and 9 ends with the same
    params and optimizer state, bit for bit, as an uninterrupted run
    (deterministic data and steps, committed checkpoints every 4 steps);
    the training-side crash schedule ≡ the reference's clauses."""
    _, cfg, _, model, _, _ = models(ARCH)
    oc = topt.OptConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    pipe = tdata.SyntheticLM(cfg.vocab, S, 4, seed=11)
    step_fn = tts.make_train_step(model, oc)

    def init_state():
        p, o, _ = tts.init_train_state(
            model, oc, torch.Generator().manual_seed(4), device="cpu")
        return {"params": p, "opt": o}

    def one_step(step, state):
        _, tb = batches(pipe.batch_at(step))
        p, o, _, _ = step_fn(state["params"], state["opt"], None, tb)
        return {"params": p, "opt": o}

    def run(name, plan):
        return ft.run_with_restarts(
            ckpt_dir=str(tmp_path / name), total_steps=12,
            init_state=init_state, step_fn=one_step, save_every=4,
            failure_plan=plan)

    (a, restarts), (b, none) = run("a", ft.FailurePlan(fail_at=(6, 9))), \
        run("b", ft.FailurePlan())
    assert (restarts, none) == (2, 0)
    assert int(a["opt"].step) == 12
    for (ka, va), (kb, vb) in zip(a["params"].state_dict().items(),
                                  b["params"].state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    for field in ("mu", "nu"):
        for k, v in getattr(a["opt"], field).items():
            assert torch.equal(v, getattr(b["opt"], field)[k]), k

    got = tfaults.FaultPlan.crash_at_steps((2, 5, 5))
    want = jfaults.FaultPlan.crash_at_steps((2, 5, 5))
    assert str(got) == str(want) == "crash:r0@2,crash:r0@5,crash:r0@5"
    for n in range(8):
        (gd, ge), (wd, we) = got.faults_for(0, n), want.faults_for(0, n)
        assert gd == wd and type(ge).__name__ == type(we).__name__
        assert str(ge) == str(we)
    plans = ft.FailurePlan(fail_at=(2,)), jft.FailurePlan(fail_at=(2,))
    for plan in plans:
        plan.maybe_fail(1)
        with pytest.raises(RuntimeError, match="injected failure at step 2"):
            plan.maybe_fail(2)
        plan.maybe_fail(2)                   # once each


def test_train_cli_trains_and_resumes(tmp_path, capsys, monkeypatch):
    """``launch.train --reduced --device cpu`` trains (the loss falls) and
    checkpoints; ``--resume`` starts from the latest committed step; the
    default device is cuda, which raises without CUDA."""
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--lr", "3e-3", "--ckpt-dir", str(tmp_path), "--save-every", "5",
            "--log-every", "5"]
    out = train.main(argv + ["--steps", "20"])
    assert out["start_step"] == 0 and out["last_loss"] < out["first_loss"]
    again = train.main(argv + ["--steps", "25", "--resume"])
    assert again["start_step"] == 20
    assert "resumed from step 20" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])
