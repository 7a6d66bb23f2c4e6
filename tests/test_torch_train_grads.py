"""Port (repro_torch) ≡ reference (repro): the training loss and every
parameter's gradient (ROADMAP A14c), for one reduced float32 config of
each layer pattern: tinyllama-1.1b (dense), h2o-danube-1.8b (dense,
sliding window 32), musicgen-large (audio prefix), paligemma-3b (vlm
prefix), grok-1-314b (MoE every layer), llama4-maverick (MoE every 2),
falcon-mamba-7b (Mamba1) and zamba2-7b (Mamba2 units and the shared
block).

The same weights (the reference's ``init`` through ``params_from_jax``)
and the same batch from ``default_rng`` (2 sequences of 32 positions, a
few labels -100) go through ``jax.value_and_grad(Model.loss_fn)`` and the
port's ``loss_fn`` with ``torch.autograd.grad``.  The grads come back in
the reference's layout through ``transformer.leaf_map``.  Tolerances:
loss and metrics 1e-5 relative; each leaf's grad 1e-4 norm-relative.
Remat on and off give the same loss and grads bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from lm_parity import rel
from repro_torch.models import transformer as TT
from train_parity import GRAD_TOL, LOSS_TOL, PATTERN_ARCHS, batches, \
    models, paths, port_leaves, worst

B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Single-threaded PyTorch in this module: its tensors are small, and
    parallel test workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    p0 = cfg.frontend_tokens if cfg.frontend != "none" else 0
    toks = rng.integers(0, cfg.vocab, (B, S - p0)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S - p0)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, -2:] = -100
    out = {"tokens": toks, "labels": labels}
    if p0:
        out["frontend"] = rng.standard_normal((B, p0, cfg.d_model),
                                              dtype=np.float32)
    return out


@pytest.mark.parametrize("arch", PATTERN_ARCHS)
def test_loss_metrics_and_grads_equal_reference(arch):
    """``loss_fn``'s loss, ``ce``, ``aux``, ``z`` and ``tokens``, and the
    grad of every leaf of the reference's tree (each parameter in exactly
    one leaf), against ``jax.value_and_grad``; remat on ≡ off."""
    jcfg, tcfg, jm, tm, jp, tp = models(arch)
    jb, tb = batches(_batch(jcfg))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b), has_aux=True))(jp, jb)
    leaves = TT.leaf_map(tcfg, tp)
    flat = [p for leaf in leaves for p in leaf.params]
    assert len(flat) == len(list(tp.parameters()))
    assert {leaf.path for leaf in leaves} == set(paths(jp))
    runs = {}
    for remat in (True, False):
        loss, met = tm.loss_fn(tp, tb, remat=remat)
        runs[remat] = loss, met, torch.autograd.grad(loss, flat)
    loss, met, flat_grads = runs[True]
    assert set(met) == set(jmet)
    for name in met:
        assert rel(met[name], jmet[name]) < LOSS_TOL, name
    assert int(met["tokens"]) == B * (S - (jcfg.frontend_tokens if
                                           jcfg.frontend != "none"
                                           else 0)) - 5
    if jcfg.family == "moe":
        assert float(met["aux"].detach()) > 0
    it = iter(flat_grads)
    grads = [[next(it) for _ in leaf.params] for leaf in leaves]
    key, err = worst(port_leaves(leaves, grads), paths(jgrads))
    assert err < GRAD_TOL, (key, err)
    off_loss, off_met, off_grads = runs[False]
    assert torch.equal(off_loss, loss)
    for a, b in zip(off_grads, flat_grads):
        assert torch.equal(a, b)
