"""Port (repro_torch) ≡ reference (repro): the traced cost model.

The reference's ``tests/test_hlo_cost.py`` cases as the port's
counterparts, on the meta device in this process:

- the grad of ``tanh(x @ w).sum()``: the trace's FLOPs within 2% of the
  reference's ``hlo_cost.analyse_text`` of the same jitted function;
- ``einsum("bij,bjk->bik")`` counts exactly 2·4·8·16·32;
- the collective byte formulas: an all-reduce of f32[64] over a group of
  4 moves 384 bytes, a permute 256;
- the reduced tinyllama train step on one device (``remat=False`` on both
  sides, so that XLA's CSE cannot drop a recomputed product): the port's
  matmul FLOPs within 2% of the dot rows of the reference's
  ``hlo_cost.top_contributors`` for the same step;
- the counterpart of the reference's trip-count weighting: ``cell_cost``
  (one and two layer units, and two and three microbatches, traced and
  extrapolated) equals a whole trace of the reduced
  configs, on one device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed import hlo_cost
from repro.models.model import Model as JModel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import trace_cost
from repro_torch.launch import dryrun

TOL = 0.02
TRAIN = ShapeSpec("train_s64", 64, 4, "train")


def _meta(*shape, grad=False):
    return torch.empty(shape, dtype=torch.float32, device="meta",
                       requires_grad=grad)


def test_scan_free_flops_match_reference():
    def g(w, x):
        return jnp.tanh(x @ w).sum()

    c = jax.jit(jax.grad(g)).lower(
        jax.ShapeDtypeStruct((128, 256), jnp.float32),
        jax.ShapeDtypeStruct((32, 128), jnp.float32)).compile()
    want = hlo_cost.analyse_text(c.as_text()).flops
    w, x = _meta(128, 256, grad=True), _meta(32, 128)
    rep, _ = trace_cost.trace(
        lambda: torch.autograd.grad(torch.tanh(x @ w).sum(), w))
    assert abs(rep.flops - want) / want < TOL, (rep.flops, want)
    assert rep.matmul_flops == 2 * 2 * 32 * 256 * 128


def test_dot_flops_contracting_dims():
    rep, _ = trace_cost.trace(torch.einsum, "bij,bjk->bik", _meta(4, 8, 16),
                              _meta(4, 16, 32))
    assert rep.flops == 2 * 4 * 8 * 16 * 32
    assert rep.bytes_ideal == 4 * (4 * 8 * 16 + 4 * 16 * 32 + 4 * 8 * 32)


def test_collective_bytes_formulas():
    # all-reduce: 2·(n-1)/n·256 = 384; permute: 256 (the reference's
    # f32[64] over replica groups of 4)
    assert trace_cost.collective_moved("all-reduce", 256, 256, 4) == 384
    assert trace_cost.collective_moved("collective-permute", 256, 256,
                                       4) == 256
    assert trace_cost.collective_moved("all-gather", 64, 256, 4) == 192
    assert trace_cost.collective_moved("reduce-scatter", 256, 64, 4) == 192


def _ref_train_step_dots(cfg):
    """Σ FLOPs of the dot rows of ``top_contributors`` for the
    reference's reduced train step (remat off, one device)."""
    model = JModel(cfg)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    oc = jopt.OptConfig()
    state = jax.eval_shape(lambda p: jopt.init_opt(oc, p), params)
    b, s = TRAIN.global_batch, TRAIN.seq_len
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
             for k in ("tokens", "labels")}
    step = jts.make_train_step_fn(model, oc, microbatches=1, remat=False)
    text = jax.jit(lambda p, o, bt: step(p, o, None, bt)).lower(
        params, state, batch).compile().as_text()
    rows = hlo_cost.top_contributors(text, n=10 ** 6)
    return sum(f for f, _, op, _, _ in rows if op in ("dot", "convolution"))


def test_reduced_train_step_matmul_flops_match_reference():
    arch = "tinyllama-1.1b"
    want = _ref_train_step_dots(jreg.reduced_config(jreg.get(arch)))
    run, _, _ = dryrun.build_step(
        arch, TRAIN, cfg=registry.reduced_config(registry.get(arch)),
        remat=False, microbatches=1)
    rep, _ = trace_cost.trace(run)
    assert abs(rep.matmul_flops - want) / want < TOL, (rep.matmul_flops,
                                                        want)


def _reduced(arch, **over):
    return dataclasses.replace(registry.reduced_config(registry.get(arch)),
                               **over)


# (arch, config changes, shape, microbatches): enough layer units that
# cell_cost extrapolates (three and more), and microbatches (four)
EXTRAPOLATED = (
    ("tinyllama-1.1b", {"n_layers": 4}, TRAIN, 4),
    ("llama4-maverick-400b-a17b", {"n_layers": 6}, TRAIN, 2),
    ("zamba2-7b", {"n_layers": 10}, TRAIN, None),
    ("falcon-mamba-7b", {"n_layers": 3},
     ShapeSpec("prefill_s512", 512, 2, "prefill"), None),
    ("h2o-danube-1.8b", {"n_layers": 3, "window": 128},
     ShapeSpec("prefill_s1024", 1024, 2, "prefill"), None),
    ("grok-1-314b", {"n_layers": 3},
     ShapeSpec("decode_s64", 64, 4, "decode"), None),
)


@pytest.mark.parametrize("arch,over,shape,mb", EXTRAPOLATED,
                         ids=[c[0] for c in EXTRAPOLATED])
def test_multiplied_count_equals_whole_trace(arch, over, shape, mb):
    """The reference multiplies a scanned layer by its trip count; the
    port extrapolates one and two layer units and two and three
    microbatches: every figure equals a whole trace of the model."""
    cfg = _reduced(arch, **over)
    kw = dict(cfg=cfg, microbatches=mb)
    got, _, _ = dryrun.cell_cost(arch, shape, **kw)
    assert got.unit_counts["traced_units"] == [1, 2]
    if shape.kind == "train" and mb == 4:
        assert got.unit_counts["traced_microbatches"] == [2, 3]
    run, _, _ = dryrun.build_step(arch, shape, **kw)
    want, _ = trace_cost.trace(run)
    for f in ("flops", "bytes", "bytes_ideal", "transcendental",
              "matmul_flops"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=1e-9), f
