"""The training step (the reference's ``train/train_step.py``): loss →
grad → (optional int8 error-feedback compression) → clip → AdamW /
Adafactor, the parameters and the optimizer state updated in place (what
the reference's donation does).

Microbatching (gradient accumulation) runs the microbatches one after the
other and sums their grads in float32 buffers, as the reference's scan
sums into its float32 ``zero`` accumulator; the optimizer then sees their
mean in float32.  With one microbatch it sees the grads in the
parameters' dtype, as the reference's does.

The sharding hooks (``distributed/sharding.py``): ``act_shard``,
``logit_shard`` and ``moe_cap_shard`` go to ``Model.loss_fn``;
``grad_shardings`` (``sharding.param_placements``: ``Leaf.key`` → the
placements of its parameters) redistributes each grad to them as soon as
it is produced.  With DTensor parameters the step, backward and update
included, runs under ``implicit_replication()``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..distributed.sharding import replicating
from ..distributed.shards import like, reduce_partial, replicate_dims
from ..models import transformer
from ..models.model import Model
from . import compression as comp
from . import optimizer as opt


def _grads(model: Model, params, leaves, batch, remat: bool, hooks,
           grad_shardings):
    """→ (loss, metrics, grads per leaf), every tensor detached."""
    loss, metrics = model.loss_fn(params, batch, remat=remat, **hooks)
    flat = torch.autograd.grad(loss, [p for leaf in leaves
                                      for p in leaf.params])
    it = iter(flat)
    grads = [[next(it) for _ in leaf.params] for leaf in leaves]
    if grad_shardings is not None:
        grads = [[g.redistribute(g.device_mesh, grad_shardings[leaf.key])
                  for g in gs] for leaf, gs in zip(leaves, grads)]
    # a DTensor loss summed over its shards (a scalar's all-reduce), so
    # that every microbatch adds alike into the running loss
    return reduce_partial(loss.detach()), \
        {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, oc: opt.OptConfig, *,
                    microbatches: int = 1, act_shard=None,
                    logit_shard=None, grad_shardings=None,
                    moe_cap_shard=None, compress: bool = False,
                    remat: bool = True):
    """→ step(params, opt_state, err_state, batch) → (params, opt_state,
    err_state, metrics): ``params`` (the ``Transformer``) and the states
    updated in place.  ``err_state`` is None unless ``compress``.  The
    batch's leading axis splits into ``microbatches`` equal parts."""
    hooks = dict(act_shard=act_shard, logit_shard=logit_shard,
                 moe_cap_shard=moe_cap_shard)

    def step(params, opt_state, err_state, batch: Dict[str, torch.Tensor]):
        with replicating(params):
            return run(params, opt_state, err_state, batch)

    def run(params, opt_state, err_state, batch):
        leaves = transformer.leaf_map(model.cfg, params)
        if microbatches == 1:
            loss, metrics, grads = _grads(model, params, leaves, batch, remat,
                                          hooks, grad_shardings)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            # like their parameters: a DTensor's accumulator carries its
            # placements
            grads = [[torch.zeros_like(p, dtype=torch.float32)
                      for p in leaf.params] for leaf in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            ms = []
            # a DTensor batch's rows (over 'data') gathered once, so that a
            # microbatch is a local slice, which then takes the batch's
            # placements again (slicing a sharded dim would gather the
            # whole batch for every microbatch)
            rows = {k: replicate_dims(v, (0,)) for k, v in batch.items()}
            for i in range(microbatches):
                mb = {k: like(v[i * n:(i + 1) * n], batch[k])
                      for k, v in rows.items()}
                l, m, g = _grads(model, params, leaves, mb, remat, hooks,
                                 grad_shardings)
                for acc, new in zip(grads, g):
                    for a, x in zip(acc, new):
                        a.add_(x)
                loss = loss + l
                ms.append(m)
            grads = [[a / microbatches for a in acc] for acc in grads]
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if compress:
            grads, err_state = comp.apply(leaves, grads, err_state)
        opt_state, om = opt.update(oc, leaves, grads, opt_state)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, err_state, metrics

    return step


# the reference's un-jitted builder (its dry run lowers it with explicit
# shardings); here both are the same eager step
make_train_step_fn = make_train_step


def init_train_state(model: Model, oc: opt.OptConfig,
                     generator: torch.Generator, *, device="cuda",
                     compress: bool = False):
    """→ (params from ``generator`` on ``device``, optimizer state, error
    state or None)."""
    params = model.init_params(generator, device=device)
    leaves = transformer.leaf_map(model.cfg, params)
    err_state = comp.init_error(leaves) if compress else None
    return params, opt.init_opt(oc, leaves), err_state
