"""Optimizers from scratch: AdamW and Adafactor, global-norm clipping,
warmup + cosine schedule (the reference's ``train/optimizer.py``).

The reference's state is a pytree shaped like (or factored from) its
*stacked* parameter leaves, and it decides weight decay and Adafactor's
factoring by a leaf's ``ndim``.  The port keeps that: the optimizer walks
``transformer.leaf_map``'s leaves, keeps its state in the leaves' stacked
shapes (keyed by ``Leaf.key``), and reads ``ndim`` from the stacked
shape.  So every layer's norms, biases, ``d_skip`` and ``dt_bias``
((L, d) stacked) are decayed, ``final_norm`` and the hybrid's shared
block's norms ((d,)) are not, and Adafactor factors an (L, d) leaf across
layers: ``vr`` (L,), ``vc`` (d,).  Where the factoring stays within a
layer (a leaf whose parameters are matrices), each parameter is updated
alone through views of the stacked state; otherwise the leaf's tensors
are stacked for the update.  Parameters are updated in place (the
reference donates them); the schedule and the bias corrections are
float32 tensors, as ``jnp`` computes them.  Where the parameters are
DTensors the state is too: a moment shards like its parameter, and a
factored one keeps the placements of the dims it keeps (the reference's
dry run, ``_opt_specs``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..models.transformer import Leaf, rows, stack

Grads = List[List[torch.Tensor]]       # per leaf, a tensor a parameter


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32, 0-d
    mu: Dict[str, torch.Tensor]         # by leaf key, the leaf's shape
    nu: Dict[str, torch.Tensor]


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Dict[str, torch.Tensor]   # row second moment (the full moment for
    #                               a leaf of rank < 2)
    vc: Dict[str, torch.Tensor]   # column second moment (0-d for rank < 2)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` × lr: float32."""
    s = step.float()
    warm = torch.clamp(s / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - oc.warmup_steps) /
                       max(oc.total_steps - oc.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * cos
    return oc.lr * warm * frac


def global_norm(grads: Grads) -> torch.Tensor:
    """sqrt of the leaves' float32 sums of squares."""
    # summed from the first term on (Python's sum would start at 0, which a
    # DTensor's partial sum first reduces): the same values, and every
    # layer's grads add alike
    leaves = [functools.reduce(operator.add, (
        torch.sum(torch.square(g.float())) for g in gs)) for gs in grads]
    return torch.sqrt(functools.reduce(operator.add, leaves))


def clip_by_global_norm(grads: Grads, max_norm: float
                        ) -> Tuple[Grads, torch.Tensor]:
    """Scale every grad by min(1, max_norm / norm) in float32 and cast it
    back to its dtype → (grads, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [[(g.float() * scale).to(g.dtype) for g in gs]
            for gs in grads], gn


def _zeros(leaf: Leaf, shape) -> torch.Tensor:
    """Float32 zeros of ``shape`` for a leaf's state, led by its stacked
    axes: a DTensor where the leaf's parameters are one, each of their
    shards moved past the stacked axes and dropped where ``shape`` ends
    first."""
    p = leaf.params[0]
    if type(p) not in (torch.Tensor, torch.nn.Parameter):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        if isinstance(p, DTensor):
            n = len(leaf.lead)
            mesh = p.device_mesh
            place = [Shard(pl.dim + n) if pl.is_shard() and
                     pl.dim + n < len(shape) else Replicate()
                     for pl in p.placements]
            # the local shard on the parameters' own device (the meta
            # device in the dry run), not on the mesh's device type
            local, _ = compute_local_shape_and_global_offset(
                tuple(shape), mesh, place)
            z = torch.zeros(local, dtype=torch.float32,
                            device=p.to_local().device)
            return DTensor.from_local(
                z, mesh, place, run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _step0(leaves: Sequence[Leaf]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].params[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(leaves: Sequence[Leaf]) -> AdamWState:
    def z():
        return {leaf.key: _zeros(leaf, leaf.shape) for leaf in leaves}
    return AdamWState(step=_step0(leaves), mu=z(), nu=z())


@torch.no_grad()
def adamw_update(oc: OptConfig, leaves: Sequence[Leaf], grads: Grads,
                 state: AdamWState):
    """One AdamW step, the parameters and moments updated in place →
    (state, {"grad_norm", "lr"})."""
    grads, gn = clip_by_global_norm(grads, oc.clip_norm)
    step = state.step + 1
    lr = schedule(oc, step)
    t = step.float()
    bc1 = 1 - oc.b1 ** t
    bc2 = 1 - oc.b2 ** t
    for leaf, gs in zip(leaves, grads):
        decay = len(leaf.shape) >= 2           # decay matrices only
        for p, g, m, v in zip(leaf.params, gs, rows(leaf, state.mu[leaf.key]),
                              rows(leaf, state.nu[leaf.key])):
            g = g.float()
            m.mul_(oc.b1).add_((1 - oc.b1) * g)
            v.mul_(oc.b2).add_((1 - oc.b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
            if decay:
                delta = delta + oc.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return AdamWState(step, state.mu, state.nu), {"grad_norm": gn, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def adafactor_init(leaves: Sequence[Leaf]) -> AdafactorState:
    vr, vc = {}, {}
    for leaf in leaves:
        shape = leaf.shape
        vr[leaf.key] = _zeros(leaf, shape[:-1] if len(shape) >= 2
                              else shape)
        vc[leaf.key] = _zeros(leaf, shape[:-2] + shape[-1:]
                              if len(shape) >= 2 else ())
    return AdafactorState(step=_step0(leaves), vr=vr, vc=vc)


def _adafactor(oc, beta2, lr, g, vr, vc, p) -> torch.Tensor:
    """The reference's update of one leaf (or of a layer's slice of one,
    when its factoring stays within the layer): ``vr``, ``vc`` updated in
    place → the new parameter value in float32."""
    g = g.float()
    g2 = g * g + 1e-30
    if p.dim() >= 2:
        vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
        vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
        r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
        prec = r[..., :, None] * (1.0 / vc)[..., None, :]
        delta = g * torch.rsqrt(torch.clamp(prec, min=1e-30))
        delta = delta + oc.weight_decay * p.float()
    else:
        vr.copy_(beta2 * vr + (1 - beta2) * g2)
        delta = g * torch.rsqrt(torch.clamp(vr, min=1e-30))
    return p.float() - lr * delta


@torch.no_grad()
def adafactor_update(oc: OptConfig, leaves: Sequence[Leaf], grads: Grads,
                     state: AdafactorState):
    """One Adafactor step, in place → (state, {"grad_norm", "lr"})."""
    grads, gn = clip_by_global_norm(grads, oc.clip_norm)
    step = state.step + 1
    lr = schedule(oc, step)
    beta2 = 1.0 - step.float() ** -0.8
    for leaf, gs in zip(leaves, grads):
        vr, vc = state.vr[leaf.key], state.vc[leaf.key]
        if leaf.lead and leaf.params[0].dim() < 2 <= len(leaf.shape):
            # the factoring crosses the stacked axes: the whole leaf
            new = _adafactor(oc, beta2, lr, stack(leaf, gs), vr, vc,
                             stack(leaf, leaf.params))
            for p, row in zip(leaf.params, rows(leaf, new)):
                p.copy_(row)
            continue
        for p, g, r, c in zip(leaf.params, gs, rows(leaf, vr),
                              rows(leaf, vc)):
            p.copy_(_adafactor(oc, beta2, lr, g, r, c, p))
    return AdafactorState(step, state.vr, state.vc), \
        {"grad_norm": gn, "lr": lr}


def init_opt(oc: OptConfig, leaves: Sequence[Leaf]):
    return adamw_init(leaves) if oc.kind == "adamw" else \
        adafactor_init(leaves)


def update(oc: OptConfig, leaves: Sequence[Leaf], grads: Grads, state):
    if oc.kind == "adamw":
        return adamw_update(oc, leaves, grads, state)
    return adafactor_update(oc, leaves, grads, state)
