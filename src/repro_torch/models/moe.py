"""Mixture-of-Experts FFN of the port: top-k routing and GShard's grouped
one-hot dispatch (the reference's ``models/moe.py``).

Tokens are reshaped to (G, S, d) groups, capacity is per group, and
dispatch and combine are einsums against a (G, S, E, C) one-hot tensor,
as the reference computes them (plain products; no kernel in either
package).  ``capacity_factor=None`` is dropless (C = S·k): decode's.
Under a finite capacity the position in an expert is the exclusive
prefix sum of the routing mask in position-major, then choice-major
order, and the pairs past C are dropped.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from torch import nn

from ..distributed.shards import einsum, merge_dims
from .layers import silu


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor        # Switch load-balance loss
    dropped_frac: torch.Tensor    # share of (token, choice) pairs dropped
    gate_idx: torch.Tensor        # (T, k) the experts each token was routed
    #                               to, most probable first


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: Optional[float] = 1.25, n_groups: int = 1,
            group_shard=None, cap_shard=None):
    """x: (T, d) tokens; router_w: (d, E); w_*: (E, d, f) / (E, f, d)
    → (y (T, d), MoEMetrics).  The router is float32; the experts' products
    are in x's dtype.  The sharding hooks, as the reference applies them:
    ``group_shard`` on the (G, S, d) grouped tokens, ``cap_shard`` on the
    (G, S, E, C) dispatch and combine tensors."""
    t, d = x.shape
    e = router_w.shape[1]
    g = n_groups if t % max(n_groups, 1) == 0 else 1
    s = t // g
    xg = x.reshape(g, s, d)
    if group_shard is not None:
        xg = group_shard(xg)

    logits = einsum("gsd,de->gse", xg.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k breaks ties to the lower index; a stable sort does too
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
        min=1e-9)

    if capacity_factor is None:
        cap = s * top_k                                     # dropless
    else:
        cap = int(max(1, round(s * top_k * capacity_factor / e)))

    # position in the expert: exclusive prefix over the routing mask
    oh = F.one_hot(gate_idx, e).float()                     # (G, S, k, E)
    flat = oh.reshape(g, s * top_k, e)                      # priority order
    pos_all = torch.cumsum(flat, dim=1) - flat
    pos = (pos_all * flat).sum(dim=-1).reshape(g, s, top_k).to(torch.int32)
    keep = pos < cap
    dropped = 1.0 - keep.float().mean()

    # the reference's one_hot gives a dropped pair (pos ≥ C) a row of
    # zeros; F.one_hot raises on it, so those rows are masked
    pos_oh = F.one_hot(torch.where(keep, pos, 0).long(), cap).float() * \
        keep[..., None]                                     # (G, S, k, C)
    dispatch = einsum("gske,gskc->gsec", oh, pos_oh)
    combine = einsum("gske,gskc->gsec", oh * gate_vals[..., None],
                           pos_oh)
    if cap_shard is not None:
        dispatch = cap_shard(dispatch)
        combine = cap_shard(combine)

    buf = einsum("gsd,gsec->gecd", xg, dispatch.to(x.dtype))
    h_g = einsum("gecd,edf->gecf", buf, w_gate)
    h_u = einsum("gecd,edf->gecf", buf, w_up)
    h = einsum("gecf,efd->gecd", silu(h_g) * h_u, w_down)
    y = einsum("gecd,gsec->gsd", h, combine.to(x.dtype))

    frac_tokens = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * (frac_tokens * probs.mean(dim=(0, 1))).sum()
    return merge_dims(y, 0, 2), MoEMetrics(
        aux_loss=aux, dropped_frac=dropped,
        gate_idx=gate_idx.reshape(t, top_k))


class MoEFFN(nn.Module):
    """``moe_ffn`` as a module without parameters, so that a forward hook
    sees every call's ``MoEMetrics``: the prefill's and decode's alike."""

    def forward(self, x, router_w, w_gate, w_up, w_down, **kwargs):
        return moe_ffn(x, router_w, w_gate, w_up, w_down, **kwargs)
