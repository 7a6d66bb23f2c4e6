"""Serving steps of the port: prefill and single-token decode, and the
host-looped ``generate`` (greedy, or temperature sampling from an
explicit ``torch.Generator``).  The sharding hooks ``act_shard`` and
``moe_cap_shard`` (``distributed/sharding.py``) go to the model's prefill
and decode; None leaves the path as it is."""
from __future__ import annotations

from typing import Optional

import torch

from ..models.model import Model


def make_prefill_step(model: Model, *, act_shard=None, moe_cap_shard=None,
                      max_len: Optional[int] = None):
    """(params, batch) → (cache, next token (B,) int32, next position)."""
    def prefill(params, batch):
        cache, last_logits, pos = model.prefill(
            params, batch, act_shard=act_shard, moe_cap_shard=moe_cap_shard,
            max_len=max_len)
        # argmax ties go to the first index, as jnp.argmax's
        return cache, last_logits.argmax(dim=-1).to(torch.int32), pos

    return prefill


def make_decode_step(model: Model, *, act_shard=None, moe_cap_shard=None,
                     temperature: float = 0.0):
    """(params, cache, token, pos, generator) → (cache, next token (B,)
    int32, logits (B, V) float32).  Sampling with ``temperature`` > 0
    draws from ``generator``; it cannot reproduce
    ``jax.random.categorical``'s draws."""
    def decode(params, cache, token, pos, generator=None):
        logits, cache = model.decode(params, cache, token, pos,
                                     act_shard=act_shard,
                                     moe_cap_shard=moe_cap_shard)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        return cache, nxt.to(torch.int32), logits

    return decode


def generate(model: Model, params, batch, n_new: int, *,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, act_shard=None,
             moe_cap_shard=None) -> torch.Tensor:
    """Host-looped generation → (B, n_new) int32: the prefill's token, then
    ``n_new - 1`` decode steps."""
    s_total = batch["tokens"].shape[1] + (
        model.cfg.frontend_tokens if model.cfg.frontend != "none" else 0)
    hooks = dict(act_shard=act_shard, moe_cap_shard=moe_cap_shard)
    prefill = make_prefill_step(model, max_len=s_total + n_new, **hooks)
    decode = make_decode_step(model, temperature=temperature, **hooks)
    cache, tok, pos = prefill(params, batch)
    toks = [tok]
    for i in range(n_new - 1):
        cache, tok, _ = decode(params, cache, tok, pos + i, generator)
        toks.append(tok)
    return torch.stack(toks, dim=1)
