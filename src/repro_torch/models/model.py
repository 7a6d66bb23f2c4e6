"""Model facade of the port: embedding, the decoder stack, the head, the
training loss, prefill and decode for every family of the registry (the
reference's ``models/model.py``).

Batch contract: ``{"tokens": (B, S) integer}`` and, for the frontend
families, ``"frontend": (B, P, d)`` precomputed embeddings that precede
the tokens; training adds ``"labels": (B, S) integer``, already
next-token aligned, with -100 (``IGNORE``) for positions without a
target.  ``params`` is the ``transformer.Transformer`` module of
``init_params`` or ``transformer.params_from_jax``, its parameters plain
tensors or DTensors (``distributed.sharding.distribute_params``); with
DTensors each entry point runs under ``implicit_replication()``.  The
sharding hooks (``act_shard``, ``logit_shard``, ``moe_cap_shard``) are
``distributed/sharding.py``'s; None leaves a path as it is.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed.sharding import replicating
from ..distributed.shards import embed_rows, matmul
from . import frontends, transformer
from .layers import rms_norm

IGNORE = -100


class Model:
    def __init__(self, cfg):
        transformer.check_family(cfg)
        self.cfg = cfg

    # -- params ------------------------------------------------------------
    def init_params(self, generator: torch.Generator, device="cuda"):
        return transformer.init(self.cfg, generator, device)

    # -- embedding / head ----------------------------------------------------
    def _embed_tokens(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # a vocabulary-sharded table: each device gathers its own rows and
        # the partial sums are all-reduced (``shards.embed_rows``)
        return embed_rows(params.embed, tokens.long())

    def _embed_batch(self, params, batch) -> Tuple[torch.Tensor, int]:
        """→ (embeds (B, S_total, d), start of the token region)."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"])
        if cfg.frontend == "none":
            return x, 0
        pre = frontends.apply_frontend(cfg, params, batch["frontend"])
        return torch.cat([pre, x], dim=1), cfg.frontend_tokens

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, V) in ``cfg.dtype`` (callers cast to
        float32, as the reference does)."""
        h = rms_norm(hidden, params.final_norm)
        if self.cfg.tie_embeddings:
            return matmul(h, params.embed.t())
        return matmul(h, params.lm_head)

    # -- training loss -------------------------------------------------------
    def loss_fn(self, params, batch, *, remat: bool = True, act_shard=None,
                logit_shard=None, moe_cap_shard=None,
                aux_weight: float = 0.01, z_weight: float = 1e-4):
        """→ (loss, metrics ``ce``, ``aux``, ``z``, ``tokens``, ``loss``):
        the cross entropy of the float32 logits over the token region's
        labels that are not ``IGNORE``, plus ``aux_weight`` × the MoE
        layers' load-balance loss and ``z_weight`` × the mean squared
        log-partition (z-loss).  ``remat``: ``transformer.forward``'s;
        ``logit_shard`` places the float32 logits."""
        with replicating(params):
            return self._loss(params, batch, remat, act_shard, logit_shard,
                              moe_cap_shard, aux_weight, z_weight)

    def _loss(self, params, batch, remat, act_shard, logit_shard,
              moe_cap_shard, aux_weight, z_weight):
        x, p0 = self._embed_batch(params, batch)
        h, aux, _ = transformer.forward(self.cfg, params, x, _positions(x),
                                        remat=remat, act_shard=act_shard,
                                        moe_cap_shard=moe_cap_shard)
        logits = self.logits(params, h[:, p0:]).float()
        if logit_shard is not None:
            logits = logit_shard(logits)
        labels = batch["labels"].long()
        mask = (labels != IGNORE).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, labels.clamp(min=0))
        denom = mask.sum().clamp(min=1.0)
        ce = ((lse - gold) * mask).sum() / denom
        z = ((lse * mask) ** 2).sum() / denom
        loss = ce + aux_weight * aux + z_weight * z
        return loss, {"ce": ce, "aux": aux, "z": z, "tokens": mask.sum(),
                      "loss": loss}

    # -- serving -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, *, act_shard=None, moe_cap_shard=None,
                max_len: Optional[int] = None):
        """Forward + cache build → (cache, last_logits (B, V) float32,
        next_pos).  ``max_len``: the tokens the cache must hold (prefill +
        generated); by default the prefill's length."""
        from ..serve import kv_cache
        cfg = self.cfg
        with replicating(params):
            x, _ = self._embed_batch(params, batch)
            s = x.shape[1]
            h, _, cache = transformer.forward(
                cfg, params, x, _positions(x), want_cache=True,
                act_shard=act_shard, moe_cap_shard=moe_cap_shard)
            if max_len is not None and max_len > s:
                cache = kv_cache.pad_cache(cfg, cache, max_len)
            last = self.logits(params, h[:, -1:])[:, 0]
            return cache, last.float(), s

    @torch.no_grad()
    def decode(self, params, cache, token: torch.Tensor, pos: int, *,
               act_shard=None, moe_cap_shard=None):
        """One decode step.  token: (B,) integer; ``pos``: the position
        being written.  → (logits (B, V) float32, cache updated in
        place)."""
        with replicating(params):
            x = self._embed_tokens(params, token[:, None])
            h, cache = transformer.decode_step(
                self.cfg, params, x, cache, pos, act_shard=act_shard,
                moe_cap_shard=moe_cap_shard)
            return self.logits(params, h)[:, 0].float(), cache


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The logit of each label (B, S): a gather, the one matching logit of
    the reference's iota-select.  Over a DTensor sharded along the
    vocabulary it is the reference's form (the matching logit summed with
    zeros, a partial sum over the shards), the same value: DTensor's
    gather along a sharded dim fails in its masked reduction."""
    if type(logits) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(logits, DTensor) and any(
                p.is_shard(logits.ndim - 1) for p in logits.placements):
            iota = torch.arange(logits.shape[-1], device=labels.device)
            return torch.where(iota == labels[..., None], logits,
                               0.0).sum(dim=-1)
    return logits.gather(-1, labels[..., None])[..., 0]


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
