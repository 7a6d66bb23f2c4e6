"""Decoder stack of the port for the attention families (dense, audio,
vlm): the reference's ``models/transformer.py`` with an ``nn.Module`` per
block in an ``nn.ModuleList`` where the reference stacks the layers'
parameters under one ``lax.scan``.

Parameters keep the reference's orientation (``x @ w``, (in, out)), so a
reference parameter tree maps onto the modules one array for one
parameter (``params_from_jax``).  The MoE, SSM and hybrid families are
ROADMAP item A14b; training (remat, the flash backward) is A14c.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .layers import (apply_rope, decode_attention, flash_attention, rms_norm,
                     swiglu)

# families whose every layer is attention + MLP over a KV cache
KV_FAMILIES = ("dense", "audio", "vlm")
# the ROADMAP item of the families this module does not run
OTHER_FAMILIES_ITEM = "A14b"


def check_family(cfg) -> None:
    """Raise unless the port runs ``cfg``'s family."""
    if cfg.family not in KV_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet (ROADMAP "
            f"item {OTHER_FAMILIES_ITEM}: MoE, SSM and hybrid serving); the "
            f"port runs {', '.join(KV_FAMILIES)}")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One pre-norm attention + SwiGLU block."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
        shapes = dict(ln1=(d,), ln2=(d,), wq=(d, qd), wk=(d, kvd),
                      wv=(d, kvd), wo=(qd, d), w_gate=(d, f), w_up=(d, f),
                      w_down=(f, d))
        for name, shape in shapes.items():
            setattr(self, name, _frozen(torch.zeros(shape, dtype=dtype,
                                                    device=device)))

    def attention(self, x, positions, cfg):
        """→ (out (B, S, d), k (B, S, K, hd), v)."""
        b, s, _ = x.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        q = (x @ self.wq).reshape(b, s, h, hd)
        k = (x @ self.wk).reshape(b, s, kv, hd)
        v = (x @ self.wv).reshape(b, s, kv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, causal=True, window=cfg.window)
        return o.reshape(b, s, h * hd) @ self.wo, k, v

    def forward(self, x, positions, cfg):
        a, k, v = self.attention(rms_norm(x, self.ln1), positions, cfg)
        x = x + a
        x = x + swiglu(rms_norm(x, self.ln2), self.w_gate, self.w_up,
                       self.w_down)
        return x, k, v

    def attend_decode(self, x, cache_k, cache_v, pos: int, cfg):
        """x: (B, 1, d); cache_k/v: (B, Sc, K, hd), written in place at the
        new token's slot.  → out (B, 1, d)."""
        b = x.shape[0]
        h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        q = (x @ self.wq).reshape(b, 1, h, hd)
        k = (x @ self.wk).reshape(b, 1, kv, hd)
        v = (x @ self.wv).reshape(b, 1, kv, hd)
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
        sc = cache_k.shape[1]
        slot = pos % sc if cfg.window > 0 else pos
        # the reference's dynamic_update_slice clamps a slot past the end
        # (overwriting the last one); an indexed copy would raise, so a
        # position the cache cannot hold is refused here instead
        if not 0 <= slot < sc:
            raise ValueError(f"position {pos} past the cache's {sc} slots")
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
        o = decode_attention(q, cache_k, cache_v, pos,
                             window=max(cfg.window, 0))
        return o.reshape(b, 1, h * hd) @ self.wo

    def decode(self, x, cache_k, cache_v, pos: int, cfg):
        x = x + self.attend_decode(rms_norm(x, self.ln1), cache_k, cache_v,
                                   pos, cfg)
        return x + swiglu(rms_norm(x, self.ln2), self.w_gate, self.w_up,
                          self.w_down)


class Transformer(nn.Module):
    """Embedding, blocks, final norm, LM head (absent when tied) and the
    frontend's norm (audio, vlm)."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        check_family(cfg)
        dt = torch_dtype(cfg.dtype)
        d = cfg.d_model
        self.embed = _frozen(torch.zeros((cfg.vocab, d), dtype=dt,
                                         device=device))
        self.final_norm = _frozen(torch.zeros((d,), dtype=dt, device=device))
        self.lm_head = None if cfg.tie_embeddings else _frozen(
            torch.zeros((d, cfg.vocab), dtype=dt, device=device))
        self.frontend_norm = None if cfg.frontend == "none" else _frozen(
            torch.zeros((d,), dtype=dt, device=device))
        self.blocks = nn.ModuleList(Block(cfg, dt, device)
                                    for _ in range(cfg.n_layers))


# weights drawn from N(0, 1/fan_in); norms start at zero (scale 1 + w)
_FAN_IN = dict(wq="d", wk="d", wv="d", wo="qd", w_gate="d", w_up="d",
               w_down="f")


def init(cfg, generator: torch.Generator, device="cuda") -> Transformer:
    """Random weights from ``generator`` on ``device``: each matrix
    N(0, 1/fan_in) drawn in float32 on the generator's device and cast to
    ``cfg.dtype``, the norms zero, as the reference's ``init`` (whose
    draws, from JAX's generator, differ).  A CPU generator gives every
    device the same model."""
    net = Transformer(cfg, device)
    fan = dict(d=cfg.d_model, qd=cfg.n_heads * cfg.hd, f=cfg.d_ff)

    def fill(p: nn.Parameter, fan_in: int) -> None:
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        p.copy_(w * (1.0 / math.sqrt(fan_in)))

    with torch.no_grad():
        fill(net.embed, cfg.d_model)
        if net.lm_head is not None:
            fill(net.lm_head, cfg.d_model)
        for blk in net.blocks:
            for name, key in _FAN_IN.items():
                fill(getattr(blk, name), fan[key])
    return net


def params_from_jax(cfg, params: Mapping, device="cuda") -> Transformer:
    """The reference's parameter tree (``transformer.init``'s, leaves as
    numpy arrays) as the port's modules: the stacked layer axis unstacked
    into blocks; ``lm_head`` absent when the embeddings are tied;
    ``frontend_norm`` where the config has a frontend."""
    net = Transformer(cfg, device)

    def put(p: nn.Parameter, a) -> None:
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"shape {a.shape} for a parameter of "
                             f"{tuple(p.shape)}")
        a = np.array(a)                     # a writable, contiguous copy
        if a.dtype.name == "bfloat16":      # ml_dtypes: carried as bits
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        p.copy_(t.to(p.dtype))

    with torch.no_grad():
        put(net.embed, params["embed"])
        put(net.final_norm, params["final_norm"])
        if net.lm_head is not None:
            put(net.lm_head, params["lm_head"])
        if net.frontend_norm is not None:
            put(net.frontend_norm, params["frontend_norm"])
        blocks = params["blocks"]
        for li, blk in enumerate(net.blocks):
            put(blk.ln1, blocks["ln1"][li])
            put(blk.ln2, blocks["ln2"][li])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(blk, name), blocks["attn"][name][li])
            for name in ("w_gate", "w_up", "w_down"):
                put(getattr(blk, name), blocks["mlp"][name][li])
    return net


def forward(cfg, params: Transformer, embeds: torch.Tensor,
            positions: torch.Tensor, *, want_cache: bool = False):
    """Run the blocks on (B, S, d) embeddings → (hidden (B, S, d), aux
    loss (0 here: no MoE), cache or None).  The cache is ``{"k", "v"}``,
    each stacked (L, B, S, K, hd) (SWA: the last ``window`` positions at
    their ring slots), as ``decode_step`` consumes it."""
    x = embeds
    ks, vs = [], []
    for blk in params.blocks:
        x, k, v = blk(x, positions, cfg)
        if want_cache:
            ks.append(k)
            vs.append(v)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = _kv_cache_from_layers(ks, vs, cfg) if want_cache else None
    return x, aux, cache


def _clip_window(kv: torch.Tensor, cfg) -> torch.Tensor:
    """Keep only the last ``window`` positions of an SWA cache (L, B, S,
    K, hd), ring layout: slot t % window holds token t."""
    if cfg.window <= 0 or kv.shape[2] <= cfg.window:
        return kv
    s, w = kv.shape[2], cfg.window
    start = s - w
    slots = (start + torch.arange(w, device=kv.device)) % w
    out = torch.zeros(kv.shape[:2] + (w,) + kv.shape[3:], dtype=kv.dtype,
                      device=kv.device)
    out[:, :, slots] = kv[:, :, start:]
    return out


def _kv_cache_from_layers(ks, vs, cfg) -> Dict[str, torch.Tensor]:
    return {"k": _clip_window(torch.stack(ks), cfg),
            "v": _clip_window(torch.stack(vs), cfg)}


def decode_step(cfg, params: Transformer, embeds: torch.Tensor, cache,
                pos: int):
    """One-token decode.  embeds: (B, 1, d); ``cache`` from ``forward`` (or
    ``serve.kv_cache.init_cache``), updated in place at ``pos`` (the
    reference returns a new one).  → (hidden (B, 1, d), cache)."""
    pos = int(pos)
    x = embeds
    for li, blk in enumerate(params.blocks):
        x = blk.decode(x, cache["k"][li], cache["v"][li], pos, cfg)
    return x, cache


def param_count(params: Transformer) -> int:
    return sum(p.numel() for p in params.parameters())
