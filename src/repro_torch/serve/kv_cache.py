"""Decode caches of the port's LM serving, as ``transformer.decode_step``
consumes them: KV ring buffers (bounded at ``window`` for the SWA archs),
Mamba1 states (ssm), and the hybrid's Mamba2 states beside one KV cache
for each application of its shared block.  ``cache_specs`` gives the dry
run the same tree on the meta device: shapes and dtypes, no memory."""
from __future__ import annotations

import torch

from ..models.ssm import Mamba1State, Mamba2State
from ..models.transformer import check_family, torch_dtype


def cache_seq_len(cfg, seq_len: int) -> int:
    """Physical cache length: SWA archs keep a window-sized ring buffer."""
    if cfg.window > 0:
        return min(seq_len, cfg.window)
    return seq_len


def _kv_shape(cfg, n: int, batch: int, sc: int):
    return (n, batch, sc, cfg.n_kv, cfg.hd)


def cache_specs(cfg, batch: int, seq_len: int, dtype=None):
    """``init_cache``'s tree on the meta device: its structure, shapes and
    dtypes, with no memory (the reference returns ``ShapeDtypeStruct``s)."""
    return init_cache(cfg, batch, seq_len, dtype=dtype, device="meta")


def pad_cache(cfg, cache, max_len: int):
    """Grow a prefill-built cache so decode can append up to ``max_len``
    tokens in all: full-attention KV caches (the hybrid's too) are
    zero-padded along the sequence; SWA ring buffers, bounded at
    ``window``, and SSM states, O(1) in the sequence, pass through."""
    if not (isinstance(cache, dict) and "k" in cache):
        return cache
    target = cache_seq_len(cfg, max_len)

    def grow(kv):
        cur = kv.shape[2]
        if cur >= target:
            return kv
        out = kv.new_zeros(kv.shape[:2] + (target,) + kv.shape[3:])
        out[:, :, :cur] = kv
        return out

    return dict(cache, k=grow(cache["k"]), v=grow(cache["v"]))


def init_cache(cfg, batch: int, seq_len: int, dtype=None, device="cuda"):
    """Zero cache for decoding up to ``seq_len`` tokens, the reference's
    shapes: {"k", "v"} (L, B, S_cache, K, hd); ssm a ``Mamba1State`` (conv
    (L, B, W-1, d_inner), ssm (L, B, d_inner, N) float32); hybrid
    {"mamba": Mamba2State (U, attn_every, B, ...), "tail": Mamba2State
    (R, B, ...) or None, "k", "v" (U, B, S_cache, K, hd)}."""
    check_family(cfg)
    dt = dtype or torch_dtype(cfg.dtype)

    def zeros(shape, d=dt):
        return torch.zeros(shape, dtype=d, device=device)

    sc = cache_seq_len(cfg, seq_len)
    w = cfg.conv_width - 1
    if cfg.family == "ssm":
        L = cfg.n_layers
        return Mamba1State(conv=zeros((L, batch, w, cfg.d_inner)),
                           ssm=zeros((L, batch, cfg.d_inner, cfg.ssm_state),
                                     torch.float32))
    if cfg.family == "hybrid":
        period = cfg.attn_every
        units, tail = divmod(cfg.n_layers, period)
        di_c = cfg.d_inner + 2 * cfg.ssm_state
        ssm = (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)

        def states(lead):
            return Mamba2State(conv=zeros(lead + (batch, w, di_c)),
                               ssm=zeros(lead + ssm, torch.float32))

        return {"mamba": states((units, period)),
                "tail": states((tail,)) if tail else None,
                "k": zeros(_kv_shape(cfg, units, batch, sc)),
                "v": zeros(_kv_shape(cfg, units, batch, sc))}
    shape = _kv_shape(cfg, cfg.n_layers, batch, sc)
    return {"k": zeros(shape), "v": zeros(shape)}
