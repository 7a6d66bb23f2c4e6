"""KV caches of the port's LM serving: ring buffers bounded at ``window``
for the SWA archs, as ``transformer.decode_step`` consumes them.  The
SSM and hybrid states are ROADMAP item A14b; ``cache_specs`` (the dry
run's shapes without allocation) A14d."""
from __future__ import annotations

from typing import Dict

import torch

from ..models.transformer import check_family, torch_dtype


def cache_seq_len(cfg, seq_len: int) -> int:
    """Physical cache length: SWA archs keep a window-sized ring buffer."""
    if cfg.window > 0:
        return min(seq_len, cfg.window)
    return seq_len


def _kv_shape(cfg, n: int, batch: int, sc: int):
    return (n, batch, sc, cfg.n_kv, cfg.hd)


def pad_cache(cfg, cache: Dict[str, torch.Tensor], max_len: int):
    """Grow a prefill-built cache so decode can append up to ``max_len``
    tokens in all: full-attention caches are zero-padded along the
    sequence; SWA ring buffers, bounded at ``window``, pass through."""
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
    """Zero cache for decoding up to ``seq_len`` tokens: {"k", "v"}, each
    (L, B, S_cache, K, hd)."""
    check_family(cfg)
    dt = dtype or torch_dtype(cfg.dtype)
    shape = _kv_shape(cfg, cfg.n_layers, batch, cache_seq_len(cfg, seq_len))
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
