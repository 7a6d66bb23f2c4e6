"""Registry of the LM architectures: each config module exports CONFIG,
and ``get(name)`` maps the architecture's id to it."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise KeyError(f"duplicate arch id {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def all_archs() -> Dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (grok_1_314b, llama4_maverick_400b_a17b, zamba2_7b,       # noqa
                   internlm2_20b, h2o_danube_3_4b, h2o_danube_1_8b,          # noqa
                   tinyllama_1_1b, falcon_mamba_7b, musicgen_large,          # noqa
                   paligemma_3b)                                             # noqa
    _LOADED = True


def reduced_config(cfg: ModelConfig, seq_len: int = 64) -> ModelConfig:
    """Shrink an arch config to a CPU-smoke-testable size, preserving the
    family topology (block pattern, GQA ratio, MoE/SSM structure)."""
    import dataclasses
    n_heads = max(cfg.n_heads // 8, 2) if cfg.n_heads else 0
    kv_ratio = max(cfg.n_heads // max(cfg.n_kv, 1), 1) if cfg.n_heads else 1
    n_kv = max(n_heads // kv_ratio, 1) if cfg.n_heads else 0
    # MQA configs (kv=1) stay MQA
    if cfg.n_kv == 1:
        n_kv = 1
    d_model = 64 * max(n_heads, 2) // 2 if cfg.n_heads else 128
    d_model = max(d_model, 64)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(max(4, (cfg.attn_every or 0) + 2), 7),
        d_model=d_model,
        n_heads=n_heads,
        n_kv=n_kv,
        d_ff=d_model * 3,
        vocab=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        # dropless at smoke scale so decode ≡ full forward exactly
        moe_capacity=float(min(cfg.n_experts, 4)) if cfg.n_experts else 1.25,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_variant == "mamba2" else cfg.ssm_head_dim,
        window=min(cfg.window, seq_len // 2) if cfg.window else 0,
        head_dim=32 if cfg.n_heads else 0,
        attn_every=min(cfg.attn_every, 3) if cfg.attn_every else 0,
        frontend_tokens=min(cfg.frontend_tokens, 8) if cfg.frontend_tokens
        else 0,
        dtype="float32",
    )
