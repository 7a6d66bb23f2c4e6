"""Unified model configuration of the LM stack (the port's own copy of the
reference's ``configs/base.py``, field for field).

One dataclass covers the families (dense / moe / ssm / hybrid / audio /
vlm backbones).  Where a published detail is needed to make a config
runnable (e.g. llama4's interleaved MoE, zamba2's shared-attention period,
SWA window sizes) it is set from the cited source and noted inline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free (ssm)
    n_kv: int
    d_ff: int
    vocab: int
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE block every k-th layer (1 = all)
    moe_capacity: float = 1.25   # train/prefill capacity factor (decode is
                                 # dropless — see models/moe.py)
    moe_groups: int = 1          # GShard dispatch groups — set to the DP
                                 # mesh extent by the launcher so expert
                                 # compute stays token-sharded
    # --- SSM ---
    ssm_state: int = 0
    ssm_variant: str = ""        # mamba1 | mamba2
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_head_dim: int = 64       # mamba2 head dim
    # --- attention ---
    window: int = 0              # sliding-window size (0 = full causal)
    rope_theta: float = 10_000.0
    head_dim: int = 0            # 0 → d_model // n_heads
    attn_every: int = 0          # hybrid: shared attn block every k layers
    # --- frontend (stub) ---
    frontend: str = "none"       # none | audio | vision
    frontend_tokens: int = 0     # prepended frame/patch embeddings
    tie_embeddings: bool = False
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # long-context capability marker (sub-quadratic decode path exists)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and sanity vs the
        architecture's published size)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        n = 0
        n += v * d                                   # embed
        if not self.tie_embeddings:
            n += d * v                               # lm head
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) + \
            (self.n_heads * hd) * d
        mlp = 3 * d * f
        moe_mlp = self.n_experts * 3 * d * f + d * self.n_experts \
            if self.n_experts else 0
        if self.family == "ssm":
            per = _mamba1_params(self)
            n += self.n_layers * (per + d)           # + norm
        elif self.family == "hybrid":
            # mamba2 backbone layers (no per-layer MLP — zamba2 puts the MLP
            # inside the ONE shared transformer block; d_ff is its width)
            per = _mamba2_params(self)
            n += self.n_layers * (per + d)
            n += attn + mlp + 2 * d                  # shared attn+MLP block
        else:
            for li in range(self.n_layers):
                is_moe = self.n_experts and ((li + 1) % self.moe_every == 0)
                n += attn + (moe_mlp if is_moe else mlp) + 2 * d
        n += d                                       # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k) for 6·N_active·D."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        n_moe_layers = sum(1 for li in range(self.n_layers)
                           if (li + 1) % self.moe_every == 0)
        inactive = n_moe_layers * (self.n_experts - self.top_k) * 3 * d * f
        return full - inactive


def _mamba1_params(cfg: ModelConfig) -> int:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return (d * 2 * di            # in_proj (x, z)
            + cfg.conv_width * di  # conv
            + di * (r + 2 * n)     # x_proj → dt, B, C
            + r * di               # dt_proj
            + di * n + di          # A_log, D
            + di * d)              # out_proj


def _mamba2_params(cfg: ModelConfig) -> int:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    # in_proj → (x: di, z: di, B: n·groups, C: n·groups, dt: h); groups=1
    return (d * (2 * di + 2 * n + h)
            + cfg.conv_width * (di + 2 * n)   # conv over x, B, C
            + h + h                           # A_log, D per head
            + di * d)                         # out_proj


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs, and the reason if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k-token decode has no "
                       "sub-quadratic path (DESIGN.md §5)")
    return True, ""
