"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention [arXiv:2411.15242].

81 Mamba2 blocks; ONE shared-parameter GQA attention+MLP
block applied every `attn_every` layers (zamba2's shared transformer block,
period 6 here => 14 applications). kv=32 == n_heads (full MHA in the shared
block, as assigned). Sub-quadratic: Mamba2 state decode + a bounded number
of attention KV caches => runs long_500k.
"""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_variant="mamba2", ssm_expand=2,
    ssm_head_dim=64, conv_width=4, attn_every=6, head_dim=112,
    subquadratic=True,
))
