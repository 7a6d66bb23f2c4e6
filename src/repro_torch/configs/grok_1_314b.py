"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

Every layer: GQA attention + MoE FFN. 64x(8x3x6144x32768) experts = 309B
+ attention/embeddings = ~314B total, ~86B active (top-2). rope/RMSNorm/
SwiGLU per the grok-1 open release.
"""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=32768,
    vocab=131072, n_experts=8, top_k=2, moe_every=1, head_dim=128,
    rope_theta=10_000.0,
))
