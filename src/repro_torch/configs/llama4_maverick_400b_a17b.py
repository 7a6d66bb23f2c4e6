"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE interleaved every other layer (published Maverick layout; with the
assigned d_ff=8192 and 48 layers this lands at ~400B total / ~17B active,
matching the model name — all-layer MoE would be ~773B). Early-fusion
multimodality enters via the stub frontend path shared with paligemma;
text-only shapes exercise the backbone per the assignment.
"""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, n_experts=128, top_k=1, moe_every=2, head_dim=128,
    rope_theta=500_000.0,
))
