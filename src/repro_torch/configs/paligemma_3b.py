"""paligemma-3b [vlm] — SigLIP + gemma [arXiv:2407.07726; hf].

Backbone only per the assignment: the SigLIP vision tower is a STUB --
input_specs() provides 256 precomputed patch embeddings prepended as a
prefix; the gemma decoder (MQA kv=1, wide d_ff) runs over prefix+text.
Loss is computed on text positions only.
"""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384,
    vocab=257216, frontend="vision", frontend_tokens=256, head_dim=256,
))
