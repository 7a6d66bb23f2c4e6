"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

Backbone only per the assignment: the EnCodec frontend is a STUB --
input_specs() provides precomputed frame embeddings prepended to the token
stream (conditioning frames), and the decoder predicts EnCodec codes
(vocab=2048). kv=32 == n_heads (MHA, as assigned).
"""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
    vocab=2048, frontend="audio", frontend_tokens=256,
))
