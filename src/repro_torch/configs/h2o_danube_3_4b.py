"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818].

Sliding-window attention (mistral-style, 4096 window) => window-bounded KV
cache => sub-quadratic decode => runs long_500k.
"""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv=8, d_ff=10240,
    vocab=32000, window=4096, head_dim=120, subquadratic=True,
))
