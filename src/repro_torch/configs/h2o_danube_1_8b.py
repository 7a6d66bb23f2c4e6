"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818; hf]."""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv=8, d_ff=6912,
    vocab=32000, window=4096, head_dim=80, subquadratic=True,
))
