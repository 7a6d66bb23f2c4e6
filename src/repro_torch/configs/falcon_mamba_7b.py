"""falcon-mamba-7b [ssm] — attention-free Mamba1 [arXiv:2410.05355].

Pure selective-SSM decoder: O(1)-state decode => runs long_500k.
d_ff=0 per the assignment (no MLP; the Mamba block IS the mixer+channel
update, as in the original Mamba architecture).
"""
from .base import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv=0, d_ff=0,
    vocab=65024, ssm_state=16, ssm_variant="mamba1", ssm_expand=2,
    conv_width=4, subquadratic=True,
))
