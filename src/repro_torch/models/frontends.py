"""Modality frontend stubs (audio, vlm): the backbone gets precomputed
frame/patch embeddings prepended to the token stream, normalized into the
residual stream's scale.  Not a real SigLIP/EnCodec tower."""
from __future__ import annotations

import torch

from .layers import rms_norm
from .transformer import torch_dtype


def frontend_input_shape(cfg, batch: int):
    """Shape of the precomputed embeddings, or None without a frontend."""
    if cfg.frontend == "none" or cfg.frontend_tokens == 0:
        return None
    return (batch, cfg.frontend_tokens, cfg.d_model)


def apply_frontend(cfg, params, frontend_embeds: torch.Tensor
                   ) -> torch.Tensor:
    """(B, P, d) precomputed embeddings → (B, P, d) in ``cfg.dtype``."""
    return rms_norm(frontend_embeds.to(torch_dtype(cfg.dtype)),
                    params.frontend_norm)


def synth_frontend_embeds(cfg, generator: torch.Generator, batch: int,
                          device="cuda") -> torch.Tensor:
    """Synthetic precomputed embeddings (unit gaussian, as a frozen tower
    would emit) from ``generator`` (drawn on its device) on ``device``, in
    ``cfg.dtype``."""
    shape = frontend_input_shape(cfg, batch)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(
        device=device, dtype=torch_dtype(cfg.dtype))
