"""Error-feedback int8 gradient compression (the reference's
``train/compression.py``).

int8 quantization with one scale a leaf cuts the bytes of a gradient
reduction 4× (float32 → int8); error feedback keeps the scheme
convergent: the quantization residual is carried into the next step's
gradient (Seide et al. 1-bit SGD / EF-SGD form).  On one device there is
no reduction to shrink: the step quantizes and dequantizes where the
reduction would be, so the update sees what a compressed reduction would
deliver.  A leaf is the reference's stacked leaf (``transformer.Leaf``):
its scale is the largest magnitude over all its layers.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..models.transformer import Leaf, rows


def init_error(leaves: Sequence[Leaf]) -> Dict[str, torch.Tensor]:
    return {leaf.key: torch.zeros(leaf.shape, dtype=torch.float32,
                                  device=leaf.params[0].device)
            for leaf in leaves}


def compress_decompress(gs: Sequence[torch.Tensor],
                        errs: Sequence[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One leaf, a tensor a parameter: → (dequantized grads in their
    dtypes, new error residuals in float32)."""
    g32 = [g.float() + e for g, e in zip(gs, errs)]
    peak = torch.stack([t.abs().amax() for t in g32]).amax()
    scale = torch.clamp(peak, min=1e-12) / 127.0
    deq, err = [], []
    for g, t in zip(gs, g32):
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        d = q.float() * scale
        deq.append(d.to(g.dtype))
        err.append(t - d)
    return deq, err


@torch.no_grad()
def apply(leaves: Sequence[Leaf], grads, err_state: Dict[str, torch.Tensor]):
    """Every leaf → (dequantized grads, ``err_state`` updated in place)."""
    out = []
    for leaf, gs in zip(leaves, grads):
        errs = rows(leaf, err_state[leaf.key])
        deq, new = compress_decompress(gs, errs)
        for e, n in zip(errs, new):
            e.copy_(n)
        out.append(deq)
    return out, err_state
