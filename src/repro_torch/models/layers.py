"""Core transformer layers of the port: RMSNorm, RoPE, chunked flash
attention with its recompute backward (train and prefill), decode
attention over a KV cache (full or sliding-window ring buffer), SwiGLU
MLP, and the SSMs' depthwise causal conv.

The reference's ``models/layers.py`` in PyTorch ops, with its arithmetic:
scores and the online-softmax state in float32, ``p`` cast to v's dtype
before the PV product, the q-chunk × kv-chunk blocks of ``_pick_chunk``
and the blocks that the causal mask or the window rule out skipped (here
a Python ``continue``; the reference's ``lax.cond``).  The backward is
the reference's ``custom_vjp`` as a ``torch.autograd.Function``.  No
library attention: the products are ``torch.einsum`` over the same
blocks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..distributed import shards, trace_cost

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32 with ``(1 + w)`` as the scale, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) → (sin, cos) each (..., dim/2), float32."""
    freq = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=positions.device) / dim *
                     math.log(theta))
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S): rotate the interleaved
    pairs (x[..., 0::2], x[..., 1::2])."""
    sin, cos = _rope_angles(positions, x.shape[-1], theta)
    sin, cos = sin[..., None, :], cos[..., None, :]    # (..., S, 1, D/2)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def split_heads(t: torch.Tensor, n_heads: int, hd: int,
                n_groups: Optional[int] = None) -> torch.Tensor:
    """(B, S, n_heads·hd) → (B, S, n_heads, hd).  A DTensor sharded on its
    last dim (the heads over 'model') keeps the heads sharded where the
    shards hold whole groups of ``n_groups`` (the KV heads: by default
    ``n_heads``), as the reference's ``attn/w*`` specs place them; where
    they do not (4 KV heads over 16 devices), the heads are replicated
    first (an all-gather the trace counts): the shards would cut a head or
    a KV group."""
    b, s = t.shape[:2]
    if shards.shards_of(t, 2) > 1 and \
            (n_groups or n_heads) % shards.shards_of(t, 2):
        t = shards.replicate_dims(t, (2,))
    return t.reshape(b, s, n_heads, hd)


def _pick_chunk(s: int, target: int = 512) -> int:
    return max(math.gcd(s, target), 1)


def _block_mask(qc, kc, q_lo, k_lo, causal, window, device):
    qpos = q_lo + torch.arange(qc, device=device)[:, None]
    kpos = k_lo + torch.arange(kc, device=device)[None, :]
    mask = torch.ones((qc, kc), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


def _chunk_needed(q_lo, k_lo, qc, kc, causal, window) -> bool:
    needed = True
    if causal:
        needed = needed and k_lo <= q_lo + qc - 1
    if window > 0:
        needed = needed and k_lo + kc - 1 > q_lo - window
    return needed


def alike(items, weight: Optional[float] = None):
    """Iterate ``items``: a loop's alike iterations (the same ops on the
    same shapes: flash attention's blocks, an SSM scan's chunks).  Under
    a sampling cost trace (``trace_cost.sampling``) only the first runs,
    each of its ops counted ``weight`` times (default: as many as the
    items), so that a trace at a long sequence stays short; the caller
    repeats what the iteration returned to the loop's length."""
    items = list(items)
    if not items or not trace_cost.sampling():
        yield from items
        return
    with trace_cost.weight(len(items) if weight is None else weight):
        yield items[0]


def _blocks(nq, nk, qc, kc, q_offset, causal, window):
    """[(q-chunk, the kv-chunks it needs)] and the blocks' mean count a
    q-chunk (the sampled q-chunk's blocks count that many times)."""
    plan = [(iq, [jk for jk in range(nk) if _chunk_needed(
        iq * qc + q_offset, jk * kc, qc, kc, causal, window)])
        for iq in range(nq)]
    return plan, sum(len(jks) for _, jks in plan) / nq


def _flash_fwd(q, k, v, causal, window, q_offset, qc, kc):
    """→ (out (B, Sq, H, D) in q's dtype, lse (B, K, rep, Sq) float32)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    rep = h // kh
    nq, nk = sq // qc, sk // kc
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, nq, qc, kh, rep, d)
    kr = k.reshape(b, nk, kc, kh, d)
    vr = v.reshape(b, nk, kc, kh, d)
    f32 = dict(dtype=torch.float32, device=q.device)
    outs, lses = [], []
    plan, per_q = _blocks(nq, nk, qc, kc, q_offset, causal, window)
    for iq, jks in alike(plan):
        q_blk = (qr[:, iq] * scale).float()            # (B, qc, K, rep, D)
        q_lo = iq * qc + q_offset
        m = torch.full((b, kh, rep, qc), NEG_INF, **f32)
        l = torch.zeros((b, kh, rep, qc), **f32)
        acc = torch.zeros((b, kh, rep, qc, d), **f32)
        for jk in alike(jks, per_q):
            k_lo = jk * kc
            s = torch.einsum("bqkrd,bskd->bkrqs", q_blk, kr[:, jk].float())
            mask = _block_mask(qc, kc, q_lo, k_lo, causal, window, q.device)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkrqs,bskd->bkrqd", p.to(v.dtype).float(),
                              vr[:, jk].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        l = l.clamp(min=1e-30)
        out = acc / l[..., None]                       # (B, K, rep, qc, D)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
        lses.append(m + torch.log(l))                  # (B, K, rep, qc)
    reps = nq // len(outs)              # a sampling trace ran one q-chunk
    return (torch.cat(outs * reps, dim=1).reshape(b, sq, h, d),
            torch.cat(lses * reps, dim=-1))


def _flash_bwd(q, k, v, out, lse, do, causal, window, q_offset, qc, kc):
    """The reference's FlashAttention-2-style recompute backward: ``p`` is
    rebuilt for each (q-chunk, kv-chunk) tile from the saved log-sum-exp,
    every product in float32, ``delta = rowsum(do ⊙ o)``; the blocks that
    the mask rules out are skipped, as in the forward.  → (dq, dk, dv) in
    the inputs' dtypes."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    rep = h // kh
    nq, nk = sq // qc, sk // kc
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, nq, qc, kh, rep, d)
    kr = k.reshape(b, nk, kc, kh, d)
    vr = v.reshape(b, nk, kc, kh, d)
    dor = do.reshape(b, nq, qc, kh, rep, d)
    lser = lse.reshape(b, kh, rep, nq, qc)
    delta = torch.einsum("bnqkrd,bnqkrd->bkrnq", dor.float(),
                         out.reshape(b, nq, qc, kh, rep, d).float())
    dk = q.new_zeros((b, nk, kc, kh, d), dtype=torch.float32)
    dv = q.new_zeros((b, nk, kc, kh, d), dtype=torch.float32)
    dqs = []
    plan, per_q = _blocks(nq, nk, qc, kc, q_offset, causal, window)
    for iq, jks in alike(plan):
        q_blk = qr[:, iq].float() * scale              # (B, qc, K, rep, D)
        do_blk = dor[:, iq].float()
        lse_blk = lser[:, :, :, iq, :, None]           # (B, K, rep, qc, 1)
        dl_blk = delta[:, :, :, iq, :, None]
        q_lo = iq * qc + q_offset
        dq = q.new_zeros((b, qc, kh, rep, d), dtype=torch.float32)
        for jk in alike(jks, per_q):
            k_lo = jk * kc
            k_blk, v_blk = kr[:, jk].float(), vr[:, jk].float()
            s = torch.einsum("bqkrd,bskd->bkrqs", q_blk, k_blk)
            mask = _block_mask(qc, kc, q_lo, k_lo, causal, window, q.device)
            p = torch.exp(torch.where(mask, s, NEG_INF) - lse_blk)
            dv[:, jk] += torch.einsum("bkrqs,bqkrd->bskd", p, do_blk)
            dp = torch.einsum("bqkrd,bskd->bkrqs", do_blk, v_blk)
            ds = p * (dp - dl_blk)                     # (B, K, rep, qc, kc)
            dq += torch.einsum("bkrqs,bskd->bqkrd", ds, k_blk) * scale
            # q_blk is already scaled, so no extra factor here
            dk[:, jk] += torch.einsum("bkrqs,bqkrd->bskd", ds, q_blk)
        dqs.append(dq)
    reps = nq // len(dqs)               # a sampling trace ran one q-chunk
    return (torch.stack(dqs * reps, dim=1).reshape(b, sq, h, d).to(q.dtype),
            dk.reshape(b, sk, kh, d).to(k.dtype),
            dv.reshape(b, sk, kh, d).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """``_flash_fwd`` with ``_flash_bwd`` as its backward (the reference's
    ``custom_vjp``): it saves only (q, k, v, out, lse), never the
    per-tile probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, qc, kc):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, qc, kc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, window, q_offset, qc, kc)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, do, *ctx.blocks)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """Blockwise online-softmax attention.  q: (B, Sq, H, D); k, v: (B, Sk,
    K, D) (GQA: H a multiple of K).  ``q_offset``: absolute position of
    q[0] relative to k[0].  ``window`` > 0: position i attends to
    (i-window, i].  The peak live tensor is one (B, K, rep, qc, kc) block
    of float32 scores.  DTensor inputs run on each device's shards of the
    batch and heads (``shards.local_map``).  With grad enabled it runs as
    ``_FlashAttention``, whose backward recomputes each block's
    probabilities from the saved log-sum-exp; the output is the same
    either way."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    qc = chunk or _pick_chunk(sq)
    kc = chunk or _pick_chunk(sk)
    if sq % qc or sk % kc:
        raise ValueError(f"chunks {qc}, {kc} do not divide {sq}, {sk}")

    def attend(q, k, v):
        if torch.is_grad_enabled():
            return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                         qc, kc)
        return _flash_fwd(q, k, v, causal, window, q_offset, qc, kc)[0]
    # DTensors: each device attends its batch rows and heads
    # (q's heads and the KV heads split alike: ``split_heads`` keeps them
    # sharded only where the shards hold whole KV groups)
    return shards.local_map(attend, ((q, "bshd"), (k, "bthd"), (v, "bthd")),
                            ("bshd",), keep="bh")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention over a cache.  q: (B, 1, H, D); caches: (B,
    S_cache, K, D); ``pos`` is the absolute position of the new token,
    already written.  With ``window`` > 0 the cache is a ring buffer (slot
    t % S_cache holds token t) and the slots of the last S_cache tokens are
    valid; otherwise slots [0, pos]."""
    b, _, h, d = q.shape
    _, sc, kh, _ = k_cache.shape
    rep = h // kh
    scale = 1.0 / math.sqrt(d)
    qr = (q.reshape(b, kh, rep, d) * scale).float()
    s = shards.einsum("bkrd,bskd->bkrs", qr, k_cache.float())
    slot = torch.arange(sc, device=q.device)
    if window > 0:
        tok_age = torch.remainder(pos - slot, sc)       # 0 = current token
        valid = tok_age < min(pos + 1, sc)
    else:
        valid = slot <= pos
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = shards.einsum("bkrs,bskd->bkrd", p.to(v_cache.dtype).float(),
                        v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x) in the reference's form, x · 1/(1 + exp(-x)), each op
    rounded to x's dtype: in bfloat16 it equals ``jax.nn.silu`` bit for
    bit on the CPU, where ``F.silu`` (one rounding) differs in ~40% of
    outputs."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; every product in x's dtype."""
    mm = shards.matmul
    return mm(silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence.  x: (B, S, C); w: (W, C);
    b: (C,).  ``state`` (B, W-1, C), the inputs before x, is prepended
    (decode), else zeros.  → (y (B, S, C), new state: the last W-1
    inputs).  The shifted products are summed from 0 in x's dtype and the
    bias added last, as the reference sums them."""
    width, s = w.shape[0], x.shape[1]
    pad = x.new_zeros((x.shape[0], width - 1) + x.shape[2:]) \
        if state is None else state
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, C)
    y = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return y + b, xp[:, s:].contiguous()
