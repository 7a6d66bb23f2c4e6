"""Selective state-space layers of the port: Mamba1 (falcon-mamba) and
Mamba2 (zamba2), forward and single-token decode.

The reference's ``models/ssm.py`` in PyTorch ops, with its arithmetic: a
loop over chunks of the sequence carries the float32 state, and within a
chunk

  mamba1 — diagonal A: the (decay, input) pairs are closed by the same
           odd/even recursion as ``jax.lax.associative_scan`` (its pair
           and combine order, so float32 sums round alike);
  mamba2 — scalar A per head (SSD): the decay-weighted lower-triangular
           (C·Bᵀ) scores times x, plus the cross-chunk state pass.

A layer's parameters ``p`` are read as attributes (the ``nn.Module`` of
``transformer``, or any namespace of tensors).  Decode is the forward
with ``chunk=1`` and the state passed in.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..distributed import shards
from .layers import alike, causal_conv1d, rms_norm, silu


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) in the reference's form, ``logaddexp(x, 0)``: max(x,
    0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# Mamba1: diagonal selective scan
# ---------------------------------------------------------------------------

def _combine(a, b):
    """The scan's operator on (decay, input) pairs, ``a`` the earlier."""
    (a1, b1), (a2, b2) = a, b
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(elems):
    """Inclusive scan of (decay, input) pairs along dim 1 under
    ``_combine``: ``jax.lax.associative_scan``'s recursion (combine the
    adjacent pairs, scan those, fill in the even positions)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = associative_scan(_combine([e[:, 0:-1:2] for e in elems],
                                    [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, s)``, halved until it divides
    s."""
    ch = min(chunk, s)
    while s % ch:
        ch //= 2
    return ch


def selective_scan(decay: torch.Tensor, inp: torch.Tensor, h0: torch.Tensor,
                   c_t: torch.Tensor, chunk: int = 256):
    """h_t = decay_t ⊙ h_{t-1} + inp_t ;  y_t = Σ_n h_t[..., n] · c_t[n].

    decay/inp: (B, S, D, N); h0: (B, D, N); c_t: (B, S, N)
    → (y (B, S, D), h_last (B, D, N))."""
    s = decay.shape[1]
    ch = chunk_len(s, chunk)
    h, ys = h0, []
    for c0 in alike(range(0, s, ch)):
        a_cum, b_cum = associative_scan((decay[:, c0:c0 + ch],
                                         inp[:, c0:c0 + ch]))
        h_all = a_cum * h[:, None] + b_cum               # (B, ch, D, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c_t[:, c0:c0 + ch]))
        # a copy: a view would keep the chunk's (B, ch, D, N) states alive
        # in every layer's cache
        h = h_all[:, -1].contiguous()
    # a sampling trace ran one chunk for all (``alike``)
    return torch.cat(ys * (s // ch // len(ys)), dim=1), h


class Mamba1State(NamedTuple):
    conv: torch.Tensor    # (B, W-1, d_inner)
    ssm: torch.Tensor     # (B, d_inner, N) float32


def mamba1_forward(p, x: torch.Tensor, *, d_inner: int, n_state: int,
                   dt_rank: int, state: Optional[Mamba1State] = None,
                   chunk: int = 256) -> Tuple[torch.Tensor, Mamba1State]:
    """The Mamba1 mixer.  x: (B, S, d) → (y (B, S, d), state)."""
    b = x.shape[0]
    mm = shards.matmul
    xi, z = mm(x, p.in_proj).split(d_inner, dim=-1)
    xi, conv_state = causal_conv1d(xi, p.conv_w, p.conv_b,
                                   None if state is None else state.conv)
    xi = silu(xi)
    dt, b_t, c_t = mm(xi, p.x_proj).split([dt_rank, n_state, n_state],
                                         dim=-1)
    dt = softplus(mm(dt, p.dt_proj) + p.dt_bias)        # (B, S, d_inner)
    a = -torch.exp(p.a_log.float())                      # (d_inner, N)
    decay = torch.exp(dt.float()[..., None] * a)         # (B, S, di, N)
    inp = (dt * xi).float()[..., None] * b_t.float()[:, :, None, :]
    h0 = x.new_zeros((b, d_inner, n_state), dtype=torch.float32) \
        if state is None else state.ssm
    # on DTensors, each device scans its batch rows and channels
    y, h_last = shards.local_map(
        lambda *t: selective_scan(*t, chunk),
        ((decay, "bsdn"), (inp, "bsdn"), (h0, "bdn"), (c_t.float(), "bsn")),
        ("bsd", "bdn"), keep="bd")
    y = y.to(x.dtype) + p.d_skip * xi
    y = y * silu(z)
    return mm(y, p.out_proj), Mamba1State(conv=conv_state, ssm=h_last)


def mamba1_decode(p, x: torch.Tensor, state: Mamba1State, *, d_inner: int,
                  n_state: int, dt_rank: int):
    """Single-token step.  x: (B, 1, d)."""
    return mamba1_forward(p, x, d_inner=d_inner, n_state=n_state,
                          dt_rank=dt_rank, state=state, chunk=1)


# ---------------------------------------------------------------------------
# Mamba2 (SSD): scalar decay per head, chunked matmul form
# ---------------------------------------------------------------------------

class Mamba2State(NamedTuple):
    conv: torch.Tensor    # (B, W-1, d_inner + 2N)
    ssm: torch.Tensor     # (B, H, dh, N) float32


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_t: torch.Tensor, c_t: torch.Tensor, h0: torch.Tensor,
                chunk: int = 128):
    """The Mamba2 SSD scan.

    xh: (B, S, H, dh); dt: (B, S, H) (post-softplus); a: (H,) (negative);
    b_t/c_t: (B, S, N); h0: (B, H, dh, N) → (y (B, S, H, dh), h_last).

    Per head: h_t = exp(dt_t a) h_{t-1} + dt_t · x_t ⊗ B_t ; y_t = h_t ·
    C_t."""
    s = xh.shape[1]
    ch = chunk_len(s, chunk)
    tri = torch.ones((ch, ch), dtype=torch.bool, device=xh.device).tril()
    h_in, ys = h0, []
    for c0 in alike(range(0, s, ch)):
        xc, dtc, bc, cc = (t[:, c0:c0 + ch] for t in (xh, dt, b_t, c_t))
        cum = torch.cumsum(dtc.float() * a, dim=1)       # L_t, (B, ch, H)
        # intra-chunk: exp(L_t - L_s') · dt_s' · (C_t·B_s') for s' ≤ t
        cb = torch.einsum("btn,bsn->bts", cc, bc)        # (B, ch, ch)
        diff = cum[:, :, None, :] - cum[:, None, :, :]   # (B, t, s', H)
        w = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        w = w * cb[..., None] * dtc[:, None, :, :]
        y_intra = torch.einsum("btsh,bshd->bthd", w.to(xc.dtype), xc)
        # cross-chunk: C_t · (exp(L_t) · h_in)
        y_cross = torch.einsum("btn,bhdn,bth->bthd", cc.float(),
                               h_in.float(), torch.exp(cum)).to(xc.dtype)
        # h_out = exp(L_last) h_in + Σ_s exp(L_last - L_s) dt_s x_s ⊗ B_s
        wlast = torch.exp(cum[:, -1:, :] - cum) * dtc    # (B, ch, H)
        h_new = torch.einsum("bsh,bshd,bsn->bhdn", wlast, xc.float(),
                             bc.float())
        h_in = torch.exp(cum[:, -1])[:, :, None, None] * h_in + h_new
        ys.append(y_intra + y_cross)
    # a sampling trace ran one chunk for all (``alike``)
    return torch.cat(ys * (s // ch // len(ys)), dim=1), h_in


# the reference's gated norm has rms_norm's arithmetic (scale 1 + w); the
# gate is the silu(z) product before it
rms_norm_gated = rms_norm


def mamba2_forward(p, x: torch.Tensor, *, d_inner: int, n_state: int,
                   n_heads: int, head_dim: int,
                   state: Optional[Mamba2State] = None,
                   chunk: int = 128) -> Tuple[torch.Tensor, Mamba2State]:
    """The Mamba2 mixer.  x: (B, S, d) → (y (B, S, d), state)."""
    b, s, _ = x.shape
    mm = shards.matmul
    xi, z, bc, dt = mm(x, p.in_proj).split(
        [d_inner, d_inner, 2 * n_state, n_heads], dim=-1)
    xbc, conv_state = causal_conv1d(torch.cat([xi, bc], dim=-1), p.conv_w,
                                    p.conv_b,
                                    None if state is None else state.conv)
    xi, b_t, c_t = silu(xbc).split([d_inner, n_state, n_state], dim=-1)
    dt = softplus(dt + p.dt_bias)                        # (B, S, H)
    a = -torch.exp(p.a_log.float())                      # (H,)
    xh = xi.reshape(b, s, n_heads, head_dim)
    h0 = x.new_zeros((b, n_heads, head_dim, n_state), dtype=torch.float32) \
        if state is None else state.ssm
    # on DTensors, each device scans its batch rows and heads
    y, h_last = shards.local_map(
        lambda *t: ssd_chunked(*t, chunk),
        ((xh, "bshd"), (dt, "bsh"), (a, "h"), (b_t, "bsn"), (c_t, "bsn"),
         (h0, "bhdn")), ("bshd", "bhdn"), keep="bh")
    y = y + p.d_skip[None, None, :, None] * xh
    y = rms_norm_gated(y.reshape(b, s, d_inner) * silu(z), p.norm_w)
    return mm(y, p.out_proj), Mamba2State(conv=conv_state, ssm=h_last)


def ssd_sequential_ref(xh, dt, a, b_t, c_t, h0):
    """The O(S) sequential recurrence: the oracle for ``ssd_chunked``."""
    hst = h0.float()
    ys = []
    for t in range(xh.shape[1]):
        dtt = dt[:, t].float()
        decay = torch.exp(dtt * a)                       # (B, H)
        upd = torch.einsum("bh,bhd,bn->bhdn", dtt, xh[:, t].float(),
                           b_t[:, t].float())
        hst = decay[:, :, None, None] * hst + upd
        ys.append(torch.einsum("bhdn,bn->bhd", hst, c_t[:, t].float()))
    return torch.stack(ys, dim=1).to(xh.dtype), hst
