"""Decoder stack of the port over the registry's families: the
reference's ``models/transformer.py`` with an ``nn.Module`` a layer in a
flat ``nn.ModuleList``, in layer order, where the reference stacks the
layers' parameters under ``lax.scan``s over layers or units:

  dense / audio / vlm  — ``Block`` (attention + SwiGLU) × n_layers
  moe, moe_every = 1   — ``MoEBlock`` (attention + MoE FFN) × n_layers
  moe, moe_every = 2   — (``Block``, ``MoEBlock``) × n_layers/2 (llama4)
  ssm                  — ``Mamba1Layer`` × n_layers (falcon-mamba)
  hybrid               — ``Mamba2Layer`` × n_layers (zamba2): after each
                         unit of ``attn_every`` of them the ONE shared
                         ``Block`` (``shared_attn``), then the
                         n_layers % attn_every tail layers

Parameters keep the reference's orientation (``x @ w``, (in, out)), so a
leaf of the reference's stacked parameter tree is a list of the modules'
parameters along its stacked axes (``leaf_map``): ``params_from_jax``
unstacks a reference tree onto the modules, ``stack`` puts the
parameters (or their grads) back into a leaf's stacked shape, and the
optimizer (``train/optimizer.py``) decides decay and factoring by the
leaves' stacked shapes, as the reference does.  Training recomputes each
layer (each unit of the reference's scans) in the backward (``remat``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.shards import (matmul, merge_dims, reduce_partial,
                                  write_at)
from .layers import (apply_rope, decode_attention, flash_attention, rms_norm,
                     split_heads, swiglu)
from .moe import MoEFFN
from .ssm import Mamba1State, Mamba2State, mamba1_forward, mamba2_forward

FAMILIES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")


def check_family(cfg) -> None:
    """Raise unless ``cfg``'s family and its layer pattern are known."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    if cfg.family == "moe" and not (
            cfg.moe_every == 1 or (cfg.moe_every == 2 and
                                   cfg.n_layers % 2 == 0)):
        raise ValueError(f"{cfg.name}: moe_every {cfg.moe_every} over "
                         f"{cfg.n_layers} layers (the reference stacks 1, "
                         f"or 2 over an even count)")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# a parameter's start, as the reference's ``init`` draws it: N(0, 1/fan_in)
# for an int, that constant for a float, log(1..N) along the last axis for
# LOG_ARANGE (Mamba1's A)
LOG_ARANGE = "log_arange"


class Layer(nn.Module):
    """A layer whose parameters ``spec(cfg)`` lists: name → (shape, start,
    float32?); a parameter that is not float32 has the config's dtype."""

    @staticmethod
    def spec(cfg) -> Dict[str, Tuple[tuple, object, bool]]:
        raise NotImplementedError

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        for name, (shape, _, f32) in self.spec(cfg).items():
            setattr(self, name, nn.Parameter(torch.zeros(
                shape, dtype=torch.float32 if f32 else dtype, device=device)))


def _attn_spec(cfg):
    d, qd, kvd = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
    return dict(ln1=((d,), 0.0, False), ln2=((d,), 0.0, False),
                wq=((d, qd), d, False), wk=((d, kvd), d, False),
                wv=((d, kvd), d, False), wo=((qd, d), qd, False))


class Block(Layer):
    """One pre-norm attention + SwiGLU block."""

    @staticmethod
    def spec(cfg):
        d, f = cfg.d_model, cfg.d_ff
        return dict(_attn_spec(cfg), w_gate=((d, f), d, False),
                    w_up=((d, f), d, False), w_down=((f, d), f, False))

    def ffn(self, h, cfg, capacity, group_shard=None, cap_shard=None):
        """The channel mixer on the normed stream → (out, MoEMetrics or
        None); the hooks are the MoE FFN's."""
        return swiglu(h, self.w_gate, self.w_up, self.w_down), None

    def attention(self, x, positions, cfg):
        """→ (out (B, S, d), k (B, S, K, hd), v)."""
        b, s, _ = x.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        q = split_heads(matmul(x, self.wq), h, hd, kv)
        k = split_heads(matmul(x, self.wk), kv, hd)
        v = split_heads(matmul(x, self.wv), kv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, causal=True, window=cfg.window)
        return reduce_partial(matmul(merge_dims(o, 2), self.wo)), k, v

    def forward(self, x, positions, cfg, group_shard=None, cap_shard=None):
        """→ (x, k, v, MoEMetrics or None); the MoE FFN at the config's
        capacity (prefill)."""
        a, k, v = self.attention(rms_norm(x, self.ln1), positions, cfg)
        x = x + a
        y, metrics = self.ffn(rms_norm(x, self.ln2), cfg, cfg.moe_capacity,
                              group_shard, cap_shard)
        return x + reduce_partial(y), k, v, metrics

    def attend_decode(self, x, cache_k, cache_v, pos: int, cfg):
        """x: (B, 1, d); cache_k/v: (B, Sc, K, hd), written in place at the
        new token's slot.  → out (B, 1, d)."""
        b = x.shape[0]
        h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        q = split_heads(matmul(x, self.wq), h, hd, kv)
        k = split_heads(matmul(x, self.wk), kv, hd)
        v = split_heads(matmul(x, self.wv), kv, hd)
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
        sc = cache_k.shape[1]
        slot = pos % sc if cfg.window > 0 else pos
        # the reference's dynamic_update_slice clamps a slot past the end
        # (overwriting the last one); an indexed copy would raise, so a
        # position the cache cannot hold is refused here instead
        if not 0 <= slot < sc:
            raise ValueError(f"position {pos} past the cache's {sc} slots")
        write_at(cache_k, 1, slot, k[:, 0].to(cache_k.dtype))
        write_at(cache_v, 1, slot, v[:, 0].to(cache_v.dtype))
        o = decode_attention(q, cache_k, cache_v, pos,
                             window=max(cfg.window, 0))
        return reduce_partial(matmul(o.reshape(b, 1, h * hd), self.wo))

    def decode(self, x, cache_k, cache_v, pos: int, cfg, group_shard=None,
               cap_shard=None):
        """The MoE FFN dropless (decode)."""
        x = x + self.attend_decode(rms_norm(x, self.ln1), cache_k, cache_v,
                                   pos, cfg)
        y, _ = self.ffn(rms_norm(x, self.ln2), cfg, None, group_shard,
                        cap_shard)
        return x + reduce_partial(y)


class MoEBlock(Block):
    """Attention + the MoE FFN: a float32 router and E SwiGLU experts."""

    @staticmethod
    def spec(cfg):
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        return dict(_attn_spec(cfg), router=((d, e), d, True),
                    w_gate=((e, d, f), d, False),
                    w_up=((e, d, f), d, False),
                    w_down=((e, f, d), f, False))

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__(cfg, dtype, device)
        self.moe = MoEFFN()

    def ffn(self, h, cfg, capacity, group_shard=None, cap_shard=None):
        b, s, d = h.shape
        y, metrics = self.moe(h.reshape(b * s, d), self.router, self.w_gate,
                              self.w_up, self.w_down, top_k=cfg.top_k,
                              capacity_factor=capacity,
                              n_groups=cfg.moe_groups,
                              group_shard=group_shard, cap_shard=cap_shard)
        return y.reshape(b, s, d), metrics


class Mamba1Layer(Layer):
    """A pre-norm Mamba1 mixer with its residual (falcon-mamba)."""

    @staticmethod
    def spec(cfg):
        d, di, n, r, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.dt_rank, cfg.conv_width)
        return dict(ln=((d,), 0.0, False),
                    in_proj=((d, 2 * di), d, False),
                    conv_w=((w, di), w, False), conv_b=((di,), 0.0, False),
                    x_proj=((di, r + 2 * n), di, False),
                    dt_proj=((r, di), r, False),
                    dt_bias=((di,), -4.6, False),        # softplus⁻¹(0.01)
                    a_log=((di, n), LOG_ARANGE, True),
                    d_skip=((di,), 1.0, False),
                    out_proj=((di, d), di, False))

    def forward(self, x, cfg, state: Optional[Mamba1State] = None,
                chunk: int = 256):
        """→ (x, Mamba1State); decode: ``state`` and ``chunk=1``."""
        y, state = mamba1_forward(self, rms_norm(x, self.ln),
                                  d_inner=cfg.d_inner, n_state=cfg.ssm_state,
                                  dt_rank=cfg.dt_rank, state=state,
                                  chunk=chunk)
        return x + reduce_partial(y), state


class Mamba2Layer(Layer):
    """A pre-norm Mamba2 (SSD) mixer with its residual (zamba2)."""

    @staticmethod
    def spec(cfg):
        d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.conv_width)
        return dict(ln=((d,), 0.0, False),
                    in_proj=((d, 2 * di + 2 * n + h), d, False),
                    conv_w=((w, di + 2 * n), w, False),
                    conv_b=((di + 2 * n,), 0.0, False),
                    dt_bias=((h,), -4.6, False),
                    a_log=((h,), 0.0, True),
                    d_skip=((h,), 1.0, False),
                    norm_w=((di,), 0.0, False),
                    out_proj=((di, d), di, False))

    def forward(self, x, cfg, state: Optional[Mamba2State] = None,
                chunk: int = 128):
        y, state = mamba2_forward(self, rms_norm(x, self.ln),
                                  d_inner=cfg.d_inner, n_state=cfg.ssm_state,
                                  n_heads=cfg.ssm_heads,
                                  head_dim=cfg.ssm_head_dim, state=state,
                                  chunk=chunk)
        return x + reduce_partial(y), state


def layer_classes(cfg) -> List[type]:
    """The class of each layer, in layer order."""
    check_family(cfg)
    if cfg.family == "ssm":
        return [Mamba1Layer] * cfg.n_layers
    if cfg.family == "hybrid":
        return [Mamba2Layer] * cfg.n_layers
    if cfg.family == "moe":
        return [Block, MoEBlock] * (cfg.n_layers // 2) \
            if cfg.moe_every == 2 else [MoEBlock] * cfg.n_layers
    return [Block] * cfg.n_layers


class Transformer(nn.Module):
    """Embedding, layers, final norm, LM head (absent when tied), the
    frontend's norm (audio, vlm) and the hybrid's shared block."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        d = cfg.d_model
        self.embed = nn.Parameter(torch.zeros((cfg.vocab, d), dtype=dt,
                                              device=device))
        self.final_norm = nn.Parameter(torch.zeros((d,), dtype=dt,
                                                   device=device))
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.zeros((d, cfg.vocab), dtype=dt, device=device))
        self.frontend_norm = None if cfg.frontend == "none" else \
            nn.Parameter(torch.zeros((d,), dtype=dt, device=device))
        self.blocks = nn.ModuleList(cls(cfg, dt, device)
                                    for cls in layer_classes(cfg))
        self.shared_attn = Block(cfg, dt, device) \
            if cfg.family == "hybrid" else None

    def layers(self) -> List[Layer]:
        """Every layer module: the stack, then the shared block."""
        return list(self.blocks) + ([self.shared_attn]
                                    if self.shared_attn is not None else [])


def _draw(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """N(0, 1/fan_in) in float32 on the generator's device into ``p``; a
    3-D (expert) tensor one slice of its leading axis at a time, so the
    float32 draw never holds a whole (E, d, f) tensor."""
    if p.dim() == 3:
        for sl in p:
            _draw(sl, fan_in, generator)
        return
    w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    p.copy_(w.mul_(1.0 / math.sqrt(fan_in)))


def init(cfg, generator: torch.Generator, device="cuda") -> Transformer:
    """Random weights from ``generator`` on ``device`` with the reference's
    starts (``init``): each matrix N(0, 1/fan_in) drawn in float32 on the
    generator's device and cast to its dtype, norms and biases zero, the
    SSMs' constants.  The reference's draws, from JAX's generator, differ.
    A CPU generator gives every device the same model."""
    net = Transformer(cfg, device)
    with torch.no_grad():
        _draw(net.embed, cfg.d_model, generator)
        if net.lm_head is not None:
            _draw(net.lm_head, cfg.d_model, generator)
        for layer in net.layers():
            for name, (_, start, _) in layer.spec(cfg).items():
                p = getattr(layer, name)
                if start == LOG_ARANGE:
                    p.copy_(torch.log(torch.arange(
                        1, p.shape[-1] + 1, dtype=torch.float32)).expand(
                        p.shape))
                elif isinstance(start, int):
                    _draw(p, start, generator)
                else:
                    p.fill_(start)
    return net


class Leaf(NamedTuple):
    """A leaf of the reference's parameter tree: its path, the port's
    parameters along its stacked axes (in their order), and those axes'
    sizes (``()`` for a leaf that is not stacked)."""
    path: Tuple[str, ...]
    params: List[nn.Parameter]
    lead: Tuple[int, ...]

    @property
    def key(self) -> str:
        return ".".join(self.path)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The stacked shape: the reference's leaf's."""
        return self.lead + tuple(self.params[0].shape)


_ATTN_NAMES = ("wq", "wk", "wv", "wo")
_NAMES = {"attn": "attn", "ln1": "ln1", "ln2": "ln2"}


def _layer_places(cfg, net: Transformer):
    """(layer, the tree's path to its unit, the index along the stacked
    axes, the tree's names for its attention and norms) for each layer:
    the reference's ``init`` layout, which stacks the layers (dense, moe,
    ssm), the (dense, moe) pairs (llama4) or the hybrid's (unit, layer in
    unit) under ``blocks``, the hybrid's remainder under ``tail``, and
    keeps one ``shared_attn``."""
    fam = cfg.family
    if fam == "hybrid":
        period = cfg.attn_every
        units = cfg.n_layers // period
        for li, layer in enumerate(net.blocks):
            u, j = divmod(li, period)
            yield (layer, ("blocks",), (u, j), _NAMES) if u < units else \
                (layer, ("tail",), (li - units * period,), _NAMES)
        yield net.shared_attn, ("shared_attn",), (), _NAMES
    elif fam == "moe" and cfg.moe_every == 2:
        pair = ({"attn": "attn1", "ln1": "ln1", "ln2": "ln2"},
                {"attn": "attn2", "ln1": "ln3", "ln2": "ln4"})
        for li, layer in enumerate(net.blocks):
            u, j = divmod(li, 2)
            yield layer, ("blocks",), (u,), pair[j]
    else:
        for li, layer in enumerate(net.blocks):
            yield layer, ("blocks",), (li,), _NAMES


def _sub_path(layer, name: str, names) -> Tuple[str, ...]:
    """A layer parameter's path within its unit of the reference's tree."""
    if isinstance(layer, (Mamba1Layer, Mamba2Layer)):
        return (name,) if name == "ln" else ("mixer", name)
    if name in _ATTN_NAMES:
        return (names["attn"], name)
    if name in ("ln1", "ln2"):
        return (names[name],)
    return ("moe" if isinstance(layer, MoEBlock) else "mlp", name)


def leaf_map(cfg, net: Transformer) -> List[Leaf]:
    """Every leaf of the reference's parameter tree for ``cfg``, in its
    flattening order (paths sorted), each with the parameters of ``net``
    it stacks: the inverse of the reference's layer stacking.  Every
    parameter of ``net`` is in one leaf."""
    found: Dict[Tuple[str, ...], list] = {}

    def add(path, idx, p):
        found.setdefault(path, []).append((idx, p))

    for name in ("embed", "final_norm", "lm_head", "frontend_norm"):
        if getattr(net, name) is not None:
            add((name,), (), getattr(net, name))
    for layer, prefix, idx, names in _layer_places(cfg, net):
        for name, p in layer.named_parameters():
            add(prefix + _sub_path(layer, name, names), idx, p)
    leaves = []
    for path in sorted(found):
        items = sorted(found[path], key=lambda t: t[0])
        lead = tuple(i + 1 for i in items[-1][0])
        leaves.append(Leaf(path, [p for _, p in items], lead))
    return leaves


def rows(leaf: Leaf, t: torch.Tensor) -> List[torch.Tensor]:
    """A tensor led by the leaf's stacked axes as views, one a parameter
    (the whole tensor for a leaf that is not stacked)."""
    if not leaf.lead:
        return [t]
    return list(t.view((-1,) + tuple(t.shape[len(leaf.lead):])).unbind(0))


def stack(leaf: Leaf, tensors) -> torch.Tensor:
    """One tensor a parameter → the leaf's stacked shape."""
    if not leaf.lead:
        return tensors[0]
    return torch.stack(list(tensors)).reshape(leaf.shape)


def _tree_paths(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], object]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_tree_paths(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def params_from_jax(cfg, params: Mapping, device="cuda") -> Transformer:
    """The reference's parameter tree (``transformer.init``'s, leaves as
    numpy arrays) as the port's modules: each leaf unstacked along its
    stacked axes into its parameters (``leaf_map``).  Every leaf of the
    tree lands in one parameter."""
    net = Transformer(cfg, device)
    leaves = leaf_map(cfg, net)
    arrays = _tree_paths(params)
    if set(arrays) != {leaf.path for leaf in leaves}:
        raise ValueError(f"tree leaves {sorted(arrays)} for the parameters "
                         f"{sorted(leaf.path for leaf in leaves)}")

    def put(p: nn.Parameter, a) -> None:
        a = np.array(a)                     # a writable, contiguous copy
        if a.dtype.name == "bfloat16":      # ml_dtypes: carried as bits
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        p.copy_(t.to(p.dtype))

    with torch.no_grad():
        for leaf in leaves:
            a = arrays[leaf.path]
            if tuple(a.shape) != leaf.shape:
                raise ValueError(f"{leaf.key}: shape {a.shape} for a leaf "
                                 f"of {leaf.shape}")
            rows_ = np.reshape(a, (-1,) + leaf.shape[len(leaf.lead):]) \
                if leaf.lead else [a]
            for p, row in zip(leaf.params, rows_):
                put(p, row)
    return net


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _stack_states(states, cls, lead: Tuple[int, ...]):
    """Per-layer states → one state stacked along ``lead`` axes."""
    return cls(*(torch.stack(parts).reshape(lead + parts[0].shape)
                 for parts in zip(*states)))


def _run(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` its activations are recomputed in the
    backward instead of stored (the reference's ``jax.checkpoint``)."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _same(t):
    return t


def _attn_unit(layers, x, positions, cfg, act_shard, cap_shard):
    """Attention blocks in order, ``act_shard`` after each → (x, their k,
    their v, their summed MoE aux loss or None)."""
    constrain = act_shard or _same
    ks, vs, aux = [], [], None
    for blk in layers:
        x, k, v, metrics = blk(x, positions, cfg, act_shard, cap_shard)
        x = constrain(x)
        ks.append(k)
        vs.append(v)
        if metrics is not None:
            aux = metrics.aux_loss if aux is None else aux + metrics.aux_loss
    return x, ks, vs, aux


def _hybrid_unit(layers, shared, x, positions, cfg, constrain):
    """A hybrid unit: its Mamba2 layers, then the shared block, then
    ``constrain`` → (x, the layers' states, k, v)."""
    states = []
    for layer in layers:
        x, st = layer(x, cfg)
        states.append(st)
    x, k, v, _ = shared(x, positions, cfg)
    return constrain(x), states, k, v


def _ssm_unit(layer, x, cfg, constrain):
    x, st = layer(x, cfg)
    return constrain(x), st


def forward(cfg, params: Transformer, embeds: torch.Tensor,
            positions: torch.Tensor, *, want_cache: bool = False,
            remat: bool = True, act_shard=None, moe_cap_shard=None):
    """Run the layers on (B, S, d) embeddings → (hidden (B, S, d), the MoE
    layers' summed aux loss (float32; 0 without MoE), cache or None).

    The cache is what ``decode_step`` consumes: attention families
    ``{"k", "v"}``, each stacked (L, B, S, K, hd) (SWA: the last
    ``window`` positions at their ring slots); ssm a ``Mamba1State``
    stacked (L, ...); hybrid ``{"mamba": Mamba2State (U, attn_every,
    ...), "tail": Mamba2State (R, ...) or None, "k", "v": (U, B, S, K,
    hd)}``, one KV cache for each application of the shared block.

    ``remat``, when grad is enabled: each unit of the reference's scans (a
    layer; llama4's (dense, MoE) pair; a hybrid unit with its shared
    block, and each tail layer) is recomputed in the backward.

    The sharding hooks (``distributed/sharding.py``), at the reference's
    points: ``act_shard`` on the (B, S, d) stream after each block, Mamba
    layer and hybrid unit (not after the hybrid's tail layers) and on the
    MoE's grouped tokens; ``moe_cap_shard`` on the MoE's dispatch and
    combine tensors.  None leaves the path as it is."""
    constrain = act_shard or _same
    x = embeds
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    fam = cfg.family
    if fam == "ssm":
        states = []
        for layer in params.blocks:
            x, st = _run(remat, _ssm_unit, layer, x, cfg, constrain)
            states.append(st)
        cache = _stack_states(states, Mamba1State, (cfg.n_layers,)) \
            if want_cache else None
        return x, aux, cache
    if fam == "hybrid":
        period = cfg.attn_every
        units, tail = divmod(cfg.n_layers, period)
        states, ks, vs = [], [], []
        for u in range(units):
            x, sts, k, v = _run(remat, _hybrid_unit,
                                params.blocks[u * period:(u + 1) * period],
                                params.shared_attn, x, positions, cfg,
                                constrain)
            states += sts
            ks.append(k)
            vs.append(v)
        for layer in params.blocks[units * period:]:
            x, st = _run(remat, layer, x, cfg)
            states.append(st)
        cache = None
        if want_cache:
            cache = _kv_cache_from_layers(ks, vs, cfg)
            cache["mamba"] = _stack_states(states[:units * period],
                                           Mamba2State, (units, period))
            cache["tail"] = _stack_states(states[units * period:],
                                          Mamba2State, (tail,)) \
                if tail else None
        return x, aux, cache
    step = 2 if fam == "moe" and cfg.moe_every == 2 else 1
    ks, vs = [], []
    for i in range(0, cfg.n_layers, step):
        x, k, v, a = _run(remat, _attn_unit, params.blocks[i:i + step], x,
                          positions, cfg, act_shard, moe_cap_shard)
        if a is not None:
            aux = aux + a
        if want_cache:
            ks += k
            vs += v
    cache = _kv_cache_from_layers(ks, vs, cfg) if want_cache else None
    return x, aux, cache


def _clip_window(kv: torch.Tensor, cfg) -> torch.Tensor:
    """Keep only the last ``window`` positions of an SWA cache (L, B, S,
    K, hd), ring layout: slot t % window holds token t."""
    if cfg.window <= 0 or kv.shape[2] <= cfg.window:
        return kv
    s, w = kv.shape[2], cfg.window
    start = s - w
    slots = (start + torch.arange(w, device=kv.device)) % w
    out = kv.new_zeros(kv.shape[:2] + (w,) + kv.shape[3:])
    out[:, :, slots] = kv[:, :, start:]
    return out


def _kv_cache_from_layers(ks, vs, cfg) -> Dict[str, torch.Tensor]:
    return {"k": _clip_window(torch.stack(ks), cfg),
            "v": _clip_window(torch.stack(vs), cfg)}


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------

def _decode_mamba(layer, x, cfg, state):
    """One token through ``layer``, its state (views into the cache)
    updated in place."""
    x, new = layer(x, cfg, state, chunk=1)
    for old, upd in zip(state, new):
        old.copy_(upd)
    return x


def decode_step(cfg, params: Transformer, embeds: torch.Tensor, cache,
                pos: int, *, act_shard=None, moe_cap_shard=None):
    """One-token decode.  embeds: (B, 1, d); ``cache`` from ``forward`` (or
    ``serve.kv_cache.init_cache``), updated in place (the reference
    returns a new one): the KV caches at ``pos``, the SSM states whole.
    MoE FFNs run dropless.  The hooks are ``forward``'s, at its points.
    → (hidden (B, 1, d), cache)."""
    constrain = act_shard or _same
    pos = int(pos)
    x = embeds
    fam = cfg.family
    if fam == "ssm":
        for li, layer in enumerate(params.blocks):
            x = constrain(_decode_mamba(layer, x, cfg, Mamba1State(
                cache.conv[li], cache.ssm[li])))
        return x, cache
    if fam == "hybrid":
        period = cfg.attn_every
        units = cfg.n_layers // period
        mamba, tail = cache["mamba"], cache["tail"]
        for li, layer in enumerate(params.blocks):
            u, j = divmod(li, period)
            if u < units:
                x = _decode_mamba(layer, x, cfg, Mamba2State(
                    mamba.conv[u, j], mamba.ssm[u, j]))
                if j == period - 1:
                    x = constrain(params.shared_attn.decode(
                        x, cache["k"][u], cache["v"][u], pos, cfg))
            else:
                r = li - units * period
                x = _decode_mamba(layer, x, cfg, Mamba2State(
                    tail.conv[r], tail.ssm[r]))
        return x, cache
    for li, blk in enumerate(params.blocks):
        x = constrain(blk.decode(x, cache["k"][li], cache["v"][li], pos, cfg,
                                 act_shard, moe_cap_shard))
    return x, cache


def param_count(params: Transformer) -> int:
    return sum(p.numel() for p in params.parameters())
