"""Sharding rules of the port (the reference's ``distributed/sharding.py``):
parameter-path patterns → specs, the specs of activations, inputs and
caches, the specs as DTensor placements, and the hooks that place
activations while a step runs.

The mesh is ("pod", "data", "model") multi-pod or ("data", "model")
single-pod (``launch/mesh.py``).  ``pod`` and ``data`` are pure DP for
training; ``model`` carries TP (attention heads / d_ff / vocab), EP
(experts, when the expert count divides the axis) and the Mamba inner
dimension.  Every function takes a ``DeviceMesh`` or the shape-only
``launch.mesh.ShapeMesh``; placing a tensor needs a ``DeviceMesh``.

A spec is a tuple with one entry a dimension: ``None``, an axis name, or
a tuple of axis names in the mesh's order.  These are the reference's
``PartitionSpec`` entries, normalized as it normalizes them (a tuple of
one name is the name).

Rules are matched on the "/"-joined path of a leaf of the reference's
parameter tree and give the spec of the leaf's TRAILING dims; leading
stacked-layer dims are padded with None.  They are decided on the
*stacked* leaf, (L, d, f) or (U, period, d, f), as the reference sees it
(``transformer.leaf_map``: ``Leaf.lead`` followed by a parameter's
shape): the rank padding, the FSDP size gate and the FSDP dimension, which
is never a stacked one, all read the stacked shape.  A per-layer parameter
takes its leaf's spec without the stacked dims' entries (always None).

``to_placements`` gives a spec as one ``Shard(d)`` or ``Replicate()`` a
mesh dimension; a dim sharded over two axes is ``Shard(d)`` on both.  One
difference from the reference: DTensor splits an uneven dimension as
``torch.chunk`` does (the last shards smaller, or empty), where GSPMD pads
it to a multiple of the axis.  ``local_shape`` gives the largest shard,
the first device's.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models import transformer

MODEL = "model"

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """The mesh's axis names → sizes, in the mesh's order."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _spec(entries) -> Spec:
    """Entries → a spec, as ``PartitionSpec`` normalizes them: a tuple of
    one axis is that axis, an empty tuple None."""
    out = []
    for e in entries:
        if isinstance(e, tuple):
            e = (e[0] if len(e) == 1 else e) if e else None
        out.append(e)
    return tuple(out)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') multi-pod, ('data',) else."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def dp_size(mesh) -> int:
    """The data-parallel extent: the product of ``batch_axes``' sizes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def _rules(cfg, mesh, moe_ep_axis: Optional[str] = "auto"
           ) -> List[Tuple[str, Tuple[Optional[str], ...]]]:
    sizes = axis_sizes(mesh)
    msize = sizes[MODEL]
    ep = cfg.n_experts > 0 and cfg.n_experts % msize == 0
    # "auto": experts over 'model' when divisible, else TP within experts;
    # "data": experts over 'data' + d_ff TP over 'model' (2-D: weights
    # fully resident, tokens all-to-all over 'data')
    ep_data = (moe_ep_axis == "data" and cfg.n_experts > 0 and
               cfg.n_experts % sizes.get("data", 1) == 0)
    rules: List[Tuple[str, Tuple[Optional[str], ...]]] = [
        (r"embed$", (MODEL, None)),
        (r"lm_head$", (None, MODEL)),
        # attention: heads (flattened H*hd) over model
        (r"attn\w*/wq$", (None, MODEL)),
        (r"attn\w*/wk$", (None, MODEL)),
        (r"attn\w*/wv$", (None, MODEL)),
        (r"attn\w*/wo$", (MODEL, None)),
        # dense MLP: d_ff over model
        (r"mlp/w_gate$", (None, MODEL)),
        (r"mlp/w_up$", (None, MODEL)),
        (r"mlp/w_down$", (MODEL, None)),
        # the router is tiny: replicated
        (r"moe/router$", ()),
    ]
    if ep_data:
        rules += [
            (r"moe/w_gate$", ("data", None, MODEL)),
            (r"moe/w_up$", ("data", None, MODEL)),
            (r"moe/w_down$", ("data", MODEL, None)),
        ]
    elif ep:          # experts over model (llama4: 128/16 = 8)
        rules += [
            (r"moe/w_gate$", (MODEL, None, None)),
            (r"moe/w_up$", (MODEL, None, None)),
            (r"moe/w_down$", (MODEL, None, None)),
        ]
    else:             # TP within experts (grok-1: 8 experts < 16)
        rules += [
            (r"moe/w_gate$", (None, None, MODEL)),
            (r"moe/w_up$", (None, None, MODEL)),
            (r"moe/w_down$", (None, MODEL, None)),
        ]
    rules += [
        # mamba: d_inner over model
        (r"mixer/in_proj$", (None, MODEL)),
        (r"mixer/x_proj$", (MODEL, None)),
        (r"mixer/dt_proj$", (None, MODEL)),
        (r"mixer/out_proj$", (MODEL, None)),
        (r"mixer/a_log$", (MODEL, None)) if cfg.ssm_variant == "mamba1"
        else (r"mixer/a_log$", ()),
        # small per-channel tensors: replicated
        (r"(conv_w|conv_b|dt_bias|d_skip|norm_w)$", ()),
        (r"(ln\d?|final_norm|frontend_norm)$", ()),
        (r".*", ()),        # default: replicated
    ]
    return rules


def _pad(spec: Sequence[Optional[str]], rank: int) -> Spec:
    spec = tuple(spec)
    if len(spec) > rank:   # scalar-ish leaves
        spec = spec[-rank:] if rank else ()
    return _spec((None,) * (rank - len(spec)) + spec)


def leaf_pspec(cfg, mesh, path: Sequence[str], shape: Sequence[int], *,
               fsdp: bool = False, moe_ep_axis: Optional[str] = "auto",
               rules=None) -> Spec:
    """The spec of one leaf of the reference's parameter tree, from its
    path and its STACKED shape.

    ``fsdp=True`` also shards every large weight across 'data' (ZeRO-3):
    only the rule's trailing dims are candidates, never a stacked-layer
    dim, and EP-over-data weights are already data-sharded.  ``pod``
    stays pure DP."""
    rules = rules if rules is not None else _rules(cfg, mesh, moe_ep_axis)
    sizes = axis_sizes(mesh)
    dsize = sizes.get("data", 1)
    name = "/".join(path)
    rank = len(shape)
    for pat, s in rules:
        if not re.search(pat, name):
            continue
        # divisibility guard: drop the annotation if the dim is smaller
        # than the axis
        ps = list(_pad(s, rank))
        for i, ax in enumerate(ps):
            if ax is not None and shape[i] % sizes[ax] and \
                    shape[i] < sizes[ax]:
                ps[i] = None
        already_data = any(ax == "data" or (isinstance(ax, tuple) and
                                            "data" in ax) for ax in ps)
        if fsdp and rank >= 2 and math.prod(shape) >= 1 << 20 and \
                not already_data:
            for i in range(max(rank - len(s), 0), rank):
                if ps[i] is None and shape[i] % dsize == 0 and \
                        shape[i] >= dsize:
                    ps[i] = "data"
                    break
        return _spec(ps)
    return ()


def param_pspecs(cfg, mesh, leaves, *, fsdp: bool = False,
                 moe_ep_axis: Optional[str] = "auto"
                 ) -> Dict[Tuple[str, ...], Spec]:
    """Leaf path → spec for ``leaves`` (``transformer.leaf_map``'s, or any
    with ``path`` and the stacked ``shape``)."""
    rules = _rules(cfg, mesh, moe_ep_axis)
    return {leaf.path: leaf_pspec(cfg, mesh, leaf.path, leaf.shape,
                                  fsdp=fsdp, rules=rules)
            for leaf in leaves}


def layer_spec(leaf, spec: Spec) -> Spec:
    """A stacked leaf's spec → that of each of its per-layer parameters."""
    n = len(leaf.lead)
    if any(e is not None for e in spec[:n]):
        raise ValueError(f"{leaf.key}: spec {spec} shards a stacked dim")
    return spec[n:]


def param_placements(cfg, mesh, params, *, fsdp: bool = False,
                     moe_ep_axis: Optional[str] = "auto"
                     ) -> Dict[str, tuple]:
    """``Leaf.key`` → the placements of each of its per-layer parameters,
    for the ``Transformer`` ``params``: what ``distribute_params`` gives
    the parameters and the train step's ``grad_shardings`` their grads."""
    leaves = transformer.leaf_map(cfg, params)
    specs = param_pspecs(cfg, mesh, leaves, fsdp=fsdp,
                         moe_ep_axis=moe_ep_axis)
    return {leaf.key: to_placements(mesh, layer_spec(leaf, specs[leaf.path]))
            for leaf in leaves}


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

def _axes_of(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, spec: Spec) -> tuple:
    """A spec → one placement a mesh dimension: ``Shard(d)`` on each axis
    that shards tensor dim d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = []
        for a in _axes_of(entry):
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {entry} out of the mesh's "
                             f"order {names}")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"spec {spec}: axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(mesh, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
    """The largest per-device shape of a tensor of ``shape`` placed by
    ``to_placements(mesh, spec)``: each sharded dim split as
    ``torch.chunk`` splits it, over its axes in the mesh's order."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in _axes_of(entry):
            out[d] = -(-out[d] // sizes[a])
    return tuple(out)


def distribute_params(cfg, mesh, params: transformer.Transformer, *,
                      fsdp: bool = False,
                      moe_ep_axis: Optional[str] = "auto",
                      by_leaf: Optional[Dict[str, tuple]] = None
                      ) -> transformer.Transformer:
    """Every parameter of ``params`` replaced, in place, by a DTensor on
    the ``DeviceMesh`` ``mesh`` with its spec's placements (each rank
    holds the same full tensors before the call) → ``params``.
    ``by_leaf``: the placements by ``Leaf.key`` to use instead (the dry
    run places a model cut in depth as its whole depth is placed).
    Parameters on the meta device are placed without communication."""
    from torch.distributed.tensor import distribute_tensor
    if by_leaf is None:
        by_leaf = param_placements(cfg, mesh, params, fsdp=fsdp,
                                   moe_ep_axis=moe_ep_axis)
    where = {id(p): by_leaf[leaf.key]
             for leaf in transformer.leaf_map(cfg, params)
             for p in leaf.params}
    for module in params.modules():
        for name, p in list(module.named_parameters(recurse=False)):
            src = {"src_data_rank": None} if p.device.type == "meta" else {}
            module.register_parameter(name, nn.Parameter(
                distribute_tensor(p.detach(), mesh, where[id(p)], **src),
                requires_grad=p.requires_grad))
    return params


def replicating(params):
    """``implicit_replication()`` where a parameter of the module
    ``params`` is a DTensor: the plain tensors the model makes itself
    (positions, RoPE tables, masks, the inputs) then count as replicated;
    else no context."""
    if not torch.distributed.is_available():
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    # implicit_replication() switches off on exit whatever it found, so an
    # entry point called inside another's context must not enter it again
    if any(isinstance(p, DTensor) for p in params.parameters()) and \
            not DTensor._op_dispatcher._allow_implicit_replication:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Activation / input / cache specs and the hooks
# ---------------------------------------------------------------------------

def act_pspec(mesh, *, seq_shard: bool = False) -> Spec:
    """(B, S, d) activations: batch over DP axes; optionally sequence over
    'data' (long-context B=1 cells — sequence parallelism)."""
    if seq_shard:
        return (None, "data", None)
    return _spec((batch_axes(mesh), None, None))


def _placer(mesh, spec: Spec) -> Callable:
    """x → x redistributed to ``spec``'s placements on its mesh, which
    must have ``mesh``'s axes; a plain tensor unchanged.  A dim of size 1,
    or smaller than its axes, stays replicated (the reference's guard on
    parameters): GSPMD pads such a dim, while DTensor would give ranks
    empty shards and refuses to view a sharded dim of size 1 away (x @ w
    on a (1, S, d) microbatch)."""
    sizes = axis_sizes(mesh)

    def put(x):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        if axis_sizes(x.device_mesh) != sizes:
            raise ValueError(f"a DTensor on {x.device_mesh} for a hook of "
                             f"the mesh {sizes}")
        fit = tuple(None if e is None or x.shape[d] == 1 or x.shape[d] <
                    math.prod(sizes[a] for a in _axes_of(e)) else e
                    for d, e in enumerate(spec))
        return x.redistribute(x.device_mesh, to_placements(mesh, fit))
    return put


def make_act_shard(mesh, *, seq_shard: bool = False) -> Callable:
    """The hook of (B, S, d) activations at unit boundaries; tensors of
    another rank pass."""
    put = _placer(mesh, act_pspec(mesh, seq_shard=seq_shard))

    def f(x):
        return put(x) if x.ndim == 3 else x
    return f


def make_moe_cap_shard(mesh) -> Callable:
    """(G, S, E, C) MoE dispatch/combine tensors: groups over DP, and the
    expert dim over 'model' where it divides (it aligns with EP-over-model
    expert weights), else the capacity dim."""
    msize = axis_sizes(mesh)[MODEL]
    ba = batch_axes(mesh)
    on_e = _placer(mesh, _spec((ba, None, MODEL, None)))
    on_c = _placer(mesh, _spec((ba, None, None, MODEL)))

    def f(x):
        if x.ndim != 4 or x.shape[0] < 2:
            return x
        if x.shape[2] % msize == 0:
            return on_e(x)
        if x.shape[3] % msize == 0:
            return on_c(x)
        return x
    return f


def make_logit_shard(mesh) -> Callable:
    """(B, S, V) logits: batch over DP, vocab over model (float32 logits
    replicated over the model axis would dominate per-device memory)."""
    return _placer(mesh, _spec((batch_axes(mesh), None, MODEL)))


def tree_map(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples (named or not) and
    leaves; None stays None.  A path entry is a key or a field name."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_pspecs(cfg, mesh, batch, *, seq_shard: bool = False):
    """Input batch specs: tokens/labels (B, S) over DP; frontend (B, P,
    d); with ``seq_shard`` (B = 1) the sequence over 'data'."""
    ba = batch_axes(mesh)
    dp = dp_size(mesh)

    def spec_for(path, leaf):
        rank = len(leaf.shape)
        if seq_shard:
            return ((None, "data") + (None,) * (rank - 2))[:rank]
        if leaf.shape[0] % dp == 0:
            return _spec((ba,) + (None,) * (rank - 1))
        return (None,) * rank

    return tree_map(spec_for, batch)


def cache_pspecs(cfg, mesh, cache_shape, *, seq_shard: bool = False,
                 split_kv: bool = True):
    """KV / SSM cache specs.

    Full-attention KV (L, B, Sc, K, hd): batch over DP and, with
    ``split_kv``, the sequence over 'model' (flash-decoding-style: each
    model shard owns a slice of history); else heads, or the head dim,
    over 'model'.  With ``seq_shard`` (long_500k, B=1) the sequence shards
    over 'data' too.  SSM states (L, B, d_inner, N): the feature dim over
    model."""
    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    msize = sizes[MODEL]
    dp = dp_size(mesh)

    def spec_for(path, leaf):
        rank = len(leaf.shape)
        shape = leaf.shape
        if rank >= 4 and path[-1:] in (("k",), ("v",)):
            # (L, B, Sc, K, hd), possibly with more leading unit dims
            k_dim, hd_dim = rank - 2, rank - 1
            seq_dim, b_dim = rank - 3, rank - 4
            spec: List[Any] = [None] * rank
            if seq_shard:
                spec[seq_dim] = ("data", MODEL) if split_kv and \
                    shape[seq_dim] % (sizes.get("data", 1) * msize) == 0 \
                    else "data"
            elif shape[b_dim] % dp == 0:
                spec[b_dim] = ba
            if split_kv:
                if spec[seq_dim] is None and shape[seq_dim] % msize == 0:
                    spec[seq_dim] = MODEL
            elif shape[k_dim] % msize == 0:
                spec[k_dim] = MODEL
            elif shape[hd_dim] % msize == 0:
                spec[hd_dim] = MODEL
            return _spec(spec)
        if rank >= 3:     # SSM states: the feature dim over model
            spec = [None] * rank
            if not seq_shard and shape[1] % dp == 0:
                spec[1] = ba
            for d in range(rank - 1, 1, -1):
                if shape[d] % msize == 0:
                    spec[d] = MODEL
                    break
            return _spec(spec)
        return (None,) * rank

    return tree_map(spec_for, cache_shape)
