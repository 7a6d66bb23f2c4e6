"""Ops of the model that run on DTensors by their local shards.

DTensor's own propagation of an ``einsum`` goes through ``view``s that
fold the batch dims into one, and torch 2.11 refuses to fold a sharded dim
behind the first (2.13 rewrites it as a strided shard).  With the batch
over 'data' and heads, experts or SSM heads over 'model', every attention,
MoE and Mamba2 contraction folds two sharded dims.  So these ops take the
shards in hand, as GSPMD would: each operand is redistributed to one
layout a mesh dim, the op runs on the local tensors (where folding is
free) and the result is placed back.  No communication happens that the
layout does not need: a contraction over a sharded dim leaves a partial
sum (``reduce_partial`` all-reduces it where the reference's specs
replicate the result).

On plain tensors every function is the plain op, so the plain path is
unchanged bit for bit; on a 1×1 mesh the shards are the whole tensors.
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, List, Optional, Sequence

import torch


def is_dtensor(t) -> bool:
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _contiguous_stride(shape, order=None) -> tuple:
    """The strides of a dense tensor of ``shape`` whose dims lie in memory
    in ``order`` (outermost first; default: row-major)."""
    order = range(len(shape)) if order is None else order
    out, acc = [0] * len(shape), 1
    for d in reversed(list(order)):
        out[d] = acc
        acc *= max(int(shape[d]), 1)
    return tuple(out)


def _layout(local: torch.Tensor, shape):
    """(local, global strides) for a DTensor of global ``shape`` built from
    ``local``: a shard dense in some order of its dims (an einsum's output
    is often a transposed product) keeps that order in the global strides,
    so that DTensor copies where a view of the shard would fail, as a
    reshape of the plain tensor does; any other shard is made contiguous."""
    if local.is_contiguous():
        return local, _contiguous_stride(shape)
    order = sorted(range(local.ndim), key=lambda d: (-local.stride(d), d))
    if local.permute(order).is_contiguous():
        return local, _contiguous_stride(shape, order)
    return local.contiguous(), _contiguous_stride(shape)


_FROM_LOCAL_GRAD = None


def _from_local(local, mesh, placements, shape, grad_placements=None):
    """``DTensor.from_local`` of a global ``shape`` (laid out as ``local``
    is: ``_layout``), passing the grad's placements where this torch takes
    them."""
    from torch.distributed.tensor import DTensor
    global _FROM_LOCAL_GRAD
    if _FROM_LOCAL_GRAD is None:
        _FROM_LOCAL_GRAD = "grad_placements" in inspect.signature(
            DTensor.from_local).parameters
    kw = {}
    if grad_placements is not None and _FROM_LOCAL_GRAD:
        kw["grad_placements"] = tuple(grad_placements)
    local, stride = _layout(local, shape)
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=stride, **kw)


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _no_partial(p):
    from torch.distributed.tensor import Replicate
    return Replicate() if p.is_partial() else p


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``; on DTensors by their shards.  For each
    mesh dim: where exactly one operand is a partial sum and the others
    are replicated, the result is a partial sum (einsum is linear in each
    operand); else, of the labels that operands shard on it, one of the
    result's (from the largest such operand) stays sharded, or failing
    that a contracted one (the result a partial sum), and every operand is
    redistributed to shard that label where it has it and to replicate
    otherwise.  ``eq`` names every dim (no ellipsis)."""
    if not any(is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = next(o for o in ops if is_dtensor(o)).device_mesh
    ops = [_as_dtensor(o, mesh) for o in ops]
    lhs, out_l = eq.replace(" ", "").split("->")
    in_ls = lhs.split(",")
    sizes = {lab: n for labs, o in zip(in_ls, ops)
             for lab, n in zip(labs, o.shape)}
    nd = mesh.ndim
    target = [[Replicate()] * nd for _ in ops]
    grads = [[Replicate()] * nd for _ in ops]
    out_pl: List = [Replicate()] * nd
    for m in range(nd):
        pl = [o.placements[m] for o in ops]
        part = [i for i, p in enumerate(pl) if p.is_partial()]
        if len(part) == 1 and getattr(pl[part[0]], "reduce_op", "sum") == \
                "sum" and all(p.is_replicate() for i, p in enumerate(pl)
                              if i != part[0]):
            target[part[0]][m] = pl[part[0]]
            for i in range(len(ops)):
                if i != part[0]:
                    grads[i][m] = Partial()
            out_pl[m] = Partial()
            continue
        cands = [(in_ls[i][p.dim], i) for i, p in enumerate(pl)
                 if p.is_shard()]
        if not cands:
            continue
        pool = [c for c in cands if c[0] in out_l] or cands
        label = max(pool, key=lambda c: ops[c[1]].numel())[0]
        for i, labs in enumerate(in_ls):
            if label in labs:
                target[i][m] = grads[i][m] = Shard(labs.index(label))
            else:
                grads[i][m] = Partial()
        out_pl[m] = Shard(out_l.index(label)) if label in out_l \
            else Partial()
    locs = [o.redistribute(mesh, t).to_local(grad_placements=g)
            for o, t, g in zip(ops, target, grads)]
    out = torch.einsum(eq, *locs)
    return _from_local(out, mesh, out_pl, [sizes[lab] for lab in out_l],
                       [_no_partial(p) for p in out_pl])


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations x (..., K) and a weight w (K, N).  On
    DTensors through ``einsum``: a weight sharded along K over an axis
    that shards the activations' batch (FSDP) is gathered there, the
    reference's ZeRO-3 (DTensor's own choice may instead move the
    activations and leave a partial sum over the batch axis)."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    lead = "abcefgh"[:x.ndim - 1]
    return einsum(f"{lead}k,kn->{lead}n", x, w)


def local_map(fn: Callable, ins: Sequence, outs: Sequence[str],
              keep: str):
    """``fn(*tensors)`` for ``ins`` = (tensor, labels) pairs, one label a
    dim as in an einsum, where ``fn``'s work is independent along the
    labels of ``keep`` (batch, heads) and its outputs are laid out as
    ``outs``' labels.  On DTensors it runs on each device's local tensors:
    each mesh dim keeps one label of ``keep`` sharded (the one that the
    largest input shards on it), every input that has that label shards
    it there and every other dim is replicated first; the outputs are
    placed by their labels.  An input without the kept label takes a
    partial sum as its grad (each device's share)."""
    tensors = [t for t, _ in ins]
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = next(t for t in tensors if is_dtensor(t)).device_mesh
    tensors = [_as_dtensor(t, mesh) for t in tensors]
    labels = [lab for _, lab in ins]
    sizes: dict = {}
    for t, lab in zip(tensors, labels):      # a label's first size counts
        for c, n in zip(lab, t.shape):
            sizes.setdefault(c, n)
    nd = mesh.ndim
    target = [[Replicate()] * nd for _ in tensors]
    grads = [[Replicate()] * nd for _ in tensors]
    chosen: List = [None] * nd
    for m in range(nd):
        cands = [(lab[t.placements[m].dim], t) for t, lab in
                 zip(tensors, labels) if t.placements[m].is_shard() and
                 lab[t.placements[m].dim] in keep]
        if not cands:
            continue
        c = max(cands, key=lambda x: x[1].numel())[0]
        chosen[m] = c
        for i, lab in enumerate(labels):
            if c in lab:
                target[i][m] = grads[i][m] = Shard(lab.index(c))
            else:
                grads[i][m] = Partial()
    locs = [t.redistribute(mesh, tp).to_local(grad_placements=g)
            for t, tp, g in zip(tensors, target, grads)]
    out = fn(*locs)
    single = isinstance(out, torch.Tensor)
    wrapped = []
    for local, lab in zip([out] if single else out, outs):
        place = [Shard(lab.index(c)) if c is not None and c in lab
                 else Replicate() for c in chosen]
        wrapped.append(_from_local(local, mesh, place,
                                   [sizes[c] for c in lab]))
    return wrapped[0] if single else tuple(wrapped)


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums all-reduced (replicated); any other tensor
    as it is: where the reference's specs replicate a row-parallel
    product's result (Megatron's all-reduce)."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def replicate_dims(t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """A DTensor with its shards of ``dims`` replicated (others kept); any
    other tensor as it is."""
    if not is_dtensor(t) or not any(p.is_shard() and p.dim in dims
                                    for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_shard() and p.dim in dims else p
        for p in t.placements])


def shards_of(t: torch.Tensor, dim: int) -> int:
    """How many pieces the mesh cuts ``t``'s ``dim`` into (1 for a plain
    tensor)."""
    if not is_dtensor(t):
        return 1
    return math.prod(t.device_mesh.size(m) for m, p in enumerate(t.placements)
                     if p.is_shard(dim))


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: (V, d) rows of integer ``ids`` → ids.shape + (d,).
    A DTensor table sharded along its rows (the vocabulary) is read as
    GSPMD reads it: each device gathers the ids that fall in its rows
    (zeros for the others) and the result is a partial sum over those
    mesh dims, then all-reduced; a shard of the row width is gathered
    first (FSDP).  The ids keep their placements."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    ids = _as_dtensor(ids, mesh)
    rows = [p.is_shard(0) for p in table.placements]
    table = table.redistribute(mesh, [Shard(0) if r else Replicate()
                                      for r in rows])
    ids = ids.redistribute(mesh, [Replicate() if r else _no_partial(p)
                                  for r, p in zip(rows, ids.placements)])
    local_rows, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    lo, n = int(offset[0]), int(local_rows[0])
    # a device's rows take its own ids' grads: a shard of the rows, a
    # partial sum over the mesh dims that split the ids
    tab = table.to_local(grad_placements=[
        Shard(0) if r else Partial() if p.is_shard() else Replicate()
        for r, p in zip(rows, ids.placements)])
    idx = ids.to_local() - lo
    inside = (idx >= 0) & (idx < n)
    out = tab[torch.where(inside, idx, 0)] * inside[..., None].to(tab.dtype)
    place = [Partial() if r else p for r, p in zip(rows, ids.placements)]
    out = _from_local(out, mesh, place, tuple(ids.shape) + (table.shape[1],),
                      [_no_partial(p) for p in place])
    return reduce_partial(out)


def write_at(dst: torch.Tensor, dim: int, index: int,
             src: torch.Tensor) -> None:
    """``dst.select(dim, index).copy_(src)`` in place.  Where a DTensor
    ``dst`` is sharded along ``dim`` (a KV cache's sequence), only the
    device that holds ``index`` writes, into its own shard, as GSPMD's
    dynamic update of a sharded dim does: no cache is gathered."""
    if not is_dtensor(dst) or not any(p.is_shard(dim)
                                      for p in dst.placements):
        dst.select(dim, index).copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    src = _as_dtensor(src, mesh).redistribute(mesh, [
        Replicate() if p.is_shard(dim) or not p.is_shard()
        else Shard(p.dim - (p.dim > dim)) for p in dst.placements])
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo = int(offset[dim])
    if lo <= index < lo + int(shape[dim]):
        dst.to_local().select(dim, index - lo).copy_(src.to_local())


def merge_dims(t: torch.Tensor, start: int,
               end: Optional[int] = None) -> torch.Tensor:
    """``t`` with its dims ``start`` .. ``end`` − 1 (default: to the last)
    merged into one (the heads' (H, hd) into H·hd; the MoE's (G, S) groups
    back into tokens).  On a DTensor, whose shards may cut only dims
    outside the group and ``start`` itself, the local tensor is reshaped
    and keeps the placements (a partial sum stays one), and so does the
    grad on its way back: DTensor's own view would unflatten a sharded dim
    in the backward, which it refuses where the shards do not hold whole
    heads, and would move a partial sum where the merge cannot be a view."""
    end = t.ndim if end is None else end
    shape = tuple(t.shape[:start]) + (math.prod(t.shape[start:end]),) + \
        tuple(t.shape[end:])
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Shard
    mesh, gone = t.device_mesh, end - start - 1
    place = [Shard(p.dim - gone) if p.is_shard() and p.dim >= end else p
             for p in t.placements]
    loc = t.to_local(grad_placements=[_no_partial(p) for p in t.placements])
    loc = loc.reshape(tuple(loc.shape[:start]) + (-1,) +
                      tuple(loc.shape[end:]))
    return _from_local(loc, mesh, place, shape,
                       [_no_partial(p) for p in place])


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` redistributed to ``ref``'s placements; any other
    tensor as it is."""
    if not is_dtensor(t):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)
