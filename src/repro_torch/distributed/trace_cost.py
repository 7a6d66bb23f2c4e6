"""Cost model over a traced step (the reference's ``distributed/
hlo_cost.py``).

The reference parses XLA's compiled, partitioned HLO text and weights
every instruction by its loop trip count.  PyTorch runs eagerly and has no
HLO, so the port records the step itself: ``CostMode``, a
``TorchDispatchMode``, sees every aten op that runs on the tensors of the
meta device while the step runs (on DTensors, each op on a device's local
shards, and the functional c10d collectives that DTensor issues to
redistribute them).  Meta tensors hold no memory and compute nothing, so
a step at its published widths over a fake process group's mesh traces in
seconds on a host.  Ops on other devices are DTensor's own bookkeeping
(shard sizes and offsets) and are skipped.

The conventions are the reference's:

  * FLOPs: a matmul-family op (``mm``, ``bmm``, ``addmm``, ``baddbmm``:
    what ``einsum`` and ``@`` lower to) counts 2·|out|·K; an elementwise
    arithmetic op counts |out|, and so does a reduction;
  * bytes: ``bytes`` is every op's operands plus its output (eager PyTorch
    fuses nothing, so every op is a fusion boundary; views are free);
    ``bytes_ideal`` only those of matmuls, reductions, gathers, scatters,
    slice updates (2× the update, read and write) and collectives, the
    ops that move data even under ideal fusion;
  * collectives, per device, from the input and output bytes and the
    group's size n: all-reduce 2·(n−1)/n of its input, reduce-scatter and
    all-to-all (n−1)/n of it, all-gather its output minus its input, a
    permute 1× (``collective_moved``).

A tensor's bytes count each element it addresses once: a broadcast (stride
0) dim counts 1.  There is no loop to read trip counts from: the dry run
traces one and two layer units (and, for training, two and three
microbatches) and extrapolates (``CostReport.combine``); ``unit_counts``
records the counts it extrapolated to.  The loops whose trip count grows
with the sequence (flash attention's blocks, the SSM scans' chunks) run
alike iterations: under a sampling trace (``CostMode(sample=True)``) the
model runs one of them, its ops counted for all (``sampling``,
``weight``; ``models.layers.alike``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_aten = torch.ops.aten

_MATMUL = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
           _aten.baddbmm.default}

_REDUCTIONS = {
    _aten.sum.default, _aten.sum.dim_IntList, _aten.mean.default,
    _aten.mean.dim, _aten.amax.default, _aten.amin.default,
    _aten.max.default, _aten.max.dim, _aten.min.default, _aten.min.dim,
    _aten.logsumexp.default, _aten.prod.default, _aten.prod.dim_int,
    _aten.argmax.default, _aten.argmin.default, _aten.cumsum.default,
    _aten.norm.Scalar, _aten.linalg_vector_norm.default,
    _aten.var.correction, _aten.std.correction, _aten.any.default,
    _aten.any.dim, _aten.all.default, _aten.all.dim,
}

_GATHERS = {_aten.index.Tensor, _aten.index_select.default,
            _aten.gather.default, _aten.embedding.default, _aten.take.default}

_SCATTERS = {
    _aten.index_put.default, _aten.index_put_.default,
    _aten._index_put_impl_.default, _aten.scatter.src,
    _aten.scatter.value, _aten.scatter_.src, _aten.scatter_.value,
    _aten.scatter_add.default, _aten.scatter_add_.default,
    _aten.index_add.default, _aten.index_add_.default,
    _aten.index_copy.default, _aten.index_copy_.default,
    _aten.slice_scatter.default, _aten.select_scatter.default,
    _aten.embedding_dense_backward.default,
}

# ops that move no memory: aliasing and allocation only (the reference's
# bitcast / parameter / tuple / constant)
_FREE = {
    _aten.detach.default, _aten.lift_fresh.default,
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.resolve_conj.default,
    _aten.resolve_neg.default, _aten._reshape_alias.default,
}

# pointwise ops that copy or fill: bytes, no FLOPs (XLA's convert and
# copy are not arithmetic either)
_COPIES = {_aten.clone.default, _aten._to_copy.default, _aten.copy_.default,
           _aten.copy.default, _aten.fill_.Scalar, _aten.fill.Scalar,
           _aten.zero_.default, _aten.masked_fill.Scalar,
           _aten.masked_fill_.Scalar}

_TRANSCENDENTAL = {"exp", "exp2", "log", "log1p", "expm1", "tanh", "sigmoid",
                   "rsqrt", "sqrt", "pow", "erf", "sin", "cos", "reciprocal"}

# a functional c10d op's name → the reference's HLO name
_COLLECTIVE_KINDS = (("all_gather", "all-gather"),
                     ("all_reduce", "all-reduce"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"),
                     ("permute", "collective-permute"))

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def collective_moved(kind: str, in_bytes: float, out_bytes: float,
                     n: int) -> float:
    """Bytes a device moves for one collective of a group of ``n``: the
    reference's formulas (``collectives.parse_collectives``)."""
    if kind == "all-gather":
        return max(out_bytes - in_bytes, 0.0)
    if kind == "all-reduce":
        return 2.0 * in_bytes * (n - 1) / max(n, 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return in_bytes * (n - 1) / max(n, 1)
    return float(in_bytes)


def nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor addresses: its element size times the product
    of its sizes, a broadcast (stride 0) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


@dataclasses.dataclass
class CollectiveOp:
    kind: str            # the reference's HLO name, e.g. "all-gather"
    bytes: float         # moved per device
    group_size: int
    hosts: int           # hosts of 8 cards that the group's ranks span
    count: float = 1.0   # how many times it runs (extrapolation weights)


@dataclasses.dataclass
class CostReport:
    """The reference's report, per device.  ``matmul_flops``: the share
    of ``flops`` in matmuls, ``matmul_flops_lowp`` in bfloat16/float16
    ones (the tensor cores' work); ``unit_counts``: the layer units the
    traced ones were extrapolated to (the reference's
    ``while_trip_counts``)."""
    flops: float = 0.0
    bytes: float = 0.0
    bytes_ideal: float = 0.0
    collective_bytes: float = 0.0
    bytes_by_collective: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    counts_by_collective: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    unit_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    transcendental: float = 0.0
    matmul_flops: float = 0.0
    matmul_flops_lowp: float = 0.0
    collectives: List[CollectiveOp] = dataclasses.field(default_factory=list)

    _SCALARS = ("flops", "bytes", "bytes_ideal", "collective_bytes",
                "transcendental", "matmul_flops", "matmul_flops_lowp")

    @staticmethod
    def combine(terms: Sequence[Tuple[float, "CostReport"]]) -> "CostReport":
        """Σ weight × report, field by field: how the dry run extrapolates
        traced layer units to a model's depth."""
        out = CostReport()
        for w, rep in terms:
            for f in CostReport._SCALARS:
                setattr(out, f, getattr(out, f) + w * getattr(rep, f))
            for f in ("bytes_by_collective", "counts_by_collective"):
                acc = getattr(out, f)
                for k, v in getattr(rep, f).items():
                    acc[k] = acc.get(k, 0.0) + w * v
            out.collectives += [dataclasses.replace(c, count=w * c.count)
                                for c in rep.collectives]
        return out


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# cards in one host, joined by NVLink (an NVIDIA DGX/HGX H100 has 8)
HOST_CARDS = 8


def _group_of(name) -> Tuple[int, int]:
    """A process group's name → (its size, the hosts its ranks span)."""
    from torch.distributed.distributed_c10d import (_resolve_process_group,
                                                    get_process_group_ranks)
    ranks = get_process_group_ranks(_resolve_process_group(name))
    return len(ranks), len({r // HOST_CARDS for r in ranks})


_ACTIVE: List["CostMode"] = []


def sampling() -> bool:
    """Whether a sampling ``CostMode`` is active."""
    return bool(_ACTIVE) and _ACTIVE[-1].sample


@contextlib.contextmanager
def weight(w: float):
    """Within the context, the active ``CostMode`` counts every op ``w``
    times (no mode: nothing)."""
    if w == 1.0 or not _ACTIVE:
        yield
        return
    mode = _ACTIVE[-1]
    old, mode.scale = mode.scale, mode.scale * w
    try:
        yield
    finally:
        mode.scale = old


class CostMode(TorchDispatchMode):
    """Records the cost of every op on meta tensors while it is active →
    ``report``.  A DTensor op is left to DTensor (``NotImplemented``), so
    the mode sees the local ops and collectives it runs."""

    def __init__(self, sample: bool = False):
        super().__init__()
        self.report = CostReport()
        self.sample = sample
        self.scale = 1.0
        self._quiet = 0
        self._restore: List = []
        self._dtensor = None
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        self._quiet_in_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        for obj, name in self._restore:      # the class's method again
            delattr(obj, name)
        self._restore.clear()
        return super().__exit__(*exc)

    def _quiet_in_propagation(self) -> None:
        """DTensor infers an op's output shapes by running it on meta
        tensors of the global shapes (the first time it meets the op and
        shapes): that is no device's work, so the mode records nothing
        while DTensor's sharding propagator runs."""
        if self._dtensor is None:
            return
        prop = self._dtensor._op_dispatcher.sharding_propagator
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            fn = getattr(prop, name, None)
            if fn is None or name in vars(prop):
                continue

            def quiet(*a, _fn=fn, **k):
                self._quiet += 1
                try:
                    return _fn(*a, **k)
                finally:
                    self._quiet -= 1
            setattr(prop, name, quiet)
            self._restore.append((prop, name))

    def _count(self, func, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func in _FREE or func.is_view or not any(
                t.device.type == "meta" for t in ins + outs):
            return
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd", "c10d"):
            self._collective(func, args, ins, outs)
            return
        k, rep = self.scale, self.report
        moved = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
        out_elems = sum(t.numel() for t in outs)
        ideal = True
        if func in _MATMUL:
            a = args[1] if func in (_aten.addmm.default,
                                    _aten.baddbmm.default) else args[0]
            f = 2.0 * outs[0].numel() * a.shape[-1]
            rep.flops += k * f
            rep.matmul_flops += k * f
            if a.dtype in _LOW_PRECISION:
                rep.matmul_flops_lowp += k * f
        elif func in _REDUCTIONS:
            rep.flops += k * out_elems
        elif func is _aten.copy_.default and args[0]._is_view():
            # an update of a slice in place: read the update, write it
            moved = 2 * nbytes(args[1])
        elif func not in _GATHERS and func not in _SCATTERS:
            ideal = False
            if func not in _COPIES and torch.Tag.pointwise in func.tags:
                rep.flops += k * out_elems
                if func._schema.name.split("::")[-1].rstrip("_") in \
                        _TRANSCENDENTAL:
                    rep.transcendental += k * out_elems
        rep.bytes += k * moved
        if ideal:
            rep.bytes_ideal += k * moved

    def _collective(self, func, args, ins, outs) -> None:
        name = func._schema.name.split("::")[-1]
        kind = next((k for key, k in _COLLECTIVE_KINDS if key in name), None)
        if kind is None or not ins:         # wait_tensor, wrappers: free
            return
        n, hosts = _group_of(args[-1])
        in_b = sum(nbytes(t) for t in ins)
        out_b = sum(nbytes(t) for t in outs)
        moved = collective_moved(kind, in_b, out_b, n)
        k, rep = self.scale, self.report
        rep.collective_bytes += k * moved
        rep.bytes_by_collective[kind] = \
            rep.bytes_by_collective.get(kind, 0.0) + k * moved
        rep.counts_by_collective[kind] = \
            rep.counts_by_collective.get(kind, 0.0) + k
        rep.collectives.append(CollectiveOp(kind, moved, n, hosts, k))
        rep.bytes += k * (in_b + out_b)
        rep.bytes_ideal += k * (in_b + out_b)


def trace(fn, *args, sample: bool = False,
          **kwargs) -> Tuple[CostReport, object]:
    """Run ``fn(*args, **kwargs)`` under ``CostMode`` → (its report, what
    ``fn`` returned).  ``sample``: loops of alike iterations run one
    (``models.layers.alike``), whose cost counts for all."""
    mode = CostMode(sample)
    with mode:
        out = fn(*args, **kwargs)
    return mode.report, out
