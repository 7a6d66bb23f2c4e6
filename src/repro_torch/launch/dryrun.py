"""The dry run (the reference's ``launch/dryrun.py``): for every
(architecture × input shape × mesh) cell, the inputs' specs, the defaults
the reference picks (microbatches, optimizer), each device's bytes of
parameters, optimizer state, batch inputs and decode cache under the
sharding rules (``distributed/sharding.py``: ``memory_cell``), and the
step's cost per device with its roofline (``build_step``, ``cell_cost``,
``analyse``, ``run_cell``: the reference's ``build_lowered``, ``analyse``
and ``run_cell``).  PyTorch has no compiled HLO to read: the step runs
once on the meta device, its tensors DTensors over a fake process group's
mesh of the production shape (``launch.mesh.fake_mesh``), under
``distributed/trace_cost.CostMode``, which counts each device's FLOPs,
bytes and collectives.  No device and no memory is used.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch tinyllama-1.1b --shape train_4k [--multi-pod] [--out f.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out dryrun.json          # --memory-only: the memory alone

The memory counts what the step's inputs hold, not its activations or
temporaries.  The roofline's constants are one NVIDIA H100 80GB HBM3's
data-sheet peaks at 700 W (``BF16_FLOPS``, ``F32_FLOPS``, ``HBM_BW``;
the links in ``distributed/collectives.py``) where the reference's are a
TPU v5e's.  The thresholds (8e9 bytes of TP-only weights before serving
goes FSDP, 1e11 parameters for Adafactor, 2 GiB remat stacks for
microbatching) are the reference's, chosen for its 16 GB devices, so
that the specs and defaults equal its own; "fits" compares the total with
one NVIDIA H100 80GB HBM3.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import registry
from ..configs.base import SHAPES, ShapeSpec, cell_runnable, get_shape
from ..distributed import collectives, sharding, shards, trace_cost
from ..models import transformer
from ..serve import kv_cache
from ..train import optimizer as opt
from .mesh import ShapeMesh, fake_mesh, make_production_mesh

MODEL_AXIS = "model"
# one NVIDIA H100 80GB HBM3's device memory (data sheet: 80 GB)
H100_NAME, H100_MEMORY_BYTES = "NVIDIA H100 80GB HBM3", 80e9
SERVE_FSDP_BYTES = 8e9          # TP-only bf16 weights a device, serving
ADAFACTOR_PARAMS = 1e11         # Adafactor from this many parameters
REMAT_STACK_BYTES = 2 << 30     # remat-saved activations a device
# the roofline's constants, one card's (the reference's are a TPU v5e's):
# NVIDIA H100 80GB HBM3, 700 W data-sheet peak (H100 SXM), dense
BF16_FLOPS = 989e12             # bfloat16 matmuls on the tensor cores
F32_FLOPS = 67e12               # float32 work outside the tensor cores
HBM_BW = 3.35e12                # bytes/s of HBM3
HARDWARE = ("NVIDIA H100 80GB HBM3, 700 W data-sheet peak: "
            f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense, "
            f"{F32_FLOPS / 1e12:.0f} TFLOP/s fp32, "
            f"{HBM_BW / 1e12:.2f} TB/s HBM, links as "
            "distributed/collectives.py")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name, cfg=None) -> Dict[str, Any]:
    """Meta tensors standing for every model input of a cell (a shape's
    name or a ``ShapeSpec``); ``cfg``: another config than the
    registry's (a model cut in depth: its cache)."""
    cfg = cfg or registry.get(arch)
    shp = _shape(shape_name)
    b, s = shp.global_batch, shp.seq_len
    p0 = cfg.frontend_tokens if cfg.frontend != "none" else 0
    i32 = torch.int32
    if shp.kind in ("train", "prefill"):
        spec = {"tokens": _meta((b, s - p0), i32)}
        if shp.kind == "train":
            spec["labels"] = _meta((b, s - p0), i32)
        if p0:
            spec["frontend"] = _meta((b, p0, cfg.d_model), torch.float32)
        return spec
    # decode: one new token against a seq_len-sized cache
    return {"cache": kv_cache.cache_specs(cfg, b, s),
            "token": _meta((b,), i32),
            "pos": _meta((), i32)}


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts D = batch tokens
    and forward-only (2·N·D)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch        # one token / seq


def default_microbatches(cfg, shp, mesh) -> int:
    """Grad-accumulation factor keeping the remat-saved per-layer activation
    stacks ≲2 GiB a device: stack ≈ L · (B/dp/mb) · S · d · 2 bytes."""
    if shp.kind != "train":
        return 1
    b_loc = max(shp.global_batch // sharding.dp_size(mesh), 1)
    stack = cfg.n_layers * b_loc * shp.seq_len * cfg.d_model * 2
    mb = 1
    while stack / mb > REMAT_STACK_BYTES and mb < b_loc:
        mb *= 2
    return mb


def default_opt_kind(cfg) -> str:
    """Adafactor for the ≥100B archs (AdamW's float32 moments alone would
    fill most of a 16 GB device), AdamW otherwise."""
    return "adafactor" if cfg.param_count() > ADAFACTOR_PARAMS else "adamw"


def _opt_specs(cfg, mesh, opt_state, p_spec):
    """The optimizer state's specs, by field (``step``, ``mu``/``nu`` or
    ``vr``/``vc``) and ``Leaf.key``: moments shard like their parameter
    (``p_spec``, by leaf path), a factored moment keeps its leading
    entries, scalars replicate."""
    by_key = {".".join(path): spec for path, spec in p_spec.items()}

    def like(head, key, leaf):
        spec = by_key.get(key)
        rank = len(leaf.shape)
        if rank == 0 or spec is None:
            return ()
        if len(spec) == rank:
            return spec
        if head in ("vr", "vc"):
            return spec[:rank]
        return ()

    return {head: {key: like(head, key, t) for key, t in val.items()}
            if isinstance(val, dict) else ()
            for head, val in opt_state._asdict().items()}


def _nbytes(mesh, spec, t: torch.Tensor) -> int:
    return math.prod(sharding.local_shape(mesh, spec, t.shape)) * \
        t.element_size()


def _at(tree, path):
    """The node of ``tree`` at a ``sharding.tree_map`` path."""
    for k in path:
        if isinstance(tree, dict):
            tree = tree[k]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, k)
        else:
            tree = tree[int(k)]
    return tree


def _tree_bytes(mesh, specs, tensors) -> int:
    """Per-device bytes of a tree of tensors under the tree of their
    specs."""
    sizes = []
    sharding.tree_map(lambda path, t: sizes.append(
        _nbytes(mesh, _at(specs, path), t)), tensors)
    return sum(sizes)


def moe_groups(cfg, shp, mesh, *, moe_group_tokens: int = 0,
               microbatches: Optional[int] = None) -> int:
    """The GShard dispatch groups of a MoE cell, as the reference's
    ``build_lowered`` picks them: the DP extent, or with
    ``moe_group_tokens`` > 0 about one group per that many tokens of a
    microbatch (its tokens: batch · sequence, decode's one a sequence;
    training's split over ``microbatches``, default
    ``default_microbatches``), rounded down to a multiple of the DP extent
    and at least that."""
    dp = sharding.dp_size(mesh)
    if not moe_group_tokens:
        return dp
    b = shp.global_batch
    tokens = b * shp.seq_len if shp.kind != "decode" else b
    if shp.kind == "train":
        tokens //= microbatches or default_microbatches(cfg, shp, mesh)
    want = max(tokens // moe_group_tokens, dp)
    return max((want // dp) * dp, dp)


def _choices(cfg, shp, mesh, *, fsdp: bool, moe_ep_axis: str,
             moe_group_tokens: int = 0, microbatches: Optional[int] = None):
    """The reference's per-cell choices on ``mesh``: → (cfg with its MoE
    dispatch groups (``moe_groups``), whether the weights go FSDP, the
    full-depth leaves, their specs by path).  FSDP for training, and for
    serving only where the TP-only weights pass ``SERVE_FSDP_BYTES``
    (never with experts over 'data')."""
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_groups=moe_groups(
            cfg, shp, mesh, moe_group_tokens=moe_group_tokens,
            microbatches=microbatches))
    leaves = transformer.leaf_map(cfg, transformer.Transformer(
        cfg, device="meta"))
    msize = sharding.axis_sizes(mesh)[MODEL_AXIS]
    serve_needs_fsdp = cfg.param_count() * 2 / msize > SERVE_FSDP_BYTES
    if moe_ep_axis == "data" and shp.kind != "train":
        serve_needs_fsdp = False
    use_fsdp = fsdp and (shp.kind == "train" or serve_needs_fsdp)
    p_spec = sharding.param_pspecs(cfg, mesh, leaves, fsdp=use_fsdp,
                                   moe_ep_axis=moe_ep_axis)
    return cfg, use_fsdp, leaves, p_spec


def memory_cell(arch: str, shape_name: str, *, multi_pod: bool,
                fsdp: bool = True, moe_ep_axis: str = "auto",
                split_kv: bool = True, opt_kind: Optional[str] = None,
                microbatches: Optional[int] = None,
                moe_group_tokens: int = 0) -> Dict[str, Any]:
    """One cell's per-device bytes of parameters, optimizer state
    (training), batch inputs and cache (decode), and their total, under
    the reference's choices: FSDP for training, and for serving only
    where the TP-only weights pass ``SERVE_FSDP_BYTES`` (never with
    experts over 'data'); the cache split over 'model' (``split_kv``) and,
    at batch 1, its sequence over 'data'.  The MoE dispatch groups
    (``moe_group_tokens``) shape no tensor counted here."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = registry.get(arch)
    shp = get_shape(shape_name)
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi_pod else "single"}
    ok, why = cell_runnable(cfg, shp)
    if not ok:
        out["skipped"] = why
        return out
    cfg, use_fsdp, leaves, p_spec = _choices(
        cfg, shp, mesh, fsdp=fsdp, moe_ep_axis=moe_ep_axis,
        moe_group_tokens=moe_group_tokens, microbatches=microbatches)
    parts = {"params": sum(_nbytes(mesh, p_spec[leaf.path],
                                   _meta(leaf.shape, leaf.params[0].dtype))
                           for leaf in leaves),
             "opt_state": 0, "inputs": 0, "cache": 0}
    specs = input_specs(arch, shape_name)
    kind = "-"
    if shp.kind == "train":
        kind = opt_kind or default_opt_kind(cfg)
        state = opt.init_opt(opt.OptConfig(kind=kind), leaves)
        parts["opt_state"] = _tree_bytes(
            mesh, _opt_specs(cfg, mesh, state, p_spec), state._asdict())
    if shp.kind in ("train", "prefill"):
        parts["inputs"] = _tree_bytes(
            mesh, sharding.batch_pspecs(cfg, mesh, specs), specs)
    else:
        seq_shard = shp.global_batch == 1
        parts["cache"] = _tree_bytes(
            mesh, sharding.cache_pspecs(cfg, mesh, specs["cache"],
                                        seq_shard=seq_shard,
                                        split_kv=split_kv), specs["cache"])
        tok = {"token": specs["token"]}
        parts["inputs"] = _tree_bytes(
            mesh, sharding.batch_pspecs(cfg, mesh, tok), tok) + \
            specs["pos"].element_size()
    parts["total"] = sum(parts.values())
    out.update({
        "devices": math.prod(sharding.axis_sizes(mesh).values()),
        "fsdp": use_fsdp, "opt": kind,
        "microbatches": microbatches if microbatches is not None
        else default_microbatches(cfg, shp, mesh),
        "model_flops": model_flops(cfg, shp),
        "bytes_per_device": parts,
        "fits": parts["total"] <= H100_MEMORY_BYTES,
        "device_memory": {"name": H100_NAME, "bytes": H100_MEMORY_BYTES}})
    return out


# ---------------------------------------------------------------------------
# The traced cost model (the reference's build_lowered / analyse / run_cell)
# ---------------------------------------------------------------------------

def depth_units(cfg) -> int:
    """The layer units the reference's scans run over: layers; llama4's
    (dense, MoE) pairs; the hybrid's units of ``attn_every`` Mamba2
    layers with the shared block (its tail layers are not a unit)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "moe" and cfg.moe_every == 2:
        return cfg.n_layers // 2
    return cfg.n_layers


def with_units(cfg, units: int):
    """``cfg`` cut to ``units`` layer units (the hybrid keeps its tail)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=units * cfg.attn_every +
                                   cfg.n_layers % cfg.attn_every)
    per = 2 if cfg.family == "moe" and cfg.moe_every == 2 else 1
    return dataclasses.replace(cfg, n_layers=units * per)


def _placed(mesh, specs, tensors):
    """A tree of meta tensors as DTensors on ``mesh`` by a tree of specs
    (no mesh: the tensors)."""
    if mesh is None:
        return tensors
    from torch.distributed.tensor import distribute_tensor
    return sharding.tree_map(lambda path, t: distribute_tensor(
        t, mesh, sharding.to_placements(mesh, _at(specs, path)),
        src_data_rank=None), tensors)


def build_step(arch: str, shape_name: str, mesh=None, *,
               units: Optional[int] = None, opt_kind: Optional[str] = None,
               microbatches: Optional[int] = None, remat: bool = True,
               fsdp: bool = True, moe_ep_axis: str = "auto",
               moe_group_tokens: int = 0, split_kv: bool = True,
               cap_shard: bool = False, cfg=None):
    """The cell's step on the meta device, as ``build_lowered`` builds it,
    → (run, cfg, shape): ``run()`` runs the step once.  ``mesh``: a
    ``DeviceMesh`` (a fake process group's, ``launch.mesh.fake_mesh``) on
    which the parameters, optimizer state, inputs and cache are DTensors
    placed by ``memory_cell``'s choices, with the hooks; None: one device,
    plain tensors.

    train: ``train_step`` with FSDP, remat, the cell's microbatches and
    optimizer, ``act_shard``, ``logit_shard`` and ``grad_shardings``;
    prefill: ``prefill`` with ``act_shard``, then the next token; decode:
    one ``decode`` step over ``cache_specs``' cache (``split_kv``; at
    batch 1 the sequence over 'data') at its last position, then the next
    token.  A MoE cell's dispatch groups follow ``moe_group_tokens``
    (``moe_groups``), and ``cap_shard`` passes
    ``sharding.make_moe_cap_shard`` to all three as ``moe_cap_shard``.
    ``units`` cuts the model to that many layer units, placed as the whole
    model is: ``cell_cost`` extrapolates from them.  ``cfg``: another
    config than the registry's (the tests' reduced ones)."""
    from ..models.model import Model
    from ..train import train_step as ts
    cfg = cfg or registry.get(arch)
    shp = _shape(shape_name)
    spec_mesh = mesh if mesh is not None else ShapeMesh((1, 1),
                                                        ("data", "model"))
    mb = None
    if shp.kind == "train":
        mb = microbatches or default_microbatches(cfg, shp, spec_mesh)
    cfg, use_fsdp, leaves, p_spec = _choices(
        cfg, shp, spec_mesh, fsdp=fsdp, moe_ep_axis=moe_ep_axis,
        moe_group_tokens=moe_group_tokens, microbatches=mb)
    run_cfg = cfg if units is None else with_units(cfg, units)
    model = Model(run_cfg)
    params = transformer.Transformer(run_cfg, device="meta")
    by_leaf = {leaf.key: sharding.to_placements(
        spec_mesh, sharding.layer_spec(leaf, p_spec[leaf.path]))
        for leaf in leaves}
    if mesh is not None:
        sharding.distribute_params(run_cfg, mesh, params, by_leaf=by_leaf)
    act = sharding.make_act_shard(mesh) if mesh is not None else None
    moe_cap = sharding.make_moe_cap_shard(spec_mesh) if cap_shard else None
    specs = input_specs(arch, shp, cfg=run_cfg)
    if shp.kind == "train":
        batch = _placed(mesh, sharding.batch_pspecs(cfg, spec_mesh, specs),
                        specs)
        oc = opt.OptConfig(kind=opt_kind or default_opt_kind(cfg))
        state = opt.init_opt(oc, transformer.leaf_map(run_cfg, params))
        hooks = {} if mesh is None else dict(
            act_shard=act, logit_shard=sharding.make_logit_shard(mesh),
            grad_shardings=by_leaf)
        step = ts.make_train_step(model, oc, microbatches=mb,
                                  remat=remat, moe_cap_shard=moe_cap,
                                  **hooks)
        return (lambda: step(params, state, None, batch)), cfg, shp
    if shp.kind == "prefill":
        batch = _placed(mesh, sharding.batch_pspecs(cfg, spec_mesh, specs),
                        specs)

        def prefill():
            with sharding.replicating(params):
                _, last, _ = model.prefill(params, batch, act_shard=act,
                                           moe_cap_shard=moe_cap)
                return _next_token(last)
        return prefill, cfg, shp
    seq_shard = shp.global_batch == 1
    cache = _placed(mesh, sharding.cache_pspecs(
        cfg, spec_mesh, specs["cache"], seq_shard=seq_shard,
        split_kv=split_kv), specs["cache"])
    tok = {"token": specs["token"]}
    token = _placed(mesh, sharding.batch_pspecs(cfg, spec_mesh, tok),
                    tok)["token"]
    # the decode position: its cost is the same at any, the cache's last
    pos = kv_cache.cache_seq_len(cfg, shp.seq_len) - 1

    def decode():
        with sharding.replicating(params):
            logits, _ = model.decode(params, cache, token, pos,
                                     moe_cap_shard=moe_cap)
            return _next_token(logits)
    return decode, cfg, shp


def _next_token(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of (B, V) logits; the vocabulary gathered first
    where it is sharded (DTensor's argmax over a sharded dim fails on a
    fake process group)."""
    return shards.replicate_dims(logits, (1,)).argmax(dim=-1).to(
        torch.int32)


def _shape(shape) -> ShapeSpec:
    """A shape's name (``SHAPES``) or a ``ShapeSpec`` → the spec."""
    return shape if isinstance(shape, ShapeSpec) else get_shape(shape)


def _points(n: int, lo: int) -> Tuple[Tuple[int, float], ...]:
    """The counts to trace for a cost linear in a count ``n`` from ``lo``
    on, each with its weight in the extrapolation to ``n``: ((n, 1),)
    where ``n`` is at most ``lo + 1``, else from ``lo`` and ``lo + 1``:
    c(n) = (lo + 1 − n)·c(lo) + (n − lo)·c(lo + 1)."""
    if n <= lo + 1:
        return ((n, 1.0),)
    return ((lo, lo + 1.0 - n), (lo + 1, n - float(lo)))


def cell_cost(arch: str, shape_name: str, mesh=None, **kw
              ) -> Tuple[trace_cost.CostReport, Any, Any]:
    """The cell's step traced under a sampling ``trace_cost.CostMode`` →
    (report per device, cfg, shape).  The reference weights a scanned
    layer's body by its trip count.  Here the alike iterations of the
    loops that grow with the sequence (flash blocks, SSM chunks) run once
    for all of them (``models.layers.alike``), and the step is traced at
    one and two layer units and, for training, at two and three
    microbatches (the first one differs: the accumulators start there):
    the counts are linear in each, bilinear in both, so the traces
    extrapolate to the model's depth and the cell's microbatches
    (``tests/test_torch_trace_cost.py`` holds the result equal to a whole
    trace).  ``kw``: ``build_step``'s."""
    cfg = kw.get("cfg") or registry.get(arch)
    shp = _shape(shape_name)
    n_units = depth_units(cfg)
    n_mb = kw.pop("microbatches", None)
    if shp.kind != "train":
        n_mb = 1
    elif not n_mb:
        n_mb = default_microbatches(cfg, shp, mesh if mesh is not None
                                    else ShapeMesh((1, 1), ("data", "model")))
    us, ms = _points(n_units, 1), _points(n_mb, 2)
    terms = []
    for u, wu in us:
        for m, wm in ms:
            run, cfg_used, _ = build_step(
                arch, dataclasses.replace(shp, global_batch=shp.global_batch
                                          // n_mb * m), mesh, units=u,
                microbatches=m, **kw)
            terms.append((wu * wm, trace_cost.trace(run, sample=True)[0]))
    rep = trace_cost.CostReport.combine(terms)
    rep.unit_counts = {"layer_units": n_units,
                       "traced_units": [u for u, _ in us],
                       "microbatches": n_mb,
                       "traced_microbatches": [m for m, _ in ms]}
    return rep, cfg_used, shp


def analyse(rep: trace_cost.CostReport, cfg, shp, n_devices: int
            ) -> Dict[str, Any]:
    """The reference's roofline keys from a per-device report, with one
    H100's constants: compute at ``BF16_FLOPS`` for the bfloat16/float16
    matmuls and ``F32_FLOPS`` for the rest, memory at ``HBM_BW`` over the
    ideal bytes, collectives at NVLink's or the fabric's rate
    (``collectives.collective_seconds``)."""
    lowp = rep.matmul_flops_lowp
    compute_s = lowp / BF16_FLOPS + (rep.flops - lowp) / F32_FLOPS
    memory_s = rep.bytes_ideal / HBM_BW
    coll_s = collectives.collective_seconds(
        collectives.from_trace(rep))
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mflops = model_flops(cfg, shp)
    total = rep.flops * n_devices
    bound = max(terms.values())
    ideal = mflops / (n_devices * BF16_FLOPS)
    return {
        "devices": int(n_devices),
        "flops_per_device": rep.flops,
        "bytes_per_device": rep.bytes_ideal,
        "bytes_per_device_eager": rep.bytes,
        "collective_bytes_per_device": rep.collective_bytes,
        "collective_breakdown": rep.bytes_by_collective,
        "collective_counts": rep.counts_by_collective,
        "unit_counts": rep.unit_counts,
        "terms": terms,
        "dominant": dominant,
        "model_flops": mflops,
        "useful_flop_fraction": mflops / total if total else 0.0,
        "roofline_fraction": ideal / bound if bound else 0.0,
        "step_time_bound_s": bound,
        "hardware": HARDWARE,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             opt_kind: Optional[str] = None,
             microbatches: Optional[int] = None, remat: bool = True,
             fsdp: bool = True, moe_ep_axis: str = "auto",
             moe_group_tokens: int = 0, split_kv: bool = True,
             cap_shard: bool = False) -> Dict[str, Any]:
    """One cell on its production mesh: ``memory_cell``'s per-device
    memory, the step traced over a fake process group's mesh of that
    shape (``cell_cost``), and ``analyse``'s roofline; a MoE cell also
    reports its dispatch groups and whether ``cap_shard`` was on."""
    mem = memory_cell(arch, shape_name, multi_pod=multi_pod, fsdp=fsdp,
                      moe_ep_axis=moe_ep_axis, split_kv=split_kv,
                      opt_kind=opt_kind, microbatches=microbatches,
                      moe_group_tokens=moe_group_tokens)
    if "skipped" in mem:
        return mem
    prod = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    with fake_mesh(tuple(prod.shape.values()), prod.axis_names) as mesh:
        rep, cfg, shp = cell_cost(arch, shape_name, mesh, opt_kind=opt_kind,
                                  microbatches=microbatches, remat=remat,
                                  fsdp=fsdp, moe_ep_axis=moe_ep_axis,
                                  moe_group_tokens=moe_group_tokens,
                                  split_kv=split_kv, cap_shard=cap_shard)
    res = {k: mem[k] for k in ("arch", "shape", "mesh", "fsdp", "opt",
                               "microbatches")}
    if cfg.n_experts:
        res.update(moe_groups=cfg.moe_groups, cap_shard=cap_shard)
    res.update(analyse(rep, cfg, shp, mem["devices"]))
    res.update({"trace_seconds": time.perf_counter() - t0,
                "memory_per_device": mem["bytes_per_device"],
                "fits": mem["fits"]})
    return res


def describe_cost(res: Dict[str, Any]) -> str:
    """One line for a cell's cost."""
    head = f"{res['arch']} × {res['shape']} × {res['mesh']}-pod"
    if "skipped" in res or "error" in res:
        return describe(res)
    t = res["terms"]
    if "moe_groups" in res:
        head += (f" (moe_groups {res['moe_groups']}, cap_shard "
                 f"{res['cap_shard']})")
    return (f"{head}: {res['dominant'][:-2]}-bound, step ≥ "
            f"{res['step_time_bound_s'] * 1e3:.3f} ms (compute "
            f"{t['compute_s'] * 1e3:.3f}, memory {t['memory_s'] * 1e3:.3f}, "
            f"collective {t['collective_s'] * 1e3:.3f} ms); per device "
            f"{res['flops_per_device'] / 1e12:.3f} TFLOP, "
            f"{res['bytes_per_device'] / 2**30:.3f} GiB ideal "
            f"({res['bytes_per_device_eager'] / 2**30:.3f} eager), "
            f"{res['collective_bytes_per_device'] / 2**30:.3f} GiB "
            f"collective; useful {res['useful_flop_fraction']:.3f}, "
            f"roofline {res['roofline_fraction']:.3f}; memory "
            f"{res['memory_per_device']['total'] / 2**30:.3f} GiB "
            f"({'fits' if res['fits'] else 'does not fit'}); traced in "
            f"{res['trace_seconds']:.1f} s")


def describe(res: Dict[str, Any]) -> str:
    """One line for a cell."""
    head = f"{res['arch']} × {res['shape']} × {res['mesh']}-pod"
    if "skipped" in res:
        return f"[skip] {head}: {res['skipped']}"
    if "error" in res:
        return f"[FAIL] {head}: {res['error']}"
    gib = {k: v / 2**30 for k, v in res["bytes_per_device"].items()}
    return (f"{head}: per device params {gib['params']:.3f} GiB, opt state "
            f"{gib['opt_state']:.3f} GiB, inputs {gib['inputs']:.3f} GiB, "
            f"cache {gib['cache']:.3f} GiB, total {gib['total']:.3f} GiB "
            f"({'fits' if res['fits'] else 'does not fit'} one "
            f"{H100_NAME}'s {H100_MEMORY_BYTES / 1e9:.0f} GB; fsdp "
            f"{res['fsdp']}, opt {res['opt']}, microbatches "
            f"{res['microbatches']})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default=None, choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ep-axis", default="auto", choices=["auto", "data"])
    ap.add_argument("--moe-group-tokens", type=int, default=0,
                    help="MoE dispatch groups of about this many tokens "
                         "(0: one a DP rank)")
    ap.add_argument("--no-split-kv", action="store_true",
                    help="head-sharded KV cache instead of sequence-split")
    ap.add_argument("--cap-shard", action="store_true",
                    help="shard MoE dispatch/combine over 'model' (the "
                         "expert dim, else the capacity dim)")
    ap.add_argument("--memory-only", action="store_true",
                    help="each device's memory only, no traced cost")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shp.name) for arch in registry.all_archs()
                 for shp in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape required (or --all)")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    kw = dict(fsdp=not args.no_fsdp, moe_ep_axis=args.ep_axis,
              split_kv=not args.no_split_kv, opt_kind=args.opt,
              microbatches=args.microbatches,
              moe_group_tokens=args.moe_group_tokens)
    if not args.memory_only:
        kw.update(remat=not args.no_remat, cap_shard=args.cap_shard)

    results, failures = [], 0
    t0 = time.perf_counter()
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                if args.memory_only:
                    res = memory_cell(arch, shape_name, multi_pod=mp, **kw)
                else:
                    res = run_cell(arch, shape_name, multi_pod=mp, **kw)
            except Exception as e:       # report the cell, go on
                failures += 1
                res = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if mp else "single",
                       "error": f"{type(e).__name__}: {e}"}
            print(describe(res) if args.memory_only else describe_cost(res),
                  flush=True)
            results.append(res)
    print(f"{len(results)} cell-meshes in {time.perf_counter() - t0:.1f} s, "
          f"{failures} failed")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
