"""The dry run's first half (the reference's ``launch/dryrun.py`` without
its lowering): for every (architecture × input shape × mesh) cell, the
inputs' specs, the defaults the reference picks (microbatches, optimizer)
and each device's bytes of parameters, optimizer state, batch inputs and
decode cache under the sharding rules (``distributed/sharding.py``).  It
needs no process group and no device: shapes live on the meta device and
the production mesh (``launch.mesh.make_production_mesh``) is shape-only.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch tinyllama-1.1b --shape train_4k [--multi-pod] [--out f.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out dryrun.json

The bytes count what the step's inputs hold, not its activations or
temporaries: those, the traced cost model and the roofline are ROADMAP
item A14d2.  The thresholds (8e9 bytes of TP-only weights before serving
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
from typing import Any, Dict, Optional

import torch

from ..configs import registry
from ..configs.base import SHAPES, cell_runnable, get_shape
from ..distributed import sharding
from ..models import transformer
from ..serve import kv_cache
from ..train import optimizer as opt
from .mesh import make_production_mesh

MODEL_AXIS = "model"
# one NVIDIA H100 80GB HBM3's device memory (data sheet: 80 GB)
H100_NAME, H100_MEMORY_BYTES = "NVIDIA H100 80GB HBM3", 80e9
SERVE_FSDP_BYTES = 8e9          # TP-only bf16 weights a device, serving
ADAFACTOR_PARAMS = 1e11         # Adafactor from this many parameters
REMAT_STACK_BYTES = 2 << 30     # remat-saved activations a device


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Meta tensors standing for every model input of a cell."""
    cfg = registry.get(arch)
    shp = get_shape(shape_name)
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


def memory_cell(arch: str, shape_name: str, *, multi_pod: bool,
                fsdp: bool = True, moe_ep_axis: str = "auto",
                split_kv: bool = True, opt_kind: Optional[str] = None,
                microbatches: Optional[int] = None) -> Dict[str, Any]:
    """One cell's per-device bytes of parameters, optimizer state
    (training), batch inputs and cache (decode), and their total, under
    the reference's choices: FSDP for training, and for serving only
    where the TP-only weights pass ``SERVE_FSDP_BYTES`` (never with
    experts over 'data'); the cache split over 'model' (``split_kv``) and,
    at batch 1, its sequence over 'data'."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = registry.get(arch)
    shp = get_shape(shape_name)
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi_pod else "single"}
    ok, why = cell_runnable(cfg, shp)
    if not ok:
        out["skipped"] = why
        return out
    if cfg.n_experts:       # dispatch groups aligned to the DP extent
        cfg = dataclasses.replace(cfg, moe_groups=sharding.dp_size(mesh))
    leaves = transformer.leaf_map(cfg, transformer.Transformer(
        cfg, device="meta"))
    msize = sharding.axis_sizes(mesh)[MODEL_AXIS]
    serve_needs_fsdp = cfg.param_count() * 2 / msize > SERVE_FSDP_BYTES
    if moe_ep_axis == "data" and shp.kind != "train":
        serve_needs_fsdp = False
    use_fsdp = fsdp and (shp.kind == "train" or serve_needs_fsdp)
    p_spec = sharding.param_pspecs(cfg, mesh, leaves, fsdp=use_fsdp,
                                   moe_ep_axis=moe_ep_axis)
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
    ap.add_argument("--ep-axis", default="auto", choices=["auto", "data"])
    ap.add_argument("--no-split-kv", action="store_true",
                    help="head-sharded KV cache instead of sequence-split")
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

    results, failures = [], 0
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                res = memory_cell(arch, shape_name, multi_pod=mp,
                                  fsdp=not args.no_fsdp,
                                  moe_ep_axis=args.ep_axis,
                                  split_kv=not args.no_split_kv,
                                  opt_kind=args.opt,
                                  microbatches=args.microbatches)
            except Exception as e:       # report the cell, go on
                failures += 1
                res = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if mp else "single",
                       "error": f"{type(e).__name__}: {e}"}
            print(describe(res), flush=True)
            results.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
