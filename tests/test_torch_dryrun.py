"""Port (repro_torch) ≡ reference (repro): the dry run's first half.

The reference's side runs in one subprocess (importing
``repro.launch.dryrun`` sets 512 host devices, which must not reach this
process's JAX) and prints, for every cell of the registry's 10 archs × 4
shapes on the (16, 16) and (2, 16, 16) production meshes: the 6 long_500k
skips, and for the 34 runnable cells the inputs' shapes and dtypes
(``input_specs``), ``model_flops``, ``default_microbatches``,
``default_opt_kind``, ``_opt_specs`` of AdamW and Adafactor (training),
and every tensor the step holds with its spec, by the reference's rules
(FSDP for training, and for serving where the TP-only weights pass 8e9
bytes).  The port must equal it exactly, and ``memory_cell``'s
per-device bytes must equal the sum over those tensors of their largest
shard under the reference's specs (each sharded dim split as
``torch.chunk`` splits it) times their item size.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, get_shape
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as opt

ROOT = os.path.join(os.path.dirname(__file__), "..")

# the MoE dispatch groups: ``build_lowered``'s own count for every MoE
# arch, serving and training shape, production mesh, token cap (0: one
# group a DP rank) and microbatch override (None: the default)
GROUP_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
GROUP_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
GROUP_TOKENS = (0, 512, 4096, 65536)
GROUP_MICROBATCHES = (None, 4)

REF_CODE = r"""
import json, math
GROUP_ARCHS, GROUP_SHAPES = %r, %r
GROUP_TOKENS, GROUP_MICROBATCHES = %r, %r
from repro.launch import dryrun
import jax, jax.numpy as jnp
from repro.configs import registry
from repro.configs.base import SHAPES, cell_runnable
from repro.distributed import sharding
from repro.models.model import Model
from repro.train import optimizer as opt


class Mesh:        # what the reference's sharding and dry run read
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


P = jax.sharding.PartitionSpec
MESHES = {"single": Mesh((16, 16), ("data", "model")),
          "multi": Mesh((2, 16, 16), ("pod", "data", "model"))}


def key(k):
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree, is_leaf=None):
    return {"/".join(key(k) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def specs(tree):
    return {p: list(s) for p, s in
            flat(tree, lambda x: isinstance(x, P)).items()}


def held(shapes, spec_tree):
    sp = specs(spec_tree)
    return [[list(x.shape), jnp.dtype(x.dtype).itemsize, sp[p]]
            for p, x in flat(shapes).items()]


cells = []
for arch, cfg in registry.all_archs().items():
    params = jax.eval_shape(Model(cfg).init_params, jax.random.PRNGKey(0))
    states = {k: jax.eval_shape(
        lambda p: opt.init_opt(opt.OptConfig(kind=k), p), params)
        for k in ("adamw", "adafactor")}
    for shp in SHAPES:
        ok, why = cell_runnable(cfg, shp)
        for mname, mesh in MESHES.items():
            cell = {"arch": arch, "shape": shp.name, "mesh": mname}
            cells.append(cell)
            if not ok:
                cell["skipped"] = why
                continue
            ins = dryrun.input_specs(arch, shp.name)
            cell["inputs"] = {p: [list(x.shape), jnp.dtype(x.dtype).name]
                              for p, x in flat(ins).items()}
            cell["flops"] = dryrun.model_flops(cfg, shp)
            cell["microbatches"] = dryrun.default_microbatches(cfg, shp,
                                                               mesh)
            cell["opt"] = dryrun.default_opt_kind(cfg)
            # build_lowered's FSDP choice
            serve_fsdp = cfg.param_count() * 2 / mesh.shape["model"] > 8e9
            use_fsdp = shp.kind == "train" or serve_fsdp
            cell["fsdp"] = use_fsdp
            p_spec = sharding.param_pspecs(cfg, mesh, params, fsdp=use_fsdp)
            cell["params"] = held(params, p_spec)
            if shp.kind == "train":
                o_specs = {k: dryrun._opt_specs(cfg, mesh, st, p_spec)
                           for k, st in states.items()}
                cell["opt_specs"] = {k: specs(v) for k, v in o_specs.items()}
                k = cell["opt"]
                cell["opt_state"] = held(states[k], o_specs[k])
            if shp.kind in ("train", "prefill"):
                cell["batch"] = held(ins, sharding.batch_pspecs(cfg, mesh,
                                                                ins))
            else:
                tok = {"t": ins["token"]}
                cell["batch"] = held(tok, sharding.batch_pspecs(cfg, mesh,
                                                                tok)) + \
                    [[[], 4, []]]
                cell["cache"] = held(ins["cache"], sharding.cache_pspecs(
                    cfg, mesh, ins["cache"],
                    seq_shard=shp.global_batch == 1, split_kv=True))


class Stop(Exception):
    pass


def stand_in(cfg):          # build_lowered's Model: the groups, then stop
    groups.append(cfg.moe_groups)
    raise Stop


groups, group_cells = [], []
dryrun.Model = stand_in
for arch in GROUP_ARCHS:
    for shape in GROUP_SHAPES:
        for mname, mesh in MESHES.items():
            for n in GROUP_TOKENS:
                for m in GROUP_MICROBATCHES:
                    try:
                        dryrun.build_lowered(arch, shape, mesh,
                                             moe_group_tokens=n,
                                             microbatches=m)
                    except Stop:
                        group_cells.append([arch, shape, mname, n, m,
                                            groups[-1]])
print(json.dumps({"cells": cells, "groups": group_cells}))
""" % (GROUP_ARCHS, GROUP_SHAPES, GROUP_TOKENS, GROUP_MICROBATCHES)


@pytest.fixture(scope="module")
def ref_out():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_CODE], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_cells(ref_out):
    return {(c["arch"], c["shape"], c["mesh"]): c for c in ref_out["cells"]}


def _spec(entries):
    """A spec from JSON lists: axis tuples back to tuples."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _largest_shard(shape, spec, sizes):
    out = list(shape)
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else e or ()):
            out[d] = -(-out[d] // sizes[a])
    return math.prod(out)


def _held_bytes(held, sizes):
    return sum(_largest_shard(shape, _spec(spec), sizes) * size
               for shape, size, spec in held)


ARCHS = sorted(registry.all_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_reference(arch, ref_cells):
    """Each cell of the arch on both meshes: the skip, the inputs' shapes
    and dtypes, ``model_flops``, ``default_microbatches``,
    ``default_opt_kind``, ``_opt_specs`` (AdamW and Adafactor) and
    ``memory_cell``'s bytes by part."""
    cfg = registry.get(arch)
    leaves = TT.leaf_map(cfg, TT.Transformer(cfg, device="meta"))
    states = {k: opt.init_opt(opt.OptConfig(kind=k), leaves)
              for k in ("adamw", "adafactor")}
    for shp in SHAPES:
        for mname, multi in (("single", False), ("multi", True)):
            want = ref_cells[(arch, shp.name, mname)]
            got = dryrun.memory_cell(arch, shp.name, multi_pod=multi)
            ctx = (arch, shp.name, mname)
            if "skipped" in want:
                assert got == want, ctx
                continue
            mesh = make_production_mesh(multi_pod=multi)
            sizes = sharding.axis_sizes(mesh)
            ins = {}
            sharding.tree_map(lambda p, t: ins.__setitem__(
                "/".join(p), [list(t.shape),
                              str(t.dtype).replace("torch.", "")]),
                dryrun.input_specs(arch, shp.name))
            assert ins == want["inputs"], ctx
            assert dryrun.model_flops(cfg, shp) == want["flops"], ctx
            assert dryrun.default_microbatches(cfg, shp, mesh) == \
                want["microbatches"] == got["microbatches"], ctx
            assert dryrun.default_opt_kind(cfg) == want["opt"], ctx
            assert got["fsdp"] == want["fsdp"], ctx
            if shp.kind == "train":
                p_spec = sharding.param_pspecs(cfg, mesh, leaves, fsdp=True)
                for kind, state in states.items():
                    o = dryrun._opt_specs(cfg, mesh, state, p_spec)
                    flat = {"step": o["step"]}
                    flat.update({f"{head}/{k.replace('.', '/')}": s
                                 for head, v in o.items() if head != "step"
                                 for k, s in v.items()})
                    assert flat == {p: _spec(s) for p, s in
                                    want["opt_specs"][kind].items()}, \
                        (ctx, kind)
            parts = got["bytes_per_device"]
            assert parts["params"] == _held_bytes(want["params"], sizes)
            assert parts["opt_state"] == _held_bytes(
                want.get("opt_state", []), sizes), ctx
            assert parts["inputs"] == _held_bytes(want["batch"], sizes), ctx
            assert parts["cache"] == _held_bytes(want.get("cache", []),
                                                 sizes), ctx
            assert parts["total"] == sum(
                v for k, v in parts.items() if k != "total")
            assert got["fits"] == (parts["total"] <=
                                   dryrun.H100_MEMORY_BYTES), ctx


def test_cli_reports_every_cell(tmp_path):
    """``main(["--all", "--both-meshes", "--memory-only", "--out", ...])``:
    34 runnable cells × 2 meshes with their bytes, the 6 long_500k cells
    of the full-attention archs × 2 skipped with ``cell_runnable``'s
    reason (the traced cost of a cell: ``tests/test_torch_dryrun_cost.py``)."""
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--all", "--both-meshes", "--memory-only", "--out",
                        str(out)]) == 0
    cells = json.loads(out.read_text())
    done = [c for c in cells if "bytes_per_device" in c]
    skipped = [c for c in cells if "skipped" in c]
    assert len(done) == 68 and len(skipped) == 12 and len(cells) == 80
    assert {c["shape"] for c in skipped} == {"long_500k"}
    assert {c["arch"] for c in skipped} == {
        a for a, cfg in registry.all_archs().items() if not cfg.subquadratic}
    assert all(c["bytes_per_device"]["total"] > 0 for c in done)
    assert dryrun.main(["--arch", "zamba2-7b", "--shape", "long_500k",
                        "--multi-pod", "--no-split-kv", "--memory-only"]) == 0
    assert get_shape("long_500k").global_batch == 1


@pytest.mark.parametrize("shape", GROUP_SHAPES)
@pytest.mark.parametrize("arch", GROUP_ARCHS)
def test_moe_groups_equal_reference(arch, shape, ref_out):
    """``moe_groups`` (``--moe-group-tokens``) equals the group count the
    reference's own ``build_lowered`` gives its model, on both production
    meshes, for every token cap and microbatch override."""
    cfg, shp = registry.get(arch), get_shape(shape)
    want = {tuple(c[:5]): c[5] for c in ref_out["groups"]
            if c[0] == arch and c[1] == shape}
    assert len(want) == 2 * len(GROUP_TOKENS) * len(GROUP_MICROBATCHES)
    for (_, _, mname, n, m), g in want.items():
        mesh = make_production_mesh(multi_pod=mname == "multi")
        assert dryrun.moe_groups(cfg, shp, mesh, moe_group_tokens=n,
                                 microbatches=m) == g, (mname, n, m)
    assert len(set(want.values())) > 1, want
