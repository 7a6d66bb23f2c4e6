"""Port (repro_torch) ≡ reference (repro): the sharding rules.

The reference's ``distributed/sharding.py`` reads only a mesh's ``shape``
mapping and ``axis_names``, so both packages get the port's shape-only
``ShapeMesh`` of the production shapes (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")``, and of the tests' (2, 4), with
no devices behind them.  Exact, spec by spec:

- ``param_pspecs`` for every stacked leaf of every arch of the registry
  at its published widths (the reference's leaves from ``jax.eval_shape``
  of its ``init_params``, the port's from ``transformer.leaf_map`` on the
  meta device), ``fsdp`` off and on, ``moe_ep_axis`` "auto" and "data";
- ``batch_pspecs`` over each runnable cell's inputs and ``cache_pspecs``
  over the reference's ``cache_specs`` and the port's, with ``seq_shard``
  and ``split_kv`` each off and on;
- in one subprocess, on a fake process group's mesh of each shape (one
  process, rank 0), ``to_placements`` gives DTensors on the meta device
  whose local shapes are ``local_shape``'s.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.configs.base import SHAPES
from repro.distributed import sharding as jsharding
from repro.models.model import Model as JModel
from repro.serve import kv_cache as jkv
from repro_torch.configs import registry as treg
from repro_torch.configs.base import cell_runnable
from repro_torch.distributed import sharding
from repro_torch.launch.dryrun import input_specs
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import transformer as TT

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "2x4": ShapeMesh((2, 4), ("data", "model"))}
ARCHS = sorted(jreg.all_archs())


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def _ref_leaves(tree):
    """A reference tree → {path: leaf}, a ``PartitionSpec`` a leaf."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(k) for k in path): leaf for path, leaf in flat}


def _ref_specs(tree):
    """A reference spec tree → {path: spec tuple}."""
    return {path: tuple(spec) for path, spec in _ref_leaves(tree).items()}


def _port_specs(tree, path=()):
    """A port spec tree → {path: spec tuple}: dicts and named tuples are
    nodes, a plain tuple is a spec, None is empty."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_port_specs(v, path + (str(k),)))
    return out


@pytest.fixture(scope="module")
def ref_params():
    """arch → the reference's parameter shapes at its published widths."""
    return {a: jax.eval_shape(JModel(jreg.get(a)).init_params,
                              jax.random.PRNGKey(0)) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, ref_params):
    """Every stacked leaf's spec, for each mesh, ``fsdp`` off and on and
    ``moe_ep_axis`` "auto" and "data"; each per-layer spec is its leaf's
    without the stacked dims."""
    cfg = treg.get(arch)
    net = TT.Transformer(cfg, device="meta")
    leaves = TT.leaf_map(cfg, net)
    n = 0
    for name, mesh in MESHES.items():
        for fsdp in (False, True):
            for ep in ("auto", "data"):
                want = _ref_specs(jsharding.param_pspecs(
                    jreg.get(arch), mesh, ref_params[arch], fsdp=fsdp,
                    moe_ep_axis=ep))
                got = sharding.param_pspecs(cfg, mesh, leaves, fsdp=fsdp,
                                            moe_ep_axis=ep)
                assert got == want, (name, fsdp, ep)
                for leaf in leaves:
                    layer = sharding.layer_spec(leaf, got[leaf.path])
                    assert got[leaf.path] == (None,) * len(leaf.lead) + \
                        layer
                n += len(got)
    assert n == 3 * 2 * 2 * len(leaves)


def _ref_inputs(cfg, shp):
    """The reference dry run's input specs (``ShapeDtypeStruct``s), built
    here: importing ``repro.launch.dryrun`` would set 512 host devices."""
    b, s = shp.global_batch, shp.seq_len
    p0 = cfg.frontend_tokens if cfg.frontend != "none" else 0
    sds = jax.ShapeDtypeStruct
    if shp.kind == "decode":
        return {"cache": jkv.cache_specs(cfg, b, s),
                "token": sds((b,), jnp.int32)}
    spec = {"tokens": sds((b, s - p0), jnp.int32)}
    if shp.kind == "train":
        spec["labels"] = sds((b, s - p0), jnp.int32)
    if p0:
        spec["frontend"] = sds((b, p0, cfg.d_model), jnp.float32)
    return spec


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(arch):
    """For every runnable cell of the arch and each mesh: the inputs'
    ``batch_pspecs`` (``seq_shard`` off and on) and the decode cache's
    ``cache_pspecs`` (``seq_shard`` × ``split_kv``); the port's
    ``cache_specs`` has the reference's paths, shapes and dtypes."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    n = 0
    for shp in SHAPES:
        if not cell_runnable(tcfg, shp)[0]:
            continue
        jin, tin = _ref_inputs(jcfg, shp), input_specs(arch, shp.name)
        tin.pop("pos", None)
        jshape = {p: (tuple(x.shape), jnp.dtype(x.dtype).name)
                  for p, x in _ref_leaves(jin).items()}
        tshape = {}
        sharding.tree_map(lambda p, t: tshape.__setitem__(
            p, (tuple(t.shape), str(t.dtype).replace("torch.", ""))), tin)
        assert tshape == jshape, (arch, shp.name)
        for mesh in MESHES.values():
            for seq in (False, True):
                if shp.kind == "decode":
                    tok = {"t": jin["token"]}
                    assert _port_specs(sharding.batch_pspecs(
                        tcfg, mesh, {"t": tin["token"]}, seq_shard=seq)) == \
                        _ref_specs(jsharding.batch_pspecs(
                            jcfg, mesh, tok, seq_shard=seq))
                    for split in (False, True):
                        want = _ref_specs(jsharding.cache_pspecs(
                            jcfg, mesh, jin["cache"], seq_shard=seq,
                            split_kv=split))
                        got = _port_specs(sharding.cache_pspecs(
                            tcfg, mesh, tin["cache"], seq_shard=seq,
                            split_kv=split))
                        assert got == want, (shp.name, seq, split)
                        n += 1
                else:
                    got = _port_specs(sharding.batch_pspecs(
                        tcfg, mesh, tin, seq_shard=seq))
                    want = _ref_specs(jsharding.batch_pspecs(
                        jcfg, mesh, jin, seq_shard=seq))
                    assert got == want, (shp.name, seq)
                    n += 1
    assert n > 0


PLACEMENTS_CODE = r"""
import json, math, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.launch.dryrun import input_specs
from repro_torch.models import transformer

out = []
for shape, axes in (((16, 16), ("data", "model")),
                    ((2, 16, 16), ("pod", "data", "model")),
                    ((2, 4), ("data", "model"))):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    cases = []
    for arch in ("grok-1-314b", "zamba2-7b", "tinyllama-1.1b"):
        cfg = registry.get(arch)
        for leaf in transformer.leaf_map(cfg, transformer.Transformer(
                cfg, device="meta")):
            for fsdp in (False, True):
                cases.append((sharding.leaf_pspec(
                    cfg, mesh, leaf.path, leaf.shape, fsdp=fsdp),
                    leaf.shape))
    for arch, shp in (("zamba2-7b", "long_500k"),
                      ("tinyllama-1.1b", "decode_32k")):
        cfg = registry.get(arch)
        cache = input_specs(arch, shp)["cache"]
        for split in (False, True):
            specs = sharding.cache_pspecs(cfg, mesh, cache,
                                          seq_shard=shp == "long_500k",
                                          split_kv=split)
            def walk(node, s):
                if node is None:
                    return
                if isinstance(node, dict):
                    for k in node:
                        walk(node[k], s[k])
                elif hasattr(node, "_fields"):
                    for a, b in zip(node, s):
                        walk(a, b)
                else:
                    cases.append((s, tuple(node.shape)))
            walk(cache, specs)
    cases.append((("data", None), (3, 5)))          # uneven: chunked
    cases.append(((("data", "model"), None), (4097, 2)))
    n = 0
    for spec, shp in cases:
        got = distribute_tensor(torch.empty(shp, device="meta"), mesh,
                                sharding.to_placements(mesh, spec),
                                src_data_rank=None)
        want = sharding.local_shape(mesh, spec, shp)
        if tuple(got.to_local().shape) != want or \
                tuple(got.shape) != tuple(shp):
            print(json.dumps({"bad": [str(spec), list(shp),
                                      list(got.to_local().shape),
                                      list(want)]}))
            sys.exit(1)
        n += 1
    out.append(n)
    dist.destroy_process_group()
print(json.dumps({"checked": out}))
"""


def test_to_placements_give_dtensor_local_shapes_on_fake_meshes():
    """On a fake process group's (16, 16), (2, 16, 16) and (2, 4) meshes,
    in one subprocess: every leaf spec of three archs (FSDP off and on),
    two caches' specs (a sequence over ("data", "model")) and two uneven
    dims, each as a DTensor on the meta device: its local shape is
    ``local_shape``'s (rank 0 holds the largest chunk)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", PLACEMENTS_CODE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    checked = json.loads(r.stdout.strip().splitlines()[-1])["checked"]
    assert len(checked) == 3 and min(checked) > 100, checked
