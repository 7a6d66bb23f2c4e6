"""The dry run's traced cost on fake process groups' meshes.

In one subprocess (a fake process group is one per process):

- on a (2, 4) ``("data", "model")`` mesh, with the emulation of torch
  2.11's flatten refusal switched on (``flatten_rule.strict_flatten``):
  the traced train, prefill and decode steps of one layer unit of every
  reduced layer pattern (dense, dense with a window, audio, vlm, MoE
  every layer, MoE every 2, Mamba1, the hybrid), their placements as the
  production cells' (FSDP, the hooks, the cache's specs), and
  ``analyse`` of each;
- on that mesh, ``cell_cost`` of the reduced tinyllama train step (three
  layers, four microbatches) against a whole trace of it (DTensors: the
  extrapolation over layer units and microbatches);
- on a 1×1 mesh, the reduced tinyllama train and decode steps;
- an all-reduce of f32[64] over the mesh's 'model' group of 4, traced;
- the dry run's CLI (``main``) on one production cell.
"""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
PATTERN_ARCHS = ("tinyllama-1.1b", "h2o-danube-1.8b", "musicgen-large",
                 "paligemma-3b", "grok-1-314b", "llama4-maverick-400b-a17b",
                 "falcon-mamba-7b", "zamba2-7b")
KINDS = ("train", "prefill", "decode")

CODE = r"""
import dataclasses, json, sys
import torch
from flatten_rule import strict_flatten
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import trace_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh

ARCHS = %r
# serving at 512 tokens: the attention's share of the work is then real,
# as at the production cells' lengths (at a few dozen tokens the
# reference's 2·N·D counts the embedding table's rows, which no step
# multiplies, above the whole step)
SHAPES = {"train": ShapeSpec("train_s32", 32, 8, "train"),
          "prefill": ShapeSpec("prefill_s512", 512, 4, "prefill"),
          "decode": ShapeSpec("decode_s512", 512, 8, "decode")}


def reduced(arch, **over):
    return dataclasses.replace(registry.reduced_config(registry.get(arch)),
                               **over)


def row(rep, cfg, shp, n):
    res = dryrun.analyse(rep, cfg, shp, n)
    out = {k: res[k] for k in ("flops_per_device", "bytes_per_device",
                               "collective_bytes_per_device",
                               "useful_flop_fraction", "dominant",
                               "roofline_fraction")}
    # the embedding table's share of the parameters that 2·N·D counts
    out["table_share"] = 0.0 if cfg.tie_embeddings else \
        cfg.vocab * cfg.d_model / cfg.active_param_count()
    return out


out = {"cells": {}}
with fake_mesh((2, 4), ("data", "model")) as mesh:
    with strict_flatten():
        for arch in ARCHS:
            one = dryrun.with_units(reduced(arch), 1)     # one layer unit
            for kind, shp in SHAPES.items():
                run, cfg, _ = dryrun.build_step(arch, shp, mesh, cfg=one)
                rep, _ = trace_cost.trace(run)
                out["cells"][arch + ":" + kind] = row(rep, cfg, shp, 8)
        kw = dict(cfg=reduced("tinyllama-1.1b", n_layers=3), microbatches=4)
        got, _, _ = dryrun.cell_cost("tinyllama-1.1b", SHAPES["train"], mesh,
                                     **kw)
        run, _, _ = dryrun.build_step("tinyllama-1.1b", SHAPES["train"],
                                      mesh, **kw)
        whole, _ = trace_cost.trace(run)
        out["whole"] = [[getattr(r, f) for f in ("flops", "bytes_ideal",
                                                 "collective_bytes")]
                        for r in (got, whole)]
    import torch.distributed._functional_collectives as funcol
    x = torch.empty(64, dtype=torch.float32, device="meta")
    rep, _ = trace_cost.trace(funcol.all_reduce, x, "sum",
                              mesh.get_group("model"))
    out["all_reduce"] = [rep.bytes_by_collective, rep.collectives[0].hosts]
with fake_mesh((1, 1), ("data", "model")) as mesh:
    one = dryrun.with_units(reduced("tinyllama-1.1b"), 1)
    for kind in ("train", "decode"):
        run, cfg, _ = dryrun.build_step("tinyllama-1.1b", SHAPES[kind], mesh,
                                        cfg=one)
        rep, _ = trace_cost.trace(run)
        out["cells"]["1x1:" + kind] = row(rep, cfg, SHAPES[kind], 1)
out["cli_rc"] = dryrun.main(["--arch", "tinyllama-1.1b", "--shape",
                             "decode_32k", "--out", sys.argv[1]])
print(json.dumps(out))
""" % (PATTERN_ARCHS,)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    cli = tmp_path_factory.mktemp("dryrun") / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]))
    r = subprocess.run([sys.executable, "-c", CODE, str(cli)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["cli"] = json.loads(cli.read_text())
    out["cli_stdout"] = r.stdout
    return out


def useful_within_bounds(c) -> bool:
    """The useful-FLOP fraction in (0, 1] once the embedding table's rows
    are taken out of 2·N·D: the reference's model FLOPs count them, and
    no step multiplies them (a lookup), so a step that is all matmuls
    over the other parameters (an SSM's serving: the reference's own
    falcon-mamba decode_32k reads 1.028) lies above 1 by that share."""
    u = c["useful_flop_fraction"]
    return 0 < u and u * (1 - c["table_share"]) <= 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", PATTERN_ARCHS)
def test_every_pattern_traces_on_a_2x4_mesh(arch, kind, traced):
    """Every reduced pattern's step traces under the flatten rule, with
    FLOPs, bytes and collectives, and a useful-FLOP fraction in (0, 1]
    (``useful_within_bounds``)."""
    c = traced["cells"][f"{arch}:{kind}"]
    assert c["flops_per_device"] > 0 and c["bytes_per_device"] > 0, c
    assert c["collective_bytes_per_device"] > 0, c
    assert useful_within_bounds(c), c
    assert 0 < c["roofline_fraction"] <= 1, c


def test_one_by_one_mesh_moves_no_collective_bytes(traced):
    for kind in ("train", "decode"):
        c = traced["cells"][f"1x1:{kind}"]
        assert c["collective_bytes_per_device"] == 0, c
        assert c["dominant"] != "collective_s"
        assert useful_within_bounds(c), c


def test_extrapolated_cost_equals_whole_trace_on_dtensors(traced):
    got, whole = traced["whole"]
    assert got == pytest.approx(whole, rel=1e-9)


def test_all_reduce_bytes_over_a_group_of_four(traced):
    by_kind, hosts = traced["all_reduce"]
    assert by_kind == {"all-reduce": 384.0}
    assert hosts == 1          # 4 consecutive ranks: one host, NVLink


def test_cli_reports_a_production_cell(traced):
    """``main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k"])``:
    the reference's cost keys, the memory, one line of it."""
    assert traced["cli_rc"] == 0
    (cell,) = traced["cli"]
    for key in ("flops_per_device", "bytes_per_device",
                "bytes_per_device_eager", "collective_bytes_per_device",
                "collective_breakdown", "collective_counts", "terms",
                "dominant", "model_flops", "useful_flop_fraction",
                "roofline_fraction", "step_time_bound_s",
                "memory_per_device"):
        assert key in cell, key
    assert cell["devices"] == 256 and 0 < cell["useful_flop_fraction"] <= 1
    assert cell["collective_bytes_per_device"] > 0
    assert "tinyllama-1.1b × decode_32k × single-pod: memory-bound" in \
        traced["cli_stdout"]
