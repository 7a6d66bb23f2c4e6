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

The MoE knobs (``--moe-group-tokens``, ``--cap-shard``) in the same
subprocess: on the (2, 4) mesh under the flatten rule, the train, prefill
and decode steps of one layer unit of both MoE patterns with dispatch
groups of ``GROUP_TOKENS`` tokens and the dispatch and combine sharded
over 'model', and ``cell_cost`` of the reduced grok-1 train step with both
knobs against a whole trace of it; ``--memory-only`` output with and
without the knobs; and the CLI with both on one production MoE cell.
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
MOE_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
# tokens a dispatch group: 64 gives the (2, 4) mesh's train step 4 groups
# (twice its DP extent), the prefill 32 and the decode the DP extent (2)
GROUP_TOKENS = 64

CODE = r"""
import contextlib, dataclasses, io, json, sys
import torch
from flatten_rule import strict_flatten
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import trace_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh

ARCHS, MOE_ARCHS, GROUP_TOKENS = %r, %r, %r
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
        knobs = dict(cap_shard=True, moe_group_tokens=GROUP_TOKENS)
        for arch in MOE_ARCHS:
            one = dryrun.with_units(reduced(arch), 1)
            for kind, shp in SHAPES.items():
                run, cfg, _ = dryrun.build_step(arch, shp, mesh, cfg=one,
                                                **knobs)
                rep, _ = trace_cost.trace(run)
                c = row(rep, cfg, shp, 8)
                c["groups"] = [cfg.moe_groups, dryrun.moe_groups(
                    one, shp, mesh, moe_group_tokens=GROUP_TOKENS)]
                out["cells"][arch + ":" + kind + ":knobs"] = c
        # 4 microbatches of 2 sequences: 64 tokens, 16 a group
        kw = dict(cfg=reduced("grok-1-314b", n_layers=3), microbatches=4,
                  cap_shard=True, moe_group_tokens=16)
        got, cfg, _ = dryrun.cell_cost("grok-1-314b", SHAPES["train"], mesh,
                                       **kw)
        run, cfg_whole, _ = dryrun.build_step("grok-1-314b", SHAPES["train"],
                                              mesh, **kw)
        whole, _ = trace_cost.trace(run)
        out["whole_knobs"] = [[getattr(r, f) for f in (
            "flops", "bytes_ideal", "collective_bytes")] + [c.moe_groups]
            for r, c in ((got, cfg), (whole, cfg_whole))]
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
out["knobs_rc"] = dryrun.main(["--arch", "grok-1-314b", "--shape",
                               "decode_32k", "--cap-shard",
                               "--moe-group-tokens", "4096", "--out",
                               sys.argv[2]])
# --memory-only: each MoE cell's output and line, without and with both
memory = []
for flags in ([], ["--cap-shard", "--moe-group-tokens", "4096"]):
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        for arch in MOE_ARCHS:
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                rc = dryrun.main(["--arch", arch, "--shape", shape,
                                  "--both-meshes", "--memory-only", "--out",
                                  sys.argv[3]] + flags)
                with open(sys.argv[3]) as f:
                    memory.append([rc, json.load(f)])
    # the cells' lines (not the timing line)
    memory.append([line for line in lines.getvalue().splitlines()
                   if " × " in line])
out["memory"] = memory
print(json.dumps(out))
""" % (PATTERN_ARCHS, MOE_ARCHS, GROUP_TOKENS)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    cli, knobs = tmp / "cell.json", tmp / "knobs.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]))
    r = subprocess.run([sys.executable, "-c", CODE, str(cli), str(knobs),
                        str(tmp / "memory.json")], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["cli"] = json.loads(cli.read_text())
    out["knobs"] = json.loads(knobs.read_text())
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_knobs_trace_on_a_2x4_mesh(arch, kind, traced):
    """Both MoE patterns with ``cap_shard`` and ``moe_group_tokens`` trace
    under the flatten rule (train: the backward through the sharded
    dispatch too), with the dispatch groups ``moe_groups`` gives (more than
    the DP extent where the tokens allow: each rank then holds several
    groups, which its local merge back into tokens must keep in order)."""
    c = traced["cells"][f"{arch}:{kind}:knobs"]
    got, want = c["groups"]
    assert got == want == {"train": 4, "prefill": 32, "decode": 2}[kind]
    assert c["flops_per_device"] > 0 and c["bytes_per_device"] > 0, c
    assert c["collective_bytes_per_device"] > 0, c
    assert useful_within_bounds(c), c
    assert 0 < c["roofline_fraction"] <= 1, c


def test_extrapolated_cost_with_moe_knobs_equals_whole_trace(traced):
    """``cell_cost`` traces the train step at 2 and 3 microbatches over a
    batch cut to match: the dispatch groups, counted from a microbatch's
    tokens, are the whole step's (4) in every trace, and the extrapolation
    equals the whole trace with both knobs on."""
    got, whole = traced["whole_knobs"]
    assert got[3] == whole[3] == 4
    assert got[:3] == pytest.approx(whole[:3], rel=1e-9)


def test_memory_only_output_unchanged_by_moe_knobs(traced):
    """``--memory-only`` reports the same bytes, JSON and lines, with and
    without ``--cap-shard`` and ``--moe-group-tokens`` (neither changes a
    tensor the memory counts)."""
    mem = traced["memory"]
    n = 3 * len(MOE_ARCHS)
    without, with_knobs = mem[:n + 1], mem[n + 1:]
    assert without == with_knobs
    assert all(rc == 0 and len(cells) == 2 and
               "bytes_per_device" in cells[0] for rc, cells in without[:n])
    assert len(without[n]) == 2 * n


def test_cli_takes_both_moe_knobs_on_a_production_cell(traced):
    """``main([... "--cap-shard", "--moe-group-tokens", "4096"])`` on
    grok-1-314b decode_32k: the cell traces, and its JSON and line carry
    the dispatch groups (256 sequences, one token each: the DP extent, 16)
    and ``cap_shard``."""
    assert traced["knobs_rc"] == 0
    (cell,) = traced["knobs"]
    assert cell["moe_groups"] == 16 and cell["cap_shard"] is True
    assert cell["collective_bytes_per_device"] > 0
    assert "grok-1-314b × decode_32k × single-pod (moe_groups 16, " \
        "cap_shard True)" in traced["cli_stdout"]
