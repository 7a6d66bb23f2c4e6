"""The port's sharding layer on real DTensors against its plain path.

On a 1×1 ``("data", "model")`` mesh of a gloo process group of world size
1, in one subprocess: the reduced float32 configs of the eight layer
patterns (dense, dense with a window, audio, vlm, MoE every layer, MoE
every 2, Mamba1, the hybrid), every parameter placed by
``distribute_params`` (FSDP on) and every hook active (``act_shard``,
``logit_shard``, ``moe_cap_shard``, ``grad_shardings``).  Bit for bit
(``torch.equal`` on ``full_tensor()``): the loss and every grad, one AdamW
and one Adafactor update from them (parameters and moments), the prefill
cache and last logits, and a decode step's logits; for tinyllama also one
AdamW step through ``make_train_step`` (remat, 2 microbatches): its loss
and every updated parameter.  DTensor's sharding propagation costs ~1 s
a pattern for each new op and shape in this process, so the checks share
shapes where they can.

On a (1, 2) mesh of two gloo ranks (tensor parallelism 2): the reduced
tinyllama config's float32 loss and every grad against the plain path,
within ``TP_TOL`` relative (per leaf, max |diff| over max |plain|): the
vocabulary-sharded embedding (each rank gathers its own rows, the partial
sums all-reduced) and logits and the head-sharded projections reduce in
another order.  The largest difference seen was 2.9e-6 (the grads; the
loss equal).  Its single KV head does not split over two ranks, so the
attention runs replicated there; the same config with 2 KV heads runs
head-parallel (each rank attends 2 of the 4 heads), held to the same
bound.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

PATTERN_ARCHS = ("tinyllama-1.1b", "h2o-danube-1.8b", "musicgen-large",
                 "paligemma-3b", "grok-1-314b", "llama4-maverick-400b-a17b",
                 "falcon-mamba-7b", "zamba2-7b")
TP_TOL = 1e-5
TRAIN_STEP_ARCH = "tinyllama-1.1b"
B, S = 4, 32
HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(code: str):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE]))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _setup(arch):
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(registry.reduced_config(registry.get(arch)),
                              dtype="float32")
    model = Model(cfg)
    rng = np.random.default_rng(1)
    p0 = cfg.frontend_tokens if cfg.frontend != "none" else 0
    toks = rng.integers(0, cfg.vocab, (B, S - p0)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S - p0)).astype(np.int32)
    labels[0, :3] = -100
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    if p0:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (B, p0, cfg.d_model), dtype=np.float32))

    def fresh():
        return model.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    return cfg, model, batch, fresh


def _grads(model, params, batch, hooks, leaves, remat=True):
    from repro_torch.distributed import sharding
    with sharding.replicating(params):
        loss, _ = model.loss_fn(params, batch, remat=remat, **hooks)
        grads = torch.autograd.grad(loss, [p for lf in leaves
                                           for p in lf.params])
    return loss, grads


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _same(a, b) -> bool:
    return torch.equal(_full(a).detach(), _full(b).detach())


def _check_arch(arch, mesh) -> dict:
    """Every comparison of the 1×1 case for one arch → {name: bool}."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer as TT
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step
    cfg, model, batch, fresh = _setup(arch)
    out = {}
    place = dict(act_shard=sharding.make_act_shard(mesh),
                 moe_cap_shard=sharding.make_moe_cap_shard(mesh))
    hooks = dict(place, logit_shard=sharding.make_logit_shard(mesh))

    # the first two sequences: the grads and serving check (shapes a
    # microbatch of the train step shares, which keeps DTensor's sharding
    # propagation cache warm)
    half = {k: v[:B // 2] for k, v in batch.items()}
    plain = fresh()
    dist_p = sharding.distribute_params(cfg, mesh, fresh(), fsdp=True)
    out["placed"] = all(isinstance(p, DTensor) for p in dist_p.parameters())

    # serving: the prefill cache and last logits, a decode step's logits
    serve_in = {k: v for k, v in half.items() if k != "labels"}
    caches, logits = [], []
    for params, kw in ((plain, {}), (dist_p, place)):
        cache, last, pos = model.prefill(params, serve_in,
                                         max_len=S + 1, **kw)
        tok = _full(last).argmax(dim=-1).to(torch.int32)
        step, cache = model.decode(params, cache, tok, pos, **kw)
        caches.append(cache)
        logits.append((last, step))
    flat = [[], []]
    for i in range(2):
        sharding.tree_map(lambda p, t: flat[i].append(t), caches[i])
    out["prefill_cache"] = len(flat[0]) == len(flat[1]) > 0 and all(
        _same(a, b) for a, b in zip(*flat))
    out["prefill_and_decode_logits"] = all(
        _same(a, b) for a, b in zip(*logits))

    # training: loss and grads (remat off: the train step below runs it),
    # then one AdamW and one Adafactor update from them, the grads placed
    # by grad_shardings' placements
    pl, dl = TT.leaf_map(cfg, plain), TT.leaf_map(cfg, dist_p)
    la, ga = _grads(model, plain, half, {}, pl, remat=False)
    lb, gb = _grads(model, dist_p, half, hooks, dl, remat=False)
    out["loss"] = _same(la, lb)
    out["grads"] = len(ga) == len(gb) and all(
        _same(a, b) for a, b in zip(ga, gb))
    shardings = sharding.param_placements(cfg, mesh, dist_p, fsdp=True)
    by_leaf = [[], []]
    for i, (leaves, grads) in enumerate(((pl, ga), (dl, gb))):
        it = iter(grads)
        by_leaf[i] = [[next(it) for _ in lf.params] for lf in leaves]
    by_leaf[1] = [[g.redistribute(g.device_mesh, shardings[lf.key])
                   for g in gs] for lf, gs in zip(dl, by_leaf[1])]
    for kind in ("adamw", "adafactor"):
        oc = opt.OptConfig(kind=kind)
        sa, sb = opt.init_opt(oc, pl), opt.init_opt(oc, dl)
        opt.update(oc, pl, by_leaf[0], sa)
        with sharding.replicating(dist_p):
            opt.update(oc, dl, by_leaf[1], sb)
        out[f"{kind}_update"] = all(
            _same(a, b) for a, b in zip(plain.parameters(),
                                        dist_p.parameters())) and all(
            _same(x[k], y[k]) for x, y in zip(sa[1:], sb[1:]) for k in x)

    # the train step itself (hooks, grad_shardings, remat, 2 microbatches
    # summed into accumulators like the parameters), for the dense arch
    if arch == TRAIN_STEP_ARCH:
        oc = opt.OptConfig(kind="adamw")
        sa, sb = opt.init_opt(oc, pl), opt.init_opt(oc, dl)
        _, sa, _, ma = train_step.make_train_step(model, oc, microbatches=2)(
            plain, sa, None, batch)
        _, sb, _, mb = train_step.make_train_step(
            model, oc, microbatches=2, grad_shardings=shardings, **hooks)(
            dist_p, sb, None, batch)
        out["train_step"] = _same(ma["loss"], mb["loss"]) and all(
            _same(a, b) for a, b in zip(plain.parameters(),
                                        dist_p.parameters()))
    return out


def child_one_by_one(port: int) -> None:
    """The 1×1 case: prints {arch: {check: bool}} as JSON."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        print(json.dumps({a: _check_arch(a, mesh) for a in PATTERN_ARCHS}))
    finally:
        dist.destroy_process_group()


def _tp2_case(mesh, n_kv=None, arch="tinyllama-1.1b", cap_shard=False
              ) -> dict:
    """The reduced config of ``arch`` (``n_kv`` KV heads where given) on
    the (1, 2) mesh against the plain path: the largest relative
    differences, the sharded parameters, and the heads that a rank's
    attention saw.  ``cap_shard``: a MoE arch in 2 dispatch groups with
    ``moe_cap_shard`` on, and the placements of the dispatch and combine
    tensors it made."""
    from repro_torch.distributed import sharding
    from repro_torch.models import layers
    from repro_torch.models import transformer as TT
    cfg, model, batch, fresh = _setup(arch)
    over = {"n_kv": n_kv} if n_kv else {}
    if cap_shard:
        over["moe_groups"] = 2
    if over:
        cfg = dataclasses.replace(cfg, **over)
        model = type(model)(cfg)

        def fresh():
            return model.init_params(torch.Generator().manual_seed(0),
                                     device="cpu")
    plain = fresh()
    dist_p = sharding.distribute_params(cfg, mesh, fresh())
    hooks = dict(act_shard=sharding.make_act_shard(mesh),
                 logit_shard=sharding.make_logit_shard(mesh))
    capped = []
    if cap_shard:
        put = sharding.make_moe_cap_shard(mesh)

        def cap(x):
            y = put(x)
            capped.append(str(tuple(y.placements)))
            return y
        hooks["moe_cap_shard"] = cap
    pl, dl = TT.leaf_map(cfg, plain), TT.leaf_map(cfg, dist_p)
    la, ga = _grads(model, plain, batch, {}, pl, remat=False)
    heads, fwd = [], layers._flash_fwd

    def seen(q, *a):
        heads.append(q.shape[2])
        return fwd(q, *a)
    layers._flash_fwd = seen
    try:
        lb, gb = _grads(model, dist_p, batch, hooks, dl, remat=False)
    finally:
        layers._flash_fwd = fwd
    shards = sum(any(p.is_shard() for p in q.placements)
                 for q in dist_p.parameters())
    rel = [float((a - _full(b)).abs().max() / a.abs().max())
           for a, b in zip(ga, gb)]
    return {"loss": float(abs(la - _full(lb)) / abs(la)), "grad": max(rel),
            "leaves": len(rel), "sharded": shards,
            "heads": sorted(set(heads)), "n_heads": cfg.n_heads,
            "capped": sorted(set(capped))}


def child_tp2(rank: int, port: int) -> None:
    """One rank of the (1, 2) case; rank 0 prints the largest relative
    differences as JSON, for the reduced config and its 2-KV-head twin."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
        got = _tp2_case(mesh)
        got["head_parallel"] = _tp2_case(mesh, n_kv=2)
        got["cap_shard"] = _tp2_case(mesh, arch="grok-1-314b",
                                     cap_shard=True)
        if rank == 0:
            print(json.dumps(got))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_by_one():
    proc = _run(f"import test_torch_hooks as t; "
                f"t.child_one_by_one({_free_port()})")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", PATTERN_ARCHS)
def test_one_by_one_mesh_equals_plain_path(arch, one_by_one):
    """Placed parameters and active hooks change nothing on a 1×1 mesh:
    loss, grads, AdamW and Adafactor, prefill cache, decode logits."""
    got = one_by_one[arch]
    assert got == {k: True for k in got}, got
    assert len(got) == 7 + (arch == TRAIN_STEP_ARCH), got


@pytest.fixture(scope="module")
def tp2():
    port = _free_port()
    procs = [_run(f"import test_torch_hooks as t; t.child_tp2({r}, {port})")
             for r in (0, 1)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_tensor_parallel_two_ranks_within_tolerance(tp2):
    """TP = 2 over two gloo ranks: the loss and every grad within
    ``TP_TOL`` of the plain path; most parameters are sharded."""
    got = {k: v for k, v in tp2.items()
           if k not in ("head_parallel", "cap_shard")}
    assert got["loss"] <= TP_TOL and got["grad"] <= TP_TOL, got
    assert got["sharded"] >= got["leaves"] // 2, got


def test_head_parallel_attention_two_ranks_within_tolerance(tp2):
    """With 2 KV heads over the two ranks each rank attends half the
    heads (its local q holds 2 of 4), the vocabulary-sharded embedding
    gathers its own rows, and the loss and every grad stay within
    ``TP_TOL`` of the plain path."""
    got = tp2["head_parallel"]
    assert got["heads"] == [got["n_heads"] // 2], got
    assert got["loss"] <= TP_TOL and got["grad"] <= TP_TOL, got
    assert got["sharded"] >= got["leaves"] // 2, got
    assert tp2["heads"] == [tp2["n_heads"]], tp2     # 1 KV head: replicated


def test_cap_sharded_moe_two_ranks_within_tolerance(tp2):
    """The reduced grok-1 config in 2 dispatch groups with
    ``moe_cap_shard`` over two ranks: the dispatch and combine tensors
    shard their expert dim over 'model', so the expert einsums contract a
    sharded dim into partial sums, and the loss and every grad stay within
    ``TP_TOL`` of the plain path (the partial sums reduced, nothing
    dropped or counted twice)."""
    got = tp2["cap_shard"]
    assert got["capped"] == ["(Shard(dim=0), Shard(dim=2))"], got
    assert got["loss"] <= TP_TOL and got["grad"] <= TP_TOL, got
