#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power
   limit;
2. build: every ``kernels/csrc/*.cu`` with nvcc for sm_90a into
   ``build/kernels/`` (timed);
3. kernels: B1 (``select_level_masks_cuda``) and B2
   (``select_level_fused_cuda``) against their plain PyTorch twins, exact,
   on every level of a 2M-rect fanout-64 tree with B=64 frontiers taken
   from a real descent (columns shuffled, 10% of slots set to -1), plus a
   cap-64 overflow case; CUDA-event times of kernel and twin at the leaf
   level beside the bound;
4. engine: ``make_select_bfs`` with ``result_cap=4096`` in the four cells
   static/adaptive × unfused/fused against the twin engine on the card
   (ids, counts, every counter, exact) and 8 queries against numpy brute
   force; both kernels' launch counts must grow; ms per 64-query batch;
5. serve: ``repro_torch.launch.serve.main`` over 2M rects in 8 partitions
   on cuda (the main path); B1's launch count must grow; one batch against
   brute force; q/s.

The kernels' line (JSON) and nvidia-smi's line come before the last line,
which is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when CUDA is absent or the port's sources are not beside the script.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
N_RECTS, FANOUT, BATCH, SELECTIVITY, RESULT_CAP = 2_000_000, 64, 64, 1e-3, 4096
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 1) -> float:
    """Host clock around work that ends in a device synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_batches(fn, iters: int = 3, top: int = 6) -> str:
    """Device kernel time by name over ``iters`` calls of ``fn`` with
    torch.profiler, and the device's busy share of the host-clock window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        return "profiler recorded no device time"
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    parts = ", ".join(f"{n[:48]} {t / iters / 1e3:.3f}" for n, t in ranked)
    return (f"device busy {busy / wall_us:.1%} of {wall_us / iters / 1e3:.3f}"
            f" ms per batch; device ms per batch by kernel: {parts}")


def assert_equal(a, b, what: str) -> int:
    """Fail unless kernel output ``a`` equals twin output ``b`` exactly;
    returns the largest absolute difference (0)."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    err = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(
        initial=0))
    check(err == 0, f"{what}: kernel and twin differ in "
          f"{int((a != b).sum())} elements (max abs err {err})")
    return err


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, tree, queries, full_caps, kern, ref):
    """Phase 3: both kernels ≡ their twins on real frontiers; leaf times."""
    dev = tree.device
    b = queries.shape[0]
    rng = np.random.default_rng(SEED + 7)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    ids = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    frontiers = {}
    for li in range(tree.height - 1, -1, -1):
        frontiers[li] = ids
        if li:
            lvl = tree.levels[li]
            ids, _, _ = ref.select_level_fused_ref(
                ids, queries, lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child,
                cap=full_caps[tree.height - 1 - li])
    rows = {li: (lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child)
            for li, lvl in enumerate(tree.levels)}
    err = {"select_level_masks": 0, "select_level_fused": 0}
    for li, ids in frontiers.items():
        perm = torch.randperm(ids.shape[1], generator=gen).to(dev)
        ids = ids[:, perm].contiguous()
        drop = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.1).to(dev)
        ids = torch.where(drop, -1, ids)
        cap = RESULT_CAP if li == 0 else full_caps[tree.height - 1 - li]
        err["select_level_masks"] = max(
            err["select_level_masks"],
            assert_equal(kern.select_level_masks_cuda(ids, queries, *rows[li]),
                         ref.select_level_masks_ref(ids, queries, *rows[li]),
                         f"B1 level {li}"))
        for name, g, w in zip(
                ("ids", "counts", "overflow"),
                kern.select_level_fused_cuda(ids, queries, *rows[li],
                                             cap=cap),
                ref.select_level_fused_ref(ids, queries, *rows[li], cap=cap)):
            err["select_level_fused"] = max(err["select_level_fused"],
                                            assert_equal(g, w, f"B2 level "
                                                         f"{li} {name}"))
        print(f"  level {li}: frontier {tuple(ids.shape)}, "
              f"{int((ids >= 0).sum())} live slots — B1, B2 exact")

    # overflow: wide queries over random leaf frontiers at cap 64
    n_leaf = tree.levels[0].n_nodes
    wide = torch.from_numpy(np.concatenate(
        [rng.random((b, 2), dtype=np.float32) * 0.7] * 2, axis=1)).to(dev)
    wide[:, 2:] += 0.3
    ids = torch.from_numpy(rng.integers(0, n_leaf, (b, 1024)).astype(
        np.int32)).to(dev)
    ids = torch.where(torch.from_numpy(rng.random((b, 1024)) < 0.1).to(dev),
                      -1, ids)
    got = kern.select_level_fused_cuda(ids, wide, *rows[0], cap=64)
    want = ref.select_level_fused_ref(ids, wide, *rows[0], cap=64)
    for name, g, w in zip(("ids", "counts", "overflow"), got, want):
        err["select_level_fused"] = max(err["select_level_fused"],
                                        assert_equal(g, w, f"B2 overflow "
                                                     f"{name}"))
    check(bool(got[2].any()), "the cap-64 overflow case did not overflow")
    print(f"  overflow case: cap 64, counts up to {int(got[1].max())} — "
          f"B2 exact")

    # times at the leaf level of the descent (the largest launch per batch)
    ids = frontiers[0]
    leaf = rows[0]
    b_, c_ = ids.shape
    f_ = tree.fanout
    live = ids[ids >= 0]
    uniq = int(torch.unique(live).numel())
    read = ids.numel() * 4 + queries.numel() * 4 + uniq * 20 * f_
    ops_ = live.numel() * f_ * 6          # 4 compares, child test, and
    out = []
    b1_bytes = read + b_ * c_ * f_ * 4
    b2_bytes = read + b_ * RESULT_CAP * 4 + b_ * 4
    for name, src_line, kfn, tfn, nbytes in (
            ("select_level_masks", "src/repro/kernels/rtree_select.py:64",
             lambda: kern.select_level_masks_cuda(ids, queries, *leaf),
             lambda: ref.select_level_masks_ref(ids, queries, *leaf),
             b1_bytes),
            ("select_level_fused", "src/repro/kernels/rtree_select.py:111",
             lambda: kern.select_level_fused_cuda(ids, queries, *leaf,
                                                  cap=RESULT_CAP),
             lambda: ref.select_level_fused_ref(ids, queries, *leaf,
                                                cap=RESULT_CAP),
             b2_bytes)):
        ms = cuda_ms(kfn, 20)
        plain_ms = cuda_ms(tfn, 5)
        bound_ms, bound_by = bound(nbytes, ops_)
        print(f"  {name}: leaf (B={b_}, C={c_}, F={f_}, {live.numel()} live "
              f"slots, {uniq} distinct nodes): kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes} bytes at 3.35 TB/s)")
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/rtree_select.cu",
                        replaces=src_line, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, max_abs_err=err[name]))
    return out


def phase_engine(tree, rects, queries, select_vector, kern):
    """Phase 4: the four engine cells ≡ the twin engine; brute force."""
    from repro_torch.core.geometry import brute_force_select
    kern.reset_launch_counts()
    engines = {}
    for caps_mode in ("static", "adaptive"):
        for fused in (False, True):
            cell = f"{caps_mode}/{'fused' if fused else 'unfused'}"
            kw = dict(result_cap=RESULT_CAP, caps_mode=caps_mode, fused=fused)
            fn = select_vector.make_select_bfs(tree, **kw)
            twin = select_vector.make_select_bfs(tree, backend="torch", **kw)
            ids, counts, ctr = fn(queries)
            tids, tcounts, tctr = twin(queries)
            assert_equal(ids, tids, f"engine {cell} ids")
            assert_equal(counts, tcounts, f"engine {cell} counts")
            check(ctr.asdict() == tctr.asdict(),
                  f"engine {cell} counters: {ctr.asdict()} vs "
                  f"{tctr.asdict()}")
            check(int(ctr.overflow) == 0, f"engine {cell} overflowed")
            engines[cell] = (fn, twin, ctr)
    launches = kern.launch_counts()
    print(f"  four cells ≡ twin engine (ids, counts, counters); launches "
          f"{launches}")
    check(launches["select_level_masks"] > 0 and
          launches["select_level_fused"] > 0, "a kernel was not launched")
    q_np = queries.cpu().numpy()
    ids_np, counts_np = ids.cpu().numpy(), counts.cpu().numpy()
    for i in range(8):
        check(np.array_equal(np.sort(ids_np[i, :counts_np[i]]),
                             brute_force_select(rects, q_np[i])),
              f"engine query {i} differs from brute force")
    print(f"  8 queries ≡ brute force (mean {counts_np.mean():.1f}, max "
          f"{counts_np.max()} ids per query)")
    ctr = engines["static/unfused"][2].asdict()
    live, padded = ctr["lanes_live"], ctr["lanes_padded"]
    print(f"  occupancy per step (static caps): live {live[:tree.height]}, "
          f"padded {padded[:tree.height]}")
    for cell, (fn, twin, _) in engines.items():
        print(f"  {cell}: {host_ms(lambda: fn(queries), 10):.3f} ms per "
              f"{BATCH}-query batch (twin engine "
              f"{host_ms(lambda: twin(queries), 3):.3f} ms)")
        print(f"    {profile_batches(lambda: fn(queries))}")
    return launches


def phase_serve(kern, serve):
    """Phase 5: the served main path through the CLI entry point."""
    from repro_torch.core.geometry import brute_force_select
    argv = ["--mode", "spatial", "--n", str(N_RECTS), "--partitions", "8",
            "--fanout", str(FANOUT), "--batches", "20", "--batch-size",
            str(BATCH)]
    kern.reset_launch_counts()
    out = serve.main(argv)
    launches = kern.launch_counts()
    print(f"  serve launches {launches}")
    check(launches["select_level_masks"] > 0,
          "serve did not launch select_level_masks")
    rects = serve.make_rects(N_RECTS, SEED)
    qs = serve.make_queries(20, BATCH, SELECTIVITY, SEED + 1)[0]
    for i, (got, q) in enumerate(zip(out["first_batch"], qs)):
        check(np.array_equal(got, brute_force_select(rects, q)),
              f"served query {i} differs from brute force")
    print(f"  first served batch ≡ brute force ({BATCH} queries)")
    return launches, out["qps"]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.core import rtree, select_vector
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rtree_select as kern
    from repro_torch.launch import serve

    t_start = time.time()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1] device: {name}; nvidia-smi: {smi}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)

    t0 = time.time()
    libs = _build.build_all()
    print(f"[2] built {sorted(libs)} in {time.time() - t0:.2f} s", flush=True)

    dev = torch.device("cuda", 0)
    rects = serve.make_rects(N_RECTS, SEED)
    t0 = time.time()
    tree = rtree.build_rtree(rects, fanout=FANOUT, device=dev)
    queries = torch.from_numpy(serve.make_queries(
        1, BATCH, SELECTIVITY, SEED + 1)[0]).to(dev)
    full_caps = select_vector.frontier_caps(tree, RESULT_CAP)
    tight_caps = select_vector.frontier_caps(tree, RESULT_CAP,
                                             policy="adaptive")
    print(f"[3] tree over {N_RECTS} rects, fanout {FANOUT}: levels "
          f"{[lvl.n_nodes for lvl in tree.levels]} in "
          f"{time.time() - t0:.2f} s; caps static {full_caps}, adaptive "
          f"{tight_caps}", flush=True)
    kernels = phase_kernels(torch, tree, queries, full_caps, kern, ref)

    print("[4] engine", flush=True)
    eng_launches = phase_engine(tree, rects, queries, select_vector, kern)

    print("[5] serve", flush=True)
    serve_launches, qps = phase_serve(kern, serve)
    print(f"  served {qps:,.1f} q/s on {name} ({smi})", flush=True)

    # launches: B1 from the served main path; B2, which serve does not
    # drive, from the fused engine cells of phase 4 (counts reset before)
    for k in kernels:
        k["launches"] = serve_launches[k["name"]] if \
            k["name"] == "select_level_masks" else eng_launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} not launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
