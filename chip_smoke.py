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
   brute force; q/s;
6. join kernels: the 2M-point fleet and 200,000 probes (half-extent
   0.002), all ``sort_key="lx"`` as the join serve runner builds them; on
   every level of the centre partition's join, B3
   (``join_pair_masks_cuda``) and B4 (``join_level_fused_cuda``) against
   their twins, exact, on pair frontiers from a real descent (shuffled,
   10% of slots -1) with the pruning bounds from the pre-pass (O3/O4-O5
   off and on) and random, plus a B4 cap that overflows; CUDA-event times
   of kernel and twin at the leaf step beside the bound;
7. join engine: ``make_join_bfs(result_cap=1048576)`` over the centre
   partition in the four cells {O3/O4 off, on} × {unfused, fused} against
   the twin engine on the card (pairs, count, every counter) and against
   the reference's numbers for this input (720,914 pairs; occupancy; the
   O3/O4 tallies); 256 sampled probes against brute force; ms per join
   and peak device memory per cell;
8. join serve: ``serve.main(["--mode", "join", ...])`` at 2M points with
   ``--join-cap 1048576`` on cuda; B3's launch count must grow, nothing
   may overflow, 256 sampled probes against brute force; joins/s and the
   host merge's share;
9. kNN kernels: on every level of the phase-3 tree, with 64 frontiers of
   a real descent of the first served query batch (columns shuffled, 10%
   of slots -1), for k in {1, 8, 64}: B5 (``knn_level_dists_cuda``, both
   variants), B6 (``knn_level_fused_cuda``, tightening on and off, random
   τ_in) and B7 (``knn_leaf_fused_cuda``) against their twins bit for bit,
   plus a B6 cap that overflows; at the k = 8 leaf step (B6 at the last
   internal step) the kernels' device time per launch (torch.profiler),
   their time per call with the wrapper and the twins' (CUDA events),
   beside the bound;
10. kNN engine: ``make_knn_bfs`` on that batch, k = 8 in the four cells
   static/adaptive × unfused/fused and k = 64 static unfused/fused, against
   the twin engine on the card (ids, distance bits, every counter) and the
   reference's numbers for this input; k = 1 adaptive escalates once; 8
   queries against numpy brute force; B5 launches grow in the unfused
   cells, B6 and B7 in the fused ones; ms per 64-query batch;
11. kNN serve: ``serve.main(["--mode", "knn", ...])`` at 2M points with
   k = 8 on cuda; B5's launch count must grow, nothing may overflow, the
   first batch against a float64 brute force on the card; q/s.

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
JOIN_CAP, QUERY_EPS, CENTRE = 1 << 20, 0.002, 4
# the reference's numbers for the centre partition's join at this size
# (the JAX package's make_join_bfs over the same fleet and probes)
JOIN_PAIRS, JOIN_LIVE = 720_914, [1, 110, 8045]
JOIN_O34 = dict(predicates=33_317_712, pruned_outer=170_740,
                pruned_inner=14_086_858)
KNN_K, KNN_BATCHES = 8, 20
# the reference's numbers for the first served kNN batch (64 queries) on
# the phase-3 tree: the JAX package's make_knn_bfs(backend="xla"), equal in
# both caps tiers and fused or not; padded slots per tier
KNN_REF = {
    8: dict(counters=dict(nodes_visited=2_331, predicates=983_552,
                          vector_ops=15_368, enqueued=2_267,
                          pruned_inner=86_117, masked_waste=8_320),
            live=[64, 576, 871, 820],
            padded={"static": [0, 7616, 7321, 7372],
                    "adaptive": [0, 0, 1177, 1228]},
            ids_sum=500_525_860, d_sum=0.0003939492196707306),
    64: dict(counters=dict(nodes_visited=10_193, predicates=3_990_528,
                           vector_ops=62_352, enqueued=10_129,
                           pruned_inner=321_775, masked_waste=13_376),
             live=[64, 576, 4755, 4798],
             padded={"static": [0, 7616, 3437, 11586],
                     "adaptive": [0, 0, 11629, 11586]},
             ids_sum=4_024_399_365, d_sum=0.022336982976781883),
}
# operations per lane: MINDIST 13, MINMAXDIST 29 (subtractions, min/max,
# selects, products and FMAs counted one each)
MINDIST_OPS, MINMAXDIST_OPS = 13, 29


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


def cuda_ms(fn, iters: int, warmup_s: float = 0.05) -> float:
    """CUDA-event ms per call of ``fn`` over ``iters`` calls, after at
    least two warm-up calls and ``warmup_s`` of them: a card that was idle
    raises its clocks only under load."""
    import torch
    n, t0 = 0, time.perf_counter()
    while n < 2 or time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
        n += 1
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


def device_ms(fn, names, iters: int = 20):
    """Device ms per launch of the one kernel whose demangled name holds
    every string of ``names``: the mean over the launches torch.profiler
    records in ``iters`` calls of ``fn`` (one launch each; the profiler
    may miss a few at its start); None when it saw no such kernel.  A
    kernel shorter than its wrapper's host work cannot be timed with events
    around back-to-back calls: the card would wait for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and all(n in e.name for n in names)]
    if not times:
        return None
    check(len(times) <= iters, f"{names}: {len(times)} launches profiled "
          f"for {iters} calls")
    return sum(times) / len(times) / 1e3


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
    import torch
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: shape/dtype {tuple(a.shape)} {a.dtype} vs "
          f"{tuple(b.shape)} {b.dtype}")
    if torch.equal(a, b):               # on the card: no GB-sized copies
        return 0
    a, b = a.cpu().numpy(), b.cpu().numpy()
    err = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(
        initial=0))
    check(err == 0, f"{what}: kernel and twin differ in "
          f"{int((a != b).sum())} elements (max abs err {err})")
    return err


def assert_bits_equal(a, b, what: str) -> int:
    """``assert_equal`` on the bits: float32 tensors compare as int32, so
    +inf, DIST_PAD and signed zeros must match exactly."""
    import torch
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return assert_equal(a, b, what)


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


def sample_probes_equal_brute_force(torch, dev, pairs, probes, rects, what,
                                    n_sample: int = 256) -> None:
    """Fail unless, for ``n_sample`` probes drawn from a seed, the data ids
    that ``pairs`` ((K, 2) probe id, data id) join them with equal a brute
    force over all of ``rects``, computed on ``dev`` in chunks."""
    rng = np.random.default_rng(SEED + 11)
    sample = np.sort(rng.choice(len(probes), n_sample, replace=False))
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    r = torch.from_numpy(np.ascontiguousarray(rects)).to(dev)
    for lo in range(0, n_sample, 64):
        qs = sample[lo:lo + 64]
        q = torch.from_numpy(probes[qs]).to(dev)
        m = ((q[:, None, 0] <= r[None, :, 2])
             & (q[:, None, 2] >= r[None, :, 0])
             & (q[:, None, 1] <= r[None, :, 3])
             & (q[:, None, 3] >= r[None, :, 1]))
        for qi, row in zip(qs, m):
            want = torch.nonzero(row).flatten().cpu().numpy()
            a, b = np.searchsorted(pairs[:, 0], [qi, qi + 1])
            got = pairs[a:b, 1]
            check(np.array_equal(got, want),
                  f"{what}: probe {qi} joins {len(got)} ids, brute force "
                  f"{len(want)}")


def phase_join_kernels(torch, lo, li_, pair_caps, jkern, ref, ops):
    """Phase 6: B3 and B4 ≡ their twins on every level of a real descent;
    times at the leaf step."""
    dev = lo[0].coords.device
    h = len(lo)
    rng = np.random.default_rng(SEED + 9)
    i32 = dict(dtype=torch.int32, device=dev)
    o, i = torch.zeros((1,), **i32), torch.zeros((1,), **i32)
    frontiers = {}
    for lvl in range(h - 1, -1, -1):            # the O3/O4 descent
        frontiers[lvl] = (o, i)
        if lvl:
            ac, fm = ops.join_prune_metadata(o, i, lo[lvl].coords,
                                             li_[lvl].coords, to=8)
            o, i, _, _ = ref.join_level_fused_ref(
                o, i, ac, fm, lo[lvl].coords, li_[lvl].coords, lo[lvl].ptr,
                li_[lvl].ptr, cap=pair_caps[h - 1 - lvl])
    err = {"join_pair_masks": 0, "join_level_fused": 0}

    def hold(name, got, want, what):
        for k, (g, w) in enumerate(zip(got, want)):
            err[name] = max(err[name], assert_equal(g, w, f"{what} [{k}]"))

    for lvl, (o, i) in frontiers.items():
        perm = torch.from_numpy(rng.permutation(o.numel())).to(dev)
        o, i = o[perm].contiguous(), i[perm].contiguous()
        drop = torch.from_numpy(rng.random(o.numel())).to(dev)
        o = torch.where(drop < 0.05, -1, o)
        i = torch.where((drop >= 0.05) & (drop < 0.1), -1, i)
        oc, icr = lo[lvl].coords, li_[lvl].coords
        ptrs = (lo[lvl].ptr, li_[lvl].ptr)
        p = o.numel()
        bounds = {f"o3={a} o45={b}": ops.join_prune_metadata(
            o, i, oc, icr, to=8, o3=a, o45=b)
            for a, b in ((False, False), (True, True))}
        bounds["random"] = (
            torch.from_numpy(rng.integers(-1, FANOUT + 3, p).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.integers(-1, FANOUT + 3, (p, FANOUT // 8))
                             .astype(np.int32)).to(dev))
        cap = pair_caps[h - 1 - lvl] if lvl else JOIN_CAP
        for tag, (ac, fm) in bounds.items():
            args = (o, i, ac, fm, oc, icr)
            hold("join_pair_masks", [jkern.join_pair_masks_cuda(*args)],
                 [ref.join_pair_masks_ref(*args)], f"B3 level {lvl} {tag}")
            hold("join_level_fused",
                 jkern.join_level_fused_cuda(*args, *ptrs, cap=cap),
                 ref.join_level_fused_ref(*args, *ptrs, cap=cap),
                 f"B4 level {lvl} {tag}")
        print(f"  level {lvl}: pair frontier {p}, "
              f"{int(((o >= 0) & (i >= 0)).sum())} live pairs — B3, B4 "
              f"exact with pre-pass bounds (O3/O4 off, on) and random ones",
              flush=True)
    # overflow: the leaf step's live pairs into a cap of 4096
    ac, fm = ops.join_prune_metadata(*frontiers[0], lo[0].coords,
                                     li_[0].coords, to=8)
    args = (*frontiers[0], ac, fm, lo[0].coords, li_[0].coords, lo[0].ptr,
            li_[0].ptr)
    got = jkern.join_level_fused_cuda(*args, cap=4096)
    hold("join_level_fused", got, ref.join_level_fused_ref(*args, cap=4096),
         "B4 overflow")
    check(bool(got[3]), "the cap-4096 B4 case did not overflow")
    print(f"  overflow case: cap 4096, count {int(got[2])} — B4 exact")

    # times at the leaf step of the unshuffled descent
    o, i = frontiers[0]
    oc, icr, optr, iptr = lo[0].coords, li_[0].coords, lo[0].ptr, li_[0].ptr
    p, fo, fi = o.numel(), oc.shape[2], icr.shape[2]
    live = (o >= 0) & (i >= 0)
    n_live = int(live.sum())
    uo = int(torch.unique(o[live]).numel())
    ui = int(torch.unique(i[live]).numel())
    # both id streams for every slot; alive_cnt and flip_max for the live
    # pairs only (a pair with a negative id is decided by its ids)
    meta = p * 4 * 2 + n_live * 4 * (1 + fm.shape[1])
    b3_bytes = meta + (uo * fo + ui * fi) * 16 + p * fo * fi * 4
    b4_bytes = meta + (uo * fo + ui * fi) * 20 + 2 * JOIN_CAP * 4 + 4 + 1
    ops_ = n_live * fo * fi * 6       # 4 compares and 2 tile tests a lane
    out = []
    for name, line, kfn, tfn, nbytes in (
            ("join_pair_masks", "src/repro/kernels/rtree_join.py:73",
             lambda: jkern.join_pair_masks_cuda(*args[:6]),
             lambda: ref.join_pair_masks_ref(*args[:6]), b3_bytes),
            ("join_level_fused", "src/repro/kernels/rtree_join.py:129",
             lambda: jkern.join_level_fused_cuda(*args, cap=JOIN_CAP),
             lambda: ref.join_level_fused_ref(*args, cap=JOIN_CAP),
             b4_bytes)):
        ms = cuda_ms(kfn, 20)
        plain_ms = cuda_ms(tfn, 3)
        bound_ms, bound_by = bound(nbytes, ops_)
        print(f"  {name}: leaf step (P={p}, F={fo}x{fi}, {n_live} live "
              f"pairs, {uo}+{ui} distinct nodes): kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes "
              f"at 3.35 TB/s, {ops_} ops at 67 TFLOP/s)", flush=True)
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/rtree_join.cu",
                        replaces=line, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, max_abs_err=err[name]))
    return out


def phase_join_engine(torch, probe_tree, part, probes, jkern, join_vector):
    """Phase 7: the four join engine cells ≡ the twin engine and the
    reference's numbers; sampled probes ≡ brute force."""
    jkern.reset_launch_counts()
    cells = {}
    for o34 in (False, True):
        for fused in (False, True):
            cell = f"o3o4={'on' if o34 else 'off'}/" \
                   f"{'fused' if fused else 'unfused'}"
            kw = dict(result_cap=JOIN_CAP, o3=o34, o4=o34, fused=fused)
            fn = join_vector.make_join_bfs(probe_tree, part.tree, **kw)
            twin = join_vector.make_join_bfs(probe_tree, part.tree,
                                             backend="torch", **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pairs, n, ctr = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            tpairs, tn, tctr = twin()
            assert_equal(pairs, tpairs, f"join engine {cell} pairs")
            assert_equal(n, tn, f"join engine {cell} count")
            d, td = ctr.asdict(), tctr.asdict()
            check(d == td, f"join engine {cell} counters: {d} vs {td}")
            check(int(n) == JOIN_PAIRS and d["overflow"] == 0,
                  f"join engine {cell}: {int(n)} pairs (overflow "
                  f"{d['overflow']}), the reference has {JOIN_PAIRS}")
            check(d["lanes_live"][:3] == JOIN_LIVE,
                  f"join engine {cell}: lanes_live {d['lanes_live']}")
            if o34:
                for k, v in JOIN_O34.items():
                    check(d[k] == v, f"join engine {cell}: {k} {d[k]}, the "
                          f"reference has {v}")
            cells[cell] = (fn, twin, peak, d)
    launches = jkern.launch_counts()
    print(f"  four cells ≡ twin engine (pairs, count, counters) and the "
          f"reference ({JOIN_PAIRS} pairs, lanes_live {JOIN_LIVE}, "
          f"{JOIN_O34}); launches {launches}", flush=True)
    check(launches["join_pair_masks"] > 0 and
          launches["join_level_fused"] > 0, "a join kernel was not launched")
    p = pairs[:int(n)].cpu().numpy().astype(np.int64)
    sample_probes_equal_brute_force(torch, part.tree.device, p, probes,
                                    part.tree.rects.cpu().numpy(),
                                    "join engine")
    print("  256 sampled probes ≡ brute force over the partition's rects")
    d = cells["o3o4=on/unfused"][3]
    print(f"  counters (O3/O4 on): {d}")
    for cell, (fn, twin, peak, _) in cells.items():
        print(f"  {cell}: {host_ms(fn, 3):.3f} ms per join (twin engine "
              f"{host_ms(twin, 1):.3f} ms), peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        print(f"    {profile_batches(fn, iters=2)}", flush=True)
    return launches


def phase_join_serve(torch, dev, jkern, serve):
    """Phase 8: the served join through the CLI entry point."""
    argv = ["--mode", "join", "--n", str(N_RECTS), "--join-cap",
            str(JOIN_CAP), "--query-eps", str(QUERY_EPS), "--batches", "3"]
    jkern.reset_launch_counts()
    out = serve.main(argv)
    launches = jkern.launch_counts()
    print(f"  serve launches {launches}")
    check(launches["join_pair_masks"] > 0,
          "join serve did not launch join_pair_masks")
    check(not out["overflow"], "the served join overflowed")
    rects, probes = serve.make_join_inputs(N_RECTS, SEED, QUERY_EPS)
    sample_probes_equal_brute_force(torch, dev, out["last_pairs"], probes,
                                    rects, "join serve")
    print(f"  last served join: {len(out['last_pairs'])} pairs; 256 sampled "
          f"probes ≡ brute force over all {N_RECTS} rects")
    return launches, out


def knn_frontiers(torch, tree, points, k, caps, ref):
    """Each level's (B, C) frontier of a real descent: the twin of the
    fused engine's internal steps with the static caps."""
    dev = tree.device
    b, h = points.shape[0], tree.height
    ids = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    tau = torch.full((b,), 3.0e38, dtype=torch.float32, device=dev)
    frontiers = {}
    for li in range(h - 1, -1, -1):
        frontiers[li] = ids
        if li:
            lvl = tree.levels[li]
            ids, tau, _, _ = ref.knn_level_fused_ref(
                ids, points, lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child, tau,
                cap=caps[h - 1 - li], k=k,
                tighten=ids.shape[1] * tree.fanout >= k)
    return frontiers


def phase_knn_kernels(torch, tree, points, kkern, ref, knn_vector):
    """Phase 9: B5, B6 and B7 ≡ their twins, bit for bit, on every level of
    a real descent for k in {1, 8, 64}; times at the k = 8 leaf step."""
    dev = tree.device
    b, h, f_ = points.shape[0], tree.height, tree.fanout
    rng = np.random.default_rng(SEED + 13)
    rows = {li: (lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child)
            for li, lvl in enumerate(tree.levels)}
    err = {"knn_level_dists": 0, "knn_level_fused": 0, "knn_leaf_fused": 0}

    def hold(name, got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            if g is None or w is None:
                check(g is None and w is None, f"{what} [{i}]: None")
                continue
            err[name] = max(err[name], assert_bits_equal(g, w,
                                                         f"{what} [{i}]"))

    descents = {}
    for k in (1, 8, 64):
        caps = knn_vector.knn_frontier_caps(tree, k)
        descents[k] = knn_frontiers(torch, tree, points, k, caps, ref)
        for li, ids in descents[k].items():
            perm = torch.from_numpy(rng.permutation(ids.shape[1])).to(dev)
            ids = ids[:, perm].contiguous()
            drop = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.1)
            ids = torch.where(drop.to(dev), -1, ids)
            tau = torch.from_numpy((rng.random(b) * 1e-4).astype(
                np.float32)).to(dev)
            cap = caps[h - 1 - li] if li else caps[-1]
            for leaf in (False, True):
                hold("knn_level_dists",
                     kkern.knn_level_dists_cuda(ids, points, *rows[li],
                                                leaf=leaf),
                     ref.knn_level_dists_ref(ids, points, *rows[li],
                                             leaf=leaf),
                     f"B5 k={k} level {li} leaf={leaf}")
            gates = (False, True) if ids.shape[1] * f_ >= k else (False,)
            for tighten in gates:
                kw = dict(cap=cap, k=k, tighten=tighten)
                hold("knn_level_fused",
                     kkern.knn_level_fused_cuda(ids, points, *rows[li], tau,
                                                **kw),
                     ref.knn_level_fused_ref(ids, points, *rows[li], tau,
                                             **kw),
                     f"B6 k={k} level {li} tighten={tighten}")
            hold("knn_leaf_fused",
                 kkern.knn_leaf_fused_cuda(ids, points, *rows[li], k=k),
                 ref.knn_leaf_fused_ref(ids, points, *rows[li], k=k),
                 f"B7 k={k} level {li}")
            print(f"  k={k} level {li}: frontier {tuple(ids.shape)}, "
                  f"{int((ids >= 0).sum())} live slots, cap {cap} — B5, "
                  f"B6 (tighten {gates}), B7 bit-exact", flush=True)
    # overflow: every valid leaf lane kept (no τ) into a cap of 16
    ids = descents[64][0]
    pad = torch.full((b,), 3.0e38, dtype=torch.float32, device=dev)
    kw = dict(cap=16, k=64, tighten=False)
    got = kkern.knn_level_fused_cuda(ids, points, *rows[0], pad, **kw)
    hold("knn_level_fused", got,
         ref.knn_level_fused_ref(ids, points, *rows[0], pad, **kw),
         "B6 overflow")
    check(bool((got[3] > 16).all()), "the cap-16 B6 case did not overflow")
    print(f"  overflow case: cap 16, kept up to {int(got[3].max())} — B6 "
          f"bit-exact", flush=True)

    # times at the k = 8 leaf step of the descent (B6 at the last internal
    # step, the largest it runs): the kernel's device time per launch from
    # the profiler, and per call with the wrapper's host work from events
    caps8 = knn_vector.knn_frontier_caps(tree, KNN_K)
    out = []
    for name, line, li, kernel, kfn, tfn in (
            ("knn_level_dists", "src/repro/kernels/rtree_knn.py:105", 0,
             ("knn_dists_kernel", "true>"),
             lambda ids, tau: kkern.knn_level_dists_cuda(
                 ids, points, *rows[0], leaf=True),
             lambda ids, tau: ref.knn_level_dists_ref(
                 ids, points, *rows[0], leaf=True)),
            ("knn_level_fused", "src/repro/kernels/rtree_knn.py:454", 1,
             ("knn_emit_kernel", "false>"),
             lambda ids, tau: kkern.knn_level_fused_cuda(
                 ids, points, *rows[1], tau, cap=caps8[-1], k=KNN_K,
                 tighten=True),
             lambda ids, tau: ref.knn_level_fused_ref(
                 ids, points, *rows[1], tau, cap=caps8[-1], k=KNN_K,
                 tighten=True)),
            ("knn_leaf_fused", "src/repro/kernels/rtree_knn.py:467", 0,
             ("knn_emit_kernel", "true>"),
             lambda ids, tau: kkern.knn_leaf_fused_cuda(
                 ids, points, *rows[0], k=KNN_K),
             lambda ids, tau: ref.knn_leaf_fused_ref(
                 ids, points, *rows[0], k=KNN_K))):
        ids = descents[KNN_K][li]
        tau = pad
        c_ = ids.shape[1]
        live = ids[ids >= 0]
        uniq = int(torch.unique(live).numel())
        n_lanes = live.numel() * f_
        reads = ids.numel() * 4 + b * 8 + uniq * 20 * f_
        if name == "knn_level_dists":
            nbytes, ops_ = reads + b * c_ * f_ * 4, n_lanes * MINDIST_OPS
        elif name == "knn_level_fused":
            nbytes = reads + b * caps8[-1] * 4 + 12 * b
            ops_ = n_lanes * (MINDIST_OPS + MINMAXDIST_OPS)
        else:
            nbytes, ops_ = reads + 8 * b * KNN_K + 4 * b, \
                n_lanes * MINDIST_OPS
        call_ms = cuda_ms(lambda: kfn(ids, tau), 50)
        ms = device_ms(lambda: kfn(ids, tau), kernel)
        if ms is None:
            print(f"  {name}: the profiler saw no device time; timing "
                  f"calls with events", flush=True)
            ms = call_ms
        plain_ms = cuda_ms(lambda: tfn(ids, tau), 5)
        bound_ms, bound_by = bound(nbytes, ops_)
        print(f"  {name}: k={KNN_K} level {li} (B={b}, C={c_}, F={f_}, "
              f"{live.numel()} live slots, {uniq} distinct nodes): kernel "
              f"{ms:.4f} ms on the device ({call_ms:.4f} ms per call with "
              f"the wrapper), twin {plain_ms:.4f} ms, bound {bound_ms:.5f} "
              f"ms ({nbytes} bytes at 3.35 TB/s, {ops_} ops at 67 TFLOP/s)",
              flush=True)
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/rtree_knn.cu",
                        replaces=line, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, max_abs_err=err[name]))
    return out


def check_knn_brute_force(torch, dev, rects, points, ids, d, what) -> None:
    """Fail unless each query's sorted distances equal a float64 brute
    force over all ``rects`` (computed on ``dev``) to rtol 1e-4, and its
    ids are distinct and sit at their reported distances."""
    r = torch.from_numpy(np.ascontiguousarray(rects)).to(dev).double()
    for i, q in enumerate(points):
        px, py = float(q[0]), float(q[1])
        dx = torch.clamp(torch.maximum(r[:, 0] - px, px - r[:, 2]), min=0)
        dy = torch.clamp(torch.maximum(r[:, 1] - py, py - r[:, 3]), min=0)
        full = dx * dx + dy * dy
        want = torch.topk(full, ids.shape[1], largest=False).values
        want = want.cpu().numpy()
        valid = ids[i] >= 0
        got_ids = ids[i][valid]
        ok = np.allclose(np.sort(d[i]), want, rtol=1e-4, atol=1e-9)
        at = full[torch.from_numpy(got_ids.astype(np.int64)).to(dev)]
        ok &= np.allclose(at.cpu().numpy(), d[i][valid], rtol=1e-4,
                          atol=1e-9)
        ok &= len(set(got_ids.tolist())) == int(valid.sum())
        check(ok, f"{what}: query {i} differs from brute force")


def phase_knn_engine(torch, tree, rects, points, kkern, knn_vector):
    """Phase 10: the kNN engine cells ≡ the twin engine and the reference's
    numbers; k = 1 adaptive escalates; 8 queries ≡ brute force."""
    kkern.reset_launch_counts()
    cells = {}
    for k, caps_mode, fused in ((8, "static", False), (8, "static", True),
                                (8, "adaptive", False),
                                (8, "adaptive", True), (64, "static", False),
                                (64, "static", True)):
        cell = f"k={k} {caps_mode}/{'fused' if fused else 'unfused'}"
        kw = dict(caps_mode=caps_mode, fused=fused)
        fn = knn_vector.make_knn_bfs(tree, k, **kw)
        twin = knn_vector.make_knn_bfs(tree, k, backend="torch", **kw)
        before = kkern.launch_counts()
        ids, d, ctr = fn(points)
        torch.cuda.synchronize()
        after = kkern.launch_counts()
        grown = ("knn_level_fused", "knn_leaf_fused") if fused else \
            ("knn_level_dists",)
        for name in grown:
            check(after[name] > before[name], f"{cell}: {name} not launched")
        tids, td, tctr = twin(points)
        assert_bits_equal(ids, tids, f"kNN engine {cell} ids")
        assert_bits_equal(d, td, f"kNN engine {cell} dists")
        got, want = ctr.asdict(), tctr.asdict()
        check(got == want, f"kNN engine {cell} counters: {got} vs {want}")
        ref_ = KNN_REF[k]
        for key, v in ref_["counters"].items():
            check(got[key] == v, f"kNN engine {cell}: {key} {got[key]}, the "
                  f"reference has {v}")
        check(got["lanes_live"][:4] == ref_["live"] and
              got["lanes_padded"][:4] == ref_["padded"][caps_mode],
              f"kNN engine {cell}: occupancy {got['lanes_live']} "
              f"{got['lanes_padded']}")
        check(got["overflow"] == 0 and got["escalations"] == 0,
              f"kNN engine {cell}: overflow {got['overflow']}, escalations "
              f"{got['escalations']}")
        ids_np, d_np = ids.cpu().numpy(), d.cpu().numpy()
        check(int(ids_np.astype(np.int64).sum()) == ref_["ids_sum"] and
              float(d_np.astype(np.float64).sum()) == ref_["d_sum"],
              f"kNN engine {cell}: ids sum {ids_np.astype(np.int64).sum()}, "
              f"distance sum {d_np.astype(np.float64).sum()!r}")
        cells[cell] = (fn, twin, ids_np, d_np)
    launches = kkern.launch_counts()
    print(f"  six cells ≡ twin engine (ids, distance bits, counters) and the "
          f"reference (counters, occupancy, ids and distance sums); "
          f"launches {launches}", flush=True)
    for fused in (False, True):
        fn = knn_vector.make_knn_bfs(tree, 1, caps_mode="adaptive",
                                     fused=fused)
        twin = knn_vector.make_knn_bfs(tree, 1, caps_mode="adaptive",
                                       fused=fused, backend="torch")
        ids, d, ctr = fn(points)
        tids, td, tctr = twin(points)
        assert_bits_equal(ids, tids, f"k=1 fused={fused} ids")
        assert_bits_equal(d, td, f"k=1 fused={fused} dists")
        check(ctr.asdict() == tctr.asdict(), f"k=1 fused={fused} counters")
        check(fn.escalation_count() == 1 and int(ctr.escalations) == 1,
              f"k=1 adaptive fused={fused}: {fn.escalation_count()} "
              f"escalations, expected 1")
    print("  k=1 adaptive (unfused, fused): escalates once, ≡ twin engine",
          flush=True)
    _, _, ids_np, d_np = cells["k=8 static/unfused"]
    check_knn_brute_force(torch, tree.device, rects, points.cpu().numpy()[:8],
                          ids_np[:8], d_np[:8], "kNN engine")
    print("  8 queries ≡ brute force over all rects", flush=True)
    for cell, (fn, twin, _, _) in cells.items():
        print(f"  {cell}: {host_ms(lambda: fn(points), 10):.3f} ms per "
              f"{BATCH}-query batch (twin engine "
              f"{host_ms(lambda: twin(points), 3):.3f} ms)", flush=True)
        print(f"    {profile_batches(lambda: fn(points))}", flush=True)
    return launches


def phase_knn_serve(torch, dev, kkern, serve):
    """Phase 11: the served kNN through the CLI entry point."""
    argv = ["--mode", "knn", "--n", str(N_RECTS), "--k", str(KNN_K),
            "--batches", str(KNN_BATCHES), "--batch-size", str(BATCH)]
    kkern.reset_launch_counts()
    out = serve.main(argv)
    launches = kkern.launch_counts()
    print(f"  serve launches {launches}")
    check(launches["knn_level_dists"] > 0,
          "kNN serve did not launch knn_level_dists")
    check(not out["overflow"], "the served kNN overflowed")
    rects, qs = serve.make_knn_inputs(N_RECTS, SEED, KNN_BATCHES, BATCH)
    ids, d = out["first_batch"]
    check(ids.shape == (BATCH, KNN_K) and bool((ids >= 0).all()),
          f"served kNN ids {ids.shape}, {int((ids < 0).sum())} missing")
    check_knn_brute_force(torch, dev, rects, qs[0], ids, d, "kNN serve")
    print(f"  first served batch ≡ brute force over all {N_RECTS} rects "
          f"({BATCH} queries)", flush=True)
    return launches, out["qps"]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.core import join_vector, knn_vector, rtree, \
        select_vector
    from repro_torch.core.join_scalar import elevate
    from repro_torch.core.layouts import tree_layout
    from repro_torch.distributed.spatial_shard import SpatialShards
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import rtree_join as jkern
    from repro_torch.kernels import rtree_knn as kkern
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

    t0 = time.time()
    rects, probes = serve.make_join_inputs(N_RECTS, SEED, QUERY_EPS)
    shards = SpatialShards.build(rects, 8, fanout=FANOUT, sort_key="lx",
                                 device=dev)
    part = shards.partitions[CENTRE]
    probe_tree = rtree.build_rtree(probes, fanout=FANOUT, sort_key="lx",
                                   device=dev)
    h = max(probe_tree.height, part.tree.height)
    to, ti = elevate(probe_tree, h), elevate(part.tree, h)
    lo, li_ = tree_layout(to, "d1"), tree_layout(ti, "d1")
    pair_caps = join_vector.default_pair_caps(h, FANOUT, JOIN_CAP)
    pc = join_vector.reachable_pair_counts(to, ti)
    tight = join_vector.default_pair_caps(h, FANOUT, JOIN_CAP,
                                          level_sizes=(pc[0],) + pc[:-1],
                                          policy="adaptive")
    check(tight == pair_caps, f"adaptive pair caps {tight} differ from the "
          f"static {pair_caps}")
    print(f"[6] join fleet: {len(shards.partitions)} partitions, "
          f"{len(probes)} probes; centre partition {len(part.ids)} rects, "
          f"probe levels {[l.ptr.shape[0] for l in lo]}, data levels "
          f"{[l.ptr.shape[0] for l in li_]}; pair caps {pair_caps} in "
          f"{time.time() - t0:.2f} s", flush=True)
    kernels += phase_join_kernels(torch, lo, li_, pair_caps, jkern, ref, ops)

    print("[7] join engine", flush=True)
    join_eng_launches = phase_join_engine(torch, probe_tree, part, probes,
                                          jkern, join_vector)
    del shards, part, probe_tree, to, ti, lo, li_

    print("[8] join serve", flush=True)
    join_serve_launches, jout = phase_join_serve(torch, dev, jkern, serve)
    print(f"  served {jout['joins_per_s']:.3f} joins/s on {name} ({smi}); "
          f"host merge {jout['merge_s']:.2f} s of 3 joins", flush=True)

    _, qs = serve.make_knn_inputs(N_RECTS, SEED, 1, BATCH)
    points = torch.from_numpy(qs[0]).to(dev)
    print(f"[9] kNN kernels on the phase-3 tree; static caps k=1 "
          f"{knn_vector.knn_frontier_caps(tree, 1)}, k=8 "
          f"{knn_vector.knn_frontier_caps(tree, 8)}, k=64 "
          f"{knn_vector.knn_frontier_caps(tree, 64)}", flush=True)
    kernels += phase_knn_kernels(torch, tree, points, kkern, ref, knn_vector)

    print("[10] kNN engine", flush=True)
    knn_eng_launches = phase_knn_engine(torch, tree, serve.make_rects(
        N_RECTS, SEED), points, kkern, knn_vector)
    del tree

    print("[11] kNN serve", flush=True)
    knn_serve_launches, knn_qps = phase_knn_serve(torch, dev, kkern, serve)
    print(f"  served {knn_qps:,.1f} kNN q/s (k={KNN_K}) on {name} ({smi})",
          flush=True)

    # launches: B1, B3 and B5 from the served paths (phases 5, 8 and 11);
    # B2, B4, B6 and B7, which serve does not drive, from the fused engine
    # cells (phases 4, 7 and 10); every count was reset just before its
    # phase
    path_launches = {
        "select_level_masks": serve_launches,
        "select_level_fused": eng_launches,
        "join_pair_masks": join_serve_launches,
        "join_level_fused": join_eng_launches,
        "knn_level_dists": knn_serve_launches,
        "knn_level_fused": knn_eng_launches,
        "knn_leaf_fused": knn_eng_launches,
    }
    for k in kernels:
        k["launches"] = path_launches[k["name"]][k["name"]]
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
