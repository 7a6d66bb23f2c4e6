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
   cap-64 overflow case; at the leaf level the kernels' device time per
   call (torch.profiler), their time per call with the wrapper and the
   twins' (CUDA events), beside the bound; B2's device time by kernel on
   the descent's leaf frontier (live slots a prefix) and on it shuffled;
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
   off and on) and random, plus a B4 cap that overflows; at the leaf step
   device, per-call and twin times (as phase 3) beside the bound; B4's
   device time is every device item of its entry point, its -1 fill
   included, and is printed by item;
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
   beside the bound; B5's variant (vector or scalar-lane, from the
   profiled kernel name) and where its bytes go (``score_split``: live
   slots, distinct nodes, output bytes, row bytes per live slot against
   per distinct node, and the fill floor, PyTorch's fill of the same
   outputs); B6's and B7's variant and split (``emit_split``: live slots
   and lanes a row, the staging a block gets and the rows staged whole or
   walked in segments; B6 also with tightening off and the τ it found as
   τ_in, so the difference is τ's select); the same at batch 4,096 with
   the lower corners of the first all-pairs chunk as points;
10. kNN engine: ``make_knn_bfs`` on that batch, k = 8 in the four cells
   static/adaptive × unfused/fused and k = 64 static unfused/fused, against
   the twin engine on the card (ids, distance bits, every counter) and the
   reference's numbers for this input; k = 1 adaptive escalates once; 8
   queries against numpy brute force; B5 launches grow in the unfused
   cells, B6 and B7 in the fused ones; ms per 64-query batch;
11. kNN serve: ``serve.main(["--mode", "knn", ...])`` at 2M points with
   k = 8 on cuda; B5's launch count must grow, nothing may overflow, the
   first batch against a float64 brute force on the card; q/s;
12. kNN-join kernels: phase 9 for B8 (``knn_join_level_dists_cuda``), B9
   (``knn_join_level_fused_cuda``) and B10 (``knn_join_leaf_fused_cuda``)
   with the first served batch of 64 query rects (half-extent 0.002); the
   times, variants and splits also at batch 4,096 (the first all-pairs
   chunk);
13. kNN-join engine: phase 10 for ``make_knn_join_bfs`` against the
   reference's numbers for that batch (every k = 8 distance is 0);
14. all-pairs kNN-join: ``knn_join`` of the 200,000 probe rects of phase 6
   against the phase-3 tree, k = 8, in chunks of 4,096, unfused and fused:
   the two equal, the first two chunks ≡ the twin engine, 256 sampled rows
   against brute force; s per join, rows/s, peak device memory, device
   busy share;
15. kNN-join serve: ``serve.main(["--mode", "knn-join", ...])`` at 2M
   points with k = 8 on cuda; B8's launch count must grow, nothing may
   overflow, the first batch against a float64 brute force; q/s;
16. D3 build: the phase-3 tree quantized on the card (timed), bytes per
   node beside D1's, every level's codes, scale, bias and slack
   byte-equal to the same quantization of the tree's CPU copy;
17. D3 kernels: on every internal level, B11
   (``select_level_masks_d3_cuda``), B12 (``select_level_fused_d3_cuda``),
   B13 (``knn_level_dists_d3_cuda``, the first served kNN batch) and B14
   (``knn_join_level_dists_d3_cuda``, the first served kNN-join batch)
   against their twins, exact, on frontiers of a real D3 descent (columns
   shuffled, 10% of slots -1), plus a B12 cap that overflows; device,
   per-call and twin times beside the bound at batch 64 on the widest D3
   step (level 1) and at batch 4,096, B12's also by kernel, B11's, B13's
   and B14's variant, B13's and B14's split as B5's, and B11's fill floor
   (PyTorch's ``zero_`` of its mask);
18. D3 engines: ``make_select_bfs(layout="d3")`` static/adaptive ×
   unfused/fused and ``make_knn_bfs`` / ``make_knn_join_bfs(layout="d3")``
   k in {8, 64} static/adaptive against the twin engine on the card (ids,
   counts or distance bits, every counter) and the reference's D3 numbers
   (``SELECT_D3_REF``, ``KNN_D3_REF``, ``KNN_JOIN_D3_REF``); results equal
   the D1 results of phases 4, 10 and 13; B11–B14 launches grow in their
   cells; ms per batch and busy share;
19. D3 serve: ``serve.main([... "--layout", "d3"])`` at 2M points for
   spatial, kNN and kNN-join; B11, B13 and B14 launches grow, nothing
   overflows, the first batch equals the D1 path's of phases 5, 11 and 15;
   q/s;
20. filtered kNN engine: ``make_knn_filtered_bfs`` (PyTorch ops on the
   card; the reference's is jnp with no kernel) on the first served
   filtered batch (64 points, windows of half-extent 0.2), k in {8, 64} ×
   static/adaptive on D1 and D3, against the same engine on a CPU copy of
   the tree (ids, distance bits, every counter) and ``FILTERED_REF``; 8
   rows against a windowed float64 brute force; the whole-universe window
   against phase 10's kNN; ms per batch and busy share;
21. browse engine: ``make_browse_bfs`` on the first served kNN batch, k =
   8, D1 and D3, a session of 4 steps (as served) and one of 72 (several
   resume descents), each step against the twin session on the card (ids,
   distance bits, overflow, lost, emitted, descents, deferred beams,
   counters), each session against ``BROWSE_REF``, the first 32 neighbours
   against ``make_knn_bfs(k=32)`` bit for bit; B5 launches grow, and B13's
   on D3; ms per ``next_batch()`` and busy share;
22. filtered kNN and browse serve: ``serve.main(["--mode", "knn-filtered",
   ...])`` and ``["--mode", "browse", ...]`` at 2M points on cuda, D1 and
   D3; nothing overflows, the first batch against a float64 brute force,
   D3 equal to D1, B5 (and on D3 B13) launches grow in browse; q/s;
23. mesh engines: the 2M points in the 9 partitions of ``serve
   --partitions 8``, packed into one forest (``enable_mesh``), D1 and D3:
   the mesh programs of select, kNN and kNN-join (k in {8, 64}), filtered
   kNN (k = 8), the distributed browse (k = 8, 4 steps) and the join (D1,
   ``--join-cap`` 1048576, O3/O4) each ≡ its twin program on the card
   (ids, counts or distance bits, every counter but dispatches; the
   browse step by step, each partition's counters) and ≡ the host path on
   the same fleet; B5 a kNN batch = 2 × the forest's height (on D3 B5 2
   and B13 2 × (height - 1)), and over 4 partitions too; for the mesh and
   the host call: launches by kernel, ms per batch, busy share, peak
   device memory;
24. mesh serve: ``serve.main([... "--mesh", "on"])`` and ``"off"`` for
   spatial, join (D1), kNN, kNN-join, filtered kNN and browse, D1 and D3:
   nothing overflows, the two paths' first batches equal (browse: the
   first k ids and every distance bit of the first session), q/s, joins/s
   and sessions·q/s side by side, B5 on the served mesh kNN = (batches +
   1) × 2 × height; B1, B3, B5, B8, B11, B13 and B14 launch on the mesh
   path (``mesh_launches`` in the kernels' line);
25. serve queue: ``serve.main([... "--queue"])`` at 2M points, 9
   partitions, 40 requests of 64 rows from 8 clients, batches of up to 256
   rows, depth 2: D1 select, kNN, kNN-join and filtered kNN with ``--mesh
   off`` and ``on``, D3 kNN with ``--mesh on``; every response bit-equal
   to the direct call of a fleet built the same way on the same path; no
   dispatch failure, retry, degraded dispatch, pool failure or failed
   request; B1, B5, B8 (and on D3 B13) launch (``queue_launches`` in the
   kernels' line); queued q/s beside the direct q/s, dispatches, rows per
   dispatch, re-issues; the queued mesh kNN and select under torch.profiler
   (busy share, top device items);
26. chaos: a ServeQueue of D1 kNN over ``replicate(devices=[cuda:0,
   cuda:0])`` with the host-path fallback, fault-free (against one
   replica too) and under ``kill:r1@5``, ``crash:r0@3,slow:r1@4:0.2`` and
   ``kill:r0@0,kill:r1@0``: no failed request, responses equal to the
   fault-free run's, the pool's failures equal to the injected exceptions,
   a quarantine under the first plan, degraded dispatches under the last;
   then ``serve.main([... "--queue", "--chaos", "crash:r0@3"])`` on one
   replica;
27. baselines: ``flatten_tree`` of the phase-3 tree on cuda ≡ its CPU
   copy's; kernels S (``make_select_dfs``) and V
   (``make_select_dfs_vector``) for the 64 select queries, one launch a
   query, ≡ their host twins on the CPU copy (res in emit order, rc,
   every counter) and ``BASELINE_REF``, also with a stack of 8 and 64
   result slots (overflow), each query's sorted ids ≡ phase 4's engine;
   the latency model (kernel S on a random one-child chain, device ns a
   node); ms per query of S, V (device time and a batch of launches /
   64), the BFS engine unfused and fused (a batch / 64),
   ``select_recursive_py`` logical and bitwise (4 queries),
   ``knn_best_first`` (4 points) and ``knn_join_best_first`` (4 rects),
   k = 8, each ≡ ``BASELINE_REF``; ``join_recursive_py`` with O3 off and
   on at ``benchmarks/bench_join.py``'s configuration (n = 100,000 a side,
   half-extent 0.0005, fanout 64, sort_key "lx"; n halved, and printed,
   while the host join takes more than 60 s) ≡ ``BASELINE_REF``, its
   pairs ≡ the D0, D1 and D2 engines' on the card, the time of each;
28. D0 and D2 engines: the levels built on the card byte-equal to the
   CPU's; select (static, adaptive), the centre partition's
   join (O3/O4 off, on), kNN, kNN-join and filtered kNN (k in {8, 64},
   static, adaptive) and browse sessions (4 and 72 steps) on the inputs
   of phases 4, 7, 10, 13, 20 and 21: ids, counts, overflow and distance
   bits ≡ the D1 engine's (kNN as sets within ties), every counter but
   dispatches ≡ ``LAYOUT_REF`` / ``LAYOUT_JOIN_REF``; ms per batch, busy
   share and peak MiB of D1, D0 and D2;
29. D0/D2 serve: ``serve.main([... "--layout", "d0" | "d2"])`` at 2M
   points, spatial, kNN and the join on the host path and kNN with
   ``--mesh on``: nothing overflows, the first batch ≡ brute force
   (the join: 256 sampled probes), q/s and joins/s;
30. D3 join engine: ``make_join_bfs(layout="d3", result_cap=1048576)`` of
   phase 6's centre partition and its 200,000 probes (PyTorch math: the
   tile over the dequantized boxes, the exact rects at the leaf; no
   kernel in either package) in {O3/O4 off, on} × {static, adaptive}: the
   sorted pairs ≡ D1's, overflow and every counter but dispatches ≡
   ``D3_JOIN_REF`` (``scripts/a9b_reference_numbers.py``), live pairs a
   level beside D1's, 256 sampled probes ≡ brute force; ms per join, busy
   share and peak MiB beside D1's; ``backend="cuda"`` and ``fused=True``
   raise ValueError;
31. D3 join serve: ``serve.main(["--mode", "join", "--layout", "d3",
   ...])`` at 2M points with ``--mesh off`` and ``on`` (one card's mesh):
   nothing overflows, 256 sampled probes ≡ brute force; joins/s and the
   host merge's share;
32. LM: tinyllama-1.1b at its published widths, weights from the seed.
   (a) bfloat16, ``generate`` over 64 prompts of 32 tokens, 16 new tokens
   (``serve --mode lm``'s traffic): tok/s and peak MiB; its tokens ≡
   prefill + decode's; every logit finite and within ``LM_BF16_TOL``
   (relative) of a teacher-forced full forward at each new position;
   prefill ms; a decode step's host ms, device ms (torch.profiler) and
   device items beside its bytes bound (weights and KV cache read once
   at the H100 SXM's 3.35 TB/s, and the card's measured copy rate); (b)
   float32 with TF32 off, 2 prompts of 24 tokens and 8 new: the card's
   logits ≡ the same weights' on the CPU within 1e-4 (relative) at every
   step, and the greedy tokens equal;
33. ``serve.main(["--mode", "lm"])`` on cuda: tok/s; its tokens ≡ the
   same command's with ``--device cpu``;
34.-37. LM: phase 32 for the other families at their published widths:
   falcon-mamba-7b (Mamba1, 64 layers), zamba2-7b (Mamba2, 81 layers, the
   shared attention block 13 times), grok-1-314b (MoE, 4 of its 64 layers)
   and llama4-maverick-400b-a17b (dense and MoE interleaved, 2 of its 48
   layers); (a) in bfloat16 with phase 32's traffic, the bytes bound
   counting SSM states read and written; MoE: the published capacity's
   prefill drops by layer and its prefill ms beside the dropless copy's,
   the teacher-forced check on the dropless copy with the routing flips
   counted (each MoE layer's ``moe`` reports its routing to a forward
   hook), and the bound also for the routed experts' weights only; (b)
   float32 at the reduced config, card against CPU; (c) float32 with TF32
   off at full width and the depth that fits (the SSM cells whole, grok-1
   3 layers, llama4 2), 8 prompts: decode within ``LM_F32_TOL`` of the
   teacher-forced forward at every position, a quarter of the sequences
   free of routing flips at least; (d) the SSM cells in bfloat16 at
   tinyllama's 22 layers, seeds 0 and 3, phase 32's traffic: within
   ``LM_BF16_TOL`` (their bound at full depth, ``LM_SSM_BF16_TOL``, is
   wider: bfloat16 over 64 and 81 layers);
38. training: tinyllama-1.1b at its published widths in bfloat16 (AdamW,
   its state float32, no master weights; remat on) at the repo's training
   sequence length (``train_4k``: 4,096 tokens), 4 sequences a step (the
   global batch of 256 cut to fit one card and the run), ``TRAIN_STEPS``
   steps of ``SyntheticLM`` batches: every loss and grad norm finite, the
   mean loss of the last 5 steps below that of the first 5; tok/s, a
   step's host ms, device ms (torch.profiler) and busy share, peak MiB,
   and 6·N·T plus the attention FLOPs as a share of the H100's bf16 dense
   peak (printed, no claim);
39. the flash backward at phase 38's shapes (float32 inputs, TF32 off):
   out, dq, dk, dv against autograd through a dense float32 softmax
   attention, one sequence at a time, within ``FLASH_F32_TOL``
   (relative); the backward's ms (CUDA events) in float32, and the
   forward's and backward's in bfloat16 (what phase 38 runs), beside the
   dense reference's;
40. float32 train steps on the card against the same steps on the CPU:
   the reduced configs of all eight layer patterns (dense, dense with a
   window, audio, vlm, MoE every layer, MoE every 2, Mamba1, the hybrid),
   the same weights and ``SyntheticLM`` batches, TF32 off: the first
   batch's loss and every leaf's grad within ``TRAIN_F32_TOL`` (relative;
   norm-relative per leaf), then AdamW (eps ``TRAIN_ADAM_EPS``) and
   Adafactor over 2 microbatches: each step's loss within it, and every
   leaf's params after the steps (norm-relative);
41. restarts: in a subprocess with ``CUBLAS_WORKSPACE_CONFIG`` set and
   deterministic algorithms on, ``run_with_restarts`` on the card
   (reduced tinyllama in bfloat16, 12 steps, checkpoints every 4,
   failures before steps 6 and 9) ≡ an uninterrupted run bit for bit
   (params, optimizer state); then ``launch.train`` on cuda (its
   default) with ``--ckpt-dir``, and again with ``--resume``, which starts
   from the latest committed step;
42. the dry run's memory table: ``python -m repro_torch.launch.dryrun
   --all --both-meshes --out <temp>`` in a subprocess (no card, no process
   group): 34 runnable cells × 2 meshes report and 6 × 2 long_500k cells
   are skipped, as ``cell_runnable`` rules; a line per cell of per-device
   GiB (parameters, optimizer state, inputs, cache) and whether the total
   fits this card's ``total_memory``;
43. the sharding hooks on the card, in a subprocess with an NCCL process
   group of world size 1 over loopback and ``make_mesh((1, 1), ("data",
   "model"))``, deterministic algorithms on and ``CUBLAS_WORKSPACE_CONFIG``
   set: tinyllama-1.1b at its published widths in bfloat16 from the seed;
   (a) every parameter placed by ``distribute_params`` (FSDP off), the
   hooks active, ``generate`` over phase 32's traffic ≡ the plain path's
   tokens bit for bit; a decode step's host ms and device ms with and
   without DTensor; (b) one AdamW step with FSDP on, remat, ``act_shard``,
   ``logit_shard`` and ``grad_shardings`` at phase 38's 4 × 4,096 tokens:
   its loss and every updated parameter ≡ the plain step's bit for bit.
   Neither phase launches a kernel of the port;
44. the traced cost model, in a subprocess started after phase 38 at the
   lowest priority (host work only, beside phases 39-43; no kernel, no
   process group on the card): (a) the dry run's ``run_cell`` of tinyllama-1.1b
   train_4k, llama4-maverick-400b-a17b decode_32k (MoE) and zamba2-7b
   train_4k (Mamba2 and the shared attention block), and grok-1-314b
   train_4k without and with the MoE knobs (``MOE_KNOBS``: dispatch groups
   of 4,096 tokens, the dispatch and combine sharded over 'model', the
   backward through them), each step traced on meta-device DTensors over
   a fake process group's (16, 16) mesh under this torch's own DTensor
   rules, a line per cell; the knob cell's ``moe_groups`` must be the dry
   run's count, and its collective GiB and TFLOP a device are printed
   beside the cell's without the knobs; (b) phase 32's decode step and
   phase 38's train step traced on one device at their shapes: the
   roofline's max(compute, memory) with the ideal bytes must not exceed
   the device time those phases measured in this run (printed with the
   eager bytes' term beside it);
45. the port's four examples on cuda (``examples/*_torch.py``, each
   through its ``main`` at its counterpart's sizes): the quickstart's
   select ≡ the scalar baseline (its own assert) with B1 launched, the
   served fleet's q/s > 0 with B1 launched, the join analytics' pairs
   (B3 launched) ≡ a brute-force join of the same 30,000 × 30,000 rects
   on the card, and the training example at ``EXAMPLE_TRAIN_STEPS``
   steps: resumed half way, its loss falls across the resume; each
   example's seconds.  Its time is paid by timing-only cuts of phases 23,
   24 and 32-37 (each cut's seconds printed from the run's own
   per-call times).

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
# the reference's numbers for the first served kNN-join batch (64 rects of
# half-extent QUERY_EPS) on the phase-3 tree: the JAX package's
# make_knn_join_bfs(backend="xla"), equal in both caps tiers and fused or
# not.  At k = 8 every distance is 0 (each rect holds 20 or more points).
KNN_JOIN_REF = {
    8: dict(counters=dict(nodes_visited=2_287, predicates=971_008,
                          vector_ops=15_172, enqueued=2_223,
                          pruned_inner=85_841, masked_waste=8_320),
            live=[64, 576, 866, 781],
            padded={"static": [0, 7616, 7326, 7411],
                    "adaptive": [0, 0, 1182, 1267]},
            ids_sum=515_026_219, d_sum=0.0),
    64: dict(counters=dict(nodes_visited=10_144, predicates=3_977_728,
                           vector_ops=62_152, enqueued=10_080,
                           pruned_inner=321_760, masked_waste=13_376),
             live=[64, 576, 4754, 4750],
             padded={"static": [0, 7616, 3438, 11634],
                     "adaptive": [0, 0, 11630, 11634]},
             ids_sum=4_034_559_553, d_sum=0.000723181390258329),
}
# the reference's numbers for the same inputs on the D3 layout: the JAX
# package's make_select_bfs / make_knn_bfs / make_knn_join_bfs(layout="d3",
# backend="xla") on the phase-3 tree, equal in both caps tiers (padded
# slots per tier) and, for select, fused or not, as
# scripts/d3_reference_numbers.py prints them.  The ids and distances are
# D1's (the leaf re-check is exact); the counters are D3's own.
SELECT_D3_REF = dict(
    counters=dict(nodes_visited=3_100, predicates=746_496, vector_ops=11_664,
                  enqueued=3_036, masked_waste=67_132),
    live=[64, 88, 216, 2732],
    padded={"static": [0, 16296, 16168, 1045844],
            "adaptive": [0, 168, 16168, 1045844]},
    ids_sum=127_911_487_263, counts_sum=128_232)
KNN_D3_REF = {
    8: dict(counters=dict(nodes_visited=2_525, predicates=646_400,
                          vector_ops=10_100, enqueued=2_461,
                          pruned_inner=90_439, masked_waste=8_412),
            live=[64, 576, 943, 942],
            padded={"static": [0, 15808, 15441, 15442],
                    "adaptive": [0, 0, 1105, 1106]},
            ids_sum=500_525_860, d_sum=0.0003939492196707306),
    64: dict(counters=dict(nodes_visited=10_568, predicates=2_705_408,
                           vector_ops=42_272, enqueued=10_504,
                           pruned_inner=331_356, masked_waste=13_468),
             live=[64, 576, 4912, 5016],
             padded={"static": [0, 15808, 11472, 11368],
                     "adaptive": [0, 0, 11472, 11368]},
             ids_sum=4_024_399_365, d_sum=0.022336982976781883),
}
KNN_JOIN_D3_REF = {
    8: dict(counters=dict(nodes_visited=2_466, predicates=631_296,
                          vector_ops=9_864, enqueued=2_402,
                          pruned_inner=89_986, masked_waste=8_412),
            live=[64, 576, 935, 891],
            padded={"static": [0, 15808, 15449, 15493],
                    "adaptive": [0, 0, 1113, 1157]},
            ids_sum=515_026_219, d_sum=0.0),
    64: dict(counters=dict(nodes_visited=10_475, predicates=2_681_600,
                           vector_ops=41_900, enqueued=10_411,
                           pruned_inner=331_019, masked_waste=13_514),
             live=[64, 576, 4906, 4929],
             padded={"static": [0, 15808, 11478, 11455],
                     "adaptive": [0, 0, 11478, 11455]},
             ids_sum=4_034_559_553, d_sum=0.000723181390258329),
}
# filtered kNN (phases 20 and 22): windows of this half-extent around each
# served point; browse (phases 21 and 22): a session of BROWSE_STEPS
# next_batch() calls, as served, and one of BROWSE_DEEP, which resumes
# more than once
FILTER_EPS, BROWSE_STEPS, BROWSE_DEEP = 0.2, 4, 72
# the mesh path's fleet: ``serve --partitions 8`` builds a 3×3 grid
MESH_PARTITIONS, MESH_KS = 8, (8, 64)
# the serve queue (phases 25-26): 40 requests of BATCH rows from 8
# closed-loop clients, coalesced into batches of up to 256 rows, two in
# flight; the chaos plans of phase 26 over two replicas on one card
QUEUE_REQUESTS, QUEUE_CLIENTS, QUEUE_MAX_BATCH, QUEUE_DEPTH = 40, 8, 256, 2
CHAOS_PLANS = ("kill:r1@5", "crash:r0@3,slow:r1@4:0.2",
               "kill:r0@0,kill:r1@0")
# the reference's numbers for the first served filtered batch (64 points,
# windows of half-extent FILTER_EPS) on the phase-3 tree: the JAX package's
# make_knn_filtered_bfs by (layout, k), equal in both caps tiers (padded
# slots per tier), as scripts/a10_reference_numbers.py prints them; and for
# browse sessions of (layout, steps) over the first served kNN batch, k = 8
# (make_browse_bfs(backend="xla")).  The deep sessions cross the lost bound
# on every row (overflow 64): the first descent's bounded beams drop
# candidates that later emission reaches.
FILTERED_REF = {
    ("d1", 8): dict(counters=dict(nodes_visited=1982, predicates=804_864,
                    vector_ops=12_576, enqueued=1918, pruned_inner=58_969,
                    masked_waste=13_481), live=[64, 227, 871, 820],
                    ids_sum=500_525_860, d_sum=0.0003939492196707306,
                    found=512, padded={"static": [0, 7965, 15_513, 15_564],
                    "adaptive": [0, 349, 3225, 3276]}),
    ("d1", 64): dict(counters=dict(nodes_visited=10_221, predicates=4_004_864,
                     vector_ops=62_576, enqueued=10_157, pruned_inner=266_178,
                     masked_waste=70_737), live=[64, 227, 5132, 4798],
                     ids_sum=4_024_399_365, d_sum=0.022336982976781883,
                     found=4096, padded={"static": [0, 7965, 11_252, 27_970],
                     "adaptive": [0, 349, 27_252, 27_970]}),
    ("d3", 8): dict(counters=dict(nodes_visited=2177, predicates=557_312,
                    vector_ops=8708, enqueued=2113, pruned_inner=63_342,
                    masked_waste=13_585), live=[64, 228, 943, 942],
                    ids_sum=500_525_860, d_sum=0.0003939492196707306,
                    found=512, padded={"static": [0, 16_156, 15_441, 15_442],
                    "adaptive": [0, 348, 3153, 3154]}),
    ("d3", 64): dict(counters=dict(nodes_visited=10_511, predicates=2_690_816,
                     vector_ops=42_044, enqueued=10_447, pruned_inner=266_576,
                     masked_waste=74_657), live=[64, 228, 5203, 5016],
                     ids_sum=4_024_399_365, d_sum=0.022336982976781883,
                     found=4096, padded={"static": [0, 16_156, 11_181, 27_752],
                     "adaptive": [0, 348, 27_181, 27_752]}),
}
BROWSE_REF = {
    ("d1", 4): dict(counters=dict(nodes_visited=2331, predicates=983_552,
                    vector_ops=15_368, enqueued=2267, pruned_inner=86_117,
                    masked_waste=8320), live=[64, 576, 871, 820], padded=[0,
                    7616, 7321, 7372], ids_sum=1_981_845_840,
                    d_sum=0.005745814926882531, found=2048, descents=1,
                    emitted=2048, overflow=0, lost_finite=64,
                    lost_sum=0.005474856538057793),
    ("d1", 72): dict(counters=dict(nodes_visited=4298, predicates=1_683_712,
                     vector_ops=26_308, enqueued=2337, pruned_inner=134_095,
                     masked_waste=9424), live=[64, 576, 1639, 2019],
                     padded=[1856, 245_184, 244_121, 243_741],
                     ids_sum=36_632_160_694, d_sum=1.817284040318924,
                     found=36_864, descents=30, emitted=36_864, overflow=64,
                     lost_finite=64, lost_sum=0.005474856538057793),
    ("d3", 4): dict(counters=dict(nodes_visited=2525, predicates=646_400,
                    vector_ops=10_100, enqueued=2461, pruned_inner=90_439,
                    masked_waste=8412), live=[64, 576, 943, 942], padded=[0,
                    7616, 7249, 7250], ids_sum=1_981_845_840,
                    d_sum=0.005745814926882531, found=2048, descents=1,
                    emitted=2048, overflow=0, lost_finite=64,
                    lost_sum=0.00540862853085855),
    ("d3", 72): dict(counters=dict(nodes_visited=9717, predicates=2_487_552,
                     vector_ops=38_868, enqueued=2812, pruned_inner=307_690,
                     masked_waste=12_110), live=[64, 576, 4399, 4678],
                     padded=[1472, 196_032, 192_209, 191_930],
                     ids_sum=36_642_230_984, d_sum=1.8773571207842963,
                     found=36_864, descents=24, emitted=36_864, overflow=64,
                     lost_finite=64, lost_sum=0.00540862853085855),
}
ALL_PAIRS_BATCH = 4096
# the paper's baselines (phase 27): the DFS walks S and V with the default
# stack and with a forced overflow (stack_cap, result_cap); the latency
# model's chain walk; the scalar join at benchmarks/bench_join.py's
# configuration, n halved while its host time passes the budget
DFS_OVERFLOW = (8, 64)
CHAIN_NODES, CHAIN_STEPS = 1 << 24, 1 << 17
SCALAR_JOIN_N, SCALAR_JOIN_EPS, SCALAR_JOIN_BUDGET_S = 100_000, 0.0005, 60.0
# the served D0/D2 runs of phase 29
LAYOUT_SERVE_BATCHES = 4
# the reference's numbers for phases 27-28, as
# scripts/a9a_reference_numbers.py prints them: the baselines over the
# first served batches (the DFS walks summed over the 64 queries, the host
# baselines over the first 4 rows, the scalar join at bench_join's
# configuration), and the D0/D2 engines (the reference's jnp path) on the
# inputs of phases 4, 7, 10, 13, 20 and 21, equal in both caps tiers
# (padded slots per tier).  The ids and distances are D1's; the counters
# are the layout's own (D2 scores in 2 stages).
BASELINE_REF = {
    ('scalar', 1024, 4096):
        {'rc': 128232, 'nodes_visited': 3056, 'predicates': 766100,
            'overflow': 0},
    ('scalar', 8, 64):
        {'rc': 133302, 'nodes_visited': 3056, 'predicates': 766100,
            'overflow': 64},
    ('vector', 1024, 4096):
        {'rc': 128232, 'nodes_visited': 3056, 'predicates': 782336,
            'overflow': 0},
    ('vector', 8, 64):
        {'rc': 133302, 'nodes_visited': 3056, 'predicates': 782336,
            'overflow': 64},
    ('recursive', 'logical'):
        {'nodes_visited': 195, 'predicates': 42453, 'branches': 42453,
            'ids_sum': 8051466081, 'found': 8066},
    ('recursive', 'bitwise'):
        {'nodes_visited': 195, 'predicates': 48848, 'branches': 12212,
            'ids_sum': 8051466081, 'found': 8066},
    ('knn_best_first', 8):
        {'nodes_visited': 23, 'predicates': 7712, 'vector_ops': 148,
            'enqueued': 732, 'pruned_inner': 520, 'ids_sum': 27232618,
            'found': 32, 'd_sum': 2.2431540450895682e-05},
    ('knn_join_best_first', 8):
        {'nodes_visited': 32, 'predicates': 10528, 'vector_ops': 192,
            'enqueued': 1198, 'pruned_inner': 630, 'ids_sum': 9505823,
            'found': 32, 'd_sum': 0.0},
    ('join_recursive', False):
        {'nodes_visited': 13716, 'predicates': 110728068, 'pairs': 39716,
            'pairs_sum': 3983095359},
    ('join_recursive', True):
        {'nodes_visited': 13716, 'predicates': 95764932, 'pruned_outer': 58866,
            'pairs': 39716, 'pairs_sum': 3983095359},
}
LAYOUT_REF = {
    ('select', 'd0'):
        {'counters': {'nodes_visited': 3056, 'predicates': 782336,
            'vector_ops': 12224, 'enqueued': 2992, 'pruned_outer': 0,
            'pruned_inner': 0, 'masked_waste': 64360}, 'live': [64, 86, 202,
            2704], 'ids_sum': 127911487263, 'found': 128232,
            'counts_sum': 128232, 'padded': {'static': [0, 8106, 16182,
            1045872], 'adaptive': [0, 170, 16182, 1045872]}},
    ('knn', 'd0', 8):
        {'counters': {'nodes_visited': 2331, 'predicates': 983552,
            'vector_ops': 15368, 'enqueued': 2267, 'pruned_outer': 0,
            'pruned_inner': 86117, 'masked_waste': 8320}, 'live': [64, 576,
            871, 820], 'ids_sum': 500525860, 'found': 512,
            'd_sum': 0.0003939492196707306, 'padded': {'static': [0, 7616,
            7321, 7372], 'adaptive': [0, 0, 1177, 1228]}},
    ('knn', 'd0', 64):
        {'counters': {'nodes_visited': 10193, 'predicates': 3990528,
            'vector_ops': 62352, 'enqueued': 10129, 'pruned_outer': 0,
            'pruned_inner': 321775, 'masked_waste': 13376}, 'live': [64, 576,
            4755, 4798], 'ids_sum': 4024399365, 'found': 4096,
            'd_sum': 0.022336982976781883, 'padded': {'static': [0, 7616, 3437,
            11586], 'adaptive': [0, 0, 11629, 11586]}},
    ('knn_join', 'd0', 8):
        {'counters': {'nodes_visited': 2287, 'predicates': 971008,
            'vector_ops': 15172, 'enqueued': 2223, 'pruned_outer': 0,
            'pruned_inner': 85841, 'masked_waste': 8320}, 'live': [64, 576,
            866, 781], 'ids_sum': 515026219, 'found': 512, 'd_sum': 0.0,
            'padded': {'static': [0, 7616, 7326, 7411], 'adaptive': [0, 0,
            1182, 1267]}},
    ('knn_join', 'd0', 64):
        {'counters': {'nodes_visited': 10144, 'predicates': 3977728,
            'vector_ops': 62152, 'enqueued': 10080, 'pruned_outer': 0,
            'pruned_inner': 321760, 'masked_waste': 13376}, 'live': [64, 576,
            4754, 4750], 'ids_sum': 4034559553, 'found': 4096,
            'd_sum': 0.000723181390258329, 'padded': {'static': [0, 7616, 3438,
            11634], 'adaptive': [0, 0, 11630, 11634]}},
    ('knn_filtered', 'd0', 8):
        {'counters': {'nodes_visited': 1982, 'predicates': 804864,
            'vector_ops': 12576, 'enqueued': 1918, 'pruned_outer': 0,
            'pruned_inner': 58969, 'masked_waste': 13481}, 'live': [64, 227,
            871, 820], 'ids_sum': 500525860, 'found': 512,
            'd_sum': 0.0003939492196707306, 'padded': {'static': [0, 7965,
            15513, 15564], 'adaptive': [0, 349, 3225, 3276]}},
    ('knn_filtered', 'd0', 64):
        {'counters': {'nodes_visited': 10221, 'predicates': 4004864,
            'vector_ops': 62576, 'enqueued': 10157, 'pruned_outer': 0,
            'pruned_inner': 266178, 'masked_waste': 70737}, 'live': [64, 227,
            5132, 4798], 'ids_sum': 4024399365, 'found': 4096,
            'd_sum': 0.022336982976781883, 'padded': {'static': [0, 7965,
            11252, 27970], 'adaptive': [0, 349, 27252, 27970]}},
    ('browse', 'd0', 4):
        {'counters': {'nodes_visited': 2331, 'predicates': 983552,
            'vector_ops': 15368, 'enqueued': 2267, 'pruned_outer': 0,
            'pruned_inner': 86117, 'masked_waste': 8320}, 'live': [64, 576,
            871, 820], 'padded': [0, 7616, 7321, 7372], 'ids_sum': 1981845840,
            'found': 2048, 'd_sum': 0.005745814926882531, 'descents': 1,
            'overflow': 0},
    ('browse', 'd0', 72):
        {'counters': {'nodes_visited': 4298, 'predicates': 1683712,
            'vector_ops': 26308, 'enqueued': 2337, 'pruned_outer': 0,
            'pruned_inner': 134095, 'masked_waste': 9424}, 'live': [64, 576,
            1639, 2019], 'padded': [1856, 245184, 244121, 243741],
            'ids_sum': 36632160694, 'found': 36864, 'd_sum': 1.817284040318924,
            'descents': 30, 'overflow': 64},
    ('select', 'd2'):
        {'counters': {'nodes_visited': 3056, 'predicates': 391168,
            'vector_ops': 6112, 'enqueued': 2992, 'pruned_outer': 0,
            'pruned_inner': 0, 'masked_waste': 64360}, 'live': [64, 86, 202,
            2704], 'ids_sum': 127911487263, 'found': 128232,
            'counts_sum': 128232, 'padded': {'static': [0, 8106, 16182,
            1045872], 'adaptive': [0, 170, 16182, 1045872]}},
    ('knn', 'd2', 8):
        {'counters': {'nodes_visited': 2331, 'predicates': 491776,
            'vector_ops': 7684, 'enqueued': 2267, 'pruned_outer': 0,
            'pruned_inner': 86117, 'masked_waste': 8320}, 'live': [64, 576,
            871, 820], 'ids_sum': 500525860, 'found': 512,
            'd_sum': 0.0003939492196707306, 'padded': {'static': [0, 7616,
            7321, 7372], 'adaptive': [0, 0, 1177, 1228]}},
    ('knn', 'd2', 64):
        {'counters': {'nodes_visited': 10193, 'predicates': 1995264,
            'vector_ops': 31176, 'enqueued': 10129, 'pruned_outer': 0,
            'pruned_inner': 321775, 'masked_waste': 13376}, 'live': [64, 576,
            4755, 4798], 'ids_sum': 4024399365, 'found': 4096,
            'd_sum': 0.022336982976781883, 'padded': {'static': [0, 7616, 3437,
            11586], 'adaptive': [0, 0, 11629, 11586]}},
    ('knn_join', 'd2', 8):
        {'counters': {'nodes_visited': 2287, 'predicates': 485504,
            'vector_ops': 7586, 'enqueued': 2223, 'pruned_outer': 0,
            'pruned_inner': 85841, 'masked_waste': 8320}, 'live': [64, 576,
            866, 781], 'ids_sum': 515026219, 'found': 512, 'd_sum': 0.0,
            'padded': {'static': [0, 7616, 7326, 7411], 'adaptive': [0, 0,
            1182, 1267]}},
    ('knn_join', 'd2', 64):
        {'counters': {'nodes_visited': 10144, 'predicates': 1988864,
            'vector_ops': 31076, 'enqueued': 10080, 'pruned_outer': 0,
            'pruned_inner': 321760, 'masked_waste': 13376}, 'live': [64, 576,
            4754, 4750], 'ids_sum': 4034559553, 'found': 4096,
            'd_sum': 0.000723181390258329, 'padded': {'static': [0, 7616, 3438,
            11634], 'adaptive': [0, 0, 11630, 11634]}},
    ('knn_filtered', 'd2', 8):
        {'counters': {'nodes_visited': 1982, 'predicates': 402432,
            'vector_ops': 6288, 'enqueued': 1918, 'pruned_outer': 0,
            'pruned_inner': 58969, 'masked_waste': 13481}, 'live': [64, 227,
            871, 820], 'ids_sum': 500525860, 'found': 512,
            'd_sum': 0.0003939492196707306, 'padded': {'static': [0, 7965,
            15513, 15564], 'adaptive': [0, 349, 3225, 3276]}},
    ('knn_filtered', 'd2', 64):
        {'counters': {'nodes_visited': 10221, 'predicates': 2002432,
            'vector_ops': 31288, 'enqueued': 10157, 'pruned_outer': 0,
            'pruned_inner': 266178, 'masked_waste': 70737}, 'live': [64, 227,
            5132, 4798], 'ids_sum': 4024399365, 'found': 4096,
            'd_sum': 0.022336982976781883, 'padded': {'static': [0, 7965,
            11252, 27970], 'adaptive': [0, 349, 27252, 27970]}},
    ('browse', 'd2', 4):
        {'counters': {'nodes_visited': 2331, 'predicates': 491776,
            'vector_ops': 7684, 'enqueued': 2267, 'pruned_outer': 0,
            'pruned_inner': 86117, 'masked_waste': 8320}, 'live': [64, 576,
            871, 820], 'padded': [0, 7616, 7321, 7372], 'ids_sum': 1981845840,
            'found': 2048, 'd_sum': 0.005745814926882531, 'descents': 1,
            'overflow': 0},
    ('browse', 'd2', 72):
        {'counters': {'nodes_visited': 4298, 'predicates': 841856,
            'vector_ops': 13154, 'enqueued': 2337, 'pruned_outer': 0,
            'pruned_inner': 134095, 'masked_waste': 9424}, 'live': [64, 576,
            1639, 2019], 'padded': [1856, 245184, 244121, 243741],
            'ids_sum': 36632160694, 'found': 36864, 'd_sum': 1.817284040318924,
            'descents': 30, 'overflow': 64},
}
LAYOUT_JOIN_REF = {
    ('join', 'd0', False):
        {'counters': {'nodes_visited': 16312, 'predicates': 133257184,
            'vector_ops': 32624, 'enqueued': 729069, 'pruned_outer': 0,
            'pruned_inner': 0, 'masked_waste': 0}, 'live': [1, 110, 8045],
            'pairs': 720914, 'pairs_sum': 152458661235},
    ('join', 'd0', True):
        {'counters': {'nodes_visited': 16312, 'predicates': 33317712,
            'vector_ops': 32624, 'enqueued': 729069, 'pruned_outer': 170740,
            'pruned_inner': 14086858, 'masked_waste': 24984868}, 'live': [1,
            110, 8045], 'pairs': 720914, 'pairs_sum': 152458661235},
    ('join', 'd2', False):
        {'counters': {'nodes_visited': 16312, 'predicates': 66628592,
            'vector_ops': 16312, 'enqueued': 729069, 'pruned_outer': 0,
            'pruned_inner': 0, 'masked_waste': 0}, 'live': [1, 110, 8045],
            'pairs': 720914, 'pairs_sum': 152458661235},
    ('join', 'd2', True):
        {'counters': {'nodes_visited': 16312, 'predicates': 16658856,
            'vector_ops': 16312, 'enqueued': 729069, 'pruned_outer': 170740,
            'pruned_inner': 14086858, 'masked_waste': 24984868}, 'live': [1,
            110, 8045], 'pairs': 720914, 'pairs_sum': 152458661235},
}
# the reference's numbers for phase 6's centre partition joined on D3 (the
# JAX package's jnp path: scripts/a9b_reference_numbers.py), equal in both
# caps tiers; its sorted pairs equal D1's
D3_JOIN_REF = {
    ('join', 'd3', False):
        {'counters': {'nodes_visited': 17676, 'predicates': 143499504,
            'vector_ops': 35130, 'enqueued': 729751, 'pruned_outer': 0,
            'pruned_inner': 0, 'masked_waste': 0}, 'live': [1, 110, 8727],
            'padded': [0, 914, 56809], 'pairs': 720914,
            'pairs_sum': 152458661235},
    ('join', 'd3', True):
        {'counters': {'nodes_visited': 17676, 'predicates': 35200252,
            'vector_ops': 35130, 'enqueued': 729751, 'pruned_outer': 179475,
            'pruned_inner': 15750994, 'masked_waste': 27233867}, 'live': [1,
            110, 8727], 'padded': [0, 914, 56809], 'pairs': 720914,
            'pairs_sum': 152458661235},
}
# phase 31: joins a served D3 run (each ~3 s, most of it the host merge)
D3_SERVE_BATCHES = 2
# phases 32-33: the LM at tinyllama-1.1b's published widths, with the
# traffic of ``serve --mode lm`` (64 prompts of 32 tokens, 16 new tokens)
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "tinyllama-1.1b", 64, 32, 16
# the float32 cell held to the CPU: 2 prompts of 24 tokens, 8 new tokens,
# to the reference's own relative bound (tests/test_models.py)
LM_F32_BATCH, LM_F32_PROMPT, LM_F32_NEW, LM_F32_TOL = 2, 24, 8, 1e-4
# bfloat16: greedy decode's logits against a teacher-forced full forward
# at each new position, relative (max |diff| / max |forward|); measured
# 1.580e-02-2.282e-02 on an H100 80GB HBM3 at 700 W by this script's
# phase 32 (PERF.md § 6), so the bound is about twice the largest
LM_BF16_TOL = 5e-2
# phases 34-37: the MoE, SSM and hybrid families at their published widths
# with phase 32's traffic: (arch, depth, bfloat16 bound, float32 depth).
# The MoE models are cut in depth to the layers given (633 GB and 789 GB
# of bfloat16 weights whole), their teacher-forced forward run 16
# sequences at a time (llama4's dropless one-hot tensors over 64 × 47
# tokens would not fit beside its weights).  The SSM cells' bound is about
# twice the largest error measured on an H100 80GB HBM3 at 700 W by these
# phases (7.484e-02 over falcon-mamba's 64 layers, 6.250e-02 over
# zamba2's 81; PERF.md § 6): bfloat16's rounding over their depth, since
# the same widths and depth in float32 hold decode to the forward within
# LM_F32_TOL (c), and the same widths at tinyllama's 22 layers in
# bfloat16 within LM_BF16_TOL for two seeds (d; 3.381e-02-3.674e-02 there)
LM_SSM_BF16_TOL = 0.15
LM_FAMILY_CELLS = (("falcon-mamba-7b", None, LM_SSM_BF16_TOL, None),
                   ("zamba2-7b", None, LM_SSM_BF16_TOL, None),
                   ("grok-1-314b", 4, LM_BF16_TOL, 3),
                   ("llama4-maverick-400b-a17b", 2, LM_BF16_TOL, 2))
LM_MOE_TF_CHUNK = 16
# (c): float32 at the cell's widths and at the depth whose float32 weights
# fit on the card (the SSM cells whole, grok-1 3 layers in 61 GiB, llama4
# its 2 in 69 GiB), 8 prompts, the forward 2 sequences at a time; a
# quarter of the sequences must stay free of routing flips at every
# position
LM_F32_DEPTH_BATCH, LM_F32_TF_CHUNK = 8, 2
# (d): the SSM cells in bfloat16 at tinyllama-1.1b's depth, two seeds
LM_WITNESS_DEPTH, LM_WITNESS_SEEDS = 22, (SEED, SEED + 3)
# phases 38-41: training.  Phase 38: tinyllama-1.1b at its published
# widths, bfloat16, remat on, at the repo's training sequence length
# (configs/base.py SHAPES "train_4k", 4,096 tokens) with train_4k's global
# batch of 256 sequences cut to 4 (16,384 tokens a step): one card's 80 GB
# and the run's time force it; TRAIN_STEPS steps of ~3.9 s on an H100
# keep the whole run inside its 1,200 s; at 10 the last 5 steps' mean
# loss stood above the first 5's (warmup 5: lr at its peak there); AdamW
# at the reference's defaults but for a warmup of 5 steps
TRAIN_ARCH, TRAIN_SHAPE, TRAIN_BATCH, TRAIN_STEPS = \
    "tinyllama-1.1b", "train_4k", 4, 12
TRAIN_WARMUP = 5
# the H100 SXM's dense bfloat16 peak (data sheet), for phase 38's share
BF16_PEAK_FLOPS = 989e12
# phase 39: the flash backward against a dense float32 softmax attention,
# relative (max |diff| / max |dense|); phase 40: float32, card against
# CPU, each step's loss, each leaf's grad and params, norm-relative: the
# float32 bound of tests/test_torch_train*.  Phase 40's AdamW takes eps
# TRAIN_ADAM_EPS: at the default 1e-8 its first steps turn float32 noise
# in a grad near zero into ±lr of either sign (on an H100 80GB HBM3 at
# 700 W, after 2 steps: zamba2's reduced config 3.1e-4 norm-relative in a
# leaf, grok-1's 1.5e-3 of its elements more than 1e-5 apart, every grad
# within 1.7e-6); a larger eps keeps the update continuous there
FLASH_F32_TOL, TRAIN_F32_TOL, TRAIN_ADAM_EPS = 1e-4, 1e-4, 1e-3
TRAIN_PATTERN_ARCHS = ("tinyllama-1.1b", "h2o-danube-1.8b", "musicgen-large",
                       "paligemma-3b", "grok-1-314b",
                       "llama4-maverick-400b-a17b", "falcon-mamba-7b",
                       "zamba2-7b")
# phase 41: failures injected before these steps of a 12-step run
RESTART_FAIL_AT = (6, 9)
# timing-only repeats, cut to pay for phase 45 (the counts before in the
# comments; ``main`` collects each cut's seconds from the run's own
# per-call times): (a) phase 23's join cells make no warm-up or separate
# counted call (the checks' calls warm them); (b) phase 24 serves 2 joins
# a path (3); (c) the LM phases 32 and 34-37 time the prefill over 3 calls
# (5), profile 5 decode steps (10) and time 5 on the host clock (20)
MESH_SERVE_JOINS = 2
LM_PREFILL_ITERS, LM_PROFILE_ITERS, LM_STEP_ITERS = 3, 5, 5
# phase 45: the port's four examples on the card, the training example cut
# to this many steps (its default 200: the loss falls across the resume
# at 20 on the CPU)
EXAMPLE_TRAIN_STEPS = 60
# phase 42: the dry run's cells (10 archs × 4 shapes on each of the two
# production meshes; the 6 full-attention archs skip long_500k)
DRYRUN_CELLS, DRYRUN_SKIPS = 34, 6
# phase 44(a): the dry-run cells traced over the fake (16, 16) mesh, each
# with the dry run's knobs given (grok-1-314b train_4k without and with
# the MoE knobs: the backward through the cap-sharded dispatch)
MOE_KNOBS = {"cap_shard": True, "moe_group_tokens": 4096}
TRACE_CELLS = (("tinyllama-1.1b", "train_4k", {}),
               ("llama4-maverick-400b-a17b", "decode_32k", {}),
               ("zamba2-7b", "train_4k", {}),
               ("grok-1-314b", "train_4k", {}),
               ("grok-1-314b", "train_4k", MOE_KNOBS))
# operations per lane: MINDIST 13, MINMAXDIST 29 (subtractions, min/max,
# selects, products and FMAs counted one each), for point and rect queries
# alike
MINDIST_OPS, MINMAXDIST_OPS = 13, 29
# D3: dequantizing a box (4 products, 4 adds), the slack correction (max,
# sqrt, 2 adds, 2 products)
D3_DEQUANT_OPS, D3_SLACK_OPS = 8, 6


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


def device_split(fn, *kernels, iters: int = 20):
    """Device ms per call of ``fn``, one entry per kernel of ``kernels``:
    each a tuple of strings that its demangled name holds, every one, and
    optionally an int, its launches per call of ``fn`` (default 1).  An
    entry is the mean over the launches torch.profiler records in ``iters``
    calls (it may miss a few at its start) times the launches per call;
    None when, in two profiled runs, it saw one of them not at all.  A
    kernel shorter than its wrapper's host work cannot be timed with events
    around back-to-back calls: the card would wait for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = [[n for n in k if isinstance(n, str)] for k in kernels]
    per_call = [next((n for n in k if isinstance(n, int)), 1)
                for k in kernels]
    fn()
    torch.cuda.synchronize()
    for _ in range(2):          # a profiled run now and then sees nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = [[e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and all(n in e.name for n in nm)] for nm in names]
        if all(found):
            break
    else:
        return None
    out = []
    for nm, k, times in zip(names, per_call, found):
        check(len(times) <= iters * k, f"{nm}: {len(times)} launches "
              f"profiled for {iters} calls")
        out.append(sum(times) / len(times) / 1e3 * k)
    return out


def device_ms(fn, *kernels, iters: int = 20):
    """``device_split`` summed over the kernels: the device ms per call of
    ``fn``, or None."""
    split = device_split(fn, *kernels, iters=iters)
    return None if split is None else sum(split)


def in_source(cu: str, kernels):
    """The entries of ``kernels`` (``device_split``'s) whose first name
    the CUDA source ``cu`` (relative to the port's ``kernels/csrc``) holds;
    a memset entry (``"Memset"``) is kept where it calls cudaMemsetAsync.
    So one list of entries times any version of a kernel's sources, an
    older design with other kernels included."""
    with open(os.path.join(SRC, "repro_torch", "kernels", "csrc", cu)) as f:
        text = f.read()
    return [k for k in kernels
            if (k[0] == "Memset" and "cudaMemsetAsync" in text)
            or (k[0] != "Memset" and f"{k[0]}(" in text)]


def score_variant(fn, kernel) -> str:
    """Which variant of a kernel with a lane count (the score kernels B5,
    B8, B13, B14, the emit kernels B6, B7, B9, B10 and the D3 mask kernel
    B11) one call of ``fn`` ran, read from the demangled names the profiler
    records for the ``device_split`` entry ``kernel``: "vector" (4 lanes a
    thread), "scalar-lane", or "lane per thread" (an older design that took
    no lane count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a profiled run now and then sees nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and all(n in e.name for n in kernel)}
        if names:
            break
    check(len(names) == 1, f"{kernel}: profiled {sorted(names)}")
    name = names.pop()
    return "vector" if "4>(" in name else "scalar-lane" \
        if "1>(" in name else "lane per thread"


def score_split(torch, ids, row_bytes: int, outs) -> str:
    """Where a score kernel's bytes go (B5, B8, B13, B14 on frontier
    ``ids``, outputs ``outs``): live slots, distinct live nodes, output
    bytes, node-row bytes (``row_bytes`` a node) read once per live slot
    against once per distinct node, and the fill floor: the device time of
    ``torch.empty_like(o).fill_(3.0e38)`` for every output, a PyTorch write
    of the same bytes."""
    live = ids[ids >= 0]
    uniq = int(torch.unique(live).numel())
    out_bytes = sum(o.numel() * o.element_size() for o in outs)
    fill = device_ms(lambda: [torch.empty_like(o).fill_(3.0e38)
                              for o in outs], (len(outs),), iters=50)
    check(fill is not None, "fill floor: the profiler saw no launch")
    return (f"{live.numel()} of {ids.numel()} slots live, {uniq} distinct "
            f"nodes; output {out_bytes} bytes; rows {live.numel() * row_bytes}"
            f" bytes read per live slot, {uniq * row_bytes} per distinct node "
            f"({live.numel() / max(uniq, 1):.2f}x); fill floor {fill:.4f} ms")


def emit_split(torch, ids, f: int, *, leaf: bool, cap: int) -> str:
    """What an emit kernel (B6, B7, B9, B10) walks on frontier ``ids``:
    live slots and lanes a row and, where the source stages the scores in
    shared memory (``rtree_knn_emit_stage_slots``), the staging a block
    gets, its bytes of shared memory, and how many rows fit it whole
    (staged) or are walked in segments (tiled)."""
    from repro_torch.kernels import _build
    b, c = ids.shape
    live = (ids >= 0).sum(dim=1)
    most, mean = int(live.max()), float(live.float().mean())
    text = (f"{int(live.sum())} of {ids.numel()} slots live ({mean:.2f} a "
            f"row, at most {most}); {mean * f:.1f} live lanes a row (at "
            f"most {most * f})")
    if not in_source("rtree_knn.cu", [("rtree_knn_emit_stage_slots",)]):
        return text + "; stages nothing (recomputes every pass)"
    slots = _build.layout("rtree_knn", "rtree_knn_emit_stage_slots", c, f,
                          int(leaf))
    smem = _build.layout("rtree_knn", "rtree_knn_emit_smem", c, f, cap,
                         int(leaf))
    tiled = int((live > slots).sum())
    return (text + f"; staging {slots} slots ({slots * f * (4 if leaf else 8)}"
            f" bytes), {smem} bytes of shared memory a block; {b - tiled} "
            f"rows staged, {tiled} tiled")


def kernel_times(kfn, tfn, kernels, iters: int = 20, twin_iters: int = 5):
    """(device ms per call from the profiler, ms per call with the wrapper
    from CUDA events, the twin's ms) of one kernel wrapper ``kfn`` and its
    twin ``tfn``; the device time falls back to the event time, with a
    note, when the profiler saw no device time."""
    call_ms = cuda_ms(kfn, iters)
    ms = device_ms(kfn, *kernels)
    if ms is None:
        print(f"  {kernels}: the profiler saw no device time; timing calls "
              f"with events", flush=True)
        ms = call_ms
    return ms, call_ms, cuda_ms(tfn, twin_iters)


def profile_batches(fn, iters: int = 3, top: int = 6,
                    warm: bool = True) -> str:
    """Device kernel time by name over ``iters`` calls of ``fn`` with
    torch.profiler, and the device's busy share of the host-clock window;
    ``warm``: one call first (False: the caller has just run it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
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
    short = [n.replace("void ", "").replace("(anonymous namespace)::", "")
             for n, _ in ranked]
    parts = ", ".join(f"{n[:48]} {t / iters / 1e3:.3f}"
                      for n, (_, t) in zip(short, ranked))
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
    b2_kernels = in_source("rtree_select.cu", [
        ("select_fused_kernel", "D1Rows"), ("select_count_kernel", "D1Rows"),
        ("select_scatter_kernel", "D1Rows")])
    for name, src_line, kernel, kfn, tfn, nbytes in (
            ("select_level_masks", "src/repro/kernels/rtree_select.py:64",
             [("select_masks_kernel",)],
             lambda: kern.select_level_masks_cuda(ids, queries, *leaf),
             lambda: ref.select_level_masks_ref(ids, queries, *leaf),
             b1_bytes),
            ("select_level_fused", "src/repro/kernels/rtree_select.py:111",
             b2_kernels,
             lambda: kern.select_level_fused_cuda(ids, queries, *leaf,
                                                  cap=RESULT_CAP),
             lambda: ref.select_level_fused_ref(ids, queries, *leaf,
                                                cap=RESULT_CAP),
             b2_bytes)):
        ms, call_ms, plain_ms = kernel_times(kfn, tfn, kernel)
        bound_ms, bound_by = bound(nbytes, ops_)
        print(f"  {name}: leaf (B={b_}, C={c_}, F={f_}, {live.numel()} live "
              f"slots, {uniq} distinct nodes): kernel {ms:.4f} ms on the "
              f"device ({call_ms:.4f} ms per call with the wrapper), twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes} bytes at 3.35 TB/s)")
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/rtree_select.cu",
                        replaces=src_line, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, max_abs_err=err[name]))
    # B2 on the same leaf frontier with its columns shuffled: the live
    # slots no longer form a prefix of each row
    perm = torch.randperm(c_, generator=gen).to(dev)
    shuf = ids[:, perm].contiguous()
    for tag, fr in (("descent", ids), ("shuffled", shuf)):
        split = device_split(lambda: kern.select_level_fused_cuda(
            fr, queries, *leaf, cap=RESULT_CAP), *b2_kernels)
        check(split is not None, f"B2 {tag}: the profiler saw no launch")
        print(f"  select_level_fused: leaf frontier, {tag} order: kernel "
              f"{sum(split):.4f} ms on the device (" + ", ".join(
                  f"{k[0]} {t:.4f}" for k, t in zip(b2_kernels, split))
              + ")", flush=True)
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
    return launches, (ids, counts)


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
    return launches, out["qps"], out["first_batch"]


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
    # every device item of B4's entry point, its -1 fill included
    b4_kernels = in_source("rtree_join.cu", [
        ("join_count_kernel",), ("join_scan_tiles_kernel",),
        ("join_scan_carry_kernel",), ("join_scatter_kernel",),
        ("Memset", 2)])
    split = device_split(
        lambda: jkern.join_level_fused_cuda(*args, cap=JOIN_CAP), *b4_kernels)
    check(split is not None, "B4: the profiler saw no launch")
    no_fill = sum(t for k, t in zip(b4_kernels, split) if k[0] != "Memset")
    print("  join_level_fused: leaf step, device ms per call by item: " +
          ", ".join(f"{k[0]}{' x2' if 2 in k else ''} {t:.4f}"
                    for k, t in zip(b4_kernels, split)) +
          f"; {sum(split):.4f} in all, {no_fill:.4f} without memsets",
          flush=True)
    out = []
    for name, line, kernels, kfn, tfn, nbytes in (
            ("join_pair_masks", "src/repro/kernels/rtree_join.py:73",
             [("join_masks_kernel",)],
             lambda: jkern.join_pair_masks_cuda(*args[:6]),
             lambda: ref.join_pair_masks_ref(*args[:6]), b3_bytes),
            ("join_level_fused", "src/repro/kernels/rtree_join.py:129",
             b4_kernels,
             lambda: jkern.join_level_fused_cuda(*args, cap=JOIN_CAP),
             lambda: ref.join_level_fused_ref(*args, cap=JOIN_CAP),
             b4_bytes)):
        ms, call_ms, plain_ms = kernel_times(kfn, tfn, kernels,
                                             twin_iters=3)
        bound_ms, bound_by = bound(nbytes, ops_)
        print(f"  {name}: leaf step (P={p}, F={fo}x{fi}, {n_live} live "
              f"pairs, {uo}+{ui} distinct nodes): kernel {ms:.4f} ms on the "
              f"device ({call_ms:.4f} ms per call with the wrapper), twin "
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


def distance_ops(kkern, kjkern, ref):
    """The two distance operators' kernels: per operator, for the score
    (dists), internal-level (level) and leaf stages, the label, the launch
    count's name, the CUDA wrapper, the twin and the TPU kernel replaced,
    and the query functor of the CUDA instantiations."""
    knn = "src/repro/kernels/rtree_knn.py"
    kj = "src/repro/kernels/rtree_knn_join.py"
    return {
        "knn": dict(
            labels=("B5", "B6", "B7"), functor="PointQuery",
            names=("knn_level_dists", "knn_level_fused", "knn_leaf_fused"),
            kernels=(kkern.knn_level_dists_cuda, kkern.knn_level_fused_cuda,
                     kkern.knn_leaf_fused_cuda),
            twins=(ref.knn_level_dists_ref, ref.knn_level_fused_ref,
                   ref.knn_leaf_fused_ref),
            lines=(f"{knn}:105", f"{knn}:454", f"{knn}:467")),
        "knn_join": dict(
            labels=("B8", "B9", "B10"), functor="RectQuery",
            names=("knn_join_level_dists", "knn_join_level_fused",
                   "knn_join_leaf_fused"),
            kernels=(kjkern.knn_join_level_dists_cuda,
                     kjkern.knn_join_level_fused_cuda,
                     kjkern.knn_join_leaf_fused_cuda),
            twins=(ref.knn_join_level_dists_ref, ref.knn_join_level_fused_ref,
                   ref.knn_join_leaf_fused_ref),
            lines=(f"{kj}:87", f"{kj}:224", f"{kj}:237")),
    }


def knn_frontiers(torch, tree, queries, k, caps, level_fused_ref):
    """Each level's (B, C) frontier of a real descent: the twin of the
    fused engine's internal steps (``level_fused_ref``) with ``caps``."""
    dev = tree.device
    b, h = queries.shape[0], tree.height
    ids = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    tau = torch.full((b,), 3.0e38, dtype=torch.float32, device=dev)
    frontiers = {}
    for li in range(h - 1, -1, -1):
        frontiers[li] = ids
        if li:
            lvl = tree.levels[li]
            ids, tau, _, _ = level_fused_ref(
                ids, queries, lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child, tau,
                cap=caps[h - 1 - li], k=k,
                tighten=ids.shape[1] * tree.fanout >= k)
    return frontiers


def distance_kernel_times(torch, tree, queries, descent, op, caps, err):
    """Times of an operator's three distance kernels at the k = KNN_K
    ``descent`` (static ``caps``): the score kernel's leaf variant and the
    leaf kernel at the leaf step, the level kernel at the last internal
    step (the largest it runs).  Each: device time per launch from the
    profiler, time per call with the wrapper's host work from events, the
    twin's time, and the bound.  Returns the kernels' line entries."""
    b, f_ = queries.shape[0], tree.fanout
    qbytes = queries.shape[1] * 4
    rows = {li: (lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child)
            for li, lvl in enumerate(tree.levels)}
    pad = torch.full((b,), 3.0e38, dtype=torch.float32, device=tree.device)
    (kd, kl, kf), (td, tl, tf) = op["kernels"], op["twins"]
    q = op["functor"]
    # "Level, true": both designs' score leaf variant; ", false" / ", true":
    # the emit kernel's kLeaf, with (this design) or without (the older
    # one) a lane count after it
    stages = (
        (0, ("knn_dists_kernel", q, "Level, true"),
         lambda ids: kd(ids, queries, *rows[0], leaf=True),
         lambda ids: td(ids, queries, *rows[0], leaf=True)),
        (1, ("knn_emit_kernel", q, ", false"),
         lambda ids, tighten=True, tau=pad: kl(ids, queries, *rows[1], tau,
                                               cap=caps[-1], k=KNN_K,
                                               tighten=tighten),
         lambda ids: tl(ids, queries, *rows[1], pad, cap=caps[-1], k=KNN_K,
                        tighten=True)),
        (0, ("knn_emit_kernel", q, ", true"),
         lambda ids: kf(ids, queries, *rows[0], k=KNN_K),
         lambda ids: tf(ids, queries, *rows[0], k=KNN_K)))
    out = []
    for i, (li, kernel, kfn, tfn) in enumerate(stages):
        ids = descent[li]
        c_ = ids.shape[1]
        live = ids[ids >= 0]
        uniq = int(torch.unique(live).numel())
        n_lanes = live.numel() * f_
        reads = ids.numel() * 4 + b * qbytes + uniq * 20 * f_
        if i == 0:
            nbytes, ops_ = reads + b * c_ * f_ * 4, n_lanes * MINDIST_OPS
        elif i == 1:
            nbytes = reads + b * caps[-1] * 4 + 12 * b
            ops_ = n_lanes * (MINDIST_OPS + MINMAXDIST_OPS)
        else:
            nbytes = reads + 8 * b * KNN_K + 4 * b
            ops_ = n_lanes * MINDIST_OPS
        ms, call_ms, plain_ms = kernel_times(lambda: kfn(ids),
                                             lambda: tfn(ids), [kernel],
                                             iters=50)
        bound_ms, bound_by = bound(nbytes, ops_)
        name = op["names"][i]
        variant = f", {score_variant(lambda: kfn(ids), kernel)} variant"
        print(f"  {op['labels'][i]} {name}: k={KNN_K} level {li} (B={b}, "
              f"C={c_}, F={f_}, {live.numel()} live slots, {uniq} distinct "
              f"nodes): kernel {ms:.4f} ms on the device{variant} "
              f"({call_ms:.4f} ms per call with the wrapper), twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} bytes "
              f"at 3.35 TB/s, {ops_} ops at 67 TFLOP/s)", flush=True)
        if i == 0:
            print("    " + score_split(torch, ids, 20 * f_, [
                o for o in kfn(ids) if o is not None]), flush=True)
        else:
            cap = caps[-1] if i == 1 else KNN_K
            split = emit_split(torch, ids, f_, leaf=i == 2, cap=cap)
            if i == 1:
                # off: tau_in is the tau that tightening found, so the
                # same lanes are kept and only tau's select is left out
                tau = kfn(ids)[1]
                off = device_ms(lambda: kfn(ids, tighten=False, tau=tau),
                                kernel, iters=50)
                check(off is not None, "tighten off: no launch profiled")
                split += (f"; tighten on {ms:.4f} ms, off {off:.4f} ms "
                          f"(tau's select {ms - off:.4f} ms)")
            print("    " + split, flush=True)
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/rtree_knn.cu",
                        replaces=op["lines"][i], ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, max_abs_err=err[name]))
    return out


def phase_distance_kernels(torch, tree, queries, op, knn_vector, seed):
    """Phases 9 and 12: an operator's score (B5 / B8, both variants), level
    (B6 / B9, tightening on and off, random τ_in) and leaf (B7 / B10)
    kernels ≡ their twins, bit for bit, on every level of a real descent
    for k in {1, 8, 64}, plus a level-kernel cap that overflows; times at
    the k = 8 descent.  Returns (the kernels' line entries, the static
    caps at k = 8)."""
    dev = tree.device
    b, h, f_ = queries.shape[0], tree.height, tree.fanout
    rng = np.random.default_rng(seed)
    rows = {li: (lvl.lx, lvl.ly, lvl.hx, lvl.hy, lvl.child)
            for li, lvl in enumerate(tree.levels)}
    (kd, kl, kf), (td, tl, tf) = op["kernels"], op["twins"]
    ld, ll, lf = op["labels"]
    err = dict.fromkeys(op["names"], 0)

    def hold(i, got, want, what):
        name = op["names"][i]
        for j, (g, w) in enumerate(zip(got, want)):
            if g is None or w is None:
                check(g is None and w is None, f"{what} [{j}]: None")
                continue
            err[name] = max(err[name], assert_bits_equal(g, w,
                                                         f"{what} [{j}]"))

    descents = {}
    for k in (1, 8, 64):
        caps = knn_vector.knn_frontier_caps(tree, k)
        descents[k] = knn_frontiers(torch, tree, queries, k, caps, tl)
        for li, ids in descents[k].items():
            perm = torch.from_numpy(rng.permutation(ids.shape[1])).to(dev)
            ids = ids[:, perm].contiguous()
            drop = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.1)
            ids = torch.where(drop.to(dev), -1, ids)
            tau = torch.from_numpy((rng.random(b) * 1e-4).astype(
                np.float32)).to(dev)
            cap = caps[h - 1 - li] if li else caps[-1]
            for leaf in (False, True):
                hold(0, kd(ids, queries, *rows[li], leaf=leaf),
                     td(ids, queries, *rows[li], leaf=leaf),
                     f"{ld} k={k} level {li} leaf={leaf}")
            gates = (False, True) if ids.shape[1] * f_ >= k else (False,)
            for tighten in gates:
                kw = dict(cap=cap, k=k, tighten=tighten)
                hold(1, kl(ids, queries, *rows[li], tau, **kw),
                     tl(ids, queries, *rows[li], tau, **kw),
                     f"{ll} k={k} level {li} tighten={tighten}")
            hold(2, kf(ids, queries, *rows[li], k=k),
                 tf(ids, queries, *rows[li], k=k), f"{lf} k={k} level {li}")
            print(f"  k={k} level {li}: frontier {tuple(ids.shape)}, "
                  f"{int((ids >= 0).sum())} live slots, cap {cap} — {ld}, "
                  f"{ll} (tighten {gates}), {lf} bit-exact", flush=True)
    # overflow: every valid leaf lane kept (no τ) into a cap of 16
    ids = descents[64][0]
    pad = torch.full((b,), 3.0e38, dtype=torch.float32, device=dev)
    kw = dict(cap=16, k=64, tighten=False)
    got = kl(ids, queries, *rows[0], pad, **kw)
    hold(1, got, tl(ids, queries, *rows[0], pad, **kw), f"{ll} overflow")
    check(bool((got[3] > 16).all()), f"the cap-16 {ll} case did not "
          f"overflow")
    print(f"  overflow case: cap 16, kept up to {int(got[3].max())} — {ll} "
          f"bit-exact", flush=True)
    caps8 = knn_vector.knn_frontier_caps(tree, KNN_K)
    return distance_kernel_times(torch, tree, queries, descents[KNN_K], op,
                                 caps8, err), caps8


def check_knn_brute_force(torch, dev, rects, queries, ids, d, what) -> None:
    """Fail unless each query's sorted distances equal a float64 brute
    force over all ``rects`` (computed on ``dev``) to rtol 1e-4, and its
    ids are distinct and sit at their reported distances.  A query is a
    point (px, py) or a rect (lx, ly, hx, hy); a point is the rect of zero
    extent."""
    r = torch.from_numpy(np.ascontiguousarray(rects)).to(dev).double()
    for i, q in enumerate(queries):
        q = [float(v) for v in q]
        lx, ly, hx, hy = q * 2 if len(q) == 2 else q
        dx = torch.clamp(torch.maximum(lx - r[:, 2], r[:, 0] - hx), min=0)
        dy = torch.clamp(torch.maximum(ly - r[:, 3], r[:, 1] - hy), min=0)
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


def phase_distance_engine(torch, tree, rects, queries, kern, build, refs,
                          names, what, escalate_k1=False):
    """Phases 10 and 13: an operator's engine (``build``: make_knn_bfs or
    make_knn_join_bfs) in six cells — k = 8 static/adaptive ×
    unfused/fused, k = 64 static unfused/fused — ≡ the twin engine on the
    card (ids, distance bits, every counter) and the reference's numbers
    ``refs`` for this batch, with no overflow and no escalation; the
    kernels ``names`` (score, level, leaf) launched; optionally k = 1
    adaptive escalates once; 8 queries ≡ a float64 brute force on the card;
    ms per batch and the device's share.  Returns the launch counts and
    the static unfused cells' (ids, dists) by k."""
    kern.reset_launch_counts()
    cells = {}
    for k, caps_mode, fused in ((8, "static", False), (8, "static", True),
                                (8, "adaptive", False),
                                (8, "adaptive", True), (64, "static", False),
                                (64, "static", True)):
        cell = f"k={k} {caps_mode}/{'fused' if fused else 'unfused'}"
        kw = dict(caps_mode=caps_mode, fused=fused)
        fn = build(tree, k, **kw)
        twin = build(tree, k, backend="torch", **kw)
        before = kern.launch_counts()
        ids, d, ctr = fn(queries)
        torch.cuda.synchronize()
        after = kern.launch_counts()
        for name in (names[1:] if fused else names[:1]):
            check(after[name] > before[name], f"{cell}: {name} not launched")
        tids, td, tctr = twin(queries)
        assert_bits_equal(ids, tids, f"{what} engine {cell} ids")
        assert_bits_equal(d, td, f"{what} engine {cell} dists")
        got, want = ctr.asdict(), tctr.asdict()
        check(got == want, f"{what} engine {cell} counters: {got} vs "
              f"{want}")
        ref_ = refs[k]
        for key, v in ref_["counters"].items():
            check(got[key] == v, f"{what} engine {cell}: {key} {got[key]}, "
                  f"the reference has {v}")
        check(got["lanes_live"][:4] == ref_["live"] and
              got["lanes_padded"][:4] == ref_["padded"][caps_mode],
              f"{what} engine {cell}: occupancy {got['lanes_live']} "
              f"{got['lanes_padded']}")
        check(got["overflow"] == 0 and got["escalations"] == 0,
              f"{what} engine {cell}: overflow {got['overflow']}, "
              f"escalations {got['escalations']}")
        ids_np, d_np = ids.cpu().numpy(), d.cpu().numpy()
        check(int(ids_np.astype(np.int64).sum()) == ref_["ids_sum"] and
              float(d_np.astype(np.float64).sum()) == ref_["d_sum"],
              f"{what} engine {cell}: ids sum "
              f"{ids_np.astype(np.int64).sum()}, distance sum "
              f"{d_np.astype(np.float64).sum()!r}")
        cells[cell] = (fn, twin, ids_np, d_np)
    launches = kern.launch_counts()
    print(f"  six cells ≡ twin engine (ids, distance bits, counters) and the "
          f"reference (counters, occupancy, ids and distance sums); "
          f"launches {launches}", flush=True)
    if escalate_k1:
        for fused in (False, True):
            fn = build(tree, 1, caps_mode="adaptive", fused=fused)
            twin = build(tree, 1, caps_mode="adaptive", fused=fused,
                         backend="torch")
            ids, d, ctr = fn(queries)
            tids, td, tctr = twin(queries)
            assert_bits_equal(ids, tids, f"k=1 fused={fused} ids")
            assert_bits_equal(d, td, f"k=1 fused={fused} dists")
            check(ctr.asdict() == tctr.asdict(),
                  f"k=1 fused={fused} counters")
            check(fn.escalation_count() == 1 and int(ctr.escalations) == 1,
                  f"k=1 adaptive fused={fused}: {fn.escalation_count()} "
                  f"escalations, expected 1")
        print("  k=1 adaptive (unfused, fused): escalates once, ≡ twin "
              "engine", flush=True)
    _, _, ids_np, d_np = cells["k=8 static/unfused"]
    check_knn_brute_force(torch, tree.device, rects,
                          queries.cpu().numpy()[:8], ids_np[:8], d_np[:8],
                          f"{what} engine")
    print("  8 queries ≡ brute force over all rects", flush=True)
    for cell, (fn, twin, _, _) in cells.items():
        print(f"  {cell}: {host_ms(lambda: fn(queries), 10):.3f} ms per "
              f"{queries.shape[0]}-query batch (twin engine "
              f"{host_ms(lambda: twin(queries), 3):.3f} ms)", flush=True)
        print(f"    {profile_batches(lambda: fn(queries))}", flush=True)
    return launches, {k: cells[f"k={k} static/unfused"][2:] for k in (8, 64)}


def phase_knn_join_all_pairs(torch, tree, rects, probes, kjkern,
                             knn_join_vector, rtree):
    """Phase 14: ``knn_join(probe_tree, tree, k=8)``, the 200,000 probe
    rects in chunks of 4,096 against the 2M tree, unfused and fused: the
    two runs equal, the first two chunks ≡ the twin engine, 256 sampled
    rows ≡ brute force; s per join, rows/s, peak device memory, and the
    device's busy share and largest items over one more join.  Returns
    {fused: (s, rows/s, peak bytes)}."""
    dev = tree.device
    batch = ALL_PAIRS_BATCH
    probe_tree = rtree.build_rtree(probes, fanout=FANOUT, device=dev)
    runs, out = {}, {}
    for fused in (False, True):
        kjkern.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ids, d, ctr = knn_join_vector.knn_join(probe_tree, tree, KNN_K,
                                               fused=fused, batch=batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        c = ctr.asdict()
        check(c["overflow"] == 0, f"all-pairs fused={fused} overflowed")
        launches = kjkern.launch_counts()
        grown = ("knn_join_level_fused", "knn_join_leaf_fused") if fused \
            else ("knn_join_level_dists",)
        check(all(launches[n] > 0 for n in grown),
              f"all-pairs fused={fused}: launches {launches}")
        runs[fused] = (ids, d)
        out[fused] = (secs, len(probes) / secs, peak)
        print(f"  fused={fused}: {secs:.3f} s per join of {len(probes)} "
              f"rects ({-(-len(probes) // batch)} chunks of {batch}), "
              f"{len(probes) / secs:,.0f} rows/s, peak device memory "
              f"{peak / 2**30:.2f} GiB, {c['escalations']} escalations; "
              f"launches {launches}; counters {c}", flush=True)
        print("    per join: " + profile_batches(
            lambda: knn_join_vector.knn_join(probe_tree, tree, KNN_K,
                                             fused=fused, batch=batch),
            iters=1), flush=True)
    check(np.array_equal(runs[False][0], runs[True][0]) and
          np.array_equal(runs[False][1], runs[True][1]),
          "all-pairs: fused and unfused differ")
    ids, d = runs[True]
    twin = knn_join_vector.make_knn_join_bfs(tree, KNN_K, backend="torch")
    for lo in (0, batch):
        tid, td, _ = twin(probe_tree.rects[lo:lo + batch])
        check(np.array_equal(tid.cpu().numpy(), ids[lo:lo + batch]) and
              np.array_equal(td.cpu().numpy().astype(np.float64),
                             d[lo:lo + batch]),
              f"all-pairs chunk at {lo} differs from the twin engine")
    rng = np.random.default_rng(SEED + 17)
    rows = np.sort(rng.choice(len(probes), 256, replace=False))
    check_knn_brute_force(torch, dev, rects, probes[rows], ids[rows],
                          d[rows], "all-pairs")
    print(f"  fused ≡ unfused; the first two chunks ≡ twin engine; 256 "
          f"sampled rows ≡ brute force over all {len(rects)} rects; "
          f"{int((d == 0).sum())} of {d.size} distances are 0", flush=True)
    return out


def phase_distance_serve(torch, dev, kern, serve, mode, score_name, argv,
                         queries):
    """Phases 11 and 15: a served distance mode through the CLI entry
    point (k = 8); its score kernel's launch count must grow, nothing may
    overflow, the first batch ≡ a float64 brute force on the card over all
    rects.  Returns (launches, q/s, the first batch's (ids, dists))."""
    kern.reset_launch_counts()
    out = serve.main(["--mode", mode, "--n", str(N_RECTS), "--k",
                      str(KNN_K), "--batches", str(KNN_BATCHES),
                      "--batch-size", str(BATCH), *argv])
    launches = kern.launch_counts()
    print(f"  serve launches {launches}")
    check(launches[score_name] > 0, f"{mode} serve did not launch "
          f"{score_name}")
    check(not out["overflow"], f"the served {mode} overflowed")
    rects, qs = queries
    ids, d = out["first_batch"]
    check(ids.shape == (BATCH, KNN_K) and bool((ids >= 0).all()),
          f"served {mode} ids {ids.shape}, {int((ids < 0).sum())} missing")
    check_knn_brute_force(torch, dev, rects, qs[0], ids, d, f"{mode} serve")
    print(f"  first served batch ≡ brute force over all {N_RECTS} rects "
          f"({BATCH} queries)", flush=True)
    return launches, out["qps"], out["first_batch"]


# ---------------------------------------------------------------------------
# the D3 layout (phases 16-19)
# ---------------------------------------------------------------------------

def same_bytes(a, b) -> bool:
    """Byte equality of two tensors of one dtype (uint16 included, which
    PyTorch cannot compare on the CPU)."""
    return (a.dtype == b.dtype and a.shape == b.shape and
            a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes())


def phase_d3_build(torch, tree, layouts, rtree):
    """Phase 16: quantize the phase-3 tree on the card (timed), bytes per
    node beside D1's, and every level ≡ the quantization of its CPU copy.
    Returns the D3 levels."""
    times = []
    for _ in range(2):                      # the first call includes set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layers = layouts.tree_layout(tree, "d3")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    f = tree.fanout
    d1_bytes, d3_bytes = 16 * f + 4 * f, 4 * f + 24 + 4 * f
    print(f"  quantized {[l.qlo.shape[0] for l in layers]} nodes on the card "
          f"in {times[0]:.3f} ms (again: {times[1]:.3f} ms); bytes per node "
          f"(F={f}): D3 {d3_bytes} (MBR {4 * f + 24} + ptr {4 * f}) vs D1 "
          f"{d1_bytes} (MBR {16 * f} + ptr {4 * f}), MBR "
          f"{16 * f / (4 * f + 24):.3f}x smaller", flush=True)
    for li, lvl in enumerate(tree.levels):
        cpu = layouts.level_to_d3(rtree.RTreeLevel(**{
            k: getattr(lvl, k).cpu() for k in rtree.LEVEL_FIELDS}))
        for k in layouts.D3_FIELDS:
            check(same_bytes(getattr(layers[li], k), getattr(cpu, k)),
                  f"D3 level {li} {k}: the card's quantization differs from "
                  f"the CPU's")
    print("  every level's codes, scale, bias, slack, ptr ≡ the CPU "
          "quantization (bytes)", flush=True)
    return layers


def d3_rows(lvl3, dist: bool):
    names = ("qlo", "qhi", "scale", "bias") + (("slack",) if dist else ()) \
        + ("ptr",)
    return tuple(getattr(lvl3, n) for n in names)


def d3_frontiers(torch, layers, queries, caps, step):
    """Each internal level's (B, C) frontier of a real D3 descent: ``step``
    (level, ids, state) → (next ids, state) from the root down."""
    h = len(layers)
    ids = torch.zeros((queries.shape[0], 1), dtype=torch.int32,
                      device=queries.device)
    state = torch.full((queries.shape[0],), 3.0e38, dtype=torch.float32,
                       device=queries.device)
    out = {}
    for li in range(h - 1, 0, -1):
        out[li] = ids
        ids, state = step(li, ids, state, caps[h - 1 - li])
    return out


def d3_descents(torch, layers, queries, points, qrects, caps_sel, caps_knn,
                ref, traversal):
    """Frontiers of a real D3 select descent (the B12 twin) and of real D3
    kNN and kNN-join descents at k = KNN_K (the B13 / B14 twins and the
    engine's emission)."""
    f = layers[0].qlo.shape[1]

    def sel(li, ids, st, cap):
        nxt, _, _ = ref.select_level_fused_d3_ref(
            ids, queries, *d3_rows(layers[li], False), cap=cap)
        return nxt, st

    def dist(twin, q):
        def step(li, ids, tau, cap):
            md, mmd = twin(ids, q, *d3_rows(layers[li], True))
            ptr = layers[li].ptr[ids.clamp(min=0).long()]
            nxt, tau, _, _ = traversal.distance_level_emit(
                md, mmd, ptr, tau, cap=cap, k=KNN_K,
                tighten=ids.shape[1] * f >= KNN_K)
            return nxt, tau
        return step

    return (d3_frontiers(torch, layers, queries, caps_sel, sel),
            d3_frontiers(torch, layers, points, caps_knn,
                         dist(ref.knn_level_dists_d3_ref, points)),
            d3_frontiers(torch, layers, qrects, caps_knn,
                         dist(ref.knn_join_level_dists_d3_ref, qrects)))


def phase_d3_kernels(torch, tree, layers, queries, points, qrects, big,
                     caps_sel, caps_knn, kern, kkern, kjkern, ref, traversal):
    """Phase 17: B11-B14 ≡ their twins on every internal level of real D3
    descents (shuffled, 10% of slots -1), a B12 overflow; times at level 1
    at batch 64 and at batch ``big`` (rects; their lower corners as kNN
    points).  Returns the kernels' line entries (batch 64)."""
    dev = tree.device
    f_ = tree.fanout
    rng = np.random.default_rng(SEED + 23)
    sel_src = "src/repro/kernels/rtree_select.py"
    specs = (      # name, label, wrapper, twin, dist rows?, descent index
        ("select_level_masks_d3", "B11", kern.select_level_masks_d3_cuda,
         ref.select_level_masks_d3_ref, False, 0, f"{sel_src}:213",
         # both designs: select_masks_d3_kernel and the older
         # select_masks_kernel<D3Rows>
         [("select_masks", "D3Rows")], "rtree_select.cu"),
        ("select_level_fused_d3", "B12", kern.select_level_fused_d3_cuda,
         ref.select_level_fused_d3_ref, False, 0, f"{sel_src}:256",
         in_source("rtree_select.cu", [
             ("select_fused_kernel", "D3Rows"),
             ("select_count_kernel", "D3Rows"),
             ("select_scatter_kernel", "D3Rows")]), "rtree_select.cu"),
        ("knn_level_dists_d3", "B13", kkern.knn_level_dists_d3_cuda,
         ref.knn_level_dists_d3_ref, True, 1,
         "src/repro/kernels/rtree_knn.py:190",
         [("knn_dists_kernel", "PointQuery", "LevelD3")], "rtree_knn.cu"),
        ("knn_join_level_dists_d3", "B14",
         kjkern.knn_join_level_dists_d3_cuda,
         ref.knn_join_level_dists_d3_ref, True, 2,
         "src/repro/kernels/rtree_knn_join.py:168",
         [("knn_dists_kernel", "RectQuery", "LevelD3")], "rtree_knn.cu"))
    h = len(layers)
    err = {sp[0]: 0 for sp in specs}

    def call(sp, fn, ids, q, li, cap):
        kw = dict(cap=cap) if sp[0] == "select_level_fused_d3" else {}
        return fn(ids, q, *d3_rows(layers[li], sp[4]), **kw)

    def hold(sp, got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for j, (g, w) in enumerate(zip(got, want)):
            err[sp[0]] = max(err[sp[0]],
                             assert_bits_equal(g, w, f"{what} [{j}]"))

    qsets = (queries, points, qrects)
    descents = d3_descents(torch, layers, queries, points, qrects, caps_sel,
                           caps_knn, ref, traversal)
    for li in range(h - 1, 0, -1):
        for sp in specs:
            q = qsets[sp[5]]
            ids = descents[sp[5]][li]
            perm = torch.from_numpy(rng.permutation(ids.shape[1])).to(dev)
            ids = ids[:, perm].contiguous()
            drop = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.1)
            ids = torch.where(drop.to(dev), -1, ids)
            cap = (caps_sel[h - 1 - li] if sp[5] == 0 else None)
            hold(sp, call(sp, sp[2], ids, q, li, cap),
                 call(sp, sp[3], ids, q, li, cap), f"{sp[1]} level {li}")
        print(f"  level {li}: frontiers "
              f"{[tuple(d[li].shape) for d in descents]} (select, kNN, "
              f"kNN-join) — B11, B12, B13, B14 exact", flush=True)
    # overflow: wide queries over random level-1 frontiers at cap 64
    n1 = layers[1].qlo.shape[0]
    b = queries.shape[0]
    wide = torch.from_numpy(np.concatenate(
        [rng.random((b, 2), dtype=np.float32) * 0.7] * 2, axis=1)).to(dev)
    wide[:, 2:] += 0.3
    ids = torch.from_numpy(rng.integers(0, n1, (b, 256)).astype(
        np.int32)).to(dev)
    ids = torch.where(torch.from_numpy(rng.random((b, 256)) < 0.1).to(dev),
                      -1, ids)
    got = call(specs[1], specs[1][2], ids, wide, 1, 64)
    hold(specs[1], got, call(specs[1], specs[1][3], ids, wide, 1, 64),
         "B12 overflow")
    check(bool(got[2].any()), "the cap-64 B12 case did not overflow")
    print(f"  overflow case: cap 64, counts up to {int(got[1].max())} — B12 "
          f"exact", flush=True)

    # times at level 1, the widest D3 step: batch 64, then batch ``big``
    big_pts = big[:, :2].contiguous()
    big_desc = d3_descents(torch, layers, big, big_pts, big, caps_sel,
                           caps_knn, ref, traversal)
    out = []
    for tag, qs, desc in (("batch 64", qsets, descents),
                          (f"batch {big.shape[0]}", (big, big_pts, big),
                           big_desc)):
        for sp in specs:
            q, ids = qs[sp[5]], desc[sp[5]][1]
            b_, c_ = ids.shape
            live = ids[ids >= 0]
            uniq = int(torch.unique(live).numel())
            n_lanes = live.numel() * f_
            qb = q.shape[1] * 4
            if sp[4]:
                nbytes = 4 * b_ * c_ + qb * b_ + (8 * f_ + 24) * uniq + \
                    8 * b_ * c_ * f_
                ops_ = n_lanes * (MINDIST_OPS + MINMAXDIST_OPS +
                                  D3_DEQUANT_OPS + D3_SLACK_OPS)
            else:
                nbytes = 4 * b_ * c_ + qb * b_ + (8 * f_ + 16) * uniq
                nbytes += 4 * b_ * c_ * f_ if sp[1] == "B11" else \
                    4 * b_ * caps_sel[h - 2] + 4 * b_
                ops_ = n_lanes * (6 + D3_DEQUANT_OPS)
            cap = caps_sel[h - 2]

            def kfn():
                return call(sp, sp[2], ids, q, 1, cap)

            ms, call_ms, plain_ms = kernel_times(
                kfn, lambda: call(sp, sp[3], ids, q, 1, cap), sp[7],
                iters=50)
            bound_ms, bound_by = bound(nbytes, ops_)
            variant = f", {score_variant(kfn, sp[7][0])} variant" \
                if sp[1] != "B12" else ""
            print(f"  {sp[1]} {sp[0]}: {tag}, level 1 (B={b_}, C={c_}, "
                  f"F={f_}, {live.numel()} live slots, {uniq} distinct "
                  f"nodes): kernel {ms:.4f} ms on the device{variant} "
                  f"({call_ms:.4f} ms per call with the wrapper), twin "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} "
                  f"bytes at 3.35 TB/s, {ops_} ops at 67 TFLOP/s)",
                  flush=True)
            if sp[4]:
                print("    " + score_split(torch, ids, 8 * f_ + 24,
                                           list(kfn())), flush=True)
            if sp[1] == "B11":
                mask = kfn()
                fill = device_ms(lambda: torch.empty_like(mask).zero_(),
                                 (1,), iters=50)
                check(fill is not None, "B11 fill floor: no launch profiled")
                print(f"    fill floor {fill:.4f} ms (PyTorch's zero_ of the "
                      f"{mask.numel() * 4} mask bytes); "
                      f"{live.numel() / max(uniq, 1):.2f} live slots a "
                      f"distinct node", flush=True)
            if len(sp[7]) > 1:
                split = device_split(kfn, *sp[7], iters=50)
                check(split is not None, f"{sp[1]}: no launch profiled")
                print(f"    by kernel: " + ", ".join(
                    f"{k[0]} {t:.4f}" for k, t in zip(sp[7], split)),
                    flush=True)
            if tag == "batch 64":
                out.append(dict(
                    name=sp[0], route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{sp[8]}",
                    replaces=sp[6], ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    max_abs_err=err[sp[0]]))
    return out


def phase_d3_engines(torch, tree, queries, points, qrects, d1, kern, kkern,
                     kjkern, select_vector, knn_vector, knn_join_vector):
    """Phase 18: the D3 engines ≡ the twin engine on the card and the
    reference's D3 numbers; their results ≡ the D1 results ``d1`` of
    phases 4, 10 and 13; B11-B14 launches grow in their cells; ms per
    batch and busy share.  Returns {kernel name: launches}."""
    for m in (kern, kkern, kjkern):
        m.reset_launch_counts()
    cells = []
    for caps_mode in ("static", "adaptive"):
        for fused in (False, True):
            cells.append(("select", f"{caps_mode}/"
                          f"{'fused' if fused else 'unfused'}", caps_mode,
                          dict(result_cap=RESULT_CAP, fused=fused), kern,
                          "select_level_fused_d3" if fused
                          else "select_level_masks_d3"))
    for op, mod, name in (("knn", kkern, "knn_level_dists_d3"),
                          ("knn_join", kjkern, "knn_join_level_dists_d3")):
        for k in (8, 64):
            for caps_mode in ("static", "adaptive"):
                cells.append((op, f"k={k} {caps_mode}", caps_mode,
                              dict(k=k), mod, name))
    build = {"select": lambda t, **kw: select_vector.make_select_bfs(t, **kw),
             "knn": lambda t, k, **kw: knn_vector.make_knn_bfs(t, k, **kw),
             "knn_join": lambda t, k, **kw:
             knn_join_vector.make_knn_join_bfs(t, k, **kw)}
    qs = {"select": queries, "knn": points, "knn_join": qrects}
    refs = {"select": SELECT_D3_REF, "knn": KNN_D3_REF,
            "knn_join": KNN_JOIN_D3_REF}
    timed = []
    for op, cell, caps_mode, kw, mod, name in cells:
        what = f"D3 {op} engine {cell}"
        kw = dict(kw, layout="d3", caps_mode=caps_mode)
        if "k" in kw:
            k = kw.pop("k")
            fn = build[op](tree, k, **kw)
            twin = build[op](tree, k, backend="torch", **kw)
            ref_ = refs[op][k]
        else:
            fn = build[op](tree, **kw)
            twin = build[op](tree, backend="torch", **kw)
            ref_ = refs[op]
        q = qs[op]
        before = mod.launch_counts()[name]
        a, b, ctr = fn(q)
        torch.cuda.synchronize()
        check(mod.launch_counts()[name] > before, f"{what}: {name} not "
              f"launched")
        ta, tb, tctr = twin(q)
        assert_bits_equal(a, ta, f"{what} ids")
        assert_bits_equal(b, tb, f"{what} counts/dists")
        got, want = ctr.asdict(), tctr.asdict()
        check(got == want, f"{what} counters: {got} vs {want}")
        for key, v in ref_["counters"].items():
            check(got[key] == v, f"{what}: {key} {got[key]}, the reference "
                  f"has {v}")
        check(got["lanes_live"][:4] == ref_["live"] and
              got["lanes_padded"][:4] == ref_["padded"][caps_mode],
              f"{what}: occupancy {got['lanes_live']} {got['lanes_padded']}")
        check(got["overflow"] == 0 and got["escalations"] == 0,
              f"{what}: overflow {got['overflow']}, escalations "
              f"{got['escalations']}")
        a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
        if op == "select":
            check(int(a_np[a_np >= 0].astype(np.int64).sum()) ==
                  ref_["ids_sum"] and int(b_np.sum()) == ref_["counts_sum"],
                  f"{what}: ids/counts sums")
            d1a, d1b = d1["select"]
            assert_equal(a, d1a, f"{what} ids vs D1")
            assert_equal(b, d1b, f"{what} counts vs D1")
        else:
            check(int(a_np.astype(np.int64).sum()) == ref_["ids_sum"] and
                  float(b_np.astype(np.float64).sum()) == ref_["d_sum"],
                  f"{what}: ids sum {a_np.astype(np.int64).sum()}, distance "
                  f"sum {b_np.astype(np.float64).sum()!r}")
            d1a, d1b = d1[op][k]
            check(np.array_equal(a_np, d1a) and
                  np.array_equal(b_np.view(np.int32), d1b.view(np.int32)),
                  f"{what}: results differ from the D1 engine's")
        timed.append((what, fn, twin, q))
    launches = {}
    for m in (kern, kkern, kjkern):
        launches.update(m.launch_counts())
    print(f"  {len(cells)} cells ≡ twin engine (ids, counts or distance "
          f"bits, counters), the reference's D3 numbers and the D1 results; "
          f"launches {launches}", flush=True)
    for what, fn, twin, q in timed:
        print(f"  {what}: {host_ms(lambda: fn(q), 10):.3f} ms per "
              f"{q.shape[0]}-query batch (twin engine "
              f"{host_ms(lambda: twin(q), 2):.3f} ms)", flush=True)
        print(f"    {profile_batches(lambda: fn(q))}", flush=True)
    return launches


def phase_d3_serve(kern, kkern, kjkern, serve, d1_first):
    """Phase 19: the three D3 serve modes through the CLI entry point; the
    D3 score kernels launched, no overflow, the first batch ≡ the D1
    path's (``d1_first`` by mode).  Returns ({kernel name: launches}, {mode:
    q/s})."""
    launches, qps = {}, {}
    for mode, mod, name, argv in (
            ("spatial", kern, "select_level_masks_d3",
             ["--partitions", "8", "--fanout", str(FANOUT), "--batches",
              "20"]),
            ("knn", kkern, "knn_level_dists_d3",
             ["--k", str(KNN_K), "--batches", str(KNN_BATCHES)]),
            ("knn-join", kjkern, "knn_join_level_dists_d3",
             ["--k", str(KNN_K), "--batches", str(KNN_BATCHES),
              "--query-eps", str(QUERY_EPS)])):
        mod.reset_launch_counts()
        out = serve.main(["--mode", mode, "--n", str(N_RECTS),
                          "--batch-size", str(BATCH), "--layout", "d3",
                          *argv])
        got = mod.launch_counts()
        launches.update(got)
        check(got[name] > 0, f"D3 {mode} serve did not launch {name}")
        check(not out["overflow"], f"the served D3 {mode} overflowed")
        first = out["first_batch"]
        if mode == "spatial":
            check(len(first) == len(d1_first[mode]) and all(
                np.array_equal(a, b) for a, b in zip(first, d1_first[mode])),
                "D3 spatial serve: the first batch differs from D1's")
        else:
            check(all(np.array_equal(a, b)
                      for a, b in zip(first, d1_first[mode])),
                  f"D3 {mode} serve: the first batch differs from D1's")
        qps[mode] = out["qps"]
        print(f"  {mode}: {name} launched {got[name]} times; first batch ≡ "
              f"the D1 path's; {out['qps']:,.1f} q/s", flush=True)
    return launches, qps


# ---------------------------------------------------------------------------
# filtered kNN and browse (phases 20-22)
# ---------------------------------------------------------------------------

def filtered_brute_force(torch, dev, rects, qs, k):
    """Float64 brute force on ``dev``: each row's k nearest rects among
    those intersecting its window → (ids (B, k), distances (B, k)) numpy,
    (-1, inf) padded, ties by id."""
    r = torch.from_numpy(np.ascontiguousarray(rects)).to(dev).double()
    ids, ds = [], []
    for q in qs:
        px, py, wlx, wly, whx, why = (float(v) for v in q)
        dx = torch.clamp(torch.maximum(r[:, 0] - px, px - r[:, 2]), min=0)
        dy = torch.clamp(torch.maximum(r[:, 1] - py, py - r[:, 3]), min=0)
        hit = (wlx <= r[:, 2]) & (whx >= r[:, 0]) & (wly <= r[:, 3]) & \
            (why >= r[:, 1])
        full = torch.where(hit, dx * dx + dy * dy, float("inf"))
        d, i = torch.sort(full, stable=True)
        d, i = d[:k].cpu().numpy(), i[:k].cpu().numpy()
        ids.append(np.where(np.isfinite(d), i, -1))
        ds.append(d)
    return np.stack(ids), np.stack(ds)


def check_filtered_brute_force(torch, dev, rects, qs, ids, d, what) -> None:
    """Fail unless each row's distances equal the float64 brute force to
    rtol 1e-4, its ids are distinct, lie in its window and sit at their
    reported distances, and missing rows match (-1, +inf)."""
    want_i, want_d = filtered_brute_force(torch, dev, rects, qs,
                                          ids.shape[1])
    ok = np.array_equal(ids < 0, want_i < 0)
    found = want_i >= 0
    ok &= np.allclose(d[found], want_d[found], rtol=1e-4, atol=1e-9)
    ok &= bool(np.isinf(d[~found]).all())
    for row, q in zip(ids, qs):
        got = row[row >= 0]
        r = rects[got]
        ok &= len(set(got.tolist())) == len(got)
        ok &= bool(((q[2] <= r[:, 2]) & (q[4] >= r[:, 0]) &
                    (q[3] <= r[:, 3]) & (q[5] >= r[:, 1])).all())
    check(ok, f"{what}: differs from the windowed brute force")


def check_ref_cell(got, ids, d, ref_, caps_mode, what) -> None:
    """A result's counters, occupancy and id / distance sums against one
    ``FILTERED_REF`` or ``BROWSE_REF`` cell (``caps_mode`` None: the cell
    keeps one padded list)."""
    for key, v in ref_["counters"].items():
        check(got[key] == v, f"{what}: {key} {got[key]}, the reference has "
              f"{v}")
    padded = ref_["padded"] if caps_mode is None else \
        ref_["padded"][caps_mode]
    check(got["lanes_live"][:4] == ref_["live"] and
          got["lanes_padded"][:4] == padded,
          f"{what}: occupancy {got['lanes_live']} {got['lanes_padded']}")
    found = ids >= 0
    check(int(ids[found].astype(np.int64).sum()) == ref_["ids_sum"] and
          float(d[found].astype(np.float64).sum()) == ref_["d_sum"] and
          int(found.sum()) == ref_["found"],
          f"{what}: ids sum {ids[found].astype(np.int64).sum()}, distance "
          f"sum {d[found].astype(np.float64).sum()!r}, {found.sum()} found")


def phase_filtered_engine(torch, tree, rects, fq, d1_knn, rtree,
                          knn_filtered):
    """Phase 20: ``make_knn_filtered_bfs`` (PyTorch ops on the card, as the
    reference's is jnp with no kernel) on the first served filtered batch,
    k in {8, 64} × static/adaptive on D1 and D3: ≡ the same engine on a
    CPU copy of the tree (ids, distance bits, every counter) and
    ``FILTERED_REF``, no overflow; 8 rows ≡ a windowed float64 brute force;
    the whole-universe window ≡ phase 10's kNN results; ms per batch and
    the device's busy share."""
    t0 = time.time()
    cpu_tree = rtree.build_rtree(rects, fanout=FANOUT, device="cpu")
    q = torch.from_numpy(fq).to(tree.device)
    timed = []
    for layout in ("d1", "d3"):
        for k in (8, 64):
            for caps_mode in ("static", "adaptive"):
                what = f"filtered {layout} k={k} {caps_mode}"
                kw = dict(layout=layout, caps_mode=caps_mode)
                fn = knn_filtered.make_knn_filtered_bfs(tree, k, **kw)
                ids, d, ctr = fn(q)
                cids, cd, cctr = knn_filtered.make_knn_filtered_bfs(
                    cpu_tree, k, **kw)(fq)
                check(ids.is_cuda, f"{what}: the result left the card")
                assert_bits_equal(ids.cpu(), cids, f"{what} ids vs CPU")
                assert_bits_equal(d.cpu(), cd, f"{what} dists vs CPU")
                got = ctr.asdict()
                check(got == cctr.asdict(), f"{what} counters: {got} vs "
                      f"{cctr.asdict()}")
                check(got["overflow"] == 0 and got["escalations"] == 0,
                      f"{what}: overflow {got['overflow']}, escalations "
                      f"{got['escalations']}")
                ids_np, d_np = ids.cpu().numpy(), d.cpu().numpy()
                check_ref_cell(got, ids_np, d_np,
                               FILTERED_REF[(layout, k)], caps_mode, what)
                if caps_mode == "static":
                    check_filtered_brute_force(torch, tree.device, rects,
                                               fq[:8], ids_np[:8], d_np[:8],
                                               what)
                    full = fq.copy()
                    full[:, 2:4], full[:, 4:6] = -1.0, 2.0
                    fi, fdist, _ = fn(full)
                    want_i, want_d = d1_knn[k]
                    check(np.array_equal(fi.cpu().numpy(), want_i) and
                          np.array_equal(fdist.cpu().numpy().view(np.int32),
                                         want_d.view(np.int32)),
                          f"{what}: the whole-universe window differs from "
                          f"phase 10's kNN")
                timed.append((what, fn))
    print(f"  8 cells ≡ the CPU engine (ids, distance bits, counters) and "
          f"FILTERED_REF; 8 rows ≡ the windowed brute force; the whole "
          f"window ≡ phase 10's kNN ({time.time() - t0:.1f} s)", flush=True)
    for what, fn in timed:
        print(f"  {what}: {host_ms(lambda: fn(q), 10):.3f} ms per "
              f"{q.shape[0]}-query batch", flush=True)
        print(f"    {profile_batches(lambda: fn(q))}", flush=True)


def tied_lanes(row: np.ndarray) -> np.ndarray:
    """Lanes of ``row`` whose value occurs more than once in it."""
    _, inv, cnt = np.unique(row, return_inverse=True, return_counts=True)
    return cnt[inv] > 1


def browse_session(start, points, steps):
    """A browse session of ``steps`` next_batch() calls → (cursor, ids (B,
    steps·k), dists (B, steps·k))."""
    cur = start(points)
    out = [cur.next_batch() for _ in range(steps)]
    return (cur, np.concatenate([i for i, _ in out], axis=1),
            np.concatenate([d for _, d in out], axis=1))


def phase_browse_engine(torch, tree, points, kkern, knn_browse, knn_vector):
    """Phase 21: ``make_browse_bfs`` on the first served kNN batch, k = 8,
    D1 and D3, sessions of BROWSE_STEPS and BROWSE_DEEP steps: each step ≡
    the twin session on the card (ids, distance bits, overflow, lost,
    emitted, descents, the deferred beams, every counter); each session ≡
    ``BROWSE_REF``; the first 32 neighbours ≡ ``make_knn_bfs(k=32)``,
    distances bit for bit; B5 launches grow, and B13's on D3; ms per
    next_batch() and the device's busy share."""
    t0 = time.time()
    state_fields = ("pool_ids", "pool_d", "lost", "emitted", "overflow",
                    "descents")
    k32 = knn_vector.make_knn_bfs(tree, 4 * KNN_K, caps_mode="static")
    ki, kd, kc = k32(points)
    check(int(kc.overflow) == 0, "kNN k=32 overflowed")
    ki, kd = ki.cpu().numpy(), kd.cpu().numpy()
    timed = []
    for layout in ("d1", "d3"):
        start = knn_browse.make_browse_bfs(tree, KNN_K, layout=layout)
        twin = knn_browse.make_browse_bfs(tree, KNN_K, layout=layout,
                                          backend="torch")
        for steps in (BROWSE_STEPS, BROWSE_DEEP):
            what = f"browse {layout} {steps} steps"
            kkern.reset_launch_counts()
            cur, tcur = start(points), twin(points)
            ids, d = [], []
            for step in range(steps):
                (gi, gd), (wi, wd) = cur.next_batch(), tcur.next_batch()
                check(np.array_equal(gi, wi) and
                      np.array_equal(gd.view(np.int32), wd.view(np.int32)),
                      f"{what}: step {step} differs from the twin session")
                a, b = cur.state, tcur.state
                for f in state_fields:
                    assert_bits_equal(getattr(a, f), getattr(b, f),
                                      f"{what} step {step} {f}")
                for x, y in zip(a.def_ids + a.def_d, b.def_ids + b.def_d):
                    assert_bits_equal(x, y, f"{what} step {step} deferred")
                check(a.ctr.asdict() == b.ctr.asdict(),
                      f"{what} step {step} counters")
                ids.append(gi)
                d.append(gd)
            launches = kkern.launch_counts()
            check(launches["knn_level_dists"] > 0 and
                  (layout == "d1" or launches["knn_level_dists_d3"] > 0),
                  f"{what}: launches {launches}")
            ids, d = np.concatenate(ids, axis=1), np.concatenate(d, axis=1)
            st = cur.state
            ref_ = BROWSE_REF[(layout, steps)]
            check_ref_cell(st.ctr.asdict(), ids, d, ref_, None, what)
            lost = st.lost.cpu().numpy()
            fin = np.isfinite(lost)
            check(int(st.descents) == ref_["descents"] and
                  int(st.emitted.sum()) == ref_["emitted"] and
                  int(st.overflow.sum()) == ref_["overflow"] and
                  int(fin.sum()) == ref_["lost_finite"] and
                  float(lost[fin].astype(np.float64).sum()) ==
                  ref_["lost_sum"],
                  f"{what}: descents {int(st.descents)}, emitted "
                  f"{int(st.emitted.sum())}, overflow "
                  f"{int(st.overflow.sum())}, lost {lost[fin].sum()!r}")
            head_i, head_d = ids[:, :4 * KNN_K], d[:, :4 * KNN_K]
            tied = np.stack([tied_lanes(row) for row in head_d])
            check(np.array_equal(head_d.view(np.int32), kd.view(np.int32))
                  and bool(((head_i == ki) | tied).all()),
                  f"{what}: the first 32 neighbours differ from kNN k=32")
            print(f"  {what}: ≡ the twin session step by step and "
                  f"BROWSE_REF; {int(st.descents)} descents, "
                  f"{int(st.overflow.sum())} rows past the lost bound; "
                  f"launches {launches}", flush=True)
            timed.append((what, start, steps))
    print(f"  sessions checked in {time.time() - t0:.1f} s", flush=True)
    for what, start, steps in timed:
        ms = host_ms(lambda: browse_session(start, points, steps), 3)
        print(f"  {what}: {ms / steps:.3f} ms per next_batch() "
              f"({ms:.3f} ms per session of {points.shape[0]} queries)",
              flush=True)
        prof = profile_batches(
            lambda: browse_session(start, points, steps), iters=1)
        print(f"    per session: {prof}", flush=True)


def phase_a10_serve(torch, dev, kkern, serve):
    """Phase 22: ``serve.main`` for knn-filtered and browse at 2M points on
    cuda, D1 and D3: no overflow; the first batch ≡ a float64 brute force
    on the card (filtered: windowed; browse: the first session's
    BROWSE_STEPS·k neighbours); D3 ≡ D1; B5 launches grow in browse, and
    B13's on D3.  Returns {(mode, layout): q/s}."""
    rects, fq = serve.make_knn_filtered_inputs(N_RECTS, SEED, 1, BATCH,
                                               FILTER_EPS)
    _, pts = serve.make_knn_inputs(N_RECTS, SEED, 1, BATCH)
    qps, first = {}, {}
    for mode, argv in (("knn-filtered", ["--filter-eps", str(FILTER_EPS)]),
                       ("browse", ["--browse-steps", str(BROWSE_STEPS)])):
        for layout in ("d1", "d3"):
            kkern.reset_launch_counts()
            out = serve.main(["--mode", mode, "--n", str(N_RECTS), "--k",
                              str(KNN_K), "--batches", str(KNN_BATCHES),
                              "--batch-size", str(BATCH), "--layout",
                              layout, *argv])
            got = kkern.launch_counts()
            check(not out["overflow"], f"the served {mode} {layout} "
                  f"overflowed")
            if mode == "browse":
                check(got["knn_level_dists"] > 0 and
                      (layout == "d1" or got["knn_level_dists_d3"] > 0),
                      f"served browse {layout}: launches {got}")
            ids, d = out["first_batch"]
            if mode == "browse":
                check_knn_brute_force(torch, dev, rects, pts[0], ids, d,
                                      f"{mode} {layout} serve")
            else:
                check_filtered_brute_force(torch, dev, rects, fq[0], ids,
                                           d, f"{mode} {layout} serve")
            first[(mode, layout)] = out["first_batch"]
            qps[(mode, layout)] = out["qps"]
            unit = "sessions·q/s" if mode == "browse" else "q/s"
            print(f"  {mode} {layout}: first batch ≡ brute force; "
                  f"{out['qps']:,.1f} {unit}; launches {got}", flush=True)
        check(all(np.array_equal(a, b) for a, b in
                  zip(first[(mode, "d1")], first[(mode, "d3")])),
              f"served {mode}: D3's first batch differs from D1's")
    return qps


# ---------------------------------------------------------------------------
# the fleet's single-program (mesh) path (phases 23-24)
# ---------------------------------------------------------------------------

def counts_of(mods) -> dict:
    """Every kernel wrapper's launch count in ``mods``, the nonzero ones."""
    return {k: v for m in mods for k, v in m.launch_counts().items() if v}


def mesh_cell(torch, fn, mods, iters: int = 2, warm: bool = True):
    """One engine call ``fn``, warm: (its launches by kernel, ms per call on
    the host clock, peak device MiB and the MiB above what was resident
    before, the profiler's busy share and top device items).
    ``warm=False``: a check has just run ``fn``, so no warm-up call, and
    the one timed call (``iters`` 1) is the call whose launches count."""
    if warm:
        fn()
        torch.cuda.synchronize()
    for m in mods:
        m.reset_launch_counts()
    if warm:
        fn()
        torch.cuda.synchronize()
        launches = counts_of(mods)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(fn, iters, warmup=0)
    if not warm:
        check(iters == 1, "a cold mesh cell counts one timed call")
        launches = counts_of(mods)
    peak = torch.cuda.max_memory_allocated()
    return (launches, ms, peak / 2 ** 20, (peak - base) / 2 ** 20,
            profile_batches(fn, iters=iters, warm=False))


def print_cells(what, mesh, host) -> None:
    for path, (launches, ms, peak, above, prof) in (("mesh", mesh),
                                                    ("host", host)):
        print(f"  {what} {path}: {ms:.3f} ms per batch, launches {launches}"
              f", peak {peak:.1f} MiB ({above:.1f} above resident)",
              flush=True)
        print(f"    {prof}", flush=True)


def same_counters(a, b) -> bool:
    """Every ``Counters`` field but ``dispatches`` equal."""
    a, b = a.asdict(), b.asdict()
    a.pop("dispatches")
    b.pop("dispatches")
    return a == b


def same_neighbours(ai, ad, bi, bd) -> bool:
    """Two (ids, squared distances) answers agree: the distances bit for
    bit, and each row's ids as a set within each run of tied distances.
    The host path keeps a single partition's answer in its engine's lane
    order at a tie, the mesh path orders every merge by (distance, id),
    as the reference's two paths do."""
    ad, bd = np.asarray(ad, np.float32), np.asarray(bd, np.float32)
    if not np.array_equal(ad.view(np.int32), bd.view(np.int32)):
        return False
    return all(np.array_equal(ai[r][np.lexsort((ai[r], ad[r]))],
                              bi[r][np.lexsort((bi[r], bd[r]))])
               for r in range(len(ai)))


def mesh_distance_cell(torch, shards, traversal, mods, op, queries, k,
                       what):
    """A distance operator's mesh program over ``shards``' forest ≡ its
    twin program on the card (ids, distance bits, every counter but
    dispatches) ≡ the host path (ids, distances, overflow); then the mesh
    and host calls timed.  Returns (mesh cell, host cell, mesh ids, d)."""
    prog = shards._mesh_program(op, k=k)
    twin = traversal.make_mesh_engine(op, shards._forest, k=k,
                                      layout=shards.layout, backend="torch")
    ids, d, ctr = prog(queries)
    tids, td, tctr = twin(queries)
    assert_bits_equal(ids, tids, f"{what} ids")
    assert_bits_equal(d, td, f"{what} dists")
    check(same_counters(ctr, tctr), f"{what} counters {ctr.asdict()} vs "
          f"the twin's {tctr.asdict()}")
    q = queries.cpu().numpy()
    host = shards.host_view()
    mi, md, mo = getattr(shards, op)(q, k)
    hi, hd, ho = getattr(host, op)(q, k)
    check(same_neighbours(mi, md, hi, hd) and mo == ho and not mo,
          f"{what}: mesh and host path differ (overflow {mo}, {ho})")
    print(f"  {what}: ≡ twin program (ids, distance bits, counters) and "
          f"the host path; counters {ctr.asdict()}", flush=True)
    cells = (mesh_cell(torch, lambda: getattr(shards, op)(q, k), mods),
             mesh_cell(torch, lambda: getattr(host, op)(q, k), mods))
    print_cells(what, *cells)
    return cells + (mi, md)


def phase_mesh_engines(torch, dev, mods, serve, SpatialShards, traversal,
                       knn_browse, rtree, elevate, cuts):
    """Phase 23: the mesh programs over the 9-partition fleet of 2M points
    (``serve --partitions 8``), D1 and D3: select, kNN and kNN-join (k in
    MESH_KS), filtered kNN (k = 8), the distributed browse (k = 8, 4
    steps) and the join (D1), each ≡ its twin program on the card (every
    counter but dispatches) and ≡ the host path on the same fleet; B5 a
    kNN batch is 2 × the forest's height, also over 4 partitions;
    launches, ms per batch, busy share and peak memory of the mesh and
    host calls.  Returns {layout: forest height}; the seconds cut (a) saves
    go into ``cuts``."""
    rects = serve.make_rects(N_RECTS, SEED)
    sel_q = torch.from_numpy(serve.make_queries(
        1, BATCH, SELECTIVITY, SEED + 1)[0]).to(dev)
    pts = torch.from_numpy(serve.make_knn_inputs(N_RECTS, SEED, 1,
                                                 BATCH)[1][0]).to(dev)
    qrects = torch.from_numpy(serve.make_knn_join_inputs(
        N_RECTS, SEED, 1, BATCH, QUERY_EPS)[1][0]).to(dev)
    fq = torch.from_numpy(serve.make_knn_filtered_inputs(
        N_RECTS, SEED, 1, BATCH, FILTER_EPS)[1][0]).to(dev)
    heights = {}
    for layout in ("d1", "d3"):
        t0 = time.time()
        shards = SpatialShards.build(rects, MESH_PARTITIONS, fanout=FANOUT,
                                     layout=layout, device=dev, mesh=True)
        forest = shards._forest
        h = heights[layout] = forest.height
        print(f"  {layout}: {forest.n_partitions} partitions packed in "
              f"{time.time() - t0:.2f} s; height {h}, padded level sizes "
              f"{[lvl.n_nodes for lvl in forest.partition_tree.levels]}, "
              f"flat {[lvl.n_nodes for lvl in forest.flat.levels]}",
              flush=True)
        # select: every partition answers the full batch
        prog = shards._mesh_program("select", result_cap=RESULT_CAP)
        twin = traversal.make_mesh_engine("select", forest,
                                          result_cap=RESULT_CAP,
                                          layout=layout, backend="torch")
        ids, counts, ctr = prog(sel_q)
        tids, tcounts, tctr = twin(sel_q)
        assert_equal(ids, tids, f"mesh select {layout} ids")
        assert_equal(counts, tcounts, f"mesh select {layout} counts")
        check(same_counters(ctr, tctr), f"mesh select {layout} counters")
        q = sel_q.cpu().numpy()
        host = shards.host_view()
        got, want = shards.range_select(q), host.range_select(q)
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"mesh select {layout}: differs from the host path")
        check(int(ctr.overflow) == 0, f"mesh select {layout} overflowed")
        print(f"  select {layout}: ≡ twin program and the host path; "
              f"counters {ctr.asdict()}", flush=True)
        print_cells(f"select {layout}",
                    mesh_cell(torch, lambda: shards.range_select(q), mods),
                    mesh_cell(torch, lambda: host.range_select(q), mods))
        knn8 = None
        for op, queries, ks in (("knn", pts, MESH_KS),
                                ("knn_join", qrects, MESH_KS),
                                ("knn_filtered", fq, (KNN_K,))):
            for k in ks:
                mesh, _, mi, md = mesh_distance_cell(
                    torch, shards, traversal, mods, op, queries, k,
                    f"{op} k={k} {layout}")
                if op == "knn" and k == KNN_K:
                    knn8 = (mi, md)
                    b5 = mesh[0].get("knn_level_dists", 0)
                    b13 = mesh[0].get("knn_level_dists_d3", 0)
                    want = (2 * h, 0) if layout == "d1" else (2, 2 * (h - 1))
                    check((b5, b13) == want, f"kNN {layout} mesh batch: B5 "
                          f"{b5}, B13 {b13} launches, expected {want}")
        # the distributed browse, 4 steps, against its twin cursor
        start = lambda p_: shards.browse(p_, KNN_K)       # noqa: E731
        twin = knn_browse.make_sharded_browse(forest, KNN_K, layout=layout,
                                              backend="torch")
        pts_np = pts.cpu().numpy()
        cur, tcur = start(pts_np), twin(pts_np)
        for step in range(BROWSE_STEPS):
            (gi, gd), (wi, wd) = cur.next_batch(), tcur.next_batch()
            check(np.array_equal(gi, wi) and
                  np.array_equal(gd.view(np.int32), wd.view(np.int32)),
                  f"mesh browse {layout}: step {step} differs from the twin")
            a, b = cur.state, tcur.state
            for f in ("pool_ids", "pool_d", "lost", "emitted", "overflow",
                      "descents"):
                assert_bits_equal(getattr(a, f), getattr(b, f),
                                  f"mesh browse {layout} step {step} {f}")
            check(a.ctr.asdict() == b.ctr.asdict(),
                  f"mesh browse {layout} step {step} counters")
            if step == 0:
                check(np.array_equal(gi, knn8[0]) and
                      np.array_equal(gd.astype(np.float64), knn8[1]),
                      f"mesh browse {layout}: the first {KNN_K} differ "
                      f"from kNN")
        check(not cur.overflow.any(), f"mesh browse {layout} overflowed")
        print(f"  browse {layout}: {BROWSE_STEPS} steps ≡ the twin cursor "
              f"(ids, distance bits, pools, lost, descents, each "
              f"partition's counters); first {KNN_K} ≡ kNN; descents "
              f"{cur.state.descents.tolist()}", flush=True)
        single = knn_browse.make_browse_bfs(
            rtree.build_rtree(rects, fanout=FANOUT, device=dev), KNN_K,
            layout=layout)
        print_cells(f"browse session ({BROWSE_STEPS} steps) {layout}",
                    mesh_cell(torch, lambda: browse_session(
                        start, pts_np, BROWSE_STEPS), mods),
                    mesh_cell(torch, lambda: browse_session(
                        single, pts_np, BROWSE_STEPS), mods))
        del shards, forest, host, single
    # B5 a batch at 4 partitions: still two descents of the forest
    shards = SpatialShards.build(rects, 4, fanout=FANOUT, device=dev,
                                 mesh=True)
    launches = mesh_cell(torch, lambda: shards.knn(pts.cpu().numpy(), KNN_K),
                         mods)[0]
    h4 = shards._forest.height
    check(launches.get("knn_level_dists") == 2 * h4,
          f"kNN over 4 partitions: {launches}, height {h4}")
    print(f"  kNN over {shards._forest.n_partitions} partitions (height "
          f"{h4}): B5 {launches.get('knn_level_dists')} launches a batch = "
          f"2 × height", flush=True)
    del shards
    # the join (D1; the D3 join is A9b)
    rects, probes = serve.make_join_inputs(N_RECTS, SEED, QUERY_EPS)
    shards = SpatialShards.build(rects, MESH_PARTITIONS, fanout=FANOUT,
                                 sort_key="lx", device=dev, mesh=True)
    probe_tree = rtree.build_rtree(probes, fanout=FANOUT, sort_key="lx",
                                   device=dev)
    check(probe_tree.height <= shards._forest.height, "probe taller")
    elevated = elevate(probe_tree, shards._forest.height)
    kw = dict(result_cap=JOIN_CAP, o3=True, o4=True)
    pairs, counts, ctr = shards._mesh_program(
        "join", outer_tree=elevated, **kw)()
    twin = traversal.make_mesh_engine("join", shards._forest,
                                      outer_tree=elevated, layout="d1",
                                      backend="torch", **kw)
    tpairs, tcounts, tctr = twin()
    assert_equal(counts, tcounts, "mesh join counts")
    assert_equal(pairs, tpairs, "mesh join pairs")
    check(same_counters(ctr, tctr), "mesh join counters")
    del twin, tpairs
    host = shards.host_view()
    got, ovf = shards.join(probe_tree, **kw)
    want, hovf = host.join(probe_tree, **kw)
    check(np.array_equal(got, want) and not ovf and not hovf,
          "mesh join: differs from the host path")
    print(f"  join: {len(got)} pairs ≡ twin program and the host path; "
          f"counters {ctr.asdict()}", flush=True)
    # a join takes 3-6 s a call: the checks' calls just above warmed both
    # paths, so one timed call, whose launches count, and one profiled
    cells = (mesh_cell(torch, lambda: shards.join(probe_tree, **kw), mods,
                       iters=1, warm=False),
             mesh_cell(torch, lambda: host.join(probe_tree, **kw), mods,
                       iters=1, warm=False))
    print_cells("join", *cells)
    # the calls that cut (a) no longer makes: each path's warm-up and its
    # separate counted call
    cuts["23: join cells' warm-up and counted calls"] = \
        2 * sum(c[1] for c in cells) / 1e3
    return heights


MESH_SERVE_MODES = (
    ("spatial", ["--batches", "20"]),
    ("join", ["--join-cap", str(JOIN_CAP), "--query-eps", str(QUERY_EPS),
              "--batches", str(MESH_SERVE_JOINS)]),
    ("knn", ["--k", str(KNN_K)]),
    ("knn-join", ["--k", str(KNN_K), "--query-eps", str(QUERY_EPS)]),
    ("knn-filtered", ["--k", str(KNN_K), "--filter-eps", str(FILTER_EPS)]),
    ("browse", ["--k", str(KNN_K), "--browse-steps", str(BROWSE_STEPS)]),
)


def phase_mesh_serve(mods, serve, heights, cuts):
    """Phase 24: ``serve.main`` for every fleet mode, D1 and D3 (the join
    D1), with ``--mesh on`` and ``--mesh off`` in turn at 2M points: no
    overflow, the first batch of the two paths equal (the join's last;
    browse: the first session's first k ids, all its distance bits), the
    rates side by side, B5 on the served mesh kNN = (batches + the warm
    batch) × 2 × height.  Returns {kernel: launches on the mesh path}; the
    seconds cut (b) saves go into ``cuts``."""
    mesh_launches = {}
    for layout in ("d1", "d3"):
        for mode, argv in MESH_SERVE_MODES:
            if mode == "join" and layout != "d1":
                continue
            outs = {}
            for mesh in ("on", "off"):
                for m in mods:
                    m.reset_launch_counts()
                out = serve.main(["--mode", mode, "--n", str(N_RECTS),
                                  "--partitions", str(MESH_PARTITIONS),
                                  "--fanout", str(FANOUT), "--batch-size",
                                  str(BATCH), "--batches", str(KNN_BATCHES),
                                  "--layout", layout, "--mesh", mesh,
                                  *argv])
                outs[mesh] = (out, counts_of(mods))
                check(not out["overflow"], f"served {mode} {layout} --mesh "
                      f"{mesh} overflowed")
            (on, got), (off, host_got) = outs["on"], outs["off"]
            if mode == "join":
                check(np.array_equal(on["last_pairs"], off["last_pairs"]),
                      f"served join --mesh on/off: the pairs differ")
            elif mode == "spatial":
                check(all(np.array_equal(a, b) for a, b in
                          zip(on["first_batch"], off["first_batch"])),
                      f"served spatial {layout}: mesh ≠ host first batch")
            else:
                (ai, ad), (bi, bd) = on["first_batch"], off["first_batch"]
                n = KNN_K if mode == "browse" else ai.shape[1]
                check(same_neighbours(ai[:, :n], ad[:, :n], bi[:, :n],
                                      bd[:, :n]) and same_neighbours(
                          ai, ad, ai, bd),
                      f"served {mode} {layout}: mesh ≠ host first batch")
            if mode == "join":    # cut (b): one join a path fewer
                cuts["24: the served join's third join a path"] = \
                    1 / on["joins_per_s"] + 1 / off["joins_per_s"]
            rate = "joins_per_s" if mode == "join" else "qps"
            unit = {"join": "joins/s", "browse": "sessions·q/s"}.get(mode,
                                                                     "q/s")
            print(f"  {mode} {layout}: mesh {on[rate]:,.3f} {unit}, host "
                  f"{off[rate]:,.3f}; first batch equal; launches mesh "
                  f"{got}, host {host_got}", flush=True)
            if mode == "knn" and layout == "d1":
                want = (KNN_BATCHES + 1) * 2 * heights["d1"]
                check(got.get("knn_level_dists") == want,
                      f"served mesh kNN: B5 {got}, expected {want}")
            for k, v in got.items():
                mesh_launches.setdefault(k, v)
    for name in ("select_level_masks", "join_pair_masks", "knn_level_dists",
                 "knn_join_level_dists", "select_level_masks_d3",
                 "knn_level_dists_d3", "knn_join_level_dists_d3"):
        check(mesh_launches.get(name, 0) > 0,
              f"{name} not launched on the served mesh path")
    return mesh_launches


# ---------------------------------------------------------------------------
# the serve queue, health tracking, fault injection and replicas (25-26)
# ---------------------------------------------------------------------------

QUEUE_MODES = (       # (mode, spec name, the mode's flags, its score kernel)
    ("spatial", "select", [], "select_level_masks"),
    ("knn", "knn", ["--k", str(KNN_K)], "knn_level_dists"),
    ("knn-join", "knn_join", ["--k", str(KNN_K), "--query-eps",
                              str(QUERY_EPS)], "knn_join_level_dists"),
    ("knn-filtered", "knn_filtered", ["--k", str(KNN_K), "--filter-eps",
                                      str(FILTER_EPS)], None),
)


def queue_args(layout="d1"):
    """The queued runs' argv past the mode's flags, and the namespace
    ``serve._queued_payloads`` reads (the same sizes and seeds)."""
    import argparse
    argv = ["--n", str(N_RECTS), "--partitions", str(MESH_PARTITIONS),
            "--fanout", str(FANOUT), "--batch-size", str(BATCH),
            "--batches", str(QUEUE_REQUESTS), "--layout", layout,
            "--clients", str(QUEUE_CLIENTS), "--max-batch",
            str(QUEUE_MAX_BATCH), "--depth", str(QUEUE_DEPTH)]
    ns = argparse.Namespace(n=N_RECTS, seed=SEED, batches=QUEUE_REQUESTS,
                            batch_size=BATCH, selectivity=SELECTIVITY,
                            k=KNN_K, query_eps=QUERY_EPS,
                            filter_eps=FILTER_EPS)
    return argv, ns


def direct_call(shards, op, rows):
    if op == "select":
        return shards.range_select(rows)
    return getattr(shards, op)(rows, KNN_K)


def same_response(op, got, want, exact: bool = True) -> bool:
    """A queued response against a direct one: select id arrays equal;
    (ids, distance bits) equal, or with ``exact`` False the same
    neighbours within ties (a host-path fallback behind mesh replicas)."""
    if op == "select":
        return len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want))
    if not exact:
        return same_neighbours(got[0], got[1], want[0], want[1])
    return np.array_equal(got[0], want[0]) and np.array_equal(
        np.asarray(got[1]).view(np.int64), np.asarray(want[1]).view(np.int64))


def warm_buckets(engines, op, params, top: int = QUEUE_MAX_BATCH) -> None:
    """Every power-of-two bucket from one request's to ``top``."""
    bk = 1 << (BATCH - 1).bit_length()
    while bk <= top:
        for e in engines:
            e.warm(op, bk, **params)
        bk <<= 1


def drive_queue(ServeQueue, engines, op, payloads, params, clients,
                max_batch: int = QUEUE_MAX_BATCH, profile: bool = False,
                **qkw):
    """``clients`` closed-loop threads send ``payloads`` through one
    ServeQueue over ``engines`` (batches of up to ``max_batch`` rows); the
    pool is settled (every engine call's outcome recorded) before the
    summary is read.  Returns (results by request, seconds, summary, failed
    requests, with ``profile`` the device's busy share of the run under
    torch.profiler)."""
    import concurrent.futures as cf
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    errors = []

    def client(cid):
        out = []
        for i in range(cid, len(payloads), clients):
            try:
                out.append((i, q.submit(payloads[i]).result(timeout=300)))
            except Exception as exc:          # a failed request
                errors.append((i, exc))
        return out

    ctx = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   ) if profile else contextlib.nullcontext()
    with ServeQueue(engines, op, max_batch=max_batch, depth=QUEUE_DEPTH,
                    seed=SEED, **params, **qkw) as q:
        with ctx as prof:
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(clients) as ex:
                parts = [f.result(timeout=600) for f in
                         [ex.submit(client, c) for c in range(clients)]]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        q.close()
        q.pool.shutdown(wait=True)
        summary = q.summary
    busy = None
    if profile:
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
        dev_us = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        busy = (f"device busy {dev_us / (dt * 1e6):.1%} of {dt:.3f} s "
                f"({dev_us / 1e3:.1f} device ms; top: " + ", ".join(
                    f"{n.replace('void ', '')[:40]} {t / 1e3:.1f}"
                    for n, t in top) + ")" if dev_us else
                "profiler recorded no device time")
    return (dict(pair for part in parts for pair in part), dt, summary,
            errors, busy)


def phase_queue_serve(torch, dev, mods, serve, SpatialShards, ServeQueue):
    """Phase 25: ``serve.main([... "--queue"])`` at 2M points, 9
    partitions, QUEUE_REQUESTS requests of BATCH rows from QUEUE_CLIENTS
    clients, batches of up to QUEUE_MAX_BATCH rows, QUEUE_DEPTH in flight:
    D1 select, kNN, kNN-join and filtered kNN with ``--mesh off`` and
    ``on``, D3 kNN with ``--mesh on``.  Every response bit-equal to the
    direct call of the same fleet (built the same way) on the same path;
    no dispatch failure, retry, degraded dispatch, pool failure or failed
    request; the launches of the mode's score kernel grow (B1, B5, B8; B13
    on D3).  Queued q/s beside the direct q/s (the same requests one at a
    time, as the synchronous runner serves them), dispatches, rows per
    dispatch, re-issues; for the mesh kNN, a queued run over the direct
    fleet under torch.profiler (busy share).  Returns ({kernel: launches
    on the queued path}, {(mode, layout, mesh): (queued, direct) q/s}, the
    D1 host-path fleet); prints each queued run's peak device memory."""
    launches, rates, fleets = {}, {}, {}
    cells = [(m, "d1", mesh) for m in QUEUE_MODES for mesh in ("off", "on")]
    cells.append((QUEUE_MODES[1], "d3", "on"))
    for (mode, op, flags, score), layout, mesh in cells:
        argv, ns = queue_args(layout)
        for m in mods:
            m.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = serve.main(["--mode", mode, "--queue", "--mesh", mesh,
                          *argv, *flags])
        got = counts_of(mods)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        what = f"queued {mode} {layout} --mesh {mesh}"
        for key in ("failed_requests", "failures", "retries",
                    "dispatch_failures", "degraded_dispatches"):
            check(out[key] == 0, f"{what}: {key} {out[key]}")
        check(sorted(out["results"]) == list(range(QUEUE_REQUESTS)),
              f"{what}: {len(out['results'])} responses")
        if score is not None:
            check(got.get(score, 0) > 0, f"{what}: {score} not launched "
                  f"({got})")
        if layout == "d3":
            check(got.get("knn_level_dists_d3", 0) > 0,
                  f"{what}: knn_level_dists_d3 not launched ({got})")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        # the direct calls: the same requests on a fleet built the same way
        rects, payloads, params = serve._queued_payloads(ns, op)
        if (layout, "off") not in fleets:
            fleets[layout, "off"] = SpatialShards.build(
                rects, MESH_PARTITIONS, fanout=FANOUT, layout=layout,
                device=dev)
        if (layout, mesh) not in fleets:
            fleets[layout, mesh] = SpatialShards(
                fleets[layout, "off"].partitions, FANOUT,
                layout=layout).enable_mesh()
        shards = fleets[layout, mesh]
        shards.warm(op, BATCH, **params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = [direct_call(shards, op, p) for p in payloads]
        direct_qps = QUEUE_REQUESTS * BATCH / (time.perf_counter() - t0)
        for i, want in enumerate(direct):
            check(same_response(op, out["results"][i], want),
                  f"{what}: response {i} ≠ the direct call")
            check(op == "select" or not want[2],
                  f"{what}: direct request {i} overflowed")
        rates[mode, layout, mesh] = (out["qps"], direct_qps)
        print(f"  {what}: {out['qps']:,.1f} q/s queued, {direct_qps:,.1f} "
              f"direct; {out['dispatches']} dispatches, "
              f"{out['rows_per_dispatch']:.1f} rows/dispatch, "
              f"{out['reissues']} re-issues, quarantines "
              f"{out['quarantines']}, peak {peak:,.0f} MiB (fleet "
              f"included); {QUEUE_REQUESTS} responses ≡ direct; launches "
              f"{got}", flush=True)
        if op in ("knn", "select") and layout == "d1" and mesh == "on":
            warm_buckets([shards], op, params)
            res, dt, summary, errors, busy = drive_queue(
                ServeQueue, [shards], op, payloads, params, QUEUE_CLIENTS,
                profile=True)
            check(not errors and all(same_response(op, res[i], direct[i])
                                     for i in range(QUEUE_REQUESTS)),
                  f"profiled queued mesh {op}: {len(errors)} failed or a "
                  f"response differs")
            print(f"  profiled queued mesh {op}: "
                  f"{QUEUE_REQUESTS * BATCH / dt:,.1f} q/s, "
                  f"{summary['batches']} dispatches, "
                  f"{summary['rows_per_dispatch']:.1f} rows/dispatch, "
                  f"{summary['reissues']} re-issues; {busy}", flush=True)
    return launches, rates, fleets["d1", "off"]


def phase_chaos(torch, dev, serve, shards, ServeQueue, FaultInjector,
                FaultPlan):
    """Phase 26: a ServeQueue of D1 kNN over ``shards.replicate(devices=
    [dev, dev])`` (two replica fleets on the one card, the 2M points in 9
    partitions) with ``shards.host_view()`` as the fallback, QUEUE_CLIENTS
    clients, one request a dispatch so that the plans arm: fault-free, then
    under each of CHAOS_PLANS.  Each plan: no failed request; every
    response equal to the fault-free run's (the same neighbours within
    ties where the host-path fallback served); the pool's failures equal
    the injected exceptions; a quarantine under ``kill:r1@5``; degraded
    dispatches when both replicas are dead.  Then ``serve.main([...
    "--queue", "--chaos", "crash:r0@3"])`` on one replica (the mesh path):
    no failed request, one injected exception, one retry."""
    _, ns = queue_args()
    _, payloads, params = serve._queued_payloads(ns, "knn")
    reps = shards.replicate(devices=[dev, dev])
    check(len(reps) == 2 and all(r.mesh_enabled for r in reps)
          and not shards.mesh_enabled, "replicate: two mesh-path fleets")
    warm_buckets(reps, "knn", params, top=BATCH)
    fallback = shards.host_view()
    clean, dt, summary, errors, _ = drive_queue(
        ServeQueue, reps, "knn", payloads, params, QUEUE_CLIENTS,
        max_batch=BATCH, fallback=fallback)
    check(not errors and summary["failures"] == 0
          and summary["retries"] == 0 and summary["degraded_dispatches"]
          == 0, f"fault-free replicas: {len(errors)} failed, {summary}")
    for i, p in enumerate(payloads[:4]):
        check(same_response("knn", clean[i], reps[0].knn(p, KNN_K)),
              f"replica queue: response {i} ≠ the direct replica call")
    _, dt1, summary1, errors1, _ = drive_queue(
        ServeQueue, reps[:1], "knn", payloads, params, QUEUE_CLIENTS,
        max_batch=BATCH, fallback=fallback)
    check(not errors1 and summary1["failures"] == 0,
          f"fault-free, one replica: {len(errors1)} failed, {summary1}")
    print(f"  fault-free, one request a dispatch: 2 replicas "
          f"{QUEUE_REQUESTS * BATCH / dt:,.1f} q/s, 1 replica "
          f"{QUEUE_REQUESTS * BATCH / dt1:,.1f}; {summary['batches']} "
          f"dispatches, re-issues {summary['reissues']}, quarantines "
          f"{summary['quarantines']}", flush=True)
    for spec in CHAOS_PLANS:
        inj = FaultInjector(FaultPlan.from_spec(spec, seed=SEED))
        res, dt, summary, errors, _ = drive_queue(
            ServeQueue, reps, "knn", payloads, params, QUEUE_CLIENTS,
            max_batch=BATCH, fallback=fallback, injector=inj)
        what = f"chaos {spec}"
        check(not errors, f"{what}: {len(errors)} failed requests "
              f"({errors[:1]})")
        exact = summary["degraded_dispatches"] == 0
        check(all(same_response("knn", res[i], clean[i], exact)
                  for i in range(QUEUE_REQUESTS)),
              f"{what}: a response differs from the fault-free run")
        check(summary["failures"] == inj.injected["exceptions"],
              f"{what}: pool failures {summary['failures']} ≠ injected "
              f"exceptions {inj.injected['exceptions']}")
        if spec == "kill:r1@5":
            check(summary["quarantines"] >= 1, f"{what}: no quarantine")
        if spec == "kill:r0@0,kill:r1@0":
            check(summary["degraded_dispatches"] > 0,
                  f"{what}: no degraded dispatch")
        print(f"  {what}: {QUEUE_REQUESTS * BATCH / dt:,.1f} q/s, 0 failed "
              f"requests, responses ≡ fault-free; injected "
              f"{dict(inj.injected)}, dispatches {dict(inj.dispatches)}; "
              f"pool failures {summary['failures']}, re-issues "
              f"{summary['reissues']}, retries {summary['retries']}, "
              f"quarantines {summary['quarantines']}, probes "
              f"{summary['probes']}, degraded "
              f"{summary['degraded_dispatches']}, health "
              f"{summary['health']}", flush=True)
    del reps
    argv, _ = queue_args()
    out = serve.main(["--mode", "knn", "--k", str(KNN_K), "--queue",
                      "--mesh", "on", "--chaos", "crash:r0@3", *argv])
    check(out["failed_requests"] == 0 and out["injected_exceptions"] == 1
          and out["failures"] == 1 and out["retries"] == 1,
          f"serve --queue --chaos crash:r0@3: {out['failed_requests']} "
          f"failed, {out['injected_exceptions']} injected, pool failures "
          f"{out['failures']}, retries {out['retries']}")
    print(f"  serve --queue --mesh on --chaos crash:r0@3: "
          f"{out['qps']:,.1f} q/s, 0 failed requests, 1 injected exception "
          f"→ 1 retry, {out['dispatches']} dispatches", flush=True)


# ---------------------------------------------------------------------------
# the paper's baselines and the D0/D2 layouts (phases 27-29)
# ---------------------------------------------------------------------------

def point_rects(n: int, seed: int, eps: float) -> np.ndarray:
    """``benchmarks/common.point_rects``: ``n`` uniform points from
    ``seed`` widened to rects of half-extent ``eps``."""
    pts = np.random.default_rng(seed).random((n, 2), dtype=np.float32)
    return np.concatenate([pts - eps, pts + eps], axis=1).astype(np.float32)


def scalar_counters(ctr) -> dict:
    """A baseline's non-zero counters among those ``BASELINE_REF`` keeps."""
    keep = ("nodes_visited", "predicates", "vector_ops", "enqueued",
            "pruned_outer", "pruned_inner", "branches", "overflow")
    return {k: int(v) for k, v in ctr.asdict().items()
            if k in keep and int(v)}


def add_into(tot: dict, part: dict) -> None:
    for k, v in part.items():
        tot[k] = tot.get(k, 0) + v


def chain_ms_per_node(torch, dev, dkern) -> float:
    """Device ms per node of kernel S walking a chain: a flat table of
    CHAIN_NODES one-child nodes (F = 1, 0.4 GB, far past the 50 MB L2),
    CHAIN_STEPS of them linked in a random order, the last a leaf.  Each
    pop waits on the node's count and then its row, both behind the
    popped id, as in a real walk: the latency model's cost of one visited
    node."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 27)
    order = torch.randperm(CHAIN_NODES, generator=g)[:CHAIN_STEPS].to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lo = torch.zeros((CHAIN_NODES, 1), **f32)
    hi = torch.ones((CHAIN_NODES, 1), **f32)
    child = torch.full((CHAIN_NODES, 1), -1, **i32)
    child[order[:-1].long(), 0] = order[1:].to(torch.int32)
    child[order[-1].long(), 0] = 0                  # the leaf's one rect
    count = torch.ones((CHAIN_NODES,), **i32)
    leaf = torch.zeros((CHAIN_NODES,), dtype=torch.bool, device=dev)
    leaf[order[-1].long()] = True
    q = torch.tensor([0.0, 0.0, 1.0, 1.0], **f32)
    rows = (lo, lo, hi, hi, child, count, leaf, q)
    kw = dict(root=int(order[0]), stack_cap=2, result_cap=1,
              max_steps=CHAIN_STEPS + 1)
    _, stats = dkern.select_dfs_scalar_cuda(*rows, **kw)
    check(stats.tolist() == [1, CHAIN_STEPS, 4 * CHAIN_STEPS, 0],
          f"the chain walk: stats {stats.tolist()}")
    # one launch runs ~0.1 s, so CUDA events time the kernel, not the
    # wrapper's host work
    ms = cuda_ms(lambda: dkern.select_dfs_scalar_cuda(*rows, **kw), 3)
    return ms / CHAIN_STEPS


def phase_baselines(torch, dev, tree, cpu_tree, queries, points, qrects,
                    d1_select):
    """Phase 27: the paper's baselines on the card.  Kernels S and V
    (``make_select_dfs``, ``make_select_dfs_vector`` over ``flatten_tree``
    on cuda) for the 64 queries ≡ their twins on a CPU copy (res, rc,
    every counter) and ``BASELINE_REF``, also with a stack of 8 and 64
    result slots (overflow), each query's sorted ids ≡ phase 4's engine;
    ms per query of S, V, the BFS engine (unfused, fused), the host
    baselines; the scalar join at ``bench_join``'s configuration ≡ the D0,
    D1 and D2 engines' pairs.  Returns (the kernels' JSON entries, their
    launches on the main path: the 64 walks of each)."""
    from repro_torch.core import flat as flatmod
    from repro_torch.core import (join_scalar, join_vector, knn_join_scalar,
                                  knn_scalar, rtree, select_scalar,
                                  select_vector)
    from repro_torch.kernels import rtree_dfs as dkern
    fl = flatmod.flatten_tree(tree)
    fl_cpu = flatmod.flatten_tree(cpu_tree)
    for f in ("lx", "ly", "hx", "hy", "child", "count", "is_leaf"):
        a, b = getattr(fl, f), getattr(fl_cpu, f)
        check(a.is_cuda and a.is_contiguous() and torch.equal(a.cpu(), b),
              f"flatten_tree on cuda: {f} differs from the CPU copy's")
    check((fl.root, fl.height) == (fl_cpu.root, fl_cpu.height), "flat root")
    print(f"  flatten_tree on {dev}: {fl.n_nodes} nodes × F {fl.fanout}, "
          f"root {fl.root}, height {fl.height} ≡ the CPU copy's", flush=True)
    qs = [queries[i] for i in range(queries.shape[0])]
    qs_cpu = [q.cpu() for q in qs]
    ids_np, counts_np = (t.cpu().numpy() for t in d1_select)
    makers = {"scalar": select_scalar.make_select_dfs,
              "vector": select_vector.make_select_dfs_vector}
    launches, fns = {}, {}
    for variant, make in makers.items():
        for stack_cap, result_cap in ((1024, RESULT_CAP), DFS_OVERFLOW):
            fn = make(fl, result_cap, stack_cap)
            twin = make(fl_cpu, result_cap, stack_cap, backend="torch")
            dkern.reset_launch_counts()
            outs = [fn(q) for q in qs]
            torch.cuda.synchronize()
            n = dkern.launch_counts()[f"select_dfs_{variant}"]
            check(n == len(qs), f"{variant} walk: {n} launches for "
                  f"{len(qs)} queries")
            if stack_cap == 1024:
                launches[variant] = n
                fns[variant] = fn
            tot = dict(rc=0, nodes_visited=0, predicates=0, overflow=0)
            for i, ((res, rc, ctr), q) in enumerate(zip(outs, qs_cpu)):
                tres, trc, tctr = twin(q)
                what = f"{variant} walk ({stack_cap}, {result_cap}) query {i}"
                assert_equal(res, tres.to(dev), f"{what} res")
                check(int(rc) == int(trc) and ctr.asdict() == tctr.asdict(),
                      f"{what}: rc {int(rc)} vs {int(trc)}, counters "
                      f"{ctr.asdict()} vs {tctr.asdict()}")
                tot["rc"] += int(rc)
                for k in ("nodes_visited", "predicates", "overflow"):
                    tot[k] += int(getattr(ctr, k))
                if stack_cap == 1024:
                    got = res[:int(rc)].cpu().numpy()
                    check(np.array_equal(np.sort(got), np.sort(
                        ids_np[i, :counts_np[i]])), f"{what}: ids differ "
                          f"from phase 4's engine")
            want = BASELINE_REF[(variant, stack_cap, result_cap)]
            check(tot == want, f"{variant} walk ({stack_cap}, "
                  f"{result_cap}): {tot}, the reference has {want}")
            print(f"  {variant} ({stack_cap}, {result_cap}): {len(qs)} "
                  f"queries ≡ twin and reference {tot}", flush=True)
    out, smi = [], smi_line()
    per_node = chain_ms_per_node(torch, dev, dkern)
    print(f"  latency model: {per_node * 1e6:.1f} ns of device time per "
          f"visited node (kernel S on a {CHAIN_STEPS}-node random chain "
          f"over {CHAIN_NODES} nodes) on {smi}", flush=True)
    nodes = BASELINE_REF[("scalar", 1024, RESULT_CAP)]["nodes_visited"]
    row_bytes = fl.fanout * 20 + 4 + 1       # 4 coords + child, count, leaf
    n_bytes = (nodes * row_bytes + len(qs) * (RESULT_CAP * 4 + 16 + 16)) \
        / len(qs)
    for variant, kernel in (("scalar", "dfs_scalar_kernel"),
                            ("vector", "dfs_vector_kernel")):
        fn = fns[variant]
        twin = makers[variant](fl_cpu, RESULT_CAP, backend="torch")
        # events first: their warm-up raises the clocks the profiled
        # window then runs at (one thread's dependent loads feel them)
        call_ms = cuda_ms(lambda: [fn(q) for q in qs], 3) / len(qs)
        ms = device_ms(lambda: [fn(q) for q in qs], (kernel, len(qs)),
                       iters=3)
        check(ms is not None, f"{variant}: the profiler saw no launch")
        ms /= len(qs)
        plain_ms = host_ms(lambda: [twin(q) for q in qs_cpu], 1,
                           warmup=0) / len(qs)
        bound_ms, bound_by = bound(n_bytes, 0)
        latency_ms = nodes / len(qs) * per_node
        print(f"  {variant} kernel: {ms:.4f} ms of device time per query "
              f"({call_ms:.4f} ms per query with the wrapper, a batch of "
              f"{len(qs)} launches / {len(qs)}), twin {plain_ms:.4f} ms; "
              f"bytes bound {bound_ms:.6f} ms, latency model "
              f"{latency_ms:.4f} ms ({nodes / len(qs):.1f} nodes a query) "
              f"on {smi}", flush=True)
        name = f"select_dfs_{variant}"
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/rtree_dfs.cu",
            replaces=("select_scalar.make_select_dfs" if variant == "scalar"
                      else "select_vector.make_select_dfs_vector")
            + " (XLA while_loop, not Pallas)",
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, max_abs_err=0,
            latency_ms=latency_ms))
    for fused in (False, True):
        bfs = select_vector.make_select_bfs(tree, result_cap=RESULT_CAP,
                                            fused=fused)
        ms = host_ms(lambda: bfs(queries), 10) / len(qs)
        print(f"  BFS engine {'fused' if fused else 'unfused'}: {ms:.4f} "
              f"ms per query (a {len(qs)}-query batch / {len(qs)}) on {smi}",
              flush=True)
    for variant in ("logical", "bitwise"):
        tot, t0 = {}, time.perf_counter()
        for q in qs_cpu[:4]:
            ids, ctr = select_scalar.select_recursive_py(cpu_tree, q,
                                                         variant)
            add_into(tot, dict(scalar_counters(ctr), ids_sum=int(ids.sum()),
                               found=len(ids)))
        ms = (time.perf_counter() - t0) * 1e3 / 4
        want = BASELINE_REF[("recursive", variant)]
        check(tot == want, f"select_recursive_py {variant}: {tot}, the "
              f"reference has {want}")
        print(f"  select_recursive_py {variant}: {ms:.3f} ms per query "
              f"(host, 4 queries) ≡ reference", flush=True)
    pts, qrects = points.cpu().numpy(), qrects.cpu().numpy()
    knn_fn = knn_scalar.make_knn_best_first(cpu_tree)
    tot, t0 = {}, time.perf_counter()
    for p in pts[:4]:
        ids, d, ctr = knn_fn(p, KNN_K)
        add_into(tot, dict(scalar_counters(ctr), **id_sums(ids, d)))
    ms = (time.perf_counter() - t0) * 1e3 / 4
    want = BASELINE_REF[("knn_best_first", KNN_K)]
    check(tot == want, f"knn_best_first: {tot}, the reference has {want}")
    print(f"  knn_best_first k={KNN_K}: {ms:.3f} ms per query (host, 4 "
          f"points) ≡ reference", flush=True)
    t0 = time.perf_counter()
    ids, d, ctr = knn_join_scalar.knn_join_best_first(cpu_tree, qrects[:4],
                                                      KNN_K)
    ms = (time.perf_counter() - t0) * 1e3 / 4
    got = dict(scalar_counters(ctr), **id_sums(ids, d))
    want = BASELINE_REF[("knn_join_best_first", KNN_K)]
    check(got == want, f"knn_join_best_first: {got}, the reference has "
          f"{want}")
    print(f"  knn_join_best_first k={KNN_K}: {ms:.3f} ms per rect (host, 4 "
          f"rects) ≡ reference", flush=True)
    phase_scalar_join(torch, dev, rtree, join_scalar, join_vector, smi)
    return out, {f"select_dfs_{v}": n for v, n in launches.items()}


def id_sums(ids, d) -> dict:
    found = ids >= 0
    return dict(ids_sum=int(ids[found].astype(np.int64).sum()),
                found=int(found.sum()),
                d_sum=float(d[found].astype(np.float64).sum()))


def phase_scalar_join(torch, dev, rtree, join_scalar, join_vector, smi):
    """Phase 27's join: ``join_recursive_py`` with O3 off and on at
    ``benchmarks/bench_join.py``'s configuration (host, CPU trees) ≡
    ``BASELINE_REF``; its pairs ≡ the D0, D1 and D2 engines' on the card;
    the time of each.  Halves n (printed) if the host join takes more
    than SCALAR_JOIN_BUDGET_S."""
    n = SCALAR_JOIN_N
    while True:
        ra, rb = (point_rects(n, s, SCALAR_JOIN_EPS) for s in (0, 1))
        cpu = [rtree.build_rtree(r, fanout=FANOUT, sort_key="lx",
                                 device="cpu") for r in (ra, rb)]
        t0 = time.perf_counter()
        pairs, ctr = join_scalar.join_recursive_py(*cpu)
        s_off = time.perf_counter() - t0
        if s_off <= SCALAR_JOIN_BUDGET_S or n < 1000:
            break
        n //= 2
        print(f"  join_recursive_py took {s_off:.1f} s: n cut to {n}",
              flush=True)
    t0 = time.perf_counter()
    pairs3, ctr3 = join_scalar.join_recursive_py(*cpu, o3=True)
    s_on = time.perf_counter() - t0
    check(np.array_equal(pairs, pairs3), "join_recursive_py: O3 changed "
          "the pairs")
    for o3, c in ((False, ctr), (True, ctr3)):
        got = dict(scalar_counters(c), pairs=len(pairs),
                   pairs_sum=int(pairs.astype(np.int64).sum()))
        if n == SCALAR_JOIN_N:
            want = BASELINE_REF[("join_recursive", o3)]
            check(got == want, f"join_recursive_py o3={o3}: {got}, the "
                  f"reference has {want}")
    print(f"  join_recursive_py (n = {n} a side, eps {SCALAR_JOIN_EPS}, "
          f"fanout {FANOUT}): {len(pairs)} pairs, O3 off {s_off:.2f} s, on "
          f"{s_on:.2f} s (host)" + (" ≡ reference" if n == SCALAR_JOIN_N
                                    else " (cut: no reference numbers)"),
          flush=True)
    cap = 1 << 16
    while cap < (n * 4 * SCALAR_JOIN_EPS) ** 2 * 4:       # bench_join's cap
        cap <<= 1
    trees = [rtree.build_rtree(r, fanout=FANOUT, sort_key="lx", device=dev)
             for r in (ra, rb)]
    for layout in ("d0", "d1", "d2"):
        fn = join_vector.make_join_bfs(*trees, layout=layout, result_cap=cap)
        got, cnt, c = fn()
        check(int(c.overflow) == 0, f"{layout} join overflowed")
        p = got[:int(cnt)].cpu().numpy().astype(np.int64)
        p = p[np.lexsort((p[:, 1], p[:, 0]))]
        check(np.array_equal(p, pairs), f"{layout} join: {len(p)} pairs "
              f"differ from join_recursive_py's {len(pairs)}")
        print(f"  {layout} engine join: ≡ join_recursive_py, "
              f"{host_ms(fn, 3):.3f} ms per join on {smi}", flush=True)


def layout_cell_check(got, ref_, caps_mode, what, steps=4) -> None:
    """A D0/D2 result's counters (all but dispatches) and occupancy
    against one ``LAYOUT_REF`` / ``LAYOUT_JOIN_REF`` cell."""
    for key, v in ref_["counters"].items():
        check(got[key] == v, f"{what}: {key} {got[key]}, the reference "
              f"has {v}")
    check(got["lanes_live"][:steps] == ref_["live"],
          f"{what}: lanes_live {got['lanes_live']}")
    if "padded" in ref_:
        padded = ref_["padded"] if caps_mode is None else \
            ref_["padded"][caps_mode]
        check(got["lanes_padded"][:steps] == padded,
              f"{what}: lanes_padded {got['lanes_padded']}")
    check(got["overflow"] == 0 or "descents" in ref_,
          f"{what}: overflow {got['overflow']}")


def timed_cell(torch, fn, what, per, iters=5) -> str:
    """ms per call of ``fn``, the device's busy share and the peak device
    memory of one call, as one line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = host_ms(fn, iters)
    prof = profile_batches(fn, iters=2, top=2)
    busy = prof.split(" of ")[0].replace("device busy ", "") \
        if prof.startswith("device busy") else "not measured"
    return (f"  {what}: {ms:.3f} ms per {per}, device busy {busy}, peak "
            f"{peak:.0f} MiB")


def phase_layout_engines(torch, tree, queries, points, qrects, fq,
                         probe_tree, part):
    """Phase 28: the D0 and D2 levels built on the card ≡ the CPU's, byte
    for byte; select, the join (centre partition), kNN, kNN-join,
    filtered kNN and browse on D0 and D2 at the sizes of phases 4, 7, 10,
    13, 20 and 21: ids, counts, overflow and distance bits ≡ the D1
    engine's (kNN as sets within ties), every counter but dispatches ≡
    ``LAYOUT_REF`` / ``LAYOUT_JOIN_REF``; ms per batch, busy share and
    peak MiB beside D1's."""
    from repro_torch.core import (join_vector, knn_browse, knn_filtered,
                                  knn_join_vector, knn_vector, layouts,
                                  rtree, select_vector)
    smi = smi_line()
    # the layouts built on the card ≡ built on the CPU, byte for byte (D0's
    # pointer column is a NaN pattern in float32)
    for lay in ("d0", "d2"):
        conv = layouts.LAYOUTS[lay].converter
        for li, lvl in enumerate(tree.levels):
            host = conv(rtree.RTreeLevel(**{f: getattr(lvl, f).cpu()
                                            for f in rtree.LEVEL_FIELDS}))
            card = conv(lvl)
            for f in ("entries",) if lay == "d0" else ("lo", "hi", "ptr"):
                a, b = getattr(card, f).cpu(), getattr(host, f)
                check(a.is_contiguous() and torch.equal(
                    a.view(torch.int32), b.view(torch.int32)),
                      f"{lay} level {li} {f}: the card's bytes differ")
    print("  D0 and D2 levels built on the card ≡ the CPU's, byte for byte",
          flush=True)
    lines = []
    for caps_mode in ("static", "adaptive"):
        fns = {lay: select_vector.make_select_bfs(
            tree, layout=lay, result_cap=RESULT_CAP, caps_mode=caps_mode)
            for lay in ("d1", "d0", "d2")}
        want = fns["d1"](queries)
        for lay in ("d0", "d2"):
            ids, counts, ctr = fns[lay](queries)
            what = f"{lay} select {caps_mode}"
            assert_equal(ids, want[0], f"{what} ids vs D1")
            assert_equal(counts, want[1], f"{what} counts vs D1")
            layout_cell_check(ctr.asdict(), LAYOUT_REF[("select", lay)],
                              caps_mode, what)
        if caps_mode == "adaptive":
            for lay, fn in fns.items():
                lines.append(timed_cell(torch, lambda: fn(queries),
                                        f"{lay} select", f"{BATCH}-query "
                                        f"batch"))
    print(f"  select: D0, D2 ≡ D1 and LAYOUT_REF (static, adaptive)",
          flush=True)
    for o34 in (False, True):
        fns = {lay: join_vector.make_join_bfs(
            probe_tree, part.tree, layout=lay, result_cap=JOIN_CAP,
            o3=o34, o4=o34) for lay in ("d1", "d0", "d2")}
        want = fns["d1"]()
        for lay in ("d0", "d2"):
            pairs, n, ctr = fns[lay]()
            what = f"{lay} join o3/o4={o34}"
            assert_equal(pairs, want[0], f"{what} pairs vs D1")
            ref_ = LAYOUT_JOIN_REF[("join", lay, o34)]
            p = pairs[:int(n)].cpu().numpy().astype(np.int64)
            check(int(n) == ref_["pairs"] and int(p.sum()) ==
                  ref_["pairs_sum"], f"{what}: {int(n)} pairs")
            layout_cell_check(ctr.asdict(), ref_, None, what, steps=3)
        if o34:
            for lay, fn in fns.items():
                lines.append(timed_cell(torch, fn, f"{lay} join (O3/O4)",
                                        "join", iters=3))
    n_pairs = LAYOUT_JOIN_REF[("join", "d0", True)]["pairs"]
    print(f"  join: D0, D2 ≡ D1 ({n_pairs} pairs) and LAYOUT_JOIN_REF "
          f"(O3/O4 off, on)", flush=True)
    ops = (("knn", knn_vector.make_knn_bfs, points),
           ("knn_join", knn_join_vector.make_knn_join_bfs, qrects),
           ("knn_filtered", knn_filtered.make_knn_filtered_bfs, fq))
    for op, make, q in ops:
        for k in (KNN_K, 64):
            for caps_mode in ("static", "adaptive"):
                fns = {lay: make(tree, k, layout=lay, caps_mode=caps_mode)
                       for lay in ("d1", "d0", "d2")}
                wi, wd, _ = fns["d1"](q)
                wi, wd = wi.cpu().numpy(), wd.cpu().numpy()
                for lay in ("d0", "d2"):
                    ids, d, ctr = fns[lay](q)
                    what = f"{lay} {op} k={k} {caps_mode}"
                    ids, d = ids.cpu().numpy(), d.cpu().numpy()
                    check(same_neighbours(ids, d, wi, wd),
                          f"{what}: results differ from D1's")
                    ref_ = LAYOUT_REF[(op, lay, k)]
                    layout_cell_check(ctr.asdict(), ref_, caps_mode, what)
                    check(id_sums(ids, d) == {x: ref_[x] for x in
                                              ("ids_sum", "found", "d_sum")},
                          f"{what}: sums {id_sums(ids, d)}")
                if k == KNN_K and caps_mode == "adaptive":
                    for lay, fn in fns.items():
                        lines.append(timed_cell(
                            torch, lambda: fn(q), f"{lay} {op} k={k}",
                            f"{BATCH}-query batch"))
        print(f"  {op}: D0, D2 ≡ D1 and LAYOUT_REF (k 8, 64; static, "
              f"adaptive)", flush=True)
    starts = {lay: knn_browse.make_browse_bfs(tree, KNN_K, layout=lay)
              for lay in ("d1", "d0", "d2")}
    for steps in (BROWSE_STEPS, BROWSE_DEEP):
        _, wi, wd = browse_session(starts["d1"], points, steps)
        for lay in ("d0", "d2"):
            cur, ids, d = browse_session(starts[lay], points, steps)
            what = f"{lay} browse {steps} steps"
            check(same_neighbours(ids, d, wi, wd),
                  f"{what}: results differ from D1's")
            ref_ = LAYOUT_REF[("browse", lay, steps)]
            st = cur.state
            layout_cell_check(st.ctr.asdict(), ref_, None, what)
            check(int(st.descents) == ref_["descents"] and
                  int(st.overflow.sum()) == ref_["overflow"] and
                  id_sums(ids, d) == {x: ref_[x] for x in
                                      ("ids_sum", "found", "d_sum")},
                  f"{what}: descents {int(st.descents)}, sums "
                  f"{id_sums(ids, d)}")
    for lay, start in starts.items():
        lines.append(timed_cell(
            torch, lambda: browse_session(start, points, BROWSE_STEPS),
            f"{lay} browse", f"{BROWSE_STEPS}-step session", iters=3))
    print(f"  browse: D0, D2 ≡ D1 and LAYOUT_REF ({BROWSE_STEPS} and "
          f"{BROWSE_DEEP} steps)", flush=True)
    print(f"  on {smi}:", flush=True)
    for line in lines:
        print(line, flush=True)


def phase_layout_serve(torch, dev, serve):
    """Phase 29: ``serve --layout d0|d2`` at 2M points for spatial, kNN
    and the join on the host path and kNN with ``--mesh on``: nothing
    overflows, the first batch ≡ brute force, q/s."""
    from repro_torch.core.geometry import brute_force_select
    smi = smi_line()
    rects = serve.make_rects(N_RECTS, SEED)
    qs = serve.make_queries(LAYOUT_SERVE_BATCHES, BATCH, SELECTIVITY,
                            SEED + 1)[0]
    knn_in = serve.make_knn_inputs(N_RECTS, SEED, LAYOUT_SERVE_BATCHES,
                                   BATCH)
    join_in = serve.make_join_inputs(N_RECTS, SEED, QUERY_EPS)
    for lay in ("d0", "d2"):
        common = ["--layout", lay, "--n", str(N_RECTS), "--batches",
                  str(LAYOUT_SERVE_BATCHES), "--batch-size", str(BATCH)]
        out = serve.main(["--mode", "spatial", "--partitions", "8",
                          "--fanout", str(FANOUT), *common])
        check(not out["overflow"], f"{lay} spatial serve overflowed")
        for i, (got, q) in enumerate(zip(out["first_batch"], qs)):
            check(np.array_equal(got, brute_force_select(rects, q)),
                  f"{lay} served query {i} differs from brute force")
        print(f"  {lay} spatial (host path): {out['qps']:,.1f} q/s, first "
              f"batch ≡ brute force, on {smi}", flush=True)
        for mesh in ("off", "on"):
            out = serve.main(["--mode", "knn", "--k", str(KNN_K), "--mesh",
                              mesh, *common])
            check(not out["overflow"], f"{lay} knn serve overflowed")
            ids, d = out["first_batch"]
            check_knn_brute_force(torch, dev, knn_in[0], knn_in[1][0], ids,
                                  d, f"{lay} knn serve --mesh {mesh}")
            print(f"  {lay} knn --mesh {mesh}: {out['qps']:,.1f} q/s, "
                  f"first batch ≡ brute force, on {smi}", flush=True)
        out = serve.main(["--mode", "join", "--layout", lay, "--n",
                          str(N_RECTS), "--join-cap", str(JOIN_CAP),
                          "--query-eps", str(QUERY_EPS), "--batches", "1"])
        check(not out["overflow"], f"{lay} join serve overflowed")
        sample_probes_equal_brute_force(torch, dev, out["last_pairs"],
                                        join_in[1], join_in[0],
                                        f"{lay} join serve")
        print(f"  {lay} join (host path): {out['joins_per_s']:.3f} joins/s, "
              f"{len(out['last_pairs'])} pairs, 256 sampled probes ≡ brute "
              f"force, on {smi}", flush=True)


def sorted_pairs(pairs, n) -> np.ndarray:
    """A join's first ``n`` (K, 2) pairs as int64 on the host, sorted."""
    p = pairs[:int(n)].cpu().numpy().astype(np.int64)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


def phase_d3_join_engine(torch, probe_tree, part, probes, join_vector):
    """Phase 30: the D3 join of the centre partition (PyTorch tile over
    the dequantized boxes, the exact rects at the leaf; no kernel in
    either package) in {O3/O4 off, on} × {static, adaptive}: the sorted
    pairs ≡ D1's, overflow and every counter but dispatches ≡
    ``D3_JOIN_REF``; 256 sampled probes ≡ brute force; live pairs a level,
    ms per join, busy share and peak MiB beside D1's; the kernel backend
    and the fused build raise."""
    smi = smi_line()
    lines = []
    for o34 in (False, True):
        kw = dict(result_cap=JOIN_CAP, o3=o34, o4=o34)
        d1_fn = join_vector.make_join_bfs(probe_tree, part.tree, **kw)
        p1, n1, c1 = d1_fn()
        want = sorted_pairs(p1, n1)
        ref_ = D3_JOIN_REF[("join", "d3", o34)]
        for caps_mode in ("static", "adaptive"):
            what = f"d3 join o3/o4={'on' if o34 else 'off'} {caps_mode}"
            fn = join_vector.make_join_bfs(probe_tree, part.tree,
                                           layout="d3", caps_mode=caps_mode,
                                           **kw)
            pairs, n, ctr = fn()
            check(pairs.device.type == "cuda", f"{what}: pairs on "
                  f"{pairs.device}")
            got = sorted_pairs(pairs, n)
            check(np.array_equal(got, want), f"{what}: {len(got)} pairs "
                  f"differ from D1's {len(want)}")
            check(int(n) == ref_["pairs"] and int(got.sum()) ==
                  ref_["pairs_sum"], f"{what}: {int(n)} pairs, the "
                  f"reference has {ref_['pairs']}")
            layout_cell_check(ctr.asdict(), ref_, None, what, steps=3)
        print(f"  o3/o4={'on' if o34 else 'off'}: D3 ≡ D1 ({int(n)} pairs) "
              f"and D3_JOIN_REF (static, adaptive); live pairs a level D3 "
              f"{ctr.asdict()['lanes_live'][:3]}, D1 "
              f"{c1.asdict()['lanes_live'][:3]}", flush=True)
        if o34:
            lines.append(timed_cell(torch, d1_fn, "d1 join (O3/O4)", "join",
                                    iters=3))
            lines.append(timed_cell(torch, fn, "d3 join (O3/O4)", "join",
                                    iters=3))
    sample_probes_equal_brute_force(
        torch, part.tree.device, sorted_pairs(pairs, n), probes,
        part.tree.rects.cpu().numpy(), "d3 join engine")
    print("  256 sampled probes ≡ brute force over the partition's rects",
          flush=True)
    for bad in (dict(backend="cuda"), dict(fused=True)):
        try:
            join_vector.make_join_bfs(probe_tree, part.tree, layout="d3",
                                      **bad)
        except ValueError:
            continue
        fail(f"d3 join with {bad} did not raise ValueError")
    print("  backend='cuda' and fused=True raise ValueError (no D3 join "
          f"kernel); on {smi}:", flush=True)
    for line in lines:
        print(line, flush=True)


def phase_d3_join_serve(torch, dev, serve):
    """Phase 31: ``serve --mode join --layout d3`` at 2M points on the
    host path and the mesh path (one card's mesh): nothing overflows, 256
    sampled probes ≡ brute force; joins/s and the host merge's share."""
    smi = smi_line()
    rects, probes = serve.make_join_inputs(N_RECTS, SEED, QUERY_EPS)
    for mesh in ("off", "on"):
        out = serve.main(["--mode", "join", "--layout", "d3", "--mesh", mesh,
                          "--n", str(N_RECTS), "--join-cap", str(JOIN_CAP),
                          "--query-eps", str(QUERY_EPS), "--batches",
                          str(D3_SERVE_BATCHES)])
        check(not out["overflow"], f"d3 join serve --mesh {mesh} overflowed")
        sample_probes_equal_brute_force(torch, dev, out["last_pairs"],
                                        probes, rects,
                                        f"d3 join serve --mesh {mesh}")
        share = out["merge_s"] * out["joins_per_s"] / D3_SERVE_BATCHES
        print(f"  d3 join --mesh {mesh}: {out['joins_per_s']:.3f} joins/s, "
              f"{len(out['last_pairs'])} pairs, host merge {share:.1%}, 256 "
              f"sampled probes ≡ brute force, on {smi}", flush=True)


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def lm_batch(torch, cfg, batch: int, prompt: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, prompt), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).to(dev)}


def lm_steps(torch, model, params, batch, n_new, feed=None):
    """Prefill and ``n_new - 1`` decode steps → (tokens (B, n_new), logits
    (B, n_new, V) float32): each step's argmax, fed back (greedy) or, with
    ``feed`` (B, n_new), those tokens (teacher forcing)."""
    s = batch["tokens"].shape[1]
    cache, last, pos = model.prefill(params, batch, max_len=s + n_new)
    logits, toks = [last], [last.argmax(dim=-1).to(torch.int32)]
    for i in range(n_new - 1):
        tok = toks[-1] if feed is None else feed[:, i]
        lg, cache = model.decode(params, cache, tok, pos + i)
        logits.append(lg)
        toks.append(lg.argmax(dim=-1).to(torch.int32))
    return torch.stack(toks, dim=1), torch.stack(logits, dim=1)


def teacher_forced(torch, model, params, tokens, prompt, chunk):
    """The full forward's logits (B, S - prompt + 1, V) float32 at the
    positions from ``prompt - 1`` on, ``chunk`` sequences at a time (each
    sequence's logits depend on it alone: the MoE runs dropless here)."""
    from repro_torch.models import transformer
    out = []
    with torch.no_grad():
        for b0 in range(0, tokens.shape[0], chunk):
            x, _ = model._embed_batch(params,
                                      {"tokens": tokens[b0:b0 + chunk]})
            pos = torch.arange(x.shape[1], dtype=torch.int32,
                               device=x.device).expand(x.shape[0], -1)
            h, _, _ = transformer.forward(model.cfg, params, x, pos)
            out.append(model.logits(params, h[:, prompt - 1:]).float())
    return torch.cat(out)


def moe_routes(torch, params):
    """Forward hooks on each MoE layer's ``moe``: the experts ``moe_ffn``
    routed each token to → ({layer: [(T, k) sorted expert ids, a call
    each]}, remove)."""
    from repro_torch.models.transformer import MoEBlock
    routes = {}
    hooks = [blk.moe.register_forward_hook(
        lambda m, a, out, li=li: routes.setdefault(li, []).append(
            out[1].gate_idx.sort(dim=-1).values))
        for li, blk in enumerate(params.blocks) if isinstance(blk, MoEBlock)]

    def remove():
        for h in hooks:
            h.remove()

    return routes, remove


def teacher_forced_check(torch, model, params, batch, n_new, tol, chunk,
                         min_keep, what):
    """Greedy decode's logits against a teacher-forced full forward over
    the same tokens (``chunk`` sequences at a time) at each new position:
    every logit finite, the relative error within ``tol``.  MoE: a token
    whose experts differ between decode and forward in some layer is a
    routing flip, and a position is held only in the sequences that have
    not flipped at it or before it (a flipped token's K and V reach the
    later positions); at least ``min_keep`` sequences must stay at every
    position.  → the largest error held."""
    b, prompt = batch["tokens"].shape
    k = model.cfg.top_k
    routes, remove = moe_routes(torch, params)
    toks, logits = lm_steps(torch, model, params, batch, n_new)
    check(bool(torch.isfinite(logits).all()), f"{what}: non-finite logits")
    dec = {li: torch.cat([r.reshape(b, -1, k) for r in rs], dim=1)
           for li, rs in routes.items()}
    routes.clear()
    full = torch.cat([batch["tokens"], toks[:, :-1]], dim=1)
    ref = teacher_forced(torch, model, params, full, prompt, chunk)
    remove()
    keep, flips = torch.ones_like(toks, dtype=torch.bool), ""
    if dec:
        s = full.shape[1]
        flip = torch.stack([(dec[li] != torch.cat(
            [r.reshape(-1, s, k) for r in rs])).any(dim=-1)
            for li, rs in routes.items()])               # (layers, B, S)
        after = flip.any(dim=0).cumsum(dim=1) > 0
        keep = ~after[:, prompt - 1:]
        every = max(rel_err(torch, logits[:, i], ref[:, i])
                    for i in range(n_new))
        flips = (f"; routing flips (a token whose experts differ between "
                 f"decode and forward, summed over {len(dec)} MoE layers) "
                 f"{int(flip.sum())} of {flip.numel()}, in "
                 f"{int(after.any(dim=1).sum())} of {b} sequences; every "
                 f"position: {every:.3e}; the bound holds the "
                 f"{int(keep.sum())} of {keep.numel()} positions before "
                 f"their sequence's first flip, at least "
                 f"{int(keep.sum(dim=0).min())} of {b} sequences a position")
    kept = int(keep.sum(dim=0).min())
    check(kept >= min_keep, f"{what}: routing flips leave {kept} of {b} "
          f"sequences at a new position (at least {min_keep})")
    errs = [rel_err(torch, logits[keep[:, i], i], ref[keep[:, i], i])
            for i in range(n_new)]
    same = float((toks == ref.argmax(dim=-1)).float().mean())
    print(f"  {what}: decode logits against the teacher-forced forward, "
          f"relative error {min(errs):.3e}-{max(errs):.3e} over {n_new} "
          f"positions (bound {tol}); argmax agreement {same:.4f}{flips}",
          flush=True)
    check(max(errs) <= tol, f"{what}: decode logits differ from the "
          f"teacher-forced forward by {max(errs):.3e} > {tol}")
    return max(errs)


def cache_traffic(cache):
    """(bytes read, bytes written) by a decode step of ``cache``: KV caches
    read whole (one slot written: not counted); SSM states read and
    written whole."""
    def nbytes(t):
        return t.numel() * t.element_size()

    if isinstance(cache, dict):
        kv = nbytes(cache["k"]) + nbytes(cache["v"])
        states = [t for key in ("mamba", "tail") if cache.get(key) is not None
                  for t in cache[key]]
    else:
        kv, states = 0, list(cache)
    st = sum(nbytes(t) for t in states)
    return kv + st, st


def device_step(torch, fn, iters: int = 10, host_ops: bool = True):
    """(device ms, device items, busy share) per call of ``fn``: every
    device item torch.profiler records over ``iters`` calls, against the
    host-clock window.  ``host_ops=False`` records the device alone: a
    training step's ~300,000 host ops take the profiler tens of seconds
    to list."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    check(us, "the profiler saw no device item")
    return sum(us) / iters / 1e3, len(us) / iters, sum(us) / wall_us


def copy_rate(torch, dev, n_bytes: int = 1 << 30) -> float:
    """Bytes/s of a device-to-device copy of ``n_bytes`` (read + write),
    CUDA events: the card's own memory rate as PyTorch reaches it."""
    a = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    ms = cuda_ms(lambda: b.copy_(a), 10)
    return 2 * n_bytes / (ms / 1e3)


def phase_lm_bf16(torch, dev, cfg, batch_size, prompt, n_new, tol,
                  tf_chunk=None):
    """Phase 32(a), and 34-37(a): the LM at ``cfg``'s widths in bfloat16
    on the card: weights from the seed, ``generate`` (tok/s, peak MiB), its
    tokens ≡ prefill + decode's, every logit finite and within ``tol``
    (relative) of a teacher-forced full forward at each new position (run
    ``tf_chunk`` sequences at a time); prefill ms; a decode step's device
    ms beside its bytes bound (weights read once, KV caches read, SSM
    states read and written), its device items and the busy share.

    MoE: ``generate`` runs the published capacity, whose prefill drops
    pairs (its dropped share printed by layer); decode is dropless, so the
    teacher-forced check runs on a dropless copy of the config, with the
    tokens whose routed experts differ between decode and forward counted
    (flips: bf16 near-ties of the router) and the bound held at the
    positions before their sequence's first flip; the bytes bound is
    printed for every expert's weights (what the dropless one-hot einsum
    reads) and for the routed experts' only."""
    import dataclasses
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.serve.serve_step import generate
    smi = smi_line()
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    torch.cuda.synchronize()
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"  {cfg.name} {cfg.dtype}: {transformer.param_count(params):,} "
          f"parameters ({w_bytes / 1e9:.3f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    batch = lm_batch(torch, cfg, batch_size, prompt, SEED, dev)
    generate(model, params, batch, n_new)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = generate(model, params, batch, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(out.device.type == "cuda" and out.shape == (batch_size, n_new),
          f"generate: {tuple(out.shape)} on {out.device}")
    toks, logits = lm_steps(torch, model, params, batch, n_new)
    check(torch.equal(toks, out), "generate's tokens differ from prefill "
          "+ decode's")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    del logits
    moe = cfg.family == "moe"
    check_model = model
    if moe:
        seen = []
        hooks = [blk.register_forward_hook(
            lambda m, a, o: seen.append(float(o[3].dropped_frac)))
            for blk in params.blocks if isinstance(blk, transformer.MoEBlock)]
        model.prefill(params, batch, max_len=prompt + n_new)
        for hk in hooks:
            hk.remove()
        print(f"  published capacity {cfg.moe_capacity}: the prefill drops "
              f"{', '.join(f'{d:.4f}' for d in seen)} of its (token, "
              f"choice) pairs by MoE layer; the teacher-forced check runs a "
              f"dropless copy (moe_capacity {float(cfg.n_experts)})",
              flush=True)
        check_model = Model(dataclasses.replace(
            cfg, moe_capacity=float(cfg.n_experts)))
    err = teacher_forced_check(torch, check_model, params, batch, n_new, tol,
                               tf_chunk or batch_size, 1,
                               f"{cfg.dtype} {cfg.n_layers} layers")
    prefill_ms = host_ms(lambda: model.prefill(
        params, batch, max_len=prompt + n_new), LM_PREFILL_ITERS)
    cut_s = (5 - LM_PREFILL_ITERS) * prefill_ms
    dropless = ""
    if moe:
        dropless = host_ms(lambda: check_model.prefill(
            params, batch, max_len=prompt + n_new), LM_PREFILL_ITERS)
        cut_s += (5 - LM_PREFILL_ITERS) * dropless
        dropless = f" (the dropless copy's {dropless:.3f} ms)"
    cache, _, p0 = model.prefill(params, batch, max_len=prompt + n_new)
    last = p0 + n_new - 2

    def step():
        return model.decode(params, cache, out[:, -2], last)

    dev_ms, items, busy = device_step(torch, step, LM_PROFILE_ITERS)
    step_ms = host_ms(step, LM_STEP_ITERS)
    # cut (c): the profiled steps (each a window of dev_ms / busy) and the
    # host-clock steps these counts no longer run
    cut_s += (10 - LM_PROFILE_ITERS) * dev_ms / busy + \
        (20 - LM_STEP_ITERS) * step_ms
    c_read, c_written = cache_traffic(cache)
    read = w_bytes - params.embed.numel() * params.embed.element_size() \
        + batch_size * cfg.d_model * params.embed.element_size()
    written = batch_size * cfg.vocab * 4 + c_written
    bound_ms = (read + c_read + written) / HBM_BYTES_PER_S * 1e3
    routed = ""
    if moe:
        routes, remove = moe_routes(torch, params)
        step()
        remove()
        experts = [int(r[0].unique().numel()) for r in routes.values()]
        blk = next(b for b in params.blocks
                   if isinstance(b, transformer.MoEBlock))
        per_expert = 3 * cfg.d_model * cfg.d_ff * blk.w_gate.element_size()
        unrouted = sum(cfg.n_experts - n for n in experts) * per_expert
        routed_ms = (read - unrouted + c_read + written) / \
            HBM_BYTES_PER_S * 1e3
        routed = (f"; the routed experts' only ({experts} of "
                  f"{cfg.n_experts} by MoE layer): {routed_ms:.3f} ms")
    rate = copy_rate(torch, dev)
    print(f"  on {smi}: {batch_size} seqs × {n_new} new tokens in "
          f"{gen_s:.3f} s → {batch_size * n_new / gen_s:,.0f} tok/s, peak "
          f"{peak:,.0f} MiB; prefill ({batch_size} × {prompt}) "
          f"{prefill_ms:.3f} ms{dropless}; a decode step {step_ms:.3f} ms "
          f"(host clock), {dev_ms:.3f} ms of device time in {items:.0f} "
          f"device items, busy {busy:.1%} under the profiler; bytes bound "
          f"{bound_ms:.3f} ms ({(read + c_read) / 1e9:.3f} GB of weights "
          f"and caches read, {written / 1e6:.1f} MB of logits and states "
          f"written, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, the H100 SXM "
          f"data sheet; a device copy here moves {rate / 1e12:.2f} TB/s)"
          f"{routed}", flush=True)
    return dict(tok_s=batch_size * n_new / gen_s, prefill_ms=prefill_ms,
                step_ms=step_ms, dev_ms=dev_ms, bound_ms=bound_ms, busy=busy,
                peak=peak, err=err, cut_s=cut_s / 1e3)


def tf32_off(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32 and
          torch.get_float32_matmul_precision() == "highest",
          "TF32 is on for float32 products")


def phase_lm_tf(torch, dev, cfg, batch_size, seed, tol, chunk, min_keep):
    """Phases 34-37(c) and (d): weights and ``batch_size`` prompts from
    ``seed`` at ``cfg``'s widths, depth and dtype (float32: TF32 off), and
    the teacher-forced check alone: with (a) it tells bfloat16's rounding
    over the depth from a fault of the decode path."""
    from repro_torch.models.model import Model
    if cfg.dtype == "float32":
        tf32_off(torch)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    batch = lm_batch(torch, cfg, batch_size, LM_PROMPT, seed, dev)
    return teacher_forced_check(
        torch, model, params, batch, LM_NEW, tol, chunk, min_keep,
        f"{cfg.dtype} {cfg.n_layers} layers, {batch_size} × {LM_PROMPT}, "
        f"seed {seed}")


def phase_lm_f32(torch, dev, cfg, batch_size, prompt, n_new, tol):
    """Phase 32(b): the same widths in float32 on the card against the
    same weights on the CPU, TF32 off: greedy tokens equal, and every
    step's logits (the CPU fed the card's tokens) within ``tol``."""
    import dataclasses
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    tf32_off(torch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 1), device=dev)
    host = transformer.Transformer(cfg, "cpu")
    host.load_state_dict(params.state_dict())
    batch = lm_batch(torch, cfg, batch_size, prompt, SEED + 1, dev)
    t0 = time.perf_counter()
    toks, logits = lm_steps(torch, model, params, batch, n_new)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    htoks, hlogits = lm_steps(torch, model, host,
                              {"tokens": batch["tokens"].cpu()}, n_new,
                              feed=toks.cpu())
    host_s = time.perf_counter() - t0
    errs = [rel_err(torch, logits[:, i], hlogits[:, i])
            for i in range(n_new)]
    print(f"  float32 {cfg.name} ({batch_size} × {prompt}, {n_new} new): "
          f"card against CPU, relative error {min(errs):.3e}-"
          f"{max(errs):.3e} (bound {tol}); card {card_s:.2f} s, CPU "
          f"{host_s:.2f} s", flush=True)
    check(max(errs) <= tol, f"float32 logits: card and CPU differ by "
          f"{max(errs):.3e} > {tol}")
    check(torch.equal(htoks, toks.cpu()), "float32 greedy tokens: the CPU "
          "and the card differ")
    print("  greedy tokens equal (the CPU's argmax at every step fed the "
          "card's tokens)", flush=True)


def lm_widths(cfg, layers_of: int) -> str:
    """The widths phases 34-37 print for ``cfg`` (``layers_of``: the
    published depth)."""
    depth = f"{cfg.n_layers} of {layers_of} layers" \
        if cfg.n_layers < layers_of else f"{cfg.n_layers} layers"
    if cfg.family == "ssm":
        return (f"{depth}, d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
                f"state {cfg.ssm_state}, conv {cfg.conv_width}, vocab "
                f"{cfg.vocab}")
    if cfg.family == "hybrid":
        units, tail = divmod(cfg.n_layers, cfg.attn_every)
        return (f"{depth} of Mamba2 in {units} units of {cfg.attn_every} "
                f"and a tail of {tail}, d_model {cfg.d_model}, "
                f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
                f"{cfg.ssm_state}; the shared block {cfg.n_heads} heads, "
                f"d_ff {cfg.d_ff}, {units} applications; vocab {cfg.vocab}")
    return (f"{depth}, d_model {cfg.d_model}, {cfg.n_heads} heads, "
            f"{cfg.n_kv} KV heads, {cfg.n_experts} experts of d_ff "
            f"{cfg.d_ff}, top-{cfg.top_k}, MoE every {cfg.moe_every}, vocab "
            f"{cfg.vocab}")


def phase_lm_serve(serve):
    """Phase 33: ``serve --mode lm`` on cuda (the default): tok/s; its
    tokens ≡ the same command's on the CPU."""
    smi = smi_line()
    out = serve.main(["--mode", "lm"])
    ref_ = serve.main(["--mode", "lm", "--device", "cpu"])
    check(out["tokens"].shape == (64, 16) and
          np.array_equal(out["tokens"], ref_["tokens"]),
          "serve --mode lm: the card's tokens differ from the CPU's")
    print(f"  serve --mode lm: {out['tok_per_s']:,.0f} tok/s on {smi} "
          f"(CPU {ref_['tok_per_s']:,.0f}); tokens ≡ the CPU's", flush=True)
    return out["tok_per_s"]


def train_batch(torch, pipe, step: int, dev):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in pipe.batch_at(step).items()}


def phase_train(torch, dev, cfg, batch_size, seq, steps):
    """Phase 38: ``steps`` train steps of ``cfg`` (bfloat16, AdamW, remat)
    on the card from the seed's weights: finite losses and grad norms,
    the last 5 steps' mean loss below the first 5's; tok/s, host ms a
    step, device ms and busy share (the last two steps under
    torch.profiler), peak MiB and the FLOP share."""
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.train import data, optimizer, train_step
    smi = smi_line()
    model = Model(cfg)
    oc = optimizer.OptConfig(warmup_steps=TRAIN_WARMUP, total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, _ = train_step.init_train_state(
        model, oc, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    n_params = transformer.param_count(params)
    step_fn = train_step.make_train_step(model, oc)
    pipe = data.SyntheticLM(cfg.vocab, seq, batch_size, seed=SEED)
    state = {"step": 0, "params": params, "opt": opt_state}
    losses, norms, secs = [], [], []

    def one_step():
        b = train_batch(torch, pipe, state["step"], dev)
        state["params"], state["opt"], _, m = step_fn(
            state["params"], state["opt"], None, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        state["step"] += 1

    for _ in range(steps - 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    dev_ms, items, busy = device_step(torch, one_step, iters=1,
                                      host_ops=False)
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses}, {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"the loss did not fall: first 5 steps {first:.4f},"
          f" last 5 {last:.4f}")
    step_s = float(np.median(secs[2:]))
    tokens = batch_size * seq
    flops = (6 * n_params + 12 * cfg.n_layers * cfg.n_heads * cfg.hd *
             seq) * tokens
    print(f"  {n_params:,} parameters, {batch_size} × {seq} tokens a step; "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f} (first 5 steps' mean "
          f"{first:.4f}, last 5 {last:.4f}), grad norm {norms[0]:.3f} → "
          f"{norms[-1]:.3f}", flush=True)
    print(f"  on {smi}: {tokens / step_s:,.0f} tok/s; a step "
          f"{step_s * 1e3:,.1f} ms host clock (median of steps 3-"
          f"{steps - 2}; first "
          f"{secs[0] * 1e3:,.1f} ms), {dev_ms:,.1f} ms of device time in "
          f"{items:,.0f} device items, busy {busy:.1%} under the profiler; "
          f"peak {peak:,.0f} MiB; 6·N·T + 12·L·H·hd·S·T = "
          f"{flops / 1e12:.1f} TFLOP a step, "
          f"{flops / step_s / BF16_PEAK_FLOPS:.1%} of the "
          f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 dense peak", flush=True)
    del state, params, opt_state
    return dict(tok_s=tokens / step_s, step_ms=step_s * 1e3, dev_ms=dev_ms,
                busy=busy, peak=peak)


def dense_attention(torch, q, k, v):
    """Causal softmax attention over whole (S × S) scores, float32: the
    plain form the flash blocks compute."""
    rep = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    n = q.shape[1]
    causal = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def phase_flash_bwd(torch, dev, cfg, batch_size, seq, tol):
    """Phase 39: the flash forward and backward at phase 38's shapes in
    float32 (TF32 off) against autograd through ``dense_attention``, one
    sequence at a time; ms (CUDA events) of the backward (float32;
    bfloat16 forward and backward) and of the dense reference's."""
    from repro_torch.models.layers import flash_attention
    tf32_off(torch)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    shapes = [(batch_size, seq, n, cfg.hd)
              for n in (cfg.n_heads, cfg.n_kv, cfg.n_kv, cfg.n_heads)]
    q, k, v, do = (torch.randn(sh, generator=g, device=dev) for sh in shapes)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, window=cfg.window)
    got = (out,) + torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    diff, peak = [0.0] * 4, [0.0] * 4
    for b in range(batch_size):
        qb, kb, vb = (t[b:b + 1].detach().requires_grad_() for t in (q, k, v))
        ref_out = dense_attention(torch, qb, kb, vb)
        want = (ref_out,) + torch.autograd.grad(ref_out, (qb, kb, vb),
                                                do[b:b + 1])
        with torch.no_grad():
            for i, (a, w) in enumerate(zip(got, want)):
                diff[i] = max(diff[i], float((a[b:b + 1] - w).abs().max()))
                peak[i] = max(peak[i], float(w.abs().max()))
        del ref_out, want
    errs = [d / p for d, p in zip(diff, peak)]
    names = ("out", "dq", "dk", "dv")
    print("  float32 flash against dense autograd, relative: " + ", ".join(
        f"{n} {e:.3e}" for n, e in zip(names, errs)) + f" (bound {tol})",
        flush=True)
    check(max(errs) <= tol, f"flash backward: {dict(zip(names, errs))}")
    bwd32 = cuda_ms(lambda: torch.autograd.grad(
        out, (q, k, v), do, retain_graph=True), 3)
    qb, kb, vb = (t[:1].detach().requires_grad_() for t in (q, k, v))
    ref_out = dense_attention(torch, qb, kb, vb)
    dense_ms = cuda_ms(lambda: torch.autograd.grad(
        ref_out, (qb, kb, vb), do[:1], retain_graph=True), 3)
    del out, got, ref_out
    q16, k16, v16 = (t.detach().bfloat16().requires_grad_()
                     for t in (q, k, v))
    out16 = flash_attention(q16, k16, v16, window=cfg.window)
    do16 = do.bfloat16()
    fwd16 = cuda_ms(lambda: flash_attention(
        q16, k16, v16, window=cfg.window), 3)
    bwd16 = cuda_ms(lambda: torch.autograd.grad(
        out16, (q16, k16, v16), do16, retain_graph=True), 3)
    print(f"  ms (CUDA events) at {batch_size} × {seq}, {cfg.n_heads} heads "
          f"over {cfg.n_kv} KV heads of {cfg.hd}, one layer: flash backward "
          f"{bwd32:.1f} (float32), bfloat16 forward {fwd16:.1f} and backward"
          f" {bwd16:.1f}; dense float32 autograd backward {dense_ms:.1f} for "
          f"one of the {batch_size} sequences, on {smi_line()}", flush=True)
    return dict(err=max(errs), bwd32_ms=bwd32, fwd16_ms=fwd16,
                bwd16_ms=bwd16, dense_ms=dense_ms)


def leaf_errors(torch, a_leaves, b_leaves, values=None) -> float:
    """The largest per-leaf ||a - b|| / ||b|| of two ``leaf_map``s'
    parameters, or of ``values`` (a pair of per-leaf tensor lists)."""
    from repro_torch.models import transformer
    a_vals, b_vals = values or ([la.params for la in a_leaves],
                                [lb.params for lb in b_leaves])
    worst = 0.0
    for la, lb, va, vb in zip(a_leaves, b_leaves, a_vals, b_vals):
        a = transformer.stack(la, va).detach().double().cpu()
        b = transformer.stack(lb, vb).detach().double()
        worst = max(worst, float((a - b).norm() /
                                 b.norm().clamp(min=1e-300)))
    return worst


def phase_train_f32(torch, dev, archs, tol, steps=2):
    """Phase 40: each reduced config in float32 on the card and on the CPU
    from the same weights and batches, TF32 off: the first batch's loss
    and grads, then ``steps`` steps of AdamW and of Adafactor over 2
    microbatches."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.train import data, optimizer, train_step
    tf32_off(torch)
    for arch in archs:
        cfg = registry.reduced_config(registry.get(arch))
        model = Model(cfg)
        p0 = cfg.frontend_tokens if cfg.frontend != "none" else 0
        pipe = data.SyntheticLM(cfg.vocab, 32, 4, seed=SEED,
                                frontend_tokens=p0, d_model=cfg.d_model)
        t0, line, grads = time.time(), [], []
        for where in (dev, "cpu"):
            params = model.init_params(torch.Generator().manual_seed(SEED),
                                       device=where)
            leaves = transformer.leaf_map(cfg, params)
            loss, _ = model.loss_fn(params, train_batch(torch, pipe, 0,
                                                        where))
            flat = iter(torch.autograd.grad(
                loss, [p for leaf in leaves for p in leaf.params]))
            grads.append((float(loss.detach()), leaves,
                          [[next(flat) for _ in leaf.params]
                           for leaf in leaves]))
        (card_loss, card_leaves, card_g), (host_loss, host_leaves,
                                           host_g) = grads
        loss_err = abs(card_loss - host_loss) / abs(host_loss)
        grad_err = leaf_errors(torch, card_leaves, host_leaves,
                               (card_g, host_g))
        check(loss_err <= tol and grad_err <= tol,
              f"{arch}: card against CPU, loss {loss_err:.3e}, grads "
              f"{grad_err:.3e} (bound {tol})")
        line.append(f"loss {loss_err:.2e}, grads {grad_err:.2e}")
        for kind in ("adamw", "adafactor"):
            oc = optimizer.OptConfig(kind=kind, lr=1e-2, warmup_steps=1,
                                     total_steps=10, eps=TRAIN_ADAM_EPS)
            step_fn = train_step.make_train_step(model, oc, microbatches=2)
            runs = []
            for where in (dev, "cpu"):
                params = model.init_params(
                    torch.Generator().manual_seed(SEED), device=where)
                leaves = transformer.leaf_map(cfg, params)
                opt_state = optimizer.init_opt(oc, leaves)
                losses = []
                for s in range(steps):
                    params, opt_state, _, m = step_fn(
                        params, opt_state, None,
                        train_batch(torch, pipe, s, where))
                    losses.append(float(m["loss"]))
                runs.append((losses, leaves))
            (card, card_leaves), (host, host_leaves) = runs
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(card, host))
            param_err = leaf_errors(torch, card_leaves, host_leaves)
            check(loss_err <= tol and param_err <= tol,
                  f"{arch} {kind}: card against CPU, loss {loss_err:.3e}, "
                  f"params {param_err:.3e} (bound {tol})")
            line.append(f"{kind} loss {loss_err:.2e}, params "
                        f"{param_err:.2e}")
        print(f"  {cfg.name} ({cfg.family}): {'; '.join(line)} "
              f"({time.time() - t0:.1f} s)", flush=True)


def restart_check() -> None:
    """Phase 41's first half, in its own process (``CUBLAS_WORKSPACE_CONFIG``
    must be set before cuBLAS starts): under deterministic algorithms, a
    run interrupted before the steps of ``RESTART_FAIL_AT`` ≡ an
    uninterrupted one, bit for bit."""
    import dataclasses
    import tempfile
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.runtime import fault_tolerance
    from repro_torch.train import data, optimizer, train_step
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(registry.reduced_config(registry.get(
        TRAIN_ARCH)), dtype="bfloat16")
    model = Model(cfg)
    oc = optimizer.OptConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    pipe = data.SyntheticLM(cfg.vocab, 64, 4, seed=SEED + 11)
    step_fn = train_step.make_train_step(model, oc)

    def init_state():
        p, o, _ = train_step.init_train_state(
            model, oc, torch.Generator(device=dev).manual_seed(SEED),
            device=dev)
        return {"params": p, "opt": o}

    def one_step(step, state):
        p, o, _, _ = step_fn(state["params"], state["opt"], None,
                             train_batch(torch, pipe, step, dev))
        return {"params": p, "opt": o}

    t0 = time.time()
    out = []
    with tempfile.TemporaryDirectory() as d:
        for name, fail_at in (("a", RESTART_FAIL_AT), ("b", ())):
            out.append(fault_tolerance.run_with_restarts(
                ckpt_dir=os.path.join(d, name), total_steps=12,
                init_state=init_state, step_fn=one_step, save_every=4,
                failure_plan=fault_tolerance.FailurePlan(fail_at=fail_at)))
    (a, restarts), (b, none) = out
    check((restarts, none) == (2, 0), f"restarts {restarts}, {none}")
    same = all(torch.equal(x, y) for x, y in zip(
        a["params"].state_dict().values(), b["params"].state_dict().values()))
    same = same and all(torch.equal(a["opt"].mu[k], b["opt"].mu[k]) and
                        torch.equal(a["opt"].nu[k], b["opt"].nu[k])
                        for k in a["opt"].mu)
    check(same, "the restarted run differs from the uninterrupted one")
    print(f"  restart: {cfg.name} in {cfg.dtype} on "
          f"{torch.cuda.get_device_name(0)}, 12 steps, failures before "
          f"steps {RESTART_FAIL_AT}: {restarts} restarts, params and AdamW "
          f"state ≡ the uninterrupted run bit for bit, deterministic "
          f"algorithms on ({time.time() - t0:.1f} s)", flush=True)


def phase_restarts(torch):
    """Phase 41: ``restart_check`` in a subprocess, then the training CLI
    on cuda, checkpointed and resumed."""
    import tempfile
    from repro_torch.launch import train
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.restart_check()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0, f"restart check: rc {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    with tempfile.TemporaryDirectory() as d:
        argv = ["--reduced", "--ckpt-dir", d, "--save-every", "10"]
        first = train.main(argv + ["--steps", "20"])
        again = train.main(argv + ["--steps", "30", "--resume"])
    check(first["start_step"] == 0 and again["start_step"] == 20,
          f"resume: started at {again['start_step']}")
    check(np.isfinite([first["last_loss"], again["last_loss"]]).all() and
          first["last_loss"] < first["first_loss"],
          f"the CLI's losses: {first}, {again}")
    print(f"  launch.train on cuda: loss {first['first_loss']:.4f} → "
          f"{first['last_loss']:.4f} in 20 steps; --resume from step "
          f"{again['start_step']} → {again['last_loss']:.4f} at step 30",
          flush=True)


def phase_dryrun(torch, smi):
    """Phase 42: the dry run's CLI in a subprocess over every cell and both
    production meshes; the cells' count, and a line per cell against this
    card's memory."""
    import tempfile
    total = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dryrun.json")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--both-meshes", "--memory-only", "--out", out], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
            text=True, timeout=300)
        check(proc.returncode == 0, f"dry run: rc {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        with open(out) as f:
            cells = json.load(f)
    done = [c for c in cells if "bytes_per_device" in c]
    skipped = [c for c in cells if "skipped" in c]
    check(len(done) == 2 * DRYRUN_CELLS and
          len(skipped) == 2 * DRYRUN_SKIPS and
          len(cells) == len(done) + len(skipped),
          f"dry run: {len(done)} cells reported, {len(skipped)} skipped, "
          f"{len(cells)} in all")
    check(all(c["shape"] == "long_500k" for c in skipped),
          "dry run: a cell other than long_500k skipped")
    for c in done:
        gib = {k: v / 2**30 for k, v in c["bytes_per_device"].items()}
        fits = c["bytes_per_device"]["total"] <= total
        print(f"  {c['arch']} × {c['shape']} × {c['mesh']}-pod: params "
              f"{gib['params']:.3f}, opt {gib['opt_state']:.3f}, inputs "
              f"{gib['inputs']:.3f}, cache {gib['cache']:.3f}, total "
              f"{gib['total']:.3f} GiB a device: "
              f"{'fits' if fits else 'does not fit'} {smi}", flush=True)
    print(f"  {len(done)} cell-meshes reported, {len(skipped)} skipped "
          f"(long_500k of the full-attention archs); against "
          f"{total / 2**30:.2f} GiB of {smi}", flush=True)


def hooks_check() -> None:
    """Phase 43's body, in its own process (``CUBLAS_WORKSPACE_CONFIG``
    must be set before cuBLAS starts): the sharding hooks on a 1×1 mesh of
    an NCCL process group, against the plain path bit for bit."""
    import socket
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import base, registry
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.serve.serve_step import generate
    from repro_torch.train import data, optimizer, train_step
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = registry.get(LM_ARCH)
        model = Model(cfg)

        def fresh():
            return model.init_params(
                torch.Generator(device=dev).manual_seed(SEED), device=dev)

        def decode_ms(params, batch, hooks):
            cache, _, p0 = model.prefill(params, batch,
                                         max_len=LM_PROMPT + LM_NEW, **hooks)
            tok = batch["tokens"][:, -1]

            def step():
                return model.decode(params, cache, tok, p0, **hooks)
            dev_ms, items, _ = device_step(torch, step, iters=3)
            return host_ms(step, 5), dev_ms, items

        smi = smi_line()
        batch = lm_batch(torch, cfg, LM_BATCH, LM_PROMPT, SEED, dev)
        t0 = time.perf_counter()
        plain = fresh()
        want = generate(model, plain, batch, LM_NEW)
        plain_ms = decode_ms(plain, batch, {})
        del plain
        params = sharding.distribute_params(cfg, mesh, fresh())
        check(all(isinstance(p, DTensor) for p in params.parameters()),
              "distribute_params left a plain parameter")
        hooks = dict(act_shard=sharding.make_act_shard(mesh),
                     moe_cap_shard=sharding.make_moe_cap_shard(mesh))
        got = generate(model, params, batch, LM_NEW, **hooks)
        check(isinstance(got, DTensor), f"generate gave {type(got)}")
        check(torch.equal(got.full_tensor(), want),
              "DTensor generate's tokens differ from the plain path's")
        dt_ms = decode_ms(params, batch, hooks)
        del params
        torch.cuda.empty_cache()
        print(f"  serving: {cfg.name} {cfg.dtype}, {LM_BATCH} prompts × "
              f"{LM_PROMPT} tokens, {LM_NEW} new: DTensor generate (FSDP "
              f"off, act_shard and moe_cap_shard) ≡ the plain tokens bit for "
              f"bit ({time.perf_counter() - t0:.1f} s); a decode step "
              f"{plain_ms[0]:.3f} ms host, {plain_ms[1]:.3f} ms device in "
              f"{plain_ms[2]:.0f} items plain; {dt_ms[0]:.3f} ms host, "
              f"{dt_ms[1]:.3f} ms device in {dt_ms[2]:.0f} items with "
              f"DTensor, on {smi}", flush=True)

        t0 = time.perf_counter()
        seq = base.get_shape(TRAIN_SHAPE).seq_len
        oc = optimizer.OptConfig(warmup_steps=TRAIN_WARMUP,
                                 total_steps=TRAIN_STEPS)
        b = train_batch(torch, data.SyntheticLM(cfg.vocab, seq, TRAIN_BATCH,
                                                seed=SEED), 0, dev)
        plain = fresh()
        state = optimizer.init_opt(oc, transformer.leaf_map(cfg, plain))
        _, state, _, m = train_step.make_train_step(model, oc)(
            plain, state, None, b)
        want_loss = m["loss"]
        del state, m
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = sharding.distribute_params(cfg, mesh, fresh(), fsdp=True)
        state = optimizer.init_opt(oc, transformer.leaf_map(cfg, params))
        step = train_step.make_train_step(
            model, oc, act_shard=sharding.make_act_shard(mesh),
            logit_shard=sharding.make_logit_shard(mesh),
            grad_shardings=sharding.param_placements(cfg, mesh, params,
                                                     fsdp=True))
        _, state, _, m = step(params, state, None, b)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        check(torch.equal(m["loss"].full_tensor(), want_loss),
              f"DTensor train step's loss {m['loss'].full_tensor()} against "
              f"{want_loss}")
        differ = [n for (n, p), (_, q) in zip(plain.named_parameters(),
                                              params.named_parameters())
                  if not torch.equal(p.detach(), q.detach().full_tensor())]
        check(not differ, f"DTensor train step: {len(differ)} parameters "
              f"differ from the plain step's, first {differ[:3]}")
        print(f"  training: one AdamW step of {TRAIN_BATCH} × {seq} tokens "
              f"(FSDP on, remat, act_shard, logit_shard, grad_shardings): "
              f"loss {float(want_loss):.6f} and all "
              f"{len(list(plain.parameters()))} updated parameters ≡ the "
              f"plain step's bit for bit; the step with its weights' draw "
              f"{plain_s:.1f} s plain, {dt_s:.1f} s with DTensor",
              flush=True)
    finally:
        dist.destroy_process_group()


def phase_hooks():
    """Phase 43: ``hooks_check`` in a subprocess."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               NCCL_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.hooks_check()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0, f"hooks check: rc {proc.returncode}: "
          f"{proc.stderr[-3000:]}")


def cost_trace() -> None:
    """Phase 44's traces, in their own process (a fake process group is
    one per process), started after phase 38 so that the host work
    overlaps phases 39-43: ``TRACE_CELLS`` on the fake (16, 16) mesh,
    a line each, then as the last line the one-device bounds of phase
    32's decode step and phase 38's train step (JSON)."""
    sys.path.insert(0, SRC)
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    plain = {}
    for arch, shape, knobs in TRACE_CELLS:
        t0 = time.perf_counter()
        res = dryrun.run_cell(arch, shape, multi_pod=False, **knobs)
        check("error" not in res and "skipped" not in res,
              f"trace {arch} × {shape} {knobs}: {res}")
        check(0 < res["useful_flop_fraction"] <= 1,
              f"trace {arch} × {shape}: useful FLOP fraction "
              f"{res['useful_flop_fraction']}")
        print(f"  (a) {dryrun.describe_cost(res)} "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        if not knobs:
            plain[arch, shape] = res
            continue
        want = dryrun.moe_groups(
            registry.get(arch), get_shape(shape), make_production_mesh(),
            moe_group_tokens=knobs["moe_group_tokens"])
        check(res["moe_groups"] == want and res["cap_shard"] is
              knobs["cap_shard"], f"trace {arch} × {shape} {knobs}: "
              f"moe_groups {res.get('moe_groups')} (want {want}), "
              f"cap_shard {res.get('cap_shard')}")
        base = plain[arch, shape]
        gib = [r["collective_bytes_per_device"] / 2**30 for r in (res, base)]
        tflop = [r["flops_per_device"] / 1e12 for r in (res, base)]
        print(f"  (a) {arch} × {shape} with {knobs}: moe_groups "
              f"{res['moe_groups']}; per device {gib[0]:.3f} GiB of "
              f"collectives against {gib[1]:.3f} without the knobs "
              f"(moe_groups {base['moe_groups']}), {tflop[0]:.3f} TFLOP "
              f"against {tflop[1]:.3f}", flush=True)
    train = get_shape(TRAIN_SHAPE)
    bounds = {}
    for key, arch, shp, mb in (
            ("decode", LM_ARCH,
             ShapeSpec("phase32", LM_PROMPT + LM_NEW, LM_BATCH, "decode"),
             None),
            ("train", TRAIN_ARCH,
             ShapeSpec(TRAIN_SHAPE, train.seq_len, TRAIN_BATCH, "train"), 1)):
        t0 = time.perf_counter()
        rep, cfg, shp = dryrun.cell_cost(arch, shp, None, microbatches=mb)
        t = dryrun.analyse(rep, cfg, shp, 1)["terms"]
        bounds[key] = {
            "arch": arch, "batch": shp.global_batch, "seq": shp.seq_len,
            "secs": time.perf_counter() - t0, "tflop": rep.flops / 1e12,
            "bf16_tflop": rep.matmul_flops_lowp / 1e12,
            "ideal_gb": rep.bytes_ideal / 1e9, "eager_gb": rep.bytes / 1e9,
            "compute_ms": t["compute_s"] * 1e3,
            "memory_ms": t["memory_s"] * 1e3,
            "eager_ms": rep.bytes / dryrun.HBM_BW * 1e3}
    print(json.dumps({"bounds": bounds}), flush=True)


def start_cost() -> subprocess.Popen:
    """``cost_trace`` in a subprocess at the lowest priority (``nice``
    19), its stderr into a temporary file (DTensor's warnings would fill
    a pipe that nobody reads until phase 44); killed at exit if still
    running."""
    import atexit
    import tempfile
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import os, chip_smoke; os.nice(19); "
         "chip_smoke.cost_trace()"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=err, text=True)
    proc.err_file = err
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def phase_cost(proc: subprocess.Popen, decode_ms: float,
               train_ms: float) -> None:
    """Phase 44: ``cost_trace``'s lines, and its bounds against the device
    ms that phases 32 and 38 measured: max(compute, memory) with the ideal
    bytes must not exceed them (TF32 stays off, PyTorch's default: the
    float32 products at 67 TFLOP/s)."""
    out, _ = proc.communicate(timeout=600)
    proc.err_file.seek(0)
    check(proc.returncode == 0, f"cost trace: rc {proc.returncode}: "
          f"{proc.err_file.read()[-3000:]}")
    lines = out.rstrip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    bounds = json.loads(lines[-1])["bounds"]
    for key, what, measured in (("decode", "phase 32's decode step",
                                 decode_ms),
                                ("train", "phase 38's train step",
                                 train_ms)):
        b = bounds[key]
        bound_ms = max(b["compute_ms"], b["memory_ms"])
        print(f"  (b) {what} ({b['arch']}, {b['batch']} × {b['seq']}) "
              f"traced on one device in {b['secs']:.1f} s: "
              f"{b['tflop']:.3f} TFLOP ({b['bf16_tflop']:.3f} in bf16 "
              f"matmuls), {b['ideal_gb']:.3f} GB ideal / "
              f"{b['eager_gb']:.3f} GB eager; bound max(compute "
              f"{b['compute_ms']:.3f}, memory {b['memory_ms']:.3f}) = "
              f"{bound_ms:.3f} ms against {measured:.3f} ms of device time "
              f"measured ({bound_ms / measured:.1%}); the eager bytes' term "
              f"{b['eager_ms']:.3f} ms", flush=True)
        check(bound_ms <= measured, f"{what}: bound {bound_ms:.3f} ms above "
              f"the {measured:.3f} ms measured: the count is wrong")


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module (its ``main`` not run)."""
    import importlib.util
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def brute_force_join(torch, dev, ra, rb, chunk: int = 4096) -> np.ndarray:
    """Every (i, j) whose rects ``ra[i]`` and ``rb[j]`` intersect (closed
    boxes), on the card a chunk of ``ra`` at a time, in row-major order."""
    a = torch.from_numpy(ra).to(dev)
    b = torch.from_numpy(rb).to(dev)
    out = []
    for lo in range(0, len(a), chunk):
        x = a[lo:lo + chunk, None]
        hit = (x[..., 0] <= b[:, 2]) & (x[..., 2] >= b[:, 0]) & \
            (x[..., 1] <= b[:, 3]) & (x[..., 3] >= b[:, 1])
        ij = hit.nonzero()
        ij[:, 0] += lo
        out.append(ij.cpu().numpy())
    return np.concatenate(out)


def phase_examples(torch, dev, mods) -> dict:
    """Phase 45: the port's four examples (``examples/*_torch.py``) on the
    card, each through its ``main`` at its counterpart's sizes (the
    training example at ``EXAMPLE_TRAIN_STEPS`` steps) and its own
    asserts: the quickstart's select ≡ the scalar baseline, q/s > 0, the
    join's pairs ≡ a brute-force join of the same rects on the card, the
    loss falls across the resume; each example's kernel launches (counts
    reset before it) and seconds.  Returns {example: seconds}."""
    secs = {}
    for name, argv, kernel in (
            ("quickstart", [], "select_level_masks"),
            ("serve_spatial", [], "select_level_masks"),
            ("spatial_join_analytics", [], "join_pair_masks"),
            ("train_lm", ["--steps", str(EXAMPLE_TRAIN_STEPS)], None)):
        mod = load_example(name)
        for m in mods:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches = counts_of(mods)
        check(kernel is None or launches.get(kernel, 0) > 0,
              f"{name}_torch.py: no {kernel} launch on the card ({launches})")
        what = ""
        if name == "spatial_join_analytics":
            _, ra, rb = mod.datasets(30_000)
            want = brute_force_join(torch, dev, ra, rb)
            got = out["pairs"]
            got = got[np.lexsort((got[:, 1], got[:, 0]))]
            check(np.array_equal(got, want), f"{name}_torch.py: "
                  f"{len(got)} pairs against {len(want)} brute force")
            what = f"; {len(got)} pairs ≡ brute force on the card"
        elif name == "train_lm":
            check(out["start_step"] == EXAMPLE_TRAIN_STEPS // 2 and
                  out["last_loss"] < out["first_loss"],
                  f"{name}_torch.py: {out}")
            what = (f"; resumed at step {out['start_step']}, loss "
                    f"{out['first_loss']:.4f} → {out['last_loss']:.4f}")
        elif name == "serve_spatial":
            what = f"; {out['qps']:,.1f} q/s"
        print(f"  {name}_torch.py on cuda: {secs[name]:.1f} s, launches "
              f"{launches}{what}", flush=True)
    return secs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.core import join_vector, knn_browse, knn_filtered, \
        knn_join_vector, knn_vector, layouts, rtree, select_vector, \
        traversal
    from repro_torch.core.join_scalar import elevate
    from repro_torch.core.layouts import tree_layout
    from repro_torch.distributed.spatial_shard import SpatialShards
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import rtree_join as jkern
    from repro_torch.kernels import rtree_knn as kkern
    from repro_torch.kernels import rtree_knn_join as kjkern
    from repro_torch.kernels import rtree_select as kern
    from repro_torch.launch import serve
    from repro_torch.launch.queue import ServeQueue
    from repro_torch.runtime.faults import FaultInjector, FaultPlan

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
    eng_launches, d1_select = phase_engine(tree, rects, queries,
                                           select_vector, kern)

    print("[5] serve", flush=True)
    serve_launches, qps, d1_first_select = phase_serve(kern, serve)
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
    dops = distance_ops(kkern, kjkern, ref)
    print(f"[9] kNN kernels on the phase-3 tree; static caps k=1 "
          f"{knn_vector.knn_frontier_caps(tree, 1)}, k=8 "
          f"{knn_vector.knn_frontier_caps(tree, 8)}, k=64 "
          f"{knn_vector.knn_frontier_caps(tree, 64)}", flush=True)
    knn_kernels, caps8 = phase_distance_kernels(
        torch, tree, points, dops["knn"], knn_vector, SEED + 13)
    kernels += knn_kernels
    big_pts = torch.from_numpy(probes[:ALL_PAIRS_BATCH, :2].copy()).to(dev)
    print(f"  at batch {ALL_PAIRS_BATCH} (the lower corners of the first "
          f"all-pairs chunk as points), k = {KNN_K} static descent:",
          flush=True)
    distance_kernel_times(
        torch, tree, big_pts, knn_frontiers(torch, tree, big_pts, KNN_K,
                                            caps8, ref.knn_level_fused_ref),
        dops["knn"], caps8, dict.fromkeys(dops["knn"]["names"], 0))
    del big_pts

    print("[10] kNN engine", flush=True)
    data = serve.make_rects(N_RECTS, SEED)
    knn_eng_launches, d1_knn = phase_distance_engine(
        torch, tree, data, points, kkern, knn_vector.make_knn_bfs, KNN_REF,
        dops["knn"]["names"], "kNN", escalate_k1=True)

    print("[11] kNN serve", flush=True)
    knn_serve_launches, knn_qps, d1_first_knn = phase_distance_serve(
        torch, dev, kkern, serve, "knn", "knn_level_dists", [],
        serve.make_knn_inputs(N_RECTS, SEED, KNN_BATCHES, BATCH))
    print(f"  served {knn_qps:,.1f} kNN q/s (k={KNN_K}) on {name} ({smi})",
          flush=True)

    _, qs = serve.make_knn_join_inputs(N_RECTS, SEED, 1, BATCH, QUERY_EPS)
    qrects = torch.from_numpy(qs[0]).to(dev)
    print(f"[12] kNN-join kernels on the phase-3 tree with the first served "
          f"batch of {BATCH} query rects (half-extent {QUERY_EPS})",
          flush=True)
    kj_kernels, caps8 = phase_distance_kernels(
        torch, tree, qrects, dops["knn_join"], knn_vector, SEED + 19)
    kernels += kj_kernels
    big = torch.from_numpy(probes[:ALL_PAIRS_BATCH]).to(dev)
    print(f"  at batch {ALL_PAIRS_BATCH} (the first all-pairs chunk), k = "
          f"{KNN_K} static descent:", flush=True)
    distance_kernel_times(
        torch, tree, big, knn_frontiers(torch, tree, big, KNN_K, caps8,
                                        ref.knn_join_level_fused_ref),
        dops["knn_join"], caps8, dict.fromkeys(dops["knn_join"]["names"], 0))
    del big

    print("[13] kNN-join engine", flush=True)
    kj_eng_launches, d1_kj = phase_distance_engine(
        torch, tree, data, qrects, kjkern, knn_join_vector.make_knn_join_bfs,
        KNN_JOIN_REF, dops["knn_join"]["names"], "kNN-join")

    print(f"[14] all-pairs kNN-join: {len(probes)} probe rects × {N_RECTS} "
          f"rects, k = {KNN_K}", flush=True)
    all_pairs = phase_knn_join_all_pairs(torch, tree, data, probes, kjkern,
                                         knn_join_vector, rtree)
    print(f"  {all_pairs[True][0]:.3f} s per join fused, "
          f"{all_pairs[False][0]:.3f} s unfused on {name} ({smi})",
          flush=True)

    print("[15] kNN-join serve", flush=True)
    kj_serve_launches, kj_qps, d1_first_kj = phase_distance_serve(
        torch, dev, kjkern, serve, "knn-join", "knn_join_level_dists",
        ["--query-eps", str(QUERY_EPS)],
        serve.make_knn_join_inputs(N_RECTS, SEED, KNN_BATCHES, BATCH,
                                   QUERY_EPS))
    print(f"  served {kj_qps:,.1f} kNN-join q/s (k={KNN_K}) on {name} "
          f"({smi})", flush=True)

    print("[16] D3 build of the phase-3 tree", flush=True)
    layers = phase_d3_build(torch, tree, layouts, rtree)
    caps_sel = select_vector.frontier_caps(tree, RESULT_CAP, lanes=256)
    caps_knn = knn_vector.knn_frontier_caps(tree, KNN_K, lanes=256)
    check(layouts.layout_lanes("d3") == 256, "D3 lanes")
    print(f"[17] D3 kernels; D3 static caps: select {caps_sel}, kNN k=8 "
          f"{caps_knn}", flush=True)
    kernels += phase_d3_kernels(
        torch, tree, layers, queries, points, qrects,
        torch.from_numpy(probes[:ALL_PAIRS_BATCH]).to(dev), caps_sel,
        caps_knn, kern, kkern, kjkern, ref, traversal)
    del layers

    print("[18] D3 engines", flush=True)
    d3_eng_launches = phase_d3_engines(
        torch, tree, queries, points, qrects,
        {"select": d1_select, "knn": d1_knn, "knn_join": d1_kj}, kern, kkern,
        kjkern, select_vector, knn_vector, knn_join_vector)

    print("[19] D3 serve", flush=True)
    d3_serve_launches, d3_qps = phase_d3_serve(
        kern, kkern, kjkern, serve, {"spatial": d1_first_select,
                                     "knn": d1_first_knn,
                                     "knn-join": d1_first_kj})
    print(f"  served D3 q/s on {name} ({smi}): " + ", ".join(
        f"{m} {v:,.1f}" for m, v in d3_qps.items()), flush=True)

    t0 = time.time()
    _, fq = serve.make_knn_filtered_inputs(N_RECTS, SEED, 1, BATCH,
                                           FILTER_EPS)
    print(f"[20] filtered kNN engine on the phase-3 tree, windows of "
          f"half-extent {FILTER_EPS}; static caps k=8 "
          f"{knn_filtered.filtered_caps(tree, 8)}", flush=True)
    phase_filtered_engine(torch, tree, data, fq[0], d1_knn, rtree,
                          knn_filtered)
    print(f"  phase 20: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print(f"[21] browse engine on the phase-3 tree, k = {KNN_K}", flush=True)
    phase_browse_engine(torch, tree, points, kkern, knn_browse, knn_vector)
    print(f"  phase 21: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)
    del tree

    t0 = time.time()
    print("[22] filtered kNN and browse serve", flush=True)
    a10_qps = phase_a10_serve(torch, dev, kkern, serve)
    print(f"  served on {name} ({smi}): " + ", ".join(
        f"{m} {lo} {v:,.1f}" for (m, lo), v in a10_qps.items())
        + f"; phase 22: {time.time() - t0:.1f} s", flush=True)

    mods = (kern, jkern, kkern, kjkern)
    cuts = {}        # the seconds each timing-only cut saves (phase 45)
    t0 = time.time()
    print(f"[23] mesh engines over the {N_RECTS} points in "
          f"{MESH_PARTITIONS + 1} partitions, D1 and D3", flush=True)
    heights = phase_mesh_engines(torch, dev, mods, serve, SpatialShards,
                                 traversal, knn_browse, rtree, elevate,
                                 cuts)
    print(f"  phase 23: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print("[24] serve --mesh on / off, every fleet mode, D1 and D3",
          flush=True)
    mesh_launches = phase_mesh_serve(mods, serve, heights, cuts)
    print(f"  phase 24: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print(f"[25] serve --queue: {QUEUE_REQUESTS} requests × {BATCH} rows, "
          f"{QUEUE_CLIENTS} clients, batches ≤ {QUEUE_MAX_BATCH}, depth "
          f"{QUEUE_DEPTH}, host and mesh path", flush=True)
    queue_launches, queue_rates, d1_fleet = phase_queue_serve(
        torch, dev, mods, serve, SpatialShards, ServeQueue)
    print(f"  phase 25: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print(f"[26] chaos: two replicas on {name}, plans {CHAOS_PLANS}",
          flush=True)
    phase_chaos(torch, dev, serve, d1_fleet, ServeQueue, FaultInjector,
                FaultPlan)
    del d1_fleet
    print(f"  phase 26: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    tree = rtree.build_rtree(data, fanout=FANOUT, device=dev)
    cpu_tree = rtree.build_rtree(data, fanout=FANOUT, device="cpu")
    print(f"[27] the paper's baselines on {name}: the phase-3 tree again, "
          f"the first served batches", flush=True)
    dfs_kernels, dfs_launches = phase_baselines(
        torch, dev, tree, cpu_tree, queries, points, qrects, d1_select)
    kernels += dfs_kernels
    del cpu_tree
    print(f"  phase 27: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    rects, probes = serve.make_join_inputs(N_RECTS, SEED, QUERY_EPS)
    shards = SpatialShards.build(rects, 8, fanout=FANOUT, sort_key="lx",
                                 device=dev)
    probe_tree = rtree.build_rtree(probes, fanout=FANOUT, sort_key="lx",
                                   device=dev)
    print("[28] D0 and D2 engines against D1 and the reference", flush=True)
    phase_layout_engines(torch, tree, queries, points, qrects, fq[0],
                         probe_tree, shards.partitions[CENTRE])
    del tree
    print(f"  phase 28: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print(f"[29] serve --layout d0|d2 at {N_RECTS} points", flush=True)
    phase_layout_serve(torch, dev, serve)
    print(f"  phase 29: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print(f"[30] D3 join engine: the centre partition and {len(probes)} "
          f"probes, result_cap {JOIN_CAP}", flush=True)
    phase_d3_join_engine(torch, probe_tree, shards.partitions[CENTRE],
                         probes, join_vector)
    del shards, probe_tree
    print(f"  phase 30: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print(f"[31] serve --mode join --layout d3 at {N_RECTS} points, mesh "
          f"off and on", flush=True)
    phase_d3_join_serve(torch, dev, serve)
    print(f"  phase 31: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    from repro_torch.configs import registry
    lm_cfg = registry.get(LM_ARCH)
    t0 = time.time()
    print(f"[32] {LM_ARCH} at its published widths ({lm_cfg.n_layers} "
          f"layers, d_model {lm_cfg.d_model}, {lm_cfg.n_heads} heads, "
          f"{lm_cfg.n_kv} KV heads, d_ff {lm_cfg.d_ff}, vocab "
          f"{lm_cfg.vocab}), weights from seed {SEED}", flush=True)
    lm32 = phase_lm_bf16(torch, dev, lm_cfg, LM_BATCH, LM_PROMPT, LM_NEW,
                         LM_BF16_TOL)
    cuts[f"32: {LM_ARCH}'s LM timing repeats"] = lm32["cut_s"]
    torch.cuda.empty_cache()
    phase_lm_f32(torch, dev, lm_cfg, LM_F32_BATCH, LM_F32_PROMPT,
                 LM_F32_NEW, LM_F32_TOL)
    torch.cuda.empty_cache()
    print(f"  phase 32: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print("[33] serve --mode lm on cuda", flush=True)
    phase_lm_serve(serve)
    print(f"  phase 33: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    import dataclasses
    for n, (arch, depth, tol, f32_depth) in enumerate(LM_FAMILY_CELLS,
                                                      start=34):
        full = registry.get(arch)
        cfg = dataclasses.replace(full, n_layers=depth or full.n_layers)
        t0 = time.time()
        print(f"[{n}] {arch} at its published widths "
              f"({lm_widths(cfg, full.n_layers)}), weights from seed {SEED}",
              flush=True)
        lm = phase_lm_bf16(torch, dev, cfg, LM_BATCH, LM_PROMPT, LM_NEW, tol,
                           tf_chunk=LM_MOE_TF_CHUNK
                           if cfg.family == "moe" else None)
        cuts[f"{n}: {arch}'s LM timing repeats"] = lm["cut_s"]
        torch.cuda.empty_cache()
        phase_lm_f32(torch, dev, registry.reduced_config(full),
                     LM_F32_BATCH, LM_F32_PROMPT, LM_F32_NEW, LM_F32_TOL)
        torch.cuda.empty_cache()
        moe = cfg.family == "moe"
        phase_lm_tf(torch, dev, dataclasses.replace(
            cfg, dtype="float32", n_layers=f32_depth or cfg.n_layers,
            moe_capacity=float(cfg.n_experts) if moe else cfg.moe_capacity),
            LM_F32_DEPTH_BATCH, SEED + 2, LM_F32_TOL, LM_F32_TF_CHUNK,
            LM_F32_DEPTH_BATCH // 4)
        torch.cuda.empty_cache()
        if not moe:
            for seed in LM_WITNESS_SEEDS:
                phase_lm_tf(torch, dev, dataclasses.replace(
                    cfg, n_layers=LM_WITNESS_DEPTH), LM_BATCH, seed,
                    LM_BF16_TOL, LM_BATCH, 1)
                torch.cuda.empty_cache()
        print(f"  phase {n}: {time.time() - t0:.1f} s on {name} ({smi})",
              flush=True)

    from repro_torch.configs import base
    seq = base.get_shape(TRAIN_SHAPE).seq_len
    train_cfg = registry.get(TRAIN_ARCH)
    t0 = time.time()
    print(f"[38] training {TRAIN_ARCH} at its published widths "
          f"({train_cfg.n_layers} layers, d_model {train_cfg.d_model}, "
          f"{train_cfg.n_heads} heads, {train_cfg.n_kv} KV heads, d_ff "
          f"{train_cfg.d_ff}, vocab {train_cfg.vocab}), {train_cfg.dtype}, "
          f"AdamW, remat, {TRAIN_STEPS} steps of {TRAIN_BATCH} × {seq} "
          f"tokens ({TRAIN_SHAPE}'s length; its batch of "
          f"{base.get_shape(TRAIN_SHAPE).global_batch} cut to "
          f"{TRAIN_BATCH}), weights from seed {SEED}", flush=True)
    tr38 = phase_train(torch, dev, train_cfg, TRAIN_BATCH, seq, TRAIN_STEPS)
    torch.cuda.empty_cache()
    print(f"  phase 38: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)
    # phase 44's traces: host work, at the lowest priority, beside phases
    # 39-43 (whose host times PERF.md tracks less than 1-38's)
    cost_proc = start_cost()

    t0 = time.time()
    print("[39] the flash backward at phase 38's shapes", flush=True)
    phase_flash_bwd(torch, dev, train_cfg, TRAIN_BATCH, seq, FLASH_F32_TOL)
    torch.cuda.empty_cache()
    print(f"  phase 39: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print("[40] float32 train steps, card against CPU, every layer pattern",
          flush=True)
    phase_train_f32(torch, dev, TRAIN_PATTERN_ARCHS, TRAIN_F32_TOL)
    print(f"  phase 40: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print("[41] restarts and launch.train --resume on cuda", flush=True)
    phase_restarts(torch)
    print(f"  phase 41: {time.time() - t0:.1f} s on {name} ({smi})",
          flush=True)

    t0 = time.time()
    print("[42] the dry run's per-device memory, every cell, both meshes",
          flush=True)
    phase_dryrun(torch, smi)
    t42 = time.time() - t0
    print(f"  phase 42: {t42:.1f} s on {name} ({smi})", flush=True)

    t0 = time.time()
    print(f"[43] the sharding hooks on a 1×1 NCCL mesh: {LM_ARCH} served "
          f"and trained against the plain path", flush=True)
    phase_hooks()
    t43 = time.time() - t0
    print(f"  phase 43: {t43:.1f} s on {name} ({smi}); phases 42-43 "
          f"{t42 + t43:.1f} s", flush=True)

    t0 = time.time()
    print("[44] the traced cost model: five dry-run cells over a fake "
          "(16, 16) mesh (grok-1-314b train_4k without and with the MoE "
          "knobs), and the one-device bound of phases 32 and 38",
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: phase 44's float32 rate assumes it off")
    phase_cost(cost_proc, lm32["dev_ms"], tr38["dev_ms"])
    t44 = time.time() - t0
    print(f"  phase 44: {t44:.1f} s on {name} ({smi})", flush=True)

    t0 = time.time()
    print("[45] the port's four examples on cuda", flush=True)
    phase_examples(torch, dev, mods)
    t45 = time.time() - t0
    cut = sum(cuts.values())
    print(f"  phase 45: {t45:.1f} s on {name} ({smi})", flush=True)
    print("  the timing-only cuts that pay for it, from this run's own "
          "per-call times: " + "; ".join(f"{k} {v:.1f} s"
                                         for k, v in cuts.items()) +
          f"; {cut:.1f} s in all against phase 45's {t45:.1f} s and "
          f"phase 44's wait of {t44:.1f} s (PR 28's run 7: 0.0 s)",
          flush=True)

    # launches: B1, B3, B5, B8, B11, B13 and B14 from the served paths
    # (phases 5, 8, 11, 15 and 19); B2, B4, B6, B7, B9, B10 and B12, which
    # serve does not drive, from the fused engine cells (phases 4, 7, 10, 13
    # and 18); S and V from the 64 walks of phase 27; every count was reset
    # just before its phase
    path_launches = {
        "select_level_masks": serve_launches,
        "select_level_fused": eng_launches,
        "join_pair_masks": join_serve_launches,
        "join_level_fused": join_eng_launches,
        "knn_level_dists": knn_serve_launches,
        "knn_level_fused": knn_eng_launches,
        "knn_leaf_fused": knn_eng_launches,
        "knn_join_level_dists": kj_serve_launches,
        "knn_join_level_fused": kj_eng_launches,
        "knn_join_leaf_fused": kj_eng_launches,
        "select_level_masks_d3": d3_serve_launches,
        "select_level_fused_d3": d3_eng_launches,
        "knn_level_dists_d3": d3_serve_launches,
        "knn_join_level_dists_d3": d3_serve_launches,
        "select_dfs_scalar": dfs_launches,
        "select_dfs_vector": dfs_launches,
    }
    # and, for the kernels the mesh path runs, its served launches (phase
    # 24, counts reset before each serve run)
    # and, for the kernels the queued path runs, its launches summed over
    # the queued serve runs (phase 25, counts reset before each)
    for k in kernels:
        k["launches"] = path_launches[k["name"]][k["name"]]
        check(k["launches"] > 0, f"{k['name']} not launched on its path")
        if k["name"] in mesh_launches:
            k["mesh_launches"] = mesh_launches[k["name"]]
        if k["name"] in queue_launches:
            k["queue_launches"] = queue_launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "latency_ms", "mesh_launches", "queue_launches")
    print("queued q/s against direct q/s: " + ", ".join(
        f"{m} {lo} mesh {me}: {a:,.1f} / {b:,.1f}"
        for (m, lo, me), (a, b) in queue_rates.items()), flush=True)
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys if k in kk}
                                  for kk in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
