"""Distributed spatial query processing: partition the dataset spatially,
build one R-tree per partition on the device, fan queries out, merge
results (the reference's ``distributed/spatial_shard.py``).

Partitioning follows the STR idea one level up: sort by x into vertical
slabs, then by y within each slab — every partition is a contiguous spatial
tile holding ~N/P rects, so most range queries touch few partitions (the
partition MBRs act as a replicated, tiny "root router" level).  Select rows
merge by sorted global id, an order with no dependence on partition
placement.  The spatial join of a probe relation merges its (probe id,
global data id) pairs by a lexicographic sort on the host.  kNN and the
kNN-join route in two phases on the partition MBRs (primary partition,
then the partitions within the primary's k-th distance) and merge the
candidates by (distance, global id); filtered kNN routes the same way on
its point columns.

Two execution paths share one public API (``range_select`` / ``join`` /
``knn`` / ``knn_join`` / ``knn_filtered`` / ``browse``):

  host path — one engine per partition (spec registry), a Python loop
      fanning routed query subsets out and merging on the host: a launch
      a level per touched partition per phase.
  mesh path (``enable_mesh``) — the partition trees are packed into one
      forest (distributed/forest.py) and a whole batch runs as one program
      (core/traversal.make_mesh_engine): routing on the device, every
      partition's descent in one launch a level over (partition × query)
      rows, and the cross-partition merges on the device
      (distributed/collectives.py).  The distance operators' second phase
      descends under the first phase's bound with no host round trip, so
      a batch's launches are O(levels), not O(partitions × levels).  The
      distributed browse runs on this path only.

Both paths agree because both reduce to the same total order: candidates
merge by (distance, global id), select and join rows by sorted global id.
The reference's mesh shards the forest over a device mesh; on one card the
forest has one shard (``torch.distributed`` waits for a second card).
``replicate`` gives the serve queue (launch/queue.py) R mesh-path fleets,
one a device, over one packing of the partitions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import knn_browse, rtree, traversal
from ..core.geometry import intersects as np_intersects
from ..core.geometry import mindist_matrix_np, mindist_rect_matrix_np
from ..core.join_scalar import elevate
from ..core.layouts import layout_lanes
from . import forest as forest_mod


@dataclasses.dataclass
class Partition:
    tree: "rtree.RTree"
    mbr: np.ndarray            # (4,)
    offset: int                # partition index
    ids: np.ndarray            # (n_local,) global rect ids


class SpatialShards:
    def __init__(self, partitions: List[Partition], fanout: int,
                 layout: str = "d1"):
        layout_lanes(layout)           # validate the name early
        self.partitions = partitions
        self.fanout = fanout
        # fleet-wide node layout, injected into every engine build; the
        # engines' backend is 'auto': kernels for trees on the card
        self.layout = layout
        self.router_mbrs = np.stack([p.mbr for p in partitions])
        # one engine cache for every operator, keyed by (spec name,
        # partition, build params) through the spec registry
        self._engines = {}
        # mesh path state (enable_mesh): the packed forest, its programs and
        # browse engines
        self._forest = None
        self._n_shards = 1
        self._mesh_programs = {}
        self._browse_starts = {}
        # Counters of the last batch: the mesh program's, or the host path's
        # sum over the partitions it touched
        self.last_counters = None
        # host seconds of the last join's (K, 2) lexsort merge
        self.last_merge_s = 0.0

    @classmethod
    def build(cls, rects: np.ndarray, n_partitions: int, fanout: int = 64,
              sort_key: Optional[str] = None, layout: str = "d1",
              device="cuda", mesh=None) -> "SpatialShards":
        """Partition ``rects`` into ``n_partitions`` spatial tiles (STR one
        level up) and build each tile's tree on ``device``.  ``mesh``:
        None serves on the host path; True (the fleet's device) or a
        device enables the mesh path (``enable_mesh``)."""
        n = len(rects)
        cx = (rects[:, 0] + rects[:, 2]) / 2
        cy = (rects[:, 1] + rects[:, 3]) / 2
        slabs = int(np.ceil(np.sqrt(n_partitions)))
        per_slab = int(np.ceil(n_partitions / slabs))
        order = np.argsort(cx, kind="stable")
        slab_size = int(np.ceil(n / slabs))
        parts: List[Partition] = []
        for si in range(slabs):
            sl = order[si * slab_size:(si + 1) * slab_size]
            if len(sl) == 0:
                continue
            sl = sl[np.argsort(cy[sl], kind="stable")]
            tile = int(np.ceil(len(sl) / per_slab))
            for ti in range(per_slab):
                ids = sl[ti * tile:(ti + 1) * tile]
                if len(ids) == 0:
                    continue
                sub = rects[ids]
                tree = rtree.build_rtree(sub, fanout=fanout,
                                         sort_key=sort_key, device=device)
                mbr = np.array([sub[:, 0].min(), sub[:, 1].min(),
                                sub[:, 2].max(), sub[:, 3].max()],
                               rects.dtype)
                parts.append(Partition(tree=tree, mbr=mbr, offset=len(parts),
                                       ids=ids))
        out = cls(parts, fanout, layout=layout)
        if mesh is not None:
            out.enable_mesh(None if mesh is True else mesh)
        return out

    # ------------------------------------------------------------------
    # mesh dispatcher
    # ------------------------------------------------------------------

    @property
    def mesh_enabled(self) -> bool:
        return self._forest is not None

    def enable_mesh(self, mesh=None, n_shards: int = 1,
                    min_height: Optional[int] = None) -> "SpatialShards":
        """Pack the partition fleet into one forest on ``mesh`` (a device;
        default the fleet's) and route the public API through the
        one-program path.  ``n_shards`` pads the partition count to its
        multiple with empty partitions (the reference's mesh axis size; 1
        on one card); ``min_height`` raises the forest's height (a taller
        join probe)."""
        dev = self.partitions[0].tree.device if mesh is None else \
            torch.device(mesh)
        packed = forest_mod.pack_forest(
            [p.tree for p in self.partitions],
            [p.ids for p in self.partitions], n_shards=n_shards,
            min_height=min_height)
        self._forest = packed.to(dev)
        self._n_shards = n_shards
        self._mesh_programs = {}
        self._browse_starts = {}
        return self

    def disable_mesh(self) -> "SpatialShards":
        self._forest = None
        self._mesh_programs = {}
        self._browse_starts = {}
        return self

    def host_view(self) -> "SpatialShards":
        """A host-path fleet over the same partitions, sharing the host
        engine cache but no mesh state, so using it cannot move this
        object's operators off the mesh path; ``self`` when this object
        already serves on the host path."""
        if not self.mesh_enabled:
            return self
        twin = SpatialShards(self.partitions, self.fanout,
                             layout=self.layout)
        twin._engines = self._engines
        return twin

    @property
    def device(self) -> torch.device:
        """Where this fleet's operators run: the forest's device on the
        mesh path, else the partition trees'."""
        if self.mesh_enabled:
            return self._forest.device
        return self.partitions[0].tree.device

    def replicate(self, replicas: Optional[int] = None,
                  devices=None) -> List["SpatialShards"]:
        """Replica fan-out: R mesh-path fleets, one a device, each serving
        the whole public API over a complete copy of the fleet.  The fleet
        is packed once (``forest.replicate_forest``); the replicas share
        ``partitions`` and nothing of the mesh state (forest placement,
        programs, browse engines).  ``devices`` defaults to
        ``launch/mesh.replica_devices(replicas)`` on this fleet's device
        type; an explicit list may name one device twice, which gives two
        distinct replica engines on it (the reference's ``meshes=`` may
        name one mesh twice).  ``self`` is left untouched."""
        if devices is None:
            from ..launch.mesh import replica_devices
            devices = replica_devices(replicas, self.device)
        packed = forest_mod.pack_forest(
            [p.tree for p in self.partitions],
            [p.ids for p in self.partitions])
        reps = []
        for fst in forest_mod.replicate_forest(packed, devices):
            rep = SpatialShards(self.partitions, self.fanout,
                                layout=self.layout)
            rep._forest = fst
            reps.append(rep)
        return reps

    def _mesh_program(self, op: str, outer_tree=None, **params):
        """The mesh program of ``op`` over the packed forest, cached per
        build params.  A program closes over its outer tree (the join's
        probe), so only the latest per (op, params) is kept: a caller
        streaming fresh probe relations cannot grow the cache.  The entry
        holds the outer tree too, so its ``id`` in the key stays its own."""
        params = dict(params, layout=self.layout)
        key = (op, tuple(sorted(params.items())),
               None if outer_tree is None else id(outer_tree))
        if key not in self._mesh_programs:
            if outer_tree is not None:
                for stale in [s for s in self._mesh_programs
                              if s[:2] == key[:2] and s[2] is not None]:
                    del self._mesh_programs[stale]
            self._mesh_programs[key] = (outer_tree, traversal.make_mesh_engine(
                op, self._forest, outer_tree=outer_tree, **params))
        return self._mesh_programs[key][1]

    def _mesh_distance(self, op: str, queries: np.ndarray, k: int
                       ) -> Tuple[np.ndarray, np.ndarray, bool]:
        ids, d, ctr = self._mesh_program(op, k=k)(queries)
        self.last_counters = ctr
        return (ids.cpu().numpy().astype(np.int64),
                d.cpu().numpy().astype(np.float64), bool(int(ctr.overflow)))

    # ------------------------------------------------------------------
    # routing + per-partition engines
    # ------------------------------------------------------------------

    def route(self, queries: np.ndarray) -> np.ndarray:
        """(B, 4) queries → (B, P) bool routing matrix from partition MBRs
        (the replicated root-router step)."""
        q = queries
        m = self.router_mbrs
        return np_intersects(q[:, None, 0], q[:, None, 1], q[:, None, 2],
                             q[:, None, 3], m[None, :, 0], m[None, :, 1],
                             m[None, :, 2], m[None, :, 3])

    def engine_for(self, op: str, pi: int, **params):
        """The engine of registered operator ``op`` for partition ``pi``,
        built through the spec registry (traversal.build) and cached per
        build params."""
        params = dict(params, layout=self.layout)
        key = (op, pi, tuple(sorted(params.items())))
        if key not in self._engines:
            self._engines[key] = traversal.build(
                op, self.partitions[pi].tree, **params)
        return self._engines[key]

    @staticmethod
    def _bucket(queries: np.ndarray) -> np.ndarray:
        """Pad a query subset to its next power-of-two row count so a
        partition sees at most log2(max batch)+1 batch shapes.  Pads with
        copies of a real query, not zeros: the overflow flag is any() over
        all rows, and an all-zeros row could overflow the frontier caps when
        no real query does."""
        b = len(queries)
        bucket = 1 << (b - 1).bit_length()
        if bucket > b:
            pad = np.repeat(queries[:1], bucket - b, axis=0)
            queries = np.concatenate([queries, pad], axis=0)
        return queries

    def range_select(self, queries: np.ndarray, result_cap: int = 4096
                     ) -> List[np.ndarray]:
        """Batched distributed select → per-query sorted global rect ids."""
        queries = np.asarray(queries, np.float32)
        if self.mesh_enabled:
            prog = self._mesh_program("select", result_cap=result_cap)
            ids, counts, ctr = prog(queries)
            self.last_counters = ctr
            ids = ids.cpu().numpy()
            counts = counts.cpu().numpy()
            return [np.sort(np.concatenate(
                [ids[p, qi, :counts[p, qi]] for p in range(ids.shape[0])]
            ).astype(np.int64)) for qi in range(len(queries))]
        routing = self.route(queries)
        results = [[] for _ in range(len(queries))]
        acc = None
        for pi, part in enumerate(self.partitions):
            hit = np.nonzero(routing[:, pi])[0]
            if len(hit) == 0:
                continue
            sel = self.engine_for("select", pi, result_cap=result_cap)
            ids, counts, ctr = sel(self._bucket(queries[hit]))
            acc = ctr if acc is None else acc + ctr
            ids = ids.cpu().numpy()
            counts = counts.cpu().numpy()
            for qi, local_q in enumerate(hit):
                found = ids[qi, :counts[qi]]
                results[local_q].append(part.ids[found])
        if acc is not None:
            self.last_counters = acc
        return [np.sort(np.concatenate(r)) if r else
                np.empty((0,), np.int64) for r in results]

    # ------------------------------------------------------------------
    # spatial join (probe rects × partitioned data)
    # ------------------------------------------------------------------

    def join(self, probe, result_cap: int = 1 << 17, o3: bool = False,
             o4: bool = False) -> Tuple[np.ndarray, bool]:
        """Distributed spatial join of a probe relation against the
        partitioned data: returns ((K, 2) int64 pairs (probe id, global
        data id) sorted lexicographically, overflow flag).  ``probe`` is a
        (M, 4) rect array or a pre-built RTree on the fleet's device (its
        rect order defines the probe ids).  ``o3``/``o4`` enable the
        sorted-key pruning — both the probe tree and the partition trees
        must then be built with ``sort_key='lx'``.  On the mesh path a
        probe taller than the forest re-packs the forest at its height,
        and the probe is elevated to the forest's (memoized per probe)."""
        params = dict(result_cap=result_cap, o3=o3, o4=o4,
                      layout=self.layout)
        probe_tree = probe if isinstance(probe, rtree.RTree) else \
            rtree.build_rtree(np.asarray(probe, np.float32),
                              fanout=self.fanout,
                              sort_key="lx" if (o3 or o4) else None,
                              device=self.partitions[0].tree.device)
        if self.mesh_enabled:
            if probe_tree.height > self._forest.height:
                self.enable_mesh(self._forest.device, self._n_shards,
                                 min_height=probe_tree.height)
            # elevated on the host side once, so the program cache (keyed
            # on the probe object) hits across joins of the same probe
            ck = ("elevated_probe", self._forest.height)
            cached = self._engines.get(ck)
            if cached is None or cached[0] is not probe_tree:
                cached = (probe_tree,
                          elevate(probe_tree, self._forest.height))
                self._engines[ck] = cached
            pairs, counts, ctr = self._mesh_program(
                "join", outer_tree=cached[1], result_cap=result_cap, o3=o3,
                o4=o4)()
            self.last_counters = ctr
            pairs = pairs.cpu().numpy()
            counts = counts.cpu().numpy()
            rows = [pairs[p, :counts[p]] for p in range(pairs.shape[0])]
            return self._merge_pairs(rows), bool(int(ctr.overflow))
        rows = []
        ovf = False
        acc = None
        for pi, part in enumerate(self.partitions):
            # join engines close over BOTH trees, so the cache entry is
            # valid only for the same probe-tree object
            key = ("join", pi, tuple(sorted(params.items())))
            cached = self._engines.get(key)
            if cached is None or cached[0] is not probe_tree:
                cached = (probe_tree, traversal.build(
                    "join", probe_tree, part.tree, **params))
                self._engines[key] = cached
            pr, n_pairs, ctr = cached[1]()
            acc = ctr if acc is None else acc + ctr
            pr = pr[:int(n_pairs)].cpu().numpy()
            rows.append(np.stack([pr[:, 0], part.ids[pr[:, 1]]], axis=1))
            ovf |= bool(int(ctr.overflow))
        if acc is not None:
            self.last_counters = acc
        return self._merge_pairs(rows), ovf

    def _merge_pairs(self, rows) -> np.ndarray:
        """Each partition's (probe id, global id) rows → one (K, 2) int64
        array sorted lexicographically (timed in ``last_merge_s``)."""
        t0 = time.perf_counter()
        cat = np.concatenate(rows).astype(np.int64) if rows else \
            np.empty((0, 2), np.int64)
        out = cat[np.lexsort((cat[:, 1], cat[:, 0]))]
        self.last_merge_s = time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------
    # distance operators (kNN, kNN-join)
    # ------------------------------------------------------------------

    def _run_partition(self, op: str, pi: int, queries: np.ndarray,
                       k: int):
        """Run one partition's batched distance engine on a routed query
        subset (padded to its power-of-two bucket); local → global ids.
        Returns (global ids (b, k) int64, dists (b, k) float64, overflow,
        Counters)."""
        part = self.partitions[pi]
        b = len(queries)
        fn = self.engine_for(op, pi, k=k)
        ids, dists, ctr = fn(self._bucket(queries))
        ids = ids[:b].cpu().numpy()
        dists = dists[:b].cpu().numpy().astype(np.float64)
        gids = np.where(ids >= 0, part.ids[np.maximum(ids, 0)], -1)
        return gids, dists, bool(int(ctr.overflow)), ctr

    def knn(self, points: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Distributed exact kNN → (global ids (B, k) int64, squared
        distances (B, k) float64, overflow flag).

        Two-phase routing on the partition MBRs: phase 1 answers every
        query on its primary partition (smallest MBR MINDIST), which gives
        a k-th-distance bound τ; phase 2 asks only the partitions whose
        MBR MINDIST is within τ.  The candidates merge by (distance,
        global id).  ``overflow`` True means some partition's frontier
        fell back to its best-first beam and the result may be approximate.
        On the mesh path both phases run in one program, the bound a
        float32 on the device.
        """
        points = np.asarray(points, np.float32)
        if self.mesh_enabled:
            return self._mesh_distance("knn", points, k)
        dmat = mindist_matrix_np(points, self.router_mbrs)   # (B, P)
        return self._two_phase_knn(points, k, dmat, "knn")

    def knn_join(self, qrects: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Distributed kNN-join → (global ids (B, k) int64, squared rect
        distances (B, k) float64, overflow flag): for each outer rect, its
        k nearest data rects across all partitions under squared
        rect-to-rect MINDIST.  Routed as ``knn``, with the router matrix
        of rect-to-MBR MINDISTs."""
        qrects = np.asarray(qrects, np.float32)
        if self.mesh_enabled:
            return self._mesh_distance("knn_join", qrects, k)
        dmat = mindist_rect_matrix_np(qrects, self.router_mbrs)   # (B, P)
        return self._two_phase_knn(qrects, k, dmat, "knn_join")

    def knn_filtered(self, queries: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Distributed filtered kNN (core/knn_filtered.py): rows (px, py,
        wlx, wly, whx, why) → the k nearest data rects intersecting each
        row's window, as (global ids (B, k) int64, squared distances (B,
        k) float64, overflow flag).  Routed as ``knn`` on the point
        columns: a partition MBR's MINDIST lower-bounds every candidate's
        distance, filtered or not, so the τ bound stays sound."""
        queries = np.asarray(queries, np.float32)
        if self.mesh_enabled:
            return self._mesh_distance("knn_filtered", queries, k)
        dmat = mindist_matrix_np(queries[:, :2], self.router_mbrs)
        return self._two_phase_knn(queries, k, dmat, "knn_filtered")

    def browse(self, points: np.ndarray, k: int):
        """Open a distributed browse session: one cursor a partition and a
        cross-partition pool merge on every ``next_batch()``
        (core/knn_browse.make_sharded_browse).  It runs on the mesh path
        only, as the reference's does, so it requires ``enable_mesh()``
        first: enabling it here would move every other operator of this
        object off the host path."""
        if not self.mesh_enabled:
            raise RuntimeError(
                "distributed browsing runs on the mesh path — call "
                "enable_mesh() first")
        if k not in self._browse_starts:
            self._browse_starts[k] = knn_browse.make_sharded_browse(
                self._forest, k, layout=self.layout)
        return self._browse_starts[k](np.asarray(points, np.float32))

    def _two_phase_knn(self, queries: np.ndarray, k: int, dmat: np.ndarray,
                       op: str) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Primary-partition answer → τ bound → τ-bounded secondary
        fan-out → cross-shard top-k merge by (distance, global id).
        ``dmat``: (B, P) exact float64 query-to-partition-MBR squared
        MINDISTs; ``op`` names the per-partition engine's spec."""
        b = len(queries)
        p = len(self.partitions)
        primary = np.argmin(dmat, axis=1)
        cand_ids = np.full((b, k), -1, np.int64)
        cand_d = np.full((b, k), np.inf)
        overflow = False
        acc = None
        # phase 1: primary partitions
        for pi in range(p):
            sel = np.nonzero(primary == pi)[0]
            if len(sel) == 0:
                continue
            gids, dists, ovf, ctr = self._run_partition(
                op, pi, queries[sel], k)
            acc = ctr if acc is None else acc + ctr
            cand_ids[sel], cand_d[sel] = gids, dists
            overflow |= ovf
        # τ: the current k-th best (inf when the primary held < k rects)
        tau = cand_d[:, k - 1].copy()
        # phase 2: secondary partitions within τ.  Partition distances are
        # float32 and the router's float64, so the bound is widened a hair:
        # that only ever adds fan-out, never skips a partition that could
        # hold a true k-th neighbour
        for pi in range(p):
            tau_cmp = tau * (1.0 + 1e-5) + 1e-30
            sel = np.nonzero((primary != pi) & (dmat[:, pi] <= tau_cmp))[0]
            if len(sel) == 0:
                continue
            gids, dists, ovf, ctr = self._run_partition(
                op, pi, queries[sel], k)
            acc = ctr if acc is None else acc + ctr
            overflow |= ovf
            merged_d = np.concatenate([cand_d[sel], dists], axis=1)
            merged_i = np.concatenate([cand_ids[sel], gids], axis=1)
            order = np.lexsort((merged_i, merged_d))[:, :k]
            cand_d[sel] = np.take_along_axis(merged_d, order, axis=1)
            cand_ids[sel] = np.take_along_axis(merged_i, order, axis=1)
            tau[sel] = cand_d[sel, k - 1]
        if acc is not None:
            self.last_counters = acc
        return cand_ids, cand_d, overflow

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------

    def warm(self, op: str, batch: int, k: Optional[int] = None,
             result_cap: int = 4096, probe=None, **op_params) -> None:
        """Build operator ``op``'s engines and run them once, so a serving
        loop pays no kernel build or first-launch cost.  Host path: every
        partition's engine at every power-of-two bucket up to ``batch``
        (routed subsets can land in any bucket ≤ the full batch's).  Mesh
        path: the one program at the serving batch shape.  Distance
        operators build with ``k``, the others with ``result_cap``.
        ``join`` warms by one join of ``probe`` (rects or RTree) with
        ``op_params`` — its engines close over the probe tree; ``browse``
        by one session's first batch."""
        spec = traversal.get_spec(op)
        if k is None and spec.kind == "distance":
            raise ValueError(f"warming {op!r} needs k")
        if op == "join":
            if probe is None:
                raise ValueError("join warmup needs the probe relation")
            self.join(probe, result_cap=result_cap, **op_params)
        elif op == "browse":
            self.browse(np.zeros((batch, 2), np.float32), k).next_batch()
        elif self.mesh_enabled:
            params = {"k": k} if spec.kind == "distance" else \
                {"result_cap": result_cap}
            self._mesh_program(op, **params)(
                np.zeros((batch, spec.query_width), np.float32))
        else:
            self._warm_host(spec, batch, k, result_cap)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_host(self, spec, batch: int, k: Optional[int],
                   result_cap: int) -> None:
        buckets = []
        bucket = 1 << (max(batch, 1) - 1).bit_length()
        while bucket >= 1:
            buckets.append(bucket)
            bucket //= 2
        params = {"k": k} if spec.kind == "distance" else \
            {"result_cap": result_cap}
        for pi in range(len(self.partitions)):
            fn = self.engine_for(spec.name, pi, **params)
            for bk in buckets:
                fn(np.zeros((bk, spec.query_width), np.float32))
