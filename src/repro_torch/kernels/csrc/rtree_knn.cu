// R-tree kNN and kNN-join level steps, hand-written for Hopper (sm_90a).
//
// Eight kernels behind plain C entry points (loaded with ctypes by
// kernels/_build.py and wrapped by kernels/rtree_knn.py and
// kernels/rtree_knn_join.py).  A query row b scores the C frontier nodes
// ids[b, :] of one level; lane l = c * F + f of the row is child f of node
// ids[b, c].  A lane is valid iff ids[b, c] >= 0 and child[node, f] >= 0;
// an invalid lane's distances are DIST_PAD.  Distances are squared
// Euclidean, rounded exactly as the reference's jitted gather traces round
// them (core/geometry.py):
//     point MINDIST     fma(dx, dx, dy*dy)
//     point MINMAXDIST  min(fma(dMy, dMy, dmx*dmx), fma(dmy, dmy, dMx*dMx))
//     centre            (lo + hi) * 0.5
//     rect MINDIST      fma(dx, dx, dy*dy)      (dx, dy interval gaps)
//     rect MINMAXDIST   min(fma(mgy, mgy, ngx*ngx), fma(ngy, ngy, mgx*mgx))
//                       (ngx, mgx = min, max of the two x face gaps; y alike)
// written with explicit intrinsics, so nvcc's --fmad cannot choose another
// contraction.  The distance functions live in a query functor (PointQuery
// for kNN, RectQuery for kNN-join), the template parameter of every
// kernel, so both operators run one body per kernel.
//
// B5  rtree_knn_dists — replaces the Pallas kernel
//     src/repro/kernels/rtree_knn.py:knn_level_dists (line 105; bodies
//     _knn_kernel line 68, _knn_leaf_kernel line 91).  Dense (B, C, F)
//     float32 MINDIST and (not at the leaf) MINMAXDIST.
//     Bound on the card: memory — the outputs (4 or 8 bytes a lane), the
//     ids, and 20*F bytes of rows per distinct live node.  About 90% of a
//     served frontier's slots are padding (-1), and at batch 4,096 the
//     output stream is 2.7x the L2 cache, so the design spends nothing on
//     a dead slot and writes the outputs as a stream:
//       - the work unit is a frontier slot (b, c): a group of F/4 threads
//         owns it, each thread 4 neighbouring lanes, so a slot's id (and,
//         when it is live, its query row) is read once per thread for 4
//         lanes, in one transaction per warp;
//       - a dead slot (id < 0) reads no row and writes DIST_PAD to its F
//         lanes; a live slot issues its child and its lx/ly/hx/hy loads
//         together (16 bytes each) and selects DIST_PAD by the child's
//         sign afterwards, so there is no child -> row round trip;
//       - a persistent grid, as many blocks as fit on the card, strides
//         over the slots and loads the next slot's id (kSlotBatch ids)
//         before it works on this one, so that load overlaps this slot's
//         loads and stores;
//       - outputs are written with 16-byte streaming stores (evict-first),
//         so they pass through L2 without evicting the node rows that
//         later slots read again.
//     The vector variant (kLanes 4) needs F % 4 == 0 and 16-byte aligned
//     rows and outputs; otherwise the same kernel runs with one lane a
//     thread (kLanes 1, the scalar-lane variant).  launch_dists chooses.
//
// B6  rtree_knn_level_fused — replaces
//     src/repro/kernels/rtree_knn.py:knn_level_fused (line 454, through
//     fused_inner_call line 241).  One internal level of the distance
//     engine: tau = min(tau_in, k-th smallest MINMAXDIST over all C*F
//     lanes, PAD lanes included) when `tighten`; keep = valid && MINDIST
//     <= tau; the next frontier is the child ids of the kept lanes in
//     ascending (MINDIST, lane) order, at most `cap`, -1 padded; plus the
//     valid and kept tallies.
//
// B7  rtree_knn_leaf_fused — replaces
//     src/repro/kernels/rtree_knn.py:knn_leaf_fused (line 467, through
//     fused_leaf_call line 361).  The leaf: the k valid lanes of smallest
//     (MINDIST, lane) as (child id, distance), (-1, +inf) for missing rows,
//     plus the valid tally.
//
//     The TPU kernels merge a running top-k in VMEM across a sequential
//     grid of frontier chunks.  Here one block of kRowThreads threads owns
//     one query row and selects instead of merging.  Non-negative float32
//     distances order as their uint32 bits, so key = bits(d) << 32 | lane
//     is unique and orders exactly as the reference's stable top-k.
//     Bound on the card: memory — the ids, the rows of the distinct live
//     nodes, and the (B, cap) or (B, k) outputs, a few MB at batch 64.  So
//     both kernels are latency-bound: what costs is each pass over the
//     row, and about 90% of a served row's C*F lanes are padding.  The
//     design (knn_emit_kernel, one body for B6, B7, B9 and B10):
//       - list the live slots once: coalesced id loads, a ballot and a
//         scan; a dead slot is never touched again (its lanes are
//         DIST_PAD: invalid, never kept, after every valid lane);
//       - score once, into shared memory: a group of F/4 threads owns a
//         live slot, each thread 4 lanes, whose child and box loads go out
//         together (Level::dists, B5's), and stages each lane's MINDIST
//         and (not at the leaf) MINMAXDIST; every later pass reads only
//         the staging;
//       - tau: a valid lane's MINMAXDIST is below DIST_VALID_MAX, so the
//         k-th smallest over the C*F lanes is the k-th smallest staged one
//         when k lanes are valid, else DIST_PAD: a radix select over the
//         staged bits (a 256-bin histogram a key byte, 4 passes), each
//         warp adding its lanes of one bin with one atomic;
//       - tally, then on overflow (kept > cap) the same select of the
//         cap-th kept 64-bit key; an ordered compaction with no atomics
//         (each warp counts a contiguous run of staged lanes, one scan of
//         the warp totals, each warp writes its survivors in lane order);
//       - order the <= cap survivors: up to kRankSortMax by counting each
//         key's rank (one thread a key, no barrier), more by a bitonic
//         sort; write the child ids.
//     The staging is sized on the host (emit_stage_slots): the whole row
//     when its C*F lanes fit kStageBytes, else fewer slots.  A row whose
//     live slots outnumber them is walked in segments, re-listed and
//     re-scored in every pass (live lanes only).  The vector variant (4
//     lanes a thread) needs F % 4 == 0 and 16-byte aligned rows;
//     otherwise the same kernel runs with one lane a thread.
//
// B8  rtree_knn_join_dists — replaces
//     src/repro/kernels/rtree_knn_join.py:knn_join_level_dists (line 87;
//     bodies _knn_join_kernel line 47, _knn_join_leaf_kernel line 69).
//     B5's kernel with RectQuery: rect MINDIST and (not at the leaf) rect
//     MINMAXDIST.  Bound on the card: memory, as B5, with 16-byte query
//     rows; at the served leaf step (64 x 128 x 64 lanes) ~3.1 MB, about
//     0.001 ms at 3.35 TB/s.
//
// B9  rtree_knn_join_level_fused — replaces
//     src/repro/kernels/rtree_knn_join.py:knn_join_level_fused (line 224,
//     through rtree_knn.py:fused_inner_call line 241).  B6's kernel with
//     RectQuery: the query row is 16 bytes instead of 8, all else as B6.
//
// B10 rtree_knn_join_leaf_fused — replaces
//     src/repro/kernels/rtree_knn_join.py:knn_join_leaf_fused (line 237,
//     through rtree_knn.py:fused_leaf_call line 361).  B7's kernel with
//     RectQuery (16-byte query rows), all else as B7.
//     B9 and B10 are bound by memory as B6 and B7.  The all-pairs join
//     runs them at batch 4096, one block per query: 4096 blocks a launch.
//
// B13 rtree_knn_dists_d3 — replaces the Pallas kernel
//     src/repro/kernels/rtree_knn.py:knn_level_dists_d3 (line 190; body
//     _knn_d3_kernel line 167).  B5's body (knn_dists_kernel) on a D3
//     level (LevelD3): each lane dequantizes its box from the packed
//     uint16 codes, bias + code * scale, exact as in rtree_select.cu's
//     B11.  A thread reads its slot's node scale, bias and slack once (8
//     bytes each) for its lanes, and four lanes' codes in one 8-byte load
//     per array; the vector variant also needs 8-byte aligned codes and
//     node columns.  MINDIST is the functor's form (a lower bound on the
//     true box).  MINMAXDIST takes the form of the reference's D3 trace,
//     which folds the other product of the first term:
//         point  min(fma(dmx, dmx, dMy*dMy), fma(dmy, dmy, dMx*dMx))
//         rect   min(fma(ngx, ngx, mgy*mgy), fma(ngy, ngy, mgx*mgx))
//     and is then made an upper bound on the true box with the node's
//     slack (layouts.d3_slacked_upper):
//         up = sqrt(max(m, 0)) + (slack_x + slack_y)
//         u  = (up * up) * (1 + 2^-16)
//     The square root must be __fsqrt_rn, the correctly rounded one, as
//     every rounding here is an explicit intrinsic.  Invalid lanes get
//     DIST_PAD after the correction.  Internal levels only: the operators
//     re-check leaf rows with B5.
//     Bound on the card: memory — 4*B*C ids, 8*B query bytes, 8F + 24
//     bytes per distinct live node (codes, ptr, scale, bias, slack) and
//     the 8*B*C*F bytes of the two outputs.
//
// B14 rtree_knn_join_dists_d3 — replaces the Pallas kernel
//     src/repro/kernels/rtree_knn_join.py:knn_join_level_dists_d3 (line
//     168; body _knn_join_d3_kernel line 144).  B13 with RectQuery:
//     16-byte query rows, the rect distances; bound as B13.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr float kDeltaClamp = 1.0e18f;    // geometry._DELTA_CLAMP
constexpr float kDistPad = 3.0e38f;       // geometry.DIST_PAD
constexpr float kDistValidMax = 1.0e37f;  // geometry.DIST_VALID_MAX
constexpr float kSlackScale = 1.0f + 1.0f / 65536.0f;   // 1 + 2^-16, exact
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDistThreads = 256;         // B5 / B8 / B13 / B14 per block
// Slots whose ids a B5 / B8 / B13 / B14 thread loads together, one batch
// ahead: 4 measured slower than 1 on the H100 (PERF.md, PR 17).
constexpr int kSlotBatch = 1;
constexpr int kRowThreads = 256;          // B6 / B7 threads per query row
constexpr int kRowWarps = kRowThreads / kWarp;
// B6 / B7 blocks that an SM should hold at once: bounds the registers to
// 42 a thread, as the staging (kStageBytes) bounds the shared memory.
constexpr int kRowBlocks = 6;
constexpr int kBins = 256;                // radix digits of one key byte
constexpr int kMaxCap = 16384;            // survivors' keys: 128 KB
// Shared memory a B6 / B7 block stages its row's scores in: 32 KB leaves
// room for six blocks on an SM.
constexpr int kStageBytes = 32 * 1024;
// Survivors up to this many are ordered by counting ranks (one thread a
// key), more by a bitonic sort.
constexpr int kRankSortMax = kRowThreads;
static_assert(kBins == 8 * kWarp, "one warp scans the bins, 8 per lane");
static_assert(kRowWarps <= kWarp, "one warp scans the warp totals");

__device__ __forceinline__ float axis_gap(float p, float lo, float hi) {
  return fminf(fmaxf(fmaxf(__fsub_rn(lo, p), __fsub_rn(p, hi)), 0.0f),
               kDeltaClamp);
}

__device__ __forceinline__ float face_dist(float p, float face) {
  return fminf(fabsf(__fsub_rn(p, face)), kDeltaClamp);
}

// Gap between the intervals [a_lo, a_hi] and [b_lo, b_hi], with the
// operand order of geometry.rect_axis_gap; b_lo == b_hi gives the gap to
// one face (geometry._face_gap).
__device__ __forceinline__ float interval_gap(float a_lo, float a_hi,
                                              float b_lo, float b_hi) {
  return fminf(fmaxf(fmaxf(__fsub_rn(a_lo, b_hi), __fsub_rn(b_lo, a_hi)),
                     0.0f),
               kDeltaClamp);
}

// A query point (px, py): the kNN distance functions.
struct PointQuery {
  static constexpr int kWidth = 2;        // floats per query row
  float px, py;
  __device__ explicit PointQuery(const float* q) : px(q[0]), py(q[1]) {}

  __device__ __forceinline__ float mindist(float lx, float ly, float hx,
                                           float hy) const {
    const float dx = axis_gap(px, lx, hx);
    const float dy = axis_gap(py, ly, hy);
    return __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  }

  __device__ __forceinline__ float minmaxdist(float lx, float ly, float hx,
                                              float hy) const {
    const float cx = __fmul_rn(__fadd_rn(lx, hx), 0.5f);
    const float cy = __fmul_rn(__fadd_rn(ly, hy), 0.5f);
    const float dmx = face_dist(px, px <= cx ? lx : hx);
    const float dmy = face_dist(py, py <= cy ? ly : hy);
    const float dMx = face_dist(px, px >= cx ? lx : hx);
    const float dMy = face_dist(py, py >= cy ? ly : hy);
    return fminf(__fmaf_rn(dMy, dMy, __fmul_rn(dmx, dmx)),
                 __fmaf_rn(dmy, dmy, __fmul_rn(dMx, dMx)));
  }

  // MINMAXDIST in the form of the reference's D3 trace (see B13).
  __device__ __forceinline__ float minmaxdist_d3(float lx, float ly,
                                                 float hx, float hy) const {
    const float cx = __fmul_rn(__fadd_rn(lx, hx), 0.5f);
    const float cy = __fmul_rn(__fadd_rn(ly, hy), 0.5f);
    const float dmx = face_dist(px, px <= cx ? lx : hx);
    const float dmy = face_dist(py, py <= cy ? ly : hy);
    const float dMx = face_dist(px, px >= cx ? lx : hx);
    const float dMy = face_dist(py, py >= cy ? ly : hy);
    return fminf(__fmaf_rn(dmx, dmx, __fmul_rn(dMy, dMy)),
                 __fmaf_rn(dmy, dmy, __fmul_rn(dMx, dMx)));
  }
};

// A query rect (qlx, qly, qhx, qhy): the kNN-join distance functions.
struct RectQuery {
  static constexpr int kWidth = 4;        // floats per query row
  float qlx, qly, qhx, qhy;
  __device__ explicit RectQuery(const float* q)
      : qlx(q[0]), qly(q[1]), qhx(q[2]), qhy(q[3]) {}

  __device__ __forceinline__ float mindist(float lx, float ly, float hx,
                                           float hy) const {
    const float dx = interval_gap(qlx, qhx, lx, hx);
    const float dy = interval_gap(qly, qhy, ly, hy);
    return __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  }

  __device__ __forceinline__ float minmaxdist(float lx, float ly, float hx,
                                              float hy) const {
    const float gxl = interval_gap(qlx, qhx, lx, lx);
    const float gxh = interval_gap(qlx, qhx, hx, hx);
    const float gyl = interval_gap(qly, qhy, ly, ly);
    const float gyh = interval_gap(qly, qhy, hy, hy);
    const float ngx = fminf(gxl, gxh), mgx = fmaxf(gxl, gxh);
    const float ngy = fminf(gyl, gyh), mgy = fmaxf(gyl, gyh);
    return fminf(__fmaf_rn(mgy, mgy, __fmul_rn(ngx, ngx)),
                 __fmaf_rn(ngy, ngy, __fmul_rn(mgx, mgx)));
  }

  // MINMAXDIST in the form of the reference's D3 trace (see B14).
  __device__ __forceinline__ float minmaxdist_d3(float lx, float ly,
                                                 float hx, float hy) const {
    const float gxl = interval_gap(qlx, qhx, lx, lx);
    const float gxh = interval_gap(qlx, qhx, hx, hx);
    const float gyl = interval_gap(qly, qhy, ly, ly);
    const float gyh = interval_gap(qly, qhy, hy, hy);
    const float ngx = fminf(gxl, gxh), mgx = fmaxf(gxl, gxh);
    const float ngy = fminf(gyl, gyh), mgy = fmaxf(gyl, gyh);
    return fminf(__fmaf_rn(ngx, ngx, __fmul_rn(mgy, mgy)),
                 __fmaf_rn(ngy, ngy, __fmul_rn(mgx, mgx)));
  }
};

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// kLanes neighbouring values from p through the read-only path: for
// kLanes 4 one 16-byte load (float, int) or one 8-byte load (uint16).
template <int kLanes>
__device__ __forceinline__ void load_lanes(const float* p,
                                           float (&v)[kLanes]) {
  if constexpr (kLanes == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kLanes>
__device__ __forceinline__ void load_lanes(const int* p, int (&v)[kLanes]) {
  if constexpr (kLanes == 4) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kLanes>
__device__ __forceinline__ void load_lanes(const uint16_t* p,
                                           unsigned (&v)[kLanes]) {
  if constexpr (kLanes == 4) {            // little-endian: lane 0 is low
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = w.x & 0xFFFFu, v[1] = w.x >> 16;
    v[2] = w.y & 0xFFFFu, v[3] = w.y >> 16;
  } else {
    v[0] = __ldg(p);
  }
}

// Node `node`'s two float32 columns of an (N, 2) array: one 8-byte load in
// the vector variant, whose launch checked the alignment.
template <int kLanes>
__device__ __forceinline__ float2 load_node_pair(const float* p, int node) {
  if constexpr (kLanes == 4) {
    return __ldg(reinterpret_cast<const float2*>(p) + node);
  } else {
    return make_float2(__ldg(p + 2 * node), __ldg(p + 2 * node + 1));
  }
}

// kLanes neighbouring outputs as a stream (evict-first): 16 bytes at once
// for kLanes 4.
template <int kLanes>
__device__ __forceinline__ void store_lanes(float* p,
                                            const float (&v)[kLanes]) {
  if constexpr (kLanes == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// One level's SoA rows and the frontier.
struct Level {
  const int* ids;                         // (B, C) node ids, -1 pad
  const float* lx;                        // (N, F) each
  const float* ly;
  const float* hx;
  const float* hy;
  const int* child;                       // (N, F) child ids, -1 pad
  int C;
  int F;
  static constexpr bool kHasLeaf = true;

  // Whether the rows take the vector variant (4 lanes a 16-byte load).
  bool vector_ok() const {
    return F % 4 == 0 && aligned(lx, 16) && aligned(ly, 16) &&
           aligned(hx, 16) && aligned(hy, 16) && aligned(child, 16);
  }

  // MINDIST and (not at the leaf) MINMAXDIST of the kLanes entries of
  // `node` from row offset `off`, DIST_PAD where the child is -1.  The
  // child and the box loads are issued together.
  template <class Q, bool kLeaf, int kLanes>
  __device__ __forceinline__ void dists(const Q& q, int node, int64_t off,
                                        float (&d)[kLanes],
                                        float (&u)[kLanes]) const {
    int c[kLanes];
    float x0[kLanes], y0[kLanes], x1[kLanes], y1[kLanes];
    load_lanes<kLanes>(child + off, c);
    load_lanes<kLanes>(lx + off, x0);
    load_lanes<kLanes>(ly + off, y0);
    load_lanes<kLanes>(hx + off, x1);
    load_lanes<kLanes>(hy + off, y1);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      d[l] = c[l] >= 0 ? q.mindist(x0[l], y0[l], x1[l], y1[l]) : kDistPad;
      if (!kLeaf)
        u[l] = c[l] >= 0 ? q.minmaxdist(x0[l], y0[l], x1[l], y1[l])
                         : kDistPad;
    }
  }
};

// One D3 level: packed uint16 code rows (N, F), the per-node float32
// scale, bias and slack (N, 2), the child ids, and the frontier.
struct LevelD3 {
  const int* ids;                         // (B, C) node ids, -1 pad
  const uint16_t* qlo;                    // (N, F) (x << 8) | y, floored
  const uint16_t* qhi;                    // (N, F) (x << 8) | y, ceiled
  const float* scale;                     // (N, 2) powers of two
  const float* bias;                      // (N, 2) node lo corner
  const float* slack;                     // (N, 2) face displacement
  const int* child;                       // (N, F) child ids, -1 pad
  int C;
  int F;
  static constexpr bool kHasLeaf = false;

  // Whether the rows take the vector variant (4 lanes' codes an 8-byte
  // load, a node's columns an 8-byte load).
  bool vector_ok() const {
    return F % 4 == 0 && aligned(qlo, 8) && aligned(qhi, 8) &&
           aligned(scale, 8) && aligned(bias, 8) && aligned(slack, 8) &&
           aligned(child, 16);
  }

  // MINDIST on the dequantized box, and its D3-form MINMAXDIST with the
  // slack correction (B13), of the kLanes entries of `node` from row
  // offset `off`, DIST_PAD where the child is -1; internal levels only,
  // so kLeaf is false.
  template <class Q, bool kLeaf, int kLanes>
  __device__ __forceinline__ void dists(const Q& q, int node, int64_t off,
                                        float (&d)[kLanes],
                                        float (&u)[kLanes]) const {
    static_assert(!kLeaf, "D3 leaf rows are re-checked with B5 / B8");
    int c[kLanes];
    unsigned lo[kLanes], hi[kLanes];
    load_lanes<kLanes>(child + off, c);
    load_lanes<kLanes>(qlo + off, lo);
    load_lanes<kLanes>(qhi + off, hi);
    const float2 s = load_node_pair<kLanes>(scale, node);
    const float2 b = load_node_pair<kLanes>(bias, node);
    const float2 k = load_node_pair<kLanes>(slack, node);
    const float disp = __fadd_rn(k.x, k.y);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const float x0 = __fadd_rn(b.x, __fmul_rn((float)(lo[l] >> 8), s.x));
      const float y0 = __fadd_rn(b.y, __fmul_rn((float)(lo[l] & 0xFFu), s.y));
      const float x1 = __fadd_rn(b.x, __fmul_rn((float)(hi[l] >> 8), s.x));
      const float y1 = __fadd_rn(b.y, __fmul_rn((float)(hi[l] & 0xFFu), s.y));
      const float m = q.minmaxdist_d3(x0, y0, x1, y1);
      const float up = __fadd_rn(__fsqrt_rn(fmaxf(m, 0.0f)), disp);
      d[l] = c[l] >= 0 ? q.mindist(x0, y0, x1, y1) : kDistPad;
      u[l] = c[l] >= 0 ? __fmul_rn(__fmul_rn(up, up), kSlackScale)
                       : kDistPad;
    }
  }
};

__device__ __forceinline__ u64 make_key(float d, int l) {
  return ((u64)__float_as_uint(d) << 32) | (unsigned)l;
}

// Shared state of the block-level select, ranks and sums.
struct Scratch {
  int hist[kBins];
  int warp_tot[kRowWarps];
  u64 prefix;
  int rank;
  int next;
  bool single;                            // one key has the prefix found
};

// The rank-th smallest (0-based) key among the staged lanes i for which
// keyfn(i, &key, with_lane) is true, found byte by byte from the most
// significant; keyfn may leave the lane field (the low 4 bytes) 0 when
// with_lane is false.  Bytes below lo_byte come back 0 and bytes in
// [lane_bytes, 4) of the lane field are 0 in every key, so their passes
// are skipped.  Once the distance bytes (7-4) are found, if one key alone
// has them, the lane bytes come back all ones instead of being selected:
// the result then bounds exactly the keys up to the rank-th from above,
// all a compaction needs.  walk(visit) calls visit(n) once for each
// segment of the row staged in shared memory (n staged lanes).  A warp
// adds its lanes of one bin to the histogram with one atomic
// (__match_any_sync), so lanes that share a digit, as most distances share
// their exponent, do not queue on one bin.  The caller guarantees rank <
// the number of such lanes.  All threads must call.
template <class Walk, class KeyFn>
__device__ u64 radix_select(Walk& walk, KeyFn keyfn, int rank, int lo_byte,
                            int lane_bytes, Scratch& s) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  u64 prefix = 0, mask = 0;
  for (int byte = 7; byte >= lo_byte; --byte) {
    const int shift = 8 * byte;
    if (byte < 4 && byte >= lane_bytes) {   // a zero byte of every lane
      mask |= 0xFFull << shift;
      continue;
    }
    for (int i = threadIdx.x; i < kBins; i += kRowThreads) s.hist[i] = 0;
    __syncthreads();
    walk([&](int n) {
      for (int j = warp * kWarp; j < n; j += kRowThreads) {  // warp-uniform
        const int i = j + lane;
        u64 key = 0;
        const bool in = i < n && keyfn(i, &key, byte < 4) &&
                        (key & mask) == prefix;
        const int bin = in ? (int)((key >> shift) & 0xFF) : -1;
        const unsigned peers = __match_any_sync(kFull, bin);
        if (in && lane == __ffs(peers) - 1)
          atomicAdd(&s.hist[bin], __popc(peers));
      }
    });
    __syncthreads();
    if (warp == 0) {
      int own = 0;
      for (int j = 0; j < 8; ++j) own += s.hist[8 * lane + j];
      int incl = own;
      for (int d = 1; d < kWarp; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      const unsigned hit = __ballot_sync(kFull, rank < incl);
      if (lane == __ffs(hit) - 1) {
        int r = rank - (incl - own);
        int bin = 8 * lane;
        while (r >= s.hist[bin]) r -= s.hist[bin++];
        s.prefix = prefix | ((u64)bin << shift);
        s.rank = r;
        s.single = s.hist[bin] == 1;
      }
    }
    __syncthreads();
    // the next pass clears hist and rewrites prefix only after its own
    // first barrier, which every thread reaches after these reads
    prefix = s.prefix;
    rank = s.rank;
    mask |= 0xFFull << shift;
    if (byte == 4 && lo_byte < 4 && s.single)   // uniform
      return prefix | 0xFFFFFFFFull;
  }
  return prefix;
}

// The block's sum of v, in every thread.  All threads must call.
__device__ __forceinline__ int block_sum(int v, Scratch& s) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if (lane == 0) s.warp_tot[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kRowWarps; ++w) total += s.warp_tot[w];
  __syncthreads();                        // warp_tot is rewritten next call
  return total;
}

// Exclusive rank of `flag` among the block's threads in thread order;
// *total gets the block's count.  All threads must call.
__device__ __forceinline__ int block_rank(bool flag, Scratch& s, int* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned bal = __ballot_sync(kFull, flag);
  if (lane == 0) s.warp_tot[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = lane < kRowWarps ? s.warp_tot[lane] : 0;
    for (int d = 1; d < kRowWarps; d <<= 1) {
      const int up = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += up;
    }
    if (lane < kRowWarps) s.warp_tot[lane] = v;
  }
  __syncthreads();
  const int r = (warp == 0 ? 0 : s.warp_tot[warp - 1]) +
                __popc(bal & ((1u << lane) - 1u));
  *total = s.warp_tot[kRowWarps - 1];
  __syncthreads();                        // warp_tot is rewritten next call
  return r;
}

// Ascending bitonic sort of keys[0, n) in shared memory; keys[n, pow2)
// are filled with the largest key first.  All threads must call.
__device__ void bitonic_sort(u64* keys, int n) {
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  for (int i = n + threadIdx.x; i < np2; i += blockDim.x) keys[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= np2; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < np2; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const u64 a = keys[i], c = keys[p];
          if ((a > c) == ((i & size) == 0)) {
            keys[i] = c;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Bytes needed for a lane index < M.
int lane_bytes_for(long long M) {
  int n = 1;
  while (n < 4 && (M - 1) >> (8 * n)) ++n;
  return n;
}

__host__ __device__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets in a B6 / B7 block's dynamic shared memory: the survivors'
// keys (pow2_at_least(cap)), then the staged MINDIST and (not at the leaf)
// MINMAXDIST of `slots` frontier slots' F lanes, then those slots' node
// ids and slot indices.
struct EmitSmem {
  size_t keys, md, mmd, node, slot, total;
  __host__ __device__ EmitSmem(int cap, int slots, int F, bool leaf) {
    const size_t lanes = sizeof(float) * (size_t)slots * F;
    keys = 0;
    md = align16(sizeof(u64) * (size_t)pow2_at_least(cap > 0 ? cap : 1));
    mmd = align16(md + lanes);
    node = leaf ? mmd : align16(mmd + lanes);
    slot = node + sizeof(int) * (size_t)slots;
    total = slot + sizeof(int) * (size_t)slots;
  }
};

// Frontier slots whose lanes a B6 / B7 block stages at once: the whole
// row when its C * F lanes fit kStageBytes, else as many slots as fit (at
// least one).
int emit_stage_slots(int C, int F, bool leaf) {
  const long long fit = kStageBytes / ((long long)F * (leaf ? 4 : 8));
  return (int)(fit >= C ? C : fit > 0 ? fit : 1);
}

// The ids of slots first, first + stride, ... (kSlotBatch of them), -1
// past n_slots: independent loads, all in flight at once.
__device__ __forceinline__ void load_slot_ids(const int* ids, unsigned first,
                                              unsigned stride,
                                              unsigned n_slots,
                                              int (&node)[kSlotBatch]) {
#pragma unroll
  for (int k = 0; k < kSlotBatch; ++k) {
    const unsigned s = first + k * stride;
    node[k] = s < n_slots ? __ldg(ids + s) : -1;
  }
}

// One slot's lanes first, first + step, ... (kLanes each) of the F.
template <class Q, class L, bool kLeaf, int kLanes>
__device__ __forceinline__ void score_slot(const L& lv, const float* queries,
                                           float* md, float* mmd,
                                           unsigned slot, int node, int first,
                                           int step) {
  float* const d_out = md + (int64_t)slot * lv.F;
  float* const u_out = kLeaf ? nullptr : mmd + (int64_t)slot * lv.F;
  float d[kLanes], u[kLanes];
  if (node >= 0) {
    const Q q(queries + (size_t)(slot / (unsigned)lv.C) * Q::kWidth);
    const int64_t row = (int64_t)node * lv.F;
    for (int j = first; j < lv.F; j += step) {
      lv.template dists<Q, kLeaf, kLanes>(q, node, row + j, d, u);
      store_lanes<kLanes>(d_out + j, d);
      if (!kLeaf) store_lanes<kLanes>(u_out + j, u);
    }
  } else {                                // a dead slot reads no row
#pragma unroll
    for (int l = 0; l < kLanes; ++l) d[l] = kDistPad;
    for (int j = first; j < lv.F; j += step) {
      store_lanes<kLanes>(d_out + j, d);
      if (!kLeaf) store_lanes<kLanes>(u_out + j, d);
    }
  }
}

// B5 / B8 (L a Level) and B13 / B14 (L a LevelD3) over n_slots = B * C
// frontier slots: a group of F / kLanes threads (at most a block) owns a
// slot, each thread kLanes neighbouring lanes; the block's groups take
// neighbouring slots and the persistent grid strides over the rest,
// kSlotBatch slots a thread at a time, whose ids were loaded together
// while the thread worked on the batch before.
template <class Q, class L, bool kLeaf, int kLanes>
__global__ void __launch_bounds__(kDistThreads)
knn_dists_kernel(L lv, const float* __restrict__ queries,
                 float* __restrict__ md, float* __restrict__ mmd,
                 unsigned n_slots) {
  const int units = lv.F / kLanes;        // a slot's units of kLanes lanes
  const int group = units < kDistThreads ? units : kDistThreads;
  const unsigned per_block = kDistThreads / group;
  const unsigned g = threadIdx.x / group;
  if (g >= per_block) return;             // the block's ragged tail
  const int first = (threadIdx.x - g * group) * kLanes;
  const unsigned stride = gridDim.x * per_block;
  unsigned slot = blockIdx.x * per_block + g;
  int node[kSlotBatch];
  load_slot_ids(lv.ids, slot, stride, n_slots, node);
  // slot + 2 * kSlotBatch * stride < 2^32: launch_dists checks n_slots
  for (; slot < n_slots; slot += kSlotBatch * stride) {
    int next[kSlotBatch];
    load_slot_ids(lv.ids, slot + kSlotBatch * stride, stride, n_slots, next);
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      const unsigned s = slot + k * stride;
      if (s < n_slots)
        score_slot<Q, L, kLeaf, kLanes>(lv, queries, md, mmd, s, node[k],
                                        first, group * kLanes);
      node[k] = next[k];
    }
  }
}

// kLanes neighbouring staged scores into shared memory: 16 bytes at once
// for kLanes 4 (the staged row offset is a multiple of 4 there).
template <int kLanes>
__device__ __forceinline__ void stage_lanes(float* p,
                                            const float (&v)[kLanes]) {
  if constexpr (kLanes == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// Lists the live slots (id >= 0) of row[from, C) in slot order, at most
// `most` of them, as node ids and slot indices; returns their number and
// sets *next to the first slot not listed (C when the rest of the row
// was).  Coalesced id loads, a ballot and a scan a tile of kRowThreads
// slots.  All threads must call; the results are the same in all.
__device__ int list_live(const int* __restrict__ row, int C, int from,
                         int most, int* s_node, int* s_slot, Scratch& s,
                         int* next) {
  int n = 0;
  for (int t0 = from; t0 < C; t0 += kRowThreads) {
    const int slot = t0 + threadIdx.x;
    const int id = slot < C ? __ldg(row + slot) : -1;
    int total;
    const int pos = n + block_rank(id >= 0, s, &total);
    if (id >= 0 && pos < most) {
      s_node[pos] = id;
      s_slot[pos] = slot;
    }
    if (n + total > most) {               // uniform: the segment is full
      // the slot after the last one listed; every live slot before t0 is
      // listed when n == most
      if (n == most) {
        *next = t0;
      } else {
        if (id >= 0 && pos == most - 1) s.next = slot + 1;
        __syncthreads();
        *next = s.next;
      }
      __syncthreads();                    // the lists are read next
      return most;
    }
    n += total;
  }
  *next = C;
  __syncthreads();                        // the lists are read next
  return n;
}

// Scores the F lanes of the n listed live slots (node ids s_node) into the
// staging: MINDIST into s_md and (not at the leaf) MINMAXDIST into s_mmd,
// lane f of listed slot r at r * F + f, DIST_PAD where the child is -1.
// A group of F / kLanes threads (at most a block) owns a slot, each thread
// kLanes neighbouring lanes, whose child and box loads go out together
// (Level::dists, the score kernel's).
template <class Q, bool kLeaf, int kLanes>
__device__ __forceinline__ void score_live(const Level& L, const Q& q,
                                           const int* s_node, int n,
                                           float* s_md, float* s_mmd) {
  const int F = L.F;
  const int units = F / kLanes;
  const int group = units < kRowThreads ? units : kRowThreads;
  const int per_block = kRowThreads / group;
  const int g = threadIdx.x / group;
  if (g >= per_block) return;             // the block's ragged tail
  const int first = (threadIdx.x - g * group) * kLanes;
  for (int r = g; r < n; r += per_block) {
    const int node = s_node[r];
    const int64_t row = (int64_t)node * F;
    for (int j = first; j < F; j += group * kLanes) {
      float d[kLanes], u[kLanes];
      L.template dists<Q, kLeaf, kLanes>(q, node, row + j, d, u);
      stage_lanes<kLanes>(s_md + r * F + j, d);
      if (!kLeaf) stage_lanes<kLanes>(s_mmd + r * F + j, u);
    }
  }
}

// B6 / B9 (kLeaf false) and B7 / B10 (kLeaf true): one block per query row.
//   B6 / B9: out_ids (B, cap) next frontier; tau_out, valid_cnt, keep_cnt
//            (B,).
//   B7 / B10: cap == k; out_ids (B, k), out_d (B, k); valid_cnt (B,).
// The block lists its row's live slots and stages their lanes' scores in
// shared memory once; every later pass reads only the staging.  A row
// whose live slots outnumber stage_slots is walked in segments of
// stage_slots live slots, each re-listed and re-scored in every pass.
// Dead slots are never touched after the list: their lanes are DIST_PAD,
// invalid, never kept, and order after every valid lane.
template <class Q, bool kLeaf, int kLanes>
__global__ void __launch_bounds__(kRowThreads, kRowBlocks)
knn_emit_kernel(Level L, const float* __restrict__ queries,
                const float* __restrict__ tau_in, int* __restrict__ out_ids,
                float* __restrict__ out_d, float* __restrict__ tau_out,
                int* __restrict__ valid_cnt, int* __restrict__ keep_cnt,
                int cap, int k, int tighten, int lane_bytes,
                int stage_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch s;
  const EmitSmem lay(cap, stage_slots, L.F, kLeaf);
  u64* const keys = reinterpret_cast<u64*>(smem + lay.keys);
  float* const s_md = reinterpret_cast<float*>(smem + lay.md);
  float* const s_mmd = reinterpret_cast<float*>(smem + lay.mmd);
  int* const s_node = reinterpret_cast<int*>(smem + lay.node);
  int* const s_slot = reinterpret_cast<int*>(smem + lay.slot);
  const int b = blockIdx.x, C = L.C, F = L.F;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int* const row = L.ids + (int64_t)b * C;
  const Q q(queries + (int64_t)b * Q::kWidth);

  // stages the segment of live slots from slot `from` on; returns its
  // staged lanes and sets *next past it
  auto stage = [&](int from, int* next) {
    const int n = list_live(row, C, from, stage_slots, s_node, s_slot, s,
                            next);
    score_live<Q, kLeaf, kLanes>(L, q, s_node, n, s_md, s_mmd);
    __syncthreads();
    return n * F;
  };
  int next;
  const int first = stage(0, &next);
  const bool whole = next >= C;           // uniform: the row fits at once
  // visit(n) over each staged segment of the row (n staged lanes)
  auto walk = [&](auto&& visit) {
    if (whole) {
      visit(first);
      return;
    }
    for (int from = 0; from < C;) {
      __syncthreads();                    // the last visit is done
      visit(stage(from, &from));
    }
  };
  // the global lane c * F + f of staged lane i, c its slot
  auto lane_of = [&](int i) {
    const int r = i / F;
    return s_slot[r] * F + (i - r * F);
  };

  int n_valid = 0;
  walk([&](int n) {
    for (int i = threadIdx.x; i < n; i += kRowThreads)
      n_valid += s_md[i] < kDistValidMax;
  });
  n_valid = block_sum(n_valid, s);

  // tau: the k-th smallest MINMAXDIST over the C * F lanes.  A valid lane's
  // is below DIST_VALID_MAX and every other lane's is DIST_PAD, so with k
  // valid lanes it is the k-th smallest staged one, else DIST_PAD.
  float tau = kLeaf ? kDistPad : tau_in[b];
  if (!kLeaf && tighten) {
    float kth = kDistPad;
    if (n_valid >= k) {
      const u64 key = radix_select(
          walk,
          [&](int i, u64* key, bool) {
            *key = (u64)__float_as_uint(s_mmd[i]) << 32;
            return true;
          },
          k - 1, 4, lane_bytes, s);
      kth = __uint_as_float((unsigned)(key >> 32));
    }
    tau = fminf(tau, kth);
  }

  // kept lanes: their key, the lane field only when with_lane asks for it
  auto kept = [&](int i, u64* key, bool with_lane) {
    const float d = s_md[i];
    if (!(d < kDistValidMax && d <= tau)) return false;
    *key = with_lane ? make_key(d, lane_of(i))
                     : (u64)__float_as_uint(d) << 32;
    return true;
  };
  int n_keep = n_valid;                   // the leaf keeps every valid lane
  if (!kLeaf) {
    n_keep = 0;
    walk([&](int n) {
      for (int i = threadIdx.x; i < n; i += kRowThreads) {
        const float d = s_md[i];
        n_keep += d < kDistValidMax && d <= tau;
      }
    });
    n_keep = block_sum(n_keep, s);
  }

  int n = 0;                              // survivors gathered in keys
  if (cap > 0) {
    // on overflow only the cap smallest keys survive
    const u64 limit = n_keep > cap
        ? radix_select(walk, kept, cap - 1, 0, lane_bytes, s) : ~0ull;
    // ordered compaction, no atomics: warp w takes a contiguous run of
    // each segment's staged lanes, counts its survivors, and after one
    // scan of the warp totals writes them at its offset in lane order
    walk([&](int n_lanes) {
      const int per = ((n_lanes + kWarp - 1) / kWarp + kRowWarps - 1) /
                      kRowWarps * kWarp;
      const int i0 = warp * per;
      const int i1 = min(n_lanes, i0 + per);
      auto take = [&](int i, u64* key) {
        return i < i1 && kept(i, key, true) && *key <= limit;
      };
      int cnt = 0;
      for (int j = i0; j < i1; j += kWarp) {
        u64 key;
        cnt += __popc(__ballot_sync(kFull, take(j + lane, &key)));
      }
      if (lane == 0) s.warp_tot[warp] = cnt;
      __syncthreads();
      int pos = n, total = 0;
      for (int w = 0; w < kRowWarps; ++w) {
        pos += w < warp ? s.warp_tot[w] : 0;
        total += s.warp_tot[w];
      }
      for (int j = i0; j < i1; j += kWarp) {
        u64 key;
        const bool t = take(j + lane, &key);
        const unsigned bal = __ballot_sync(kFull, t);
        if (t) keys[pos + __popc(bal & ((1u << lane) - 1u))] = key;
        pos += __popc(bal);
      }
      n += total;
      __syncthreads();                    // warp_tot is rewritten next
    });
  }

  // the survivors in ascending key order, then the -1 (+inf) tail
  const int64_t base = (int64_t)b * cap;
  auto emit = [&](int i, u64 key) {
    const int l = (int)(key & 0xffffffffu);
    const int c = l / F;
    out_ids[base + i] = L.child[(int64_t)__ldg(row + c) * F + (l - c * F)];
    if (kLeaf) out_d[base + i] = __uint_as_float((unsigned)(key >> 32));
  };
  if (n <= kRankSortMax) {
    if (threadIdx.x < n) {                // keys are unique: ranks are too
      const u64 key = keys[threadIdx.x];
      int r = 0;
      for (int j = 0; j < n; ++j) r += keys[j] < key;
      emit(r, key);
    }
  } else {
    bitonic_sort(keys, n);
    for (int i = threadIdx.x; i < n; i += kRowThreads) emit(i, keys[i]);
  }
  for (int i = n + threadIdx.x; i < cap; i += kRowThreads) {
    out_ids[base + i] = -1;
    if (kLeaf) out_d[base + i] = INFINITY;
  }
  if (threadIdx.x == 0) {
    valid_cnt[b] = n_valid;
    if (!kLeaf) {
      tau_out[b] = tau;
      keep_cnt[b] = n_keep;
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// One variant of B5 / B8 / B13 / B14 on a persistent grid: as many blocks
// as fit on the card at once, fewer when the slots need fewer.
template <class Q, class L, bool kLeaf, int kLanes>
int launch_dists_variant(const L& lv, const float* queries, float* md,
                         float* mmd, unsigned n_slots, cudaStream_t st) {
  auto kernel = knn_dists_kernel<Q, L, kLeaf, kLanes>;
  static int per_sm = 0;                  // resident blocks an SM
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kDistThreads, 0);
    if (per_sm <= 0) per_sm = 1;
  }
  const int units = lv.F / kLanes;
  const unsigned per_block =
      kDistThreads / (units < kDistThreads ? units : kDistThreads);
  const unsigned need = (n_slots + per_block - 1) / per_block;
  const unsigned full = (unsigned)(sm_count() * per_sm);
  const unsigned blocks = need < full ? need : full;
  kernel<<<blocks, kDistThreads, 0, st>>>(
      lv, queries, md, mmd, n_slots);
  return (int)cudaGetLastError();
}

// B5 / B8 and B13 / B14: the vector variant where F and the pointers
// allow it, else the scalar-lane one.
template <class Q, class L>
int launch_dists(const L& lv, const float* queries, float* md, float* mmd,
                 int B, int leaf, cudaStream_t st) {
  const int64_t n_slots = (int64_t)B * lv.C;
  if (n_slots >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const bool vec = lv.vector_ok() && aligned(md, 16) &&
                   (leaf || aligned(mmd, 16));
  const unsigned n = (unsigned)n_slots;
  if (leaf) {
    if constexpr (L::kHasLeaf) {
      return vec ? launch_dists_variant<Q, L, true, 4>(lv, queries, md,
                                                       nullptr, n, st)
                 : launch_dists_variant<Q, L, true, 1>(lv, queries, md,
                                                       nullptr, n, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return vec ? launch_dists_variant<Q, L, false, 4>(lv, queries, md, mmd, n,
                                                    st)
             : launch_dists_variant<Q, L, false, 1>(lv, queries, md, mmd, n,
                                                    st);
}

// B6 / B9 and B7 / B10: one block per query row, the vector variant where
// F and the rows allow it, else the scalar-lane one; the staging holds
// emit_stage_slots slots' lanes.
template <class Q, bool kLeaf>
int launch_emit(const Level& L, const float* queries, const float* tau_in,
                int* out_ids, float* out_d, float* tau_out, int* valid_cnt,
                int* keep_cnt, int B, int cap, int k, int tighten,
                cudaStream_t st) {
  if (cap > kMaxCap) return (int)cudaErrorInvalidValue;
  const int slots = emit_stage_slots(L.C, L.F, kLeaf);
  const size_t smem = EmitSmem(cap, slots, L.F, kLeaf).total;
  auto kernel = L.vector_ok() ? knn_emit_kernel<Q, kLeaf, 4>
                              : knn_emit_kernel<Q, kLeaf, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, kRowThreads, smem, st>>>(
      L, queries, tau_in, out_ids, out_d, tau_out, valid_cnt, keep_cnt, cap,
      k, tighten, lane_bytes_for((long long)L.C * L.F), slots);
  return (int)cudaGetLastError();
}

Level make_level(const void* ids, const void* lx, const void* ly,
                 const void* hx, const void* hy, const void* child, int C,
                 int F) {
  return Level{(const int*)ids, (const float*)lx, (const float*)ly,
               (const float*)hx, (const float*)hy, (const int*)child, C, F};
}

LevelD3 make_level_d3(const void* ids, const void* qlo, const void* qhi,
                      const void* scale, const void* bias, const void* slack,
                      const void* ptr, int C, int F) {
  return LevelD3{(const int*)ids,     (const uint16_t*)qlo,
                 (const uint16_t*)qhi, (const float*)scale,
                 (const float*)bias,  (const float*)slack,
                 (const int*)ptr,     C,
                 F};
}

}  // namespace

// The largest cap (B6, B9) or k (B7, B10) whose survivors fit in shared
// memory.
extern "C" int rtree_knn_max_cap() { return kMaxCap; }

// Layout queries for the wrappers, tests and chip_smoke.py: the frontier
// slots a B6 / B9 (leaf 0) or B7 / B10 (leaf 1) block stages at once for a
// (B, C) frontier of fanout F, and the block's bytes of dynamic shared
// memory at that cap.
extern "C" long long rtree_knn_emit_stage_slots(int C, int F, int leaf) {
  return emit_stage_slots(C, F, leaf != 0);
}

extern "C" long long rtree_knn_emit_smem(int C, int F, int cap, int leaf) {
  return (long long)EmitSmem(cap, emit_stage_slots(C, F, leaf != 0), F,
                             leaf != 0).total;
}

extern "C" int rtree_knn_dists(const void* ids, const void* points,
                               const void* lx, const void* ly, const void* hx,
                               const void* hy, const void* child, void* md,
                               void* mmd, int B, int C, int F, int leaf,
                               void* stream) {
  return launch_dists<PointQuery>(
      make_level(ids, lx, ly, hx, hy, child, C, F), (const float*)points,
      (float*)md, (float*)mmd, B, leaf, (cudaStream_t)stream);
}

extern "C" int rtree_knn_level_fused(const void* ids, const void* points,
                                     const void* lx, const void* ly,
                                     const void* hx, const void* hy,
                                     const void* child, const void* tau_in,
                                     void* next, void* tau_out,
                                     void* valid_cnt, void* keep_cnt, int B,
                                     int C, int F, int cap, int k,
                                     int tighten, void* stream) {
  return launch_emit<PointQuery, false>(
      make_level(ids, lx, ly, hx, hy, child, C, F), (const float*)points,
      (const float*)tau_in, (int*)next, nullptr, (float*)tau_out,
      (int*)valid_cnt, (int*)keep_cnt, B, cap, k, tighten,
      (cudaStream_t)stream);
}

extern "C" int rtree_knn_leaf_fused(const void* ids, const void* points,
                                    const void* lx, const void* ly,
                                    const void* hx, const void* hy,
                                    const void* child, void* out_ids,
                                    void* out_d, void* valid_cnt, int B,
                                    int C, int F, int k, void* stream) {
  return launch_emit<PointQuery, true>(
      make_level(ids, lx, ly, hx, hy, child, C, F), (const float*)points,
      nullptr, (int*)out_ids, (float*)out_d, nullptr, (int*)valid_cnt,
      nullptr, B, k, k, 0, (cudaStream_t)stream);
}

extern "C" int rtree_knn_join_dists(const void* ids, const void* qrects,
                                    const void* lx, const void* ly,
                                    const void* hx, const void* hy,
                                    const void* child, void* md, void* mmd,
                                    int B, int C, int F, int leaf,
                                    void* stream) {
  return launch_dists<RectQuery>(
      make_level(ids, lx, ly, hx, hy, child, C, F), (const float*)qrects,
      (float*)md, (float*)mmd, B, leaf, (cudaStream_t)stream);
}

extern "C" int rtree_knn_join_level_fused(const void* ids,
                                          const void* qrects, const void* lx,
                                          const void* ly, const void* hx,
                                          const void* hy, const void* child,
                                          const void* tau_in, void* next,
                                          void* tau_out, void* valid_cnt,
                                          void* keep_cnt, int B, int C,
                                          int F, int cap, int k, int tighten,
                                          void* stream) {
  return launch_emit<RectQuery, false>(
      make_level(ids, lx, ly, hx, hy, child, C, F), (const float*)qrects,
      (const float*)tau_in, (int*)next, nullptr, (float*)tau_out,
      (int*)valid_cnt, (int*)keep_cnt, B, cap, k, tighten,
      (cudaStream_t)stream);
}

extern "C" int rtree_knn_join_leaf_fused(const void* ids, const void* qrects,
                                         const void* lx, const void* ly,
                                         const void* hx, const void* hy,
                                         const void* child, void* out_ids,
                                         void* out_d, void* valid_cnt, int B,
                                         int C, int F, int k, void* stream) {
  return launch_emit<RectQuery, true>(
      make_level(ids, lx, ly, hx, hy, child, C, F), (const float*)qrects,
      nullptr, (int*)out_ids, (float*)out_d, nullptr, (int*)valid_cnt,
      nullptr, B, k, k, 0, (cudaStream_t)stream);
}

extern "C" int rtree_knn_dists_d3(const void* ids, const void* points,
                                  const void* qlo, const void* qhi,
                                  const void* scale, const void* bias,
                                  const void* slack, const void* ptr,
                                  void* md, void* mmd, int B, int C, int F,
                                  void* stream) {
  return launch_dists<PointQuery>(
      make_level_d3(ids, qlo, qhi, scale, bias, slack, ptr, C, F),
      (const float*)points, (float*)md, (float*)mmd, B, 0,
      (cudaStream_t)stream);
}

extern "C" int rtree_knn_join_dists_d3(const void* ids, const void* qrects,
                                       const void* qlo, const void* qhi,
                                       const void* scale, const void* bias,
                                       const void* slack, const void* ptr,
                                       void* md, void* mmd, int B, int C,
                                       int F, void* stream) {
  return launch_dists<RectQuery>(
      make_level_d3(ids, qlo, qhi, scale, bias, slack, ptr, C, F),
      (const float*)qrects, (float*)md, (float*)mmd, B, 0,
      (cudaStream_t)stream);
}
