// R-tree range-select BFS level step, hand-written for Hopper (sm_90a).
//
// Four kernels, each behind a plain C entry point (loaded with ctypes by
// kernels/_build.py and wrapped by kernels/rtree_select.py).  The fused
// bodies (select_count_kernel, select_scatter_kernel) are templates over
// the node rows they read: D1Rows (four float rows, B2) or D3Rows (two
// uint16 code rows and the node's scale and bias, B12).  B1 is
// select_masks_kernel over D1Rows, B11 select_masks_d3_kernel.
//
// B1  rtree_select_masks — replaces the Pallas kernel
//     src/repro/kernels/rtree_select.py:select_level_masks (line 64, body
//     _select_kernel line 47).  For every (query b, frontier slot c) it
//     writes the F-lane int32 mask of the D1 predicate
//         (qlx <= hx) & (qhx >= lx) & (qly <= hy) & (qhy >= ly)
//         & child >= 0 & ids[b, c] >= 0.
//     Bound on the card: memory.  It must write B*C*F*4 bytes of mask and
//     read 20*F bytes of node row per live slot; the compares are free
//     beside that.  At the leaf level of a 2M-rect fanout-64 tree with
//     B=64 and C=16384 the mask alone is 268 MB, ~80 us at 3.35 TB/s.
//     Design: one warp per (b, c) slot, lanes striding over F, so the five
//     SoA row loads (lx, ly, hx, hy, child at id*F + j) and the mask store
//     are coalesced.  A padded slot (id < 0) stores zeros and loads no row.
//     The TPU kernel's scalar-prefetch grid does not carry over: a warp
//     reads its own id.
//
// B2  rtree_select_fused — replaces the Pallas kernel
//     src/repro/kernels/rtree_select.py:select_level_fused (line 111, with
//     fused_common.pad_frontier / compress_store / chunk_tile).  B1's
//     predicate over the whole level plus an in-order compress-store of the
//     qualifying child ids into (B, cap), -1 padded; counts[b] is the total
//     qualifying (may exceed cap).  The output equals compact_rows over the
//     flat C*F lanes, order included, because the next level's frontier
//     order feeds every later result.
//     Bound on the card: memory — the ids (4*B*C bytes), 20*F bytes of
//     node row per live slot, B*cap*4 written; no (B, C, F) mask exists.
//     At the 2M leaf with B = 64, C = 16384 and ~42 live slots a query
//     that is ~8.6 MB, ~0.0026 ms.  The work is nearly all padding: 0.26%
//     of the slots are live.
//     Design: a query's C slots are cut into chunks of kSelTile slots, one
//     block of kSelThreads threads per (query, chunk), so that B = 64 fills
//     the 132 SMs.  A block loads its chunk's ids with coalesced loads,
//     ballots on id >= 0 and lists its live slots in slot order in shared
//     memory; only they read node rows.  Their F lanes each are walked as
//     one flat list in tiles of kSelTile lanes, so a chunk with few live
//     slots costs one tile whether they form a prefix or lie anywhere.
//     Two kernels, and no atomic:
//       1. select_count_kernel: each block counts its chunk's qualifying
//          lanes (no barrier per tile) into scratch (B, n_chunks);
//       2. select_scatter_kernel: each block sums the totals of its
//          query's earlier chunks (its base) and of all of them, walks its
//          live lanes again and ranks each tile's hits with __ballot_sync /
//          __popc and one scan of the 32 group totals, storing at base +
//          rank while that is < cap.  A chunk whose base is past cap skips
//          the walk.  The -1 tail [min(count, cap), cap) is written with
//          16-byte stores shared out over the query's blocks, and the first
//          chunk's block writes counts[b].
//     The TPU kernel's sequential grid carry (pl.when(ci == 0)) becomes
//     the exclusive scan of the chunk totals.  No tensor cores: the kernel
//     compares and scans integers, with no product, so wgmma and TMA do not
//     apply; the gain is in bytes and scheduling (skip the padding, fill
//     the SMs, fewer barriers).
//
// B11 rtree_select_masks_d3 — replaces the Pallas kernel
//     src/repro/kernels/rtree_select.py:select_level_masks_d3 (line 213,
//     body _select_d3_kernel line 190).  B1's predicate on a D3 level:
//     each lane reads its packed codes qlo, qhi = (x << 8) | y and
//     dequantizes in registers, lo = bias + code * scale per axis.  scale
//     is a power of two and a code has 8 significant bits, so the product
//     is exact and the add is the one rounding: written __fadd_rn(bias,
//     __fmul_rn(code, scale)), any contraction gives the same box.  The
//     mask is conservative: a superset of the D1 mask on the true boxes.
//     Bound on the card: memory — 4*B*C ids, 16*B query bytes, 8F + 16
//     bytes per distinct live node (codes, ptr, scale, bias) and the
//     4*B*C*F mask, which dominates as for B1: at level 1 with B = 4,096
//     and C = 256, 268 MB of mask, ~0.08 ms; and 99% of those slots are
//     dead.  So the kernel is a store stream that must not wait on its
//     loads.  Design (select_masks_d3_kernel): a block owns a tile of
//     kD3Tile frontier slots, whose masks are one contiguous run.  It
//     stores zeros over the whole run first, 16 bytes a thread and
//     coalesced, which waits for nothing; then it ballots on the tile's
//     ids, lists the live slots in shared memory, and a group of F/4
//     threads takes each live slot, each thread 4 neighbouring lanes:
//     it loads the node's scale and bias once (8 bytes each), its 4
//     lanes' codes (8 bytes an array) and child ids (16 bytes) together,
//     and stores the 4 mask lanes over the zeros in one 16-byte streaming
//     store.  A persistent grid sized by occupancy strides over the tiles,
//     each thread loading its slot id of the next tile ahead.  The
//     scalar-lane variant (one lane a thread) covers F % 4 != 0 and
//     misaligned codes, node columns, child ids or mask.
//
// B12 rtree_select_fused_d3 — replaces the Pallas kernel
//     src/repro/kernels/rtree_select.py:select_level_fused_d3 (line 256,
//     tile fused_common.d3_chunk_tile line 68).  B2's two kernels on a D3
//     level (the D3Rows instances): B11's predicate and the same in-order
//     compress-store, no atomics.  Bound on the card: memory — the reads of
//     B11 and 4*B*cap + 4*B bytes written.  At level 1 and batch 4,096 the
//     cap is the leaf frontier's, 16,384, so the -1 tails (268 MB) are the
//     whole bound; the 16-byte tail stores are what the design does there.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaskWarps = 8;          // B1: warps (= slots) per block
constexpr int kD3Threads = 256;       // B11: threads per block
constexpr int kD3Tile = 128;          // B11: frontier slots a block tile
constexpr int kSelThreads = 256;      // B2/B12: threads per block
constexpr int kSelItems = 4;          // items (slots or lanes) per thread
constexpr int kSelTile = kSelThreads * kSelItems;   // a chunk, and a tile
constexpr int kSelWarps = kSelThreads / kWarp;
constexpr int kSelGroups = kSelItems * kSelWarps;   // ranked groups a tile

__device__ __forceinline__ bool intersects(float qlx, float qly, float qhx,
                                           float qhy, float lx, float ly,
                                           float hx, float hy) {
  return (qlx <= hx) && (qhx >= lx) && (qly <= hy) && (qhy >= ly);
}

// D1 node rows: four float32 SoA rows (N, F) and the child ids.
struct D1Rows {
  const float* lx;
  const float* ly;
  const float* hx;
  const float* hy;
  const int* child;

  // The predicate for entry k = node * F + j of node `node`.
  __device__ __forceinline__ bool hit(float qlx, float qly, float qhx,
                                      float qhy, int node, int64_t k) const {
    return intersects(qlx, qly, qhx, qhy, lx[k], ly[k], hx[k], hy[k]);
  }
};

// D3 node rows: two uint16 code rows (N, F), the node's float32 scale and
// bias (N, 2), and the child ids.  Dequantization is exact (see B11).
struct D3Rows {
  const uint16_t* qlo;
  const uint16_t* qhi;
  const float* scale;
  const float* bias;
  const int* child;

  // The predicate on the box of codes lo, hi dequantized with the node's
  // scale s and bias b.
  static __device__ __forceinline__ bool hit_box(float qlx, float qly,
                                                 float qhx, float qhy,
                                                 unsigned lo, unsigned hi,
                                                 float2 s, float2 b) {
    const float lx = __fadd_rn(b.x, __fmul_rn((float)(lo >> 8), s.x));
    const float ly = __fadd_rn(b.y, __fmul_rn((float)(lo & 0xFFu), s.y));
    const float hx = __fadd_rn(b.x, __fmul_rn((float)(hi >> 8), s.x));
    const float hy = __fadd_rn(b.y, __fmul_rn((float)(hi & 0xFFu), s.y));
    return intersects(qlx, qly, qhx, qhy, lx, ly, hx, hy);
  }

  __device__ __forceinline__ bool hit(float qlx, float qly, float qhx,
                                      float qhy, int node, int64_t k) const {
    return hit_box(qlx, qly, qhx, qhy, qlo[k], qhi[k],
                   make_float2(scale[2 * node], scale[2 * node + 1]),
                   make_float2(bias[2 * node], bias[2 * node + 1]));
  }
};

template <class Rows>
__global__ void __launch_bounds__(kMaskWarps * kWarp)
select_masks_kernel(const int* __restrict__ ids, const float* __restrict__ q,
                    Rows rows, int* __restrict__ mask, int B, int C, int F) {
  const int lane = threadIdx.x % kWarp;
  const int64_t slot =
      (int64_t)blockIdx.x * kMaskWarps + threadIdx.x / kWarp;
  if (slot >= (int64_t)B * C) return;
  const int b = (int)(slot / C);
  const int id = ids[slot];
  int* out = mask + slot * F;
  if (id < 0) {
    for (int j = lane; j < F; j += kWarp) out[j] = 0;
    return;
  }
  const float qlx = q[4 * b + 0], qly = q[4 * b + 1];
  const float qhx = q[4 * b + 2], qhy = q[4 * b + 3];
  const int64_t row = (int64_t)id * F;
  for (int j = lane; j < F; j += kWarp) {
    const int64_t k = row + j;
    const bool m = rows.hit(qlx, qly, qhx, qhy, id, k) && rows.child[k] >= 0;
    out[j] = m ? 1 : 0;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// kLanes neighbouring values from p through the read-only path: for
// kLanes 4 one 16-byte load (int) or one 8-byte load (uint16).
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

// kLanes neighbouring mask lanes as a stream (evict-first): one 16-byte
// store for kLanes 4.
template <int kLanes>
__device__ __forceinline__ void store_lanes(int* p, const int (&v)[kLanes]) {
  if constexpr (kLanes == 4) {
    __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// The id of slot tile * kD3Tile + threadIdx.x (threads below kD3Tile),
// -1 past n_slots and in the other threads.
__device__ __forceinline__ int tile_id(const int* __restrict__ ids,
                                       unsigned tile, unsigned n_slots) {
  const unsigned slot = tile * kD3Tile + threadIdx.x;
  return threadIdx.x < kD3Tile && slot < n_slots ? __ldg(ids + slot) : -1;
}

// B11 over n_slots = B * C frontier slots in tiles of kD3Tile slots, whose
// masks are one contiguous run of kD3Tile * F ints.  A block owns a tile
// at a time, and a persistent grid, as many blocks as fit on the card,
// strides over the tiles; each thread loads its slot id of the block's
// next tile before it works on this one.  For a tile the block
//   1. stores zeros over the whole run, kLanes lanes a store, neighbouring
//      threads on neighbouring units, without waiting on any load;
//   2. ballots on the tile's ids and lists its live slots in shared
//      memory;
//   3. gives each listed slot to a group of F / kLanes threads (at most a
//      block), each thread kLanes neighbouring lanes: it loads the node's
//      scale and bias once (8 bytes each) and its codes (kLanes a load)
//      and child ids (16 bytes) together, and stores its lanes' mask over
//      the zeros.  The barrier of step 2 orders the two stores.
// A dead slot costs its zero stores and no load.
template <int kLanes>
__global__ void __launch_bounds__(kD3Threads)
select_masks_d3_kernel(const int* __restrict__ ids,
                       const float* __restrict__ q, D3Rows rows,
                       int* __restrict__ mask, unsigned n_slots, int C,
                       int F) {
  constexpr int kTileWarps = kD3Tile / kWarp;
  __shared__ int s_node[kD3Tile];         // the tile's live slots, in order
  __shared__ int s_slot[kD3Tile];
  __shared__ int s_cnt[kTileWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int units = F / kLanes;           // a slot's units of kLanes lanes
  const int group = units < kD3Threads ? units : kD3Threads;
  const int groups = kD3Threads / group;
  const int g = threadIdx.x / group;
  const int first = (threadIdx.x - g * group) * kLanes;
  const int zero[kLanes] = {};
  const unsigned n_tiles = (n_slots + kD3Tile - 1) / kD3Tile;
  unsigned tile = blockIdx.x;
  int id = tile_id(ids, tile, n_slots);
  // tile + gridDim.x < 2^32 / kD3Tile: launch_masks_d3 checks n_slots
  for (; tile < n_tiles; tile += gridDim.x) {
    const int next = tile_id(ids, tile + gridDim.x, n_slots);
    const unsigned slot0 = tile * kD3Tile;
    const unsigned left = n_slots - slot0;
    const int run = (int)(left < kD3Tile ? left : kD3Tile) * units;
    int* const out = mask + (int64_t)slot0 * F;
    for (int u = threadIdx.x; u < run; u += kD3Threads)
      store_lanes<kLanes>(out + u * kLanes, zero);
    const unsigned bal = __ballot_sync(0xffffffffu, id >= 0);
    if (lane == 0 && warp < kTileWarps) s_cnt[warp] = __popc(bal);
    __syncthreads();
    int pos = __popc(bal & ((1u << lane) - 1u)), n_live = 0;
    for (int w = 0; w < kTileWarps; ++w) {
      pos += w < warp ? s_cnt[w] : 0;
      n_live += s_cnt[w];
    }
    if (id >= 0) {
      s_node[pos] = id;
      s_slot[pos] = threadIdx.x;
    }
    __syncthreads();
    for (int r = g; g < groups && r < n_live; r += groups) {
      const int node = s_node[r];
      const unsigned slot = slot0 + s_slot[r];
      const float* qb = q + 4 * (size_t)(slot / (unsigned)C);
      const float qlx = __ldg(qb), qly = __ldg(qb + 1);
      const float qhx = __ldg(qb + 2), qhy = __ldg(qb + 3);
      const float2 sc = load_node_pair<kLanes>(rows.scale, node);
      const float2 bi = load_node_pair<kLanes>(rows.bias, node);
      const int64_t row = (int64_t)node * F;
      int* const o = mask + (int64_t)slot * F;
      for (int j = first; j < F; j += group * kLanes) {
        int c[kLanes], m[kLanes];
        unsigned lo[kLanes], hi[kLanes];
        load_lanes<kLanes>(rows.child + row + j, c);
        load_lanes<kLanes>(rows.qlo + row + j, lo);
        load_lanes<kLanes>(rows.qhi + row + j, hi);
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          m[l] = c[l] >= 0 && D3Rows::hit_box(qlx, qly, qhx, qhy, lo[l],
                                              hi[l], sc, bi);
        store_lanes<kLanes>(o + j, m);
      }
    }
    __syncthreads();                      // the lists are rewritten next
    id = next;
  }
}

static_assert(kSelGroups == kWarp, "warp 0 scans one group total a lane");

// Shared state of block_rank: the group totals and their inclusive scan.
struct RankSmem {
  int cnt[kSelGroups];
  int incl[kSelGroups];
};

// Block-wide exclusive ranks of kSelItems predicates a thread.  Item u of
// thread t is element u * kSelThreads + t of a tile, so group u * kSelWarps
// + warp holds elements in tile order.  pos[u] is item u's rank among the
// tile's set items; returns their number.  Two barriers; the next call may
// follow at once (warp 0 reads cnt before the second barrier, and the
// others read incl before the next call's first).
__device__ __forceinline__ int block_rank(const bool (&m)[kSelItems],
                                          int (&pos)[kSelItems],
                                          RankSmem& sm) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  unsigned bal[kSelItems];
#pragma unroll
  for (int u = 0; u < kSelItems; ++u) {
    bal[u] = __ballot_sync(0xffffffffu, m[u]);
    if (lane == 0) sm.cnt[u * kSelWarps + warp] = __popc(bal[u]);
  }
  __syncthreads();
  if (warp == 0) {
    int v = sm.cnt[lane];
    for (int d = 1; d < kWarp; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += up;
    }
    sm.incl[lane] = v;
  }
  __syncthreads();
  const unsigned lt_mask = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kSelItems; ++u) {
    const int g = u * kSelWarps + warp;
    pos[u] = (g == 0 ? 0 : sm.incl[g - 1]) + __popc(bal[u] & lt_mask);
  }
  return sm.incl[kSelGroups - 1];
}

// Lists the live slots (id >= 0) of chunk `chunk` of one query's frontier
// row `frow` (C slots): their node ids, in slot order, into s_node.
// Returns their number (the same in every thread).
__device__ __forceinline__ int live_slots(const int* __restrict__ frow,
                                          int C, int chunk, int* s_node,
                                          RankSmem& sm) {
  bool m[kSelItems];
  int id[kSelItems], pos[kSelItems];
  const int s0 = chunk * kSelTile + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kSelItems; ++u) {
    const int s = s0 + u * kSelThreads;
    id[u] = s < C ? frow[s] : -1;
    m[u] = id[u] >= 0;
  }
  const int n = block_rank(m, pos, sm);
#pragma unroll
  for (int u = 0; u < kSelItems; ++u)
    if (m[u]) s_node[pos[u]] = id[u];
  __syncthreads();
  return n;
}

struct Query {
  float lx, ly, hx, hy;
};

// Lane l of a chunk's live lanes: entry j = l % F of live slot l / F.
// Sets *ch to the entry's child id; true when it qualifies.
template <class Rows>
__device__ __forceinline__ bool live_lane(const Rows& rows,
                                          const int* s_node, const Query& q,
                                          int l, int n_lanes, int F,
                                          int* ch) {
  if (l >= n_lanes) return false;
  const int r = l / F;
  const int node = s_node[r];
  const int64_t k = (int64_t)node * F + (l - r * F);
  *ch = rows.child[k];
  // both loads in flight together: the row is read whatever the child
  const bool hit = rows.hit(q.lx, q.ly, q.hx, q.hy, node, k);
  return *ch >= 0 && hit;
}

__device__ __forceinline__ Query load_query(const float* __restrict__ q,
                                            int b) {
  return Query{q[4 * b + 0], q[4 * b + 1], q[4 * b + 2], q[4 * b + 3]};
}

// Writes -1 to row[lo, cap): 16-byte stores where aligned, shared out over
// `parts` blocks (this one is `part`).
__device__ __forceinline__ void fill_tail(int* row, long long lo,
                                          long long cap, long long part,
                                          long long parts) {
  if (lo >= cap) return;
  const long long t = part * blockDim.x + threadIdx.x;
  const long long stride = parts * blockDim.x;
  const long long head = min(
      (long long)(((16 - ((uintptr_t)(row + lo) & 15)) & 15) / 4), cap - lo);
  if (t < head) row[lo + t] = -1;
  const long long a = lo + head;
  const long long n4 = (cap - a) / 4;
  int4* row4 = reinterpret_cast<int4*>(row + a);
  for (long long k = t; k < n4; k += stride)
    row4[k] = make_int4(-1, -1, -1, -1);
  const long long rest = a + 4 * n4;
  if (t < cap - rest) row[rest + t] = -1;
}

// Block sum of one int per thread, every thread gets it (s: kSelWarps).
__device__ __forceinline__ long long block_sum(long long v, long long* s) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int d = kWarp / 2; d > 0; d >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, d);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kSelWarps; ++w) total += s[w];
  return total;
}

// B2/B12 pass 1: chunk_tot[b * n_chunks + chunk] = the chunk's qualifying
// lanes.  One block per (query b, chunk), blockIdx.x = b * n_chunks + chunk.
template <class Rows>
__global__ void __launch_bounds__(kSelThreads)
select_count_kernel(const int* __restrict__ ids, const float* __restrict__ q,
                    Rows rows, int* __restrict__ chunk_tot, int C, int F,
                    int n_chunks) {
  __shared__ int s_node[kSelTile];
  __shared__ RankSmem sm;
  __shared__ long long s_sum[kSelWarps];
  const int b = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - b * n_chunks;
  const Query qb = load_query(q, b);
  const int n = live_slots(ids + (int64_t)b * C, C, chunk, s_node, sm);
  if (n == 0) {                         // uniform over the block
    if (threadIdx.x == 0) chunk_tot[blockIdx.x] = 0;
    return;
  }
  const int n_lanes = n * F;
  int hits = 0;
  for (int l0 = 0; l0 < n_lanes; l0 += kSelTile) {
#pragma unroll
    for (int u = 0; u < kSelItems; ++u) {
      int ch;
      hits += live_lane(rows, s_node, qb, l0 + u * kSelThreads + threadIdx.x,
                        n_lanes, F, &ch);
    }
  }
  const long long total = block_sum(hits, s_sum);
  if (threadIdx.x == 0) chunk_tot[blockIdx.x] = (int)total;
}

// B2/B12 pass 2: the ordered scatter, the -1 tail and counts[b].
template <class Rows>
__global__ void __launch_bounds__(kSelThreads)
select_scatter_kernel(const int* __restrict__ ids,
                      const float* __restrict__ q, Rows rows,
                      const int* __restrict__ chunk_tot, int* __restrict__ out,
                      int* __restrict__ counts, int C, int F, int cap,
                      int n_chunks) {
  __shared__ int s_node[kSelTile];
  __shared__ RankSmem sm;
  __shared__ long long s_sum[2][kSelWarps];
  const int b = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - b * n_chunks;
  const int* tot = chunk_tot + (int64_t)b * n_chunks;
  long long before = 0, all = 0;
  for (int k = threadIdx.x; k < n_chunks; k += kSelThreads) {
    all += tot[k];
    if (k < chunk) before += tot[k];
  }
  before = block_sum(before, s_sum[0]);
  all = block_sum(all, s_sum[1]);
  int* orow = out + (int64_t)b * cap;
  if (before < cap && tot[chunk] > 0) {        // uniform over the block
    const Query qb = load_query(q, b);
    const int n = live_slots(ids + (int64_t)b * C, C, chunk, s_node, sm);
    const int n_lanes = n * F;
    long long run = before;
    for (int l0 = 0; l0 < n_lanes && run < cap; l0 += kSelTile) {
      bool m[kSelItems];
      int ch[kSelItems], pos[kSelItems];
#pragma unroll
      for (int u = 0; u < kSelItems; ++u)
        m[u] = live_lane(rows, s_node, qb, l0 + u * kSelThreads + threadIdx.x,
                         n_lanes, F, &ch[u]);
      const int t = block_rank(m, pos, sm);
#pragma unroll
      for (int u = 0; u < kSelItems; ++u)
        if (m[u] && run + pos[u] < cap) orow[run + pos[u]] = ch[u];
      run += t;
    }
  }
  fill_tail(orow, min(all, (long long)cap), cap, chunk, n_chunks);
  if (chunk == 0 && threadIdx.x == 0) counts[b] = (int)all;
}

int select_chunks(int C) { return (C + kSelTile - 1) / kSelTile; }

template <class Rows>
int launch_masks(const void* ids, const void* q, const Rows& rows,
                 void* mask, int B, int C, int F, void* stream) {
  const int64_t slots = (int64_t)B * C;
  const int64_t blocks = (slots + kMaskWarps - 1) / kMaskWarps;
  select_masks_kernel<Rows><<<(unsigned)blocks, kMaskWarps * kWarp, 0,
                              (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)q, rows, (int*)mask, B, C, F);
  return (int)cudaGetLastError();
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

// One variant of B11 on a persistent grid: as many blocks as fit on the
// card at once, fewer when the tiles need fewer.
template <int kLanes>
int launch_masks_d3_variant(const int* ids, const float* q,
                            const D3Rows& rows, int* mask, unsigned n_slots,
                            int C, int F, cudaStream_t st) {
  auto kernel = select_masks_d3_kernel<kLanes>;
  static int per_sm = 0;                  // resident blocks an SM
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kD3Threads, 0);
    if (per_sm <= 0) per_sm = 1;
  }
  const unsigned need = (n_slots + kD3Tile - 1) / kD3Tile;
  const unsigned full = (unsigned)(sm_count() * per_sm);
  kernel<<<need < full ? need : full, kD3Threads, 0, st>>>(
      ids, q, rows, mask, n_slots, C, F);
  return (int)cudaGetLastError();
}

// B11: the vector variant (4 lanes a thread) where F is a multiple of 4
// and the codes, node columns, child ids and mask are aligned for its
// 8- and 16-byte accesses, else the scalar-lane one.
int launch_masks_d3(const void* ids, const void* q, const D3Rows& rows,
                    void* mask, int B, int C, int F, void* stream) {
  const int64_t n_slots = (int64_t)B * C;
  if (n_slots >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const bool vec = F % 4 == 0 && aligned(rows.qlo, 8) &&
                   aligned(rows.qhi, 8) && aligned(rows.scale, 8) &&
                   aligned(rows.bias, 8) && aligned(rows.child, 16) &&
                   aligned(mask, 16);
  const auto st = (cudaStream_t)stream;
  const unsigned n = (unsigned)n_slots;
  return vec ? launch_masks_d3_variant<4>((const int*)ids, (const float*)q,
                                          rows, (int*)mask, n, C, F, st)
             : launch_masks_d3_variant<1>((const int*)ids, (const float*)q,
                                          rows, (int*)mask, n, C, F, st);
}

template <class Rows>
int launch_fused(const void* ids, const void* q, const Rows& rows, void* out,
                 void* counts, void* scratch, int B, int C, int F, int cap,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = select_chunks(C);
  const unsigned blocks = (unsigned)((int64_t)B * n_chunks);
  select_count_kernel<Rows><<<blocks, kSelThreads, 0, st>>>(
      (const int*)ids, (const float*)q, rows, (int*)scratch, C, F, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_scatter_kernel<Rows><<<blocks, kSelThreads, 0, st>>>(
      (const int*)ids, (const float*)q, rows, (const int*)scratch, (int*)out,
      (int*)counts, C, F, cap, n_chunks);
  return (int)cudaGetLastError();
}

D1Rows d1_rows(const void* lx, const void* ly, const void* hx,
               const void* hy, const void* child) {
  return D1Rows{(const float*)lx, (const float*)ly, (const float*)hx,
                (const float*)hy, (const int*)child};
}

D3Rows d3_rows(const void* qlo, const void* qhi, const void* scale,
               const void* bias, const void* ptr) {
  return D3Rows{(const uint16_t*)qlo, (const uint16_t*)qhi,
                (const float*)scale, (const float*)bias, (const int*)ptr};
}

}  // namespace

// Layout query for the wrapper, so that the chunking lives here only: the
// int32 elements of B2's and B12's scratch (one total per (query, chunk))
// for a (B, C) frontier.
extern "C" long long rtree_select_fused_scratch(int B, int C) {
  return (long long)B * select_chunks(C);
}

extern "C" int rtree_select_masks(const void* ids, const void* q,
                                  const void* lx, const void* ly,
                                  const void* hx, const void* hy,
                                  const void* child, void* mask, int B, int C,
                                  int F, void* stream) {
  return launch_masks(ids, q, d1_rows(lx, ly, hx, hy, child), mask, B, C, F,
                      stream);
}

extern "C" int rtree_select_fused(const void* ids, const void* q,
                                  const void* lx, const void* ly,
                                  const void* hx, const void* hy,
                                  const void* child, void* out, void* counts,
                                  void* scratch, int B, int C, int F, int cap,
                                  void* stream) {
  return launch_fused(ids, q, d1_rows(lx, ly, hx, hy, child), out, counts,
                      scratch, B, C, F, cap, stream);
}

extern "C" int rtree_select_masks_d3(const void* ids, const void* q,
                                     const void* qlo, const void* qhi,
                                     const void* scale, const void* bias,
                                     const void* ptr, void* mask, int B,
                                     int C, int F, void* stream) {
  return launch_masks_d3(ids, q, d3_rows(qlo, qhi, scale, bias, ptr), mask,
                         B, C, F, stream);
}

extern "C" int rtree_select_fused_d3(const void* ids, const void* q,
                                     const void* qlo, const void* qhi,
                                     const void* scale, const void* bias,
                                     const void* ptr, void* out,
                                     void* counts, void* scratch, int B,
                                     int C, int F, int cap, void* stream) {
  return launch_fused(ids, q, d3_rows(qlo, qhi, scale, bias, ptr), out,
                      counts, scratch, B, C, F, cap, stream);
}
