// R-tree range-select BFS level step, hand-written for Hopper (sm_90a).
//
// Four kernels, each behind a plain C entry point (loaded with ctypes by
// kernels/_build.py and wrapped by kernels/rtree_select.py).  Two bodies,
// select_masks_kernel and select_fused_kernel, are templates over the node
// rows they read: D1Rows (four float rows, B1 and B2) or D3Rows (two
// uint16 code rows and the node's scale and bias, B11 and B12).
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
//     Bound on the card: memory — 20*F bytes per live slot read, B*cap*4
//     written; no (B, C, F) mask exists.
//     Design: one block per query walks the flat lanes in order, one tile
//     of blockDim lanes at a time.  Per tile: the predicate, a block-wide
//     exclusive scan of the mask (__ballot_sync/__popc inside each warp,
//     warp totals scanned by warp 0 through shared memory), a store at
//     base + position when that is < cap, then base advances by the tile's
//     total.  No atomics allocate slots, so the order is deterministic.
//     The TPU kernel's sequential grid carry (pl.when(ci == 0)) becomes the
//     loop inside the block.  One block per query leaves most of the 132
//     SMs idle at B=64: a later change splits a query's lanes over several
//     blocks (count pass, scan, scatter pass).
//
// B11 rtree_select_masks_d3 — replaces the Pallas kernel
//     src/repro/kernels/rtree_select.py:select_level_masks_d3 (line 213,
//     body _select_d3_kernel line 190).  B1's body on a D3 level: each
//     lane reads its packed codes qlo, qhi = (x << 8) | y and dequantizes
//     in registers, lo = bias + code * scale per axis.  scale is a power
//     of two and a code has 8 significant bits, so the product is exact
//     and the add is the one rounding: written __fadd_rn(bias,
//     __fmul_rn(code, scale)), any contraction gives the same box.  The
//     mask is conservative: a superset of the D1 mask on the true boxes.
//     Bound on the card: memory — 4*B*C ids, 16*B query bytes, 8F + 16
//     bytes per distinct live node (codes, ptr, scale, bias) and the
//     4*B*C*F mask, which dominates as for B1.
//
// B12 rtree_select_fused_d3 — replaces the Pallas kernel
//     src/repro/kernels/rtree_select.py:select_level_fused_d3 (line 256,
//     tile fused_common.d3_chunk_tile line 68).  B2's body on a D3 level:
//     B11's predicate and the same in-order ballot/popc compress-store,
//     no atomics.  Bound on the card: memory — the reads of B11 and
//     4*B*cap + 4*B bytes written.  One block per query, as B2: at B = 64
//     most SMs idle.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaskWarps = 8;          // B1: warps (= slots) per block
constexpr int kFusedThreads = 1024;    // B2: threads (= lanes per tile)
constexpr int kFusedWarps = kFusedThreads / kWarp;

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

  __device__ __forceinline__ bool hit(float qlx, float qly, float qhx,
                                      float qhy, int node, int64_t k) const {
    const float sx = scale[2 * node], sy = scale[2 * node + 1];
    const float bx = bias[2 * node], by = bias[2 * node + 1];
    const unsigned lo = qlo[k], hi = qhi[k];
    const float lx = __fadd_rn(bx, __fmul_rn((float)(lo >> 8), sx));
    const float ly = __fadd_rn(by, __fmul_rn((float)(lo & 0xFFu), sy));
    const float hx = __fadd_rn(bx, __fmul_rn((float)(hi >> 8), sx));
    const float hy = __fadd_rn(by, __fmul_rn((float)(hi & 0xFFu), sy));
    return intersects(qlx, qly, qhx, qhy, lx, ly, hx, hy);
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

template <class Rows>
__global__ void __launch_bounds__(kFusedThreads)
select_fused_kernel(const int* __restrict__ ids, const float* __restrict__ q,
                    Rows rows, int* __restrict__ out,
                    int* __restrict__ counts, int C, int F, int cap) {
  __shared__ int warp_incl[kFusedWarps];   // inclusive scan of warp totals
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const float qlx = q[4 * b + 0], qly = q[4 * b + 1];
  const float qhx = q[4 * b + 2], qhy = q[4 * b + 3];
  const int* frow = ids + (int64_t)b * C;
  int* orow = out + (int64_t)b * cap;
  const int64_t n_lanes = (int64_t)C * F;
  const unsigned lt_mask = (1u << lane) - 1u;   // lanes below this one
  int base = 0;   // qualifying lanes before this tile (may exceed cap)
  for (int64_t t0 = 0; t0 < n_lanes; t0 += kFusedThreads) {
    const int64_t g = t0 + tid;           // flat lane c*F + j, in order
    bool m = false;
    int ch = -1;
    if (g < n_lanes) {
      const int c = (int)(g / F);
      const int id = frow[c];
      if (id >= 0) {
        const int64_t k = (int64_t)id * F + (g - (int64_t)c * F);
        ch = rows.child[k];
        m = ch >= 0 && rows.hit(qlx, qly, qhx, qhy, id, k);
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_incl[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      int v = warp_incl[lane];            // kFusedWarps == kWarp
      for (int d = 1; d < kWarp; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += up;
      }
      warp_incl[lane] = v;
    }
    __syncthreads();
    if (m) {
      const int pos = base + (warp == 0 ? 0 : warp_incl[warp - 1]) +
                      __popc(bal & lt_mask);
      if (pos < cap) orow[pos] = ch;
    }
    base += warp_incl[kFusedWarps - 1];
    __syncthreads();                      // warp_incl is rewritten next tile
  }
  for (int p = min(base, cap) + tid; p < cap; p += kFusedThreads) orow[p] = -1;
  if (tid == 0) counts[b] = base;
}

static_assert(kFusedWarps == kWarp, "warp 0 scans one total per lane");

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

template <class Rows>
int launch_fused(const void* ids, const void* q, const Rows& rows, void* out,
                 void* counts, int B, int C, int F, int cap, void* stream) {
  select_fused_kernel<Rows><<<B, kFusedThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)q, rows, (int*)out, (int*)counts, C, F,
      cap);
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
                                  int B, int C, int F, int cap, void* stream) {
  return launch_fused(ids, q, d1_rows(lx, ly, hx, hy, child), out, counts, B,
                      C, F, cap, stream);
}

extern "C" int rtree_select_masks_d3(const void* ids, const void* q,
                                     const void* qlo, const void* qhi,
                                     const void* scale, const void* bias,
                                     const void* ptr, void* mask, int B,
                                     int C, int F, void* stream) {
  return launch_masks(ids, q, d3_rows(qlo, qhi, scale, bias, ptr), mask, B,
                      C, F, stream);
}

extern "C" int rtree_select_fused_d3(const void* ids, const void* q,
                                     const void* qlo, const void* qhi,
                                     const void* scale, const void* bias,
                                     const void* ptr, void* out,
                                     void* counts, int B, int C, int F,
                                     int cap, void* stream) {
  return launch_fused(ids, q, d3_rows(qlo, qhi, scale, bias, ptr), out,
                      counts, B, C, F, cap, stream);
}
