// R-tree spatial-join pair-frontier level step, hand-written for Hopper
// (sm_90a).
//
// Two kernels, each behind a plain C entry point (loaded with ctypes by
// kernels/_build.py and wrapped by kernels/rtree_join.py).  A pair p of the
// frontier is (outer node o_ids[p], inner node i_ids[p]) of one level; its
// lanes are the F_out x F_in (outer child r, inner child c) cross product.
// Lane (r, c) of pair p qualifies iff
//     o_ids[p] >= 0 && i_ids[p] >= 0
//     && (r / to) * to < alive_cnt[p]                 (O3 outer-tile skip)
//     && (c / ti) * ti < flip_max[p, r / to]          (O4/O5 inner-tile skip)
//     && olx <= ihx && ohx >= ilx && oly <= ihy && ohy >= ily
// (B4 also needs o_ptr[r] >= 0 && i_ptr[c] >= 0).  The tile skip belongs to
// the function, not to the TPU's tiling: on sorted trees it only zeroes
// lanes that cannot intersect, and random alive_cnt / flip_max values give
// the plain PyTorch twin's answer (kernels/ref.py).
//
// B3  rtree_join_masks — replaces the Pallas kernel
//     src/repro/kernels/rtree_join.py:join_pair_masks (line 73, body
//     _join_kernel line 45).  Writes the dense (P, F_out, F_in) int32 mask:
//     every pair slot, padded and skipped ones included (zeros).
//     Bound on the card: memory — the output write.  At the leaf step of a
//     2M-point fanout-64 join (P = 65536) that is 1,073,741,824 bytes,
//     ~0.32 ms at 3.35 TB/s; the node rows read are < 2% of it.
//     Design: one block per pair.  The two nodes' 4 x F coordinate rows
//     and the pair's flip_max row are staged in shared memory; each thread
//     then writes runs of four int32 lanes as one 16-byte store, neighbours
//     on neighbouring addresses, so the stores coalesce.  A pair with a
//     negative id writes zeros reading only its ids; one with alive_cnt
//     <= 0 writes zeros without reading a row.
//
// B4  rtree_join_fused — replaces the Pallas kernel
//     src/repro/kernels/rtree_join.py:join_level_fused (line 129, with
//     fused_common.compress_store line 37).  B3's predicate plus child-
//     pointer validity, and the qualifying (o_ptr[r], i_ptr[c]) pairs
//     written in flat p*F_out*F_in + r*F_in + c order into (cap,) buffers
//     -1 padded; count (may exceed cap) and overflow = count > cap.  The
//     output equals compact_pairs over the flat lanes, order included.
//     Bound on the card: memory — the live pairs' node rows (coords and
//     child pointers), the ids and the metadata read, 2 x cap int32
//     written: ~14 MB, ~0.0042 ms at the leaf step of a 2M-point fanout-64
//     join, where only 8,045 of P = 65,536 pair slots are live.
//     The TPU kernel carries a running SMEM offset across its sequential
//     grid; blocks on the GPU run in no order, so the offset becomes an
//     ordered int64 scan over the pairs, and no atomic allocates a slot:
//       1. join_count_kernel: a persistent grid (as many blocks as fit on
//          the card) strides over the pair slots; warp 0 of a block loads
//          32 of its slots' ids at once and ballots on liveness, writing 0
//          for dead pairs, so no block is scheduled for a dead pair.  A
//          live pair's rows are staged in shared memory once, folded into
//          one bound per outer row (its flip_max tile bound where the
//          row's outer tile is alive and its child pointer valid, else
//          INT_MIN) and one tile start per inner column (INT_MAX where its
//          pointer is invalid).
//          Each warp owns a contiguous run of outer rows, skips a row whose
//          bound is <= 0, and counts its lanes with __ballot_sync/__popc
//          and no block barrier; for F_in = 32, 64, 96 or 128 a lane keeps
//          its inner columns in registers (on an H100, 1.9x faster at
//          F_in = 64 than the general walk).  It writes the pair's count
//          and each warp's;
//       2. join_scan_tiles_kernel + join_scan_carry_kernel: the exclusive
//          scan of the pair counts over P — tiles of kScanTile pairs, then
//          the tile totals in order by one block (int64), which also writes
//          the count, the overflow flag and the int64 total;
//       3. join_scatter_kernel: the same persistent walk over the pairs
//          with a count > 0 whose offset is < cap; each warp starts at the
//          pair's offset plus the counts of the warps before it, ranks its
//          lanes with __ballot_sync/__popc and stores while the position is
//          < cap, stopping once its count is written.  Then the whole grid
//          writes the -1 tail [min(count, cap), cap) of both outputs with
//          16-byte stores: no memset of the whole buffers.
//     Each live lane is evaluated twice (count, scatter): one pass behind a
//     decoupled look-back would need its flags cleared before every call.
//     No tensor cores: the kernels compare and scan integers, with no
//     product, so wgmma and TMA do not apply; the gain is in bytes and
//     scheduling (no block for a dead pair, no barrier per lane tile, no
//     full-buffer fill).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPairThreads = 256;                 // B3 / B4 threads per pair
constexpr int kPairWarps = kPairThreads / kWarp;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;                     // counts per scan thread
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / kWarp;

static_assert(kPairWarps <= kWarp, "one warp holds a pair's warp counts");
static_assert(kScanWarps == kWarp, "one warp scans the warp totals");

// B3: one pair's staged rows — coords (4 x F, rows lx, ly, hx, hy) of both
// nodes and the pair's flip_max row.
struct Staged {
  const float* o;
  const float* i;
  const int* fm;
};

__device__ __forceinline__ Staged stage(
    float* smem, const float* __restrict__ oc, const float* __restrict__ ic,
    const int* __restrict__ flip_max, int oid, int iid, int p, int Fo,
    int Fi, int na) {
  float* s_o = smem;
  float* s_i = s_o + 4 * Fo;
  int* s_fm = reinterpret_cast<int*>(s_i + 4 * Fi);
  const float* orow = oc + (int64_t)oid * 4 * Fo;
  const float* irow = ic + (int64_t)iid * 4 * Fi;
  for (int k = threadIdx.x; k < 4 * Fo; k += blockDim.x) s_o[k] = orow[k];
  for (int k = threadIdx.x; k < 4 * Fi; k += blockDim.x) s_i[k] = irow[k];
  for (int k = threadIdx.x; k < na; k += blockDim.x)
    s_fm[k] = flip_max[(int64_t)p * na + k];
  __syncthreads();
  return Staged{s_o, s_i, s_fm};
}

__device__ __forceinline__ bool boxes_meet(float olx, float oly, float ohx,
                                           float ohy, float ilx, float ily,
                                           float ihx, float ihy) {
  return (olx <= ihx) && (ohx >= ilx) && (oly <= ihy) && (ohy >= ily);
}

// The intersect test and the tile skip of lane (r, c).
__device__ __forceinline__ bool lane_hits(const Staged& s, int r, int c,
                                          int Fo, int Fi, int to, int ti,
                                          int alive) {
  const int a = r / to;
  return (a * to < alive) && ((c / ti) * ti < s.fm[a]) &&
         boxes_meet(s.o[r], s.o[Fo + r], s.o[2 * Fo + r], s.o[3 * Fo + r],
                    s.i[c], s.i[Fi + c], s.i[2 * Fi + c], s.i[3 * Fi + c]);
}

__global__ void __launch_bounds__(kPairThreads)
join_masks_kernel(const int* __restrict__ o_ids, const int* __restrict__ i_ids,
                  const int* __restrict__ alive_cnt,
                  const int* __restrict__ flip_max,
                  const float* __restrict__ oc, const float* __restrict__ ic,
                  int* __restrict__ mask, int Fo, int Fi, int to, int ti,
                  int na) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int oid = o_ids[p], iid = i_ids[p];
  const int alive = (oid < 0 || iid < 0) ? 0 : alive_cnt[p];
  const int64_t lanes = (int64_t)Fo * Fi;
  int* out = mask + (int64_t)p * lanes;
  const bool vec = (Fi & 3) == 0;    // rows of 4-lane runs, 16-byte aligned
  if (alive <= 0) {
    if (vec) {
      int4* out4 = reinterpret_cast<int4*>(out);
      for (int64_t k = threadIdx.x; k < lanes / 4; k += blockDim.x)
        out4[k] = make_int4(0, 0, 0, 0);
    } else {
      for (int64_t k = threadIdx.x; k < lanes; k += blockDim.x) out[k] = 0;
    }
    return;
  }
  const Staged s = stage(smem, oc, ic, flip_max, oid, iid, p, Fo, Fi, na);
  if (vec) {
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int64_t k = threadIdx.x; k < lanes / 4; k += blockDim.x) {
      const int r = (int)((4 * k) / Fi);
      const int c = (int)(4 * k - (int64_t)r * Fi);
      out4[k] = make_int4(lane_hits(s, r, c, Fo, Fi, to, ti, alive),
                          lane_hits(s, r, c + 1, Fo, Fi, to, ti, alive),
                          lane_hits(s, r, c + 2, Fo, Fi, to, ti, alive),
                          lane_hits(s, r, c + 3, Fo, Fi, to, ti, alive));
    }
  } else {
    for (int64_t k = threadIdx.x; k < lanes; k += blockDim.x) {
      const int r = (int)(k / Fi);
      out[k] = lane_hits(s, r, (int)(k - (int64_t)r * Fi), Fo, Fi, to, ti,
                         alive);
    }
  }
}

// B4: one live pair staged in shared memory.  Lane (r, c) qualifies iff
// ctile[c] < rowfm[r] and the boxes meet: rowfm[r] is flip_max[p, r / to]
// where r's outer tile is alive (r / to * to < alive_cnt[p]) and
// o_ptr[r] >= 0, else INT_MIN; ctile[c] is (c / ti) * ti where
// i_ptr[c] >= 0, else INT_MAX.  A row with rowfm <= 0 has no hit.
struct Pair {
  const float* o;      // 4 x Fo: lx, ly, hx, hy
  const float* i;      // 4 x Fi
  const int* rowfm;    // Fo
  const int* ctile;    // Fi
  const int* optr;     // Fo
  const int* iptr;     // Fi
};

// Dynamic shared memory of one B4 block (stage_pair's layout).
size_t fused_smem_bytes(int Fo, int Fi) {
  return sizeof(float) * 4 * (size_t)(Fo + Fi) +
         sizeof(int) * 2 * (size_t)(Fo + Fi);
}

// Stages live pair p (ids oid, iid; alive_cnt alive).  Callers put a
// barrier between the last read of the previous pair and this call.
__device__ __forceinline__ Pair stage_pair(
    float* smem, const float* __restrict__ oc, const float* __restrict__ ic,
    const int* __restrict__ flip_max, const int* __restrict__ o_ptr,
    const int* __restrict__ i_ptr, int oid, int iid, int alive, int64_t p,
    int Fo, int Fi, int to, int ti, int na) {
  float* s_o = smem;
  float* s_i = s_o + 4 * Fo;
  int* s_rowfm = reinterpret_cast<int*>(s_i + 4 * Fi);
  int* s_ctile = s_rowfm + Fo;
  int* s_op = s_ctile + Fi;
  int* s_ip = s_op + Fo;
  const float* orow = oc + (int64_t)oid * 4 * Fo;
  const float* irow = ic + (int64_t)iid * 4 * Fi;
  for (int k = threadIdx.x; k < 4 * Fo; k += blockDim.x) s_o[k] = orow[k];
  for (int k = threadIdx.x; k < 4 * Fi; k += blockDim.x) s_i[k] = irow[k];
  for (int r = threadIdx.x; r < Fo; r += blockDim.x) {
    const int ptr = o_ptr[(int64_t)oid * Fo + r];
    const int a = r / to;
    s_op[r] = ptr;
    s_rowfm[r] = (a * to < alive && ptr >= 0) ? flip_max[p * na + a]
                                              : INT_MIN;
  }
  for (int c = threadIdx.x; c < Fi; c += blockDim.x) {
    const int ptr = i_ptr[(int64_t)iid * Fi + c];
    s_ip[c] = ptr;
    s_ctile[c] = ptr >= 0 ? (c / ti) * ti : INT_MAX;
  }
  __syncthreads();
  return Pair{s_o, s_i, s_rowfm, s_ctile, s_op, s_ip};
}

// This warp's outer rows [*r0, *r1) of a pair: contiguous runs, so the
// warps' lanes follow the flat r * Fi + c order warp after warp.
__device__ __forceinline__ void warp_rows(int Fo, int* r0, int* r1) {
  const int per = (Fo + kPairWarps - 1) / kPairWarps;
  const int warp = threadIdx.x / kWarp;
  *r0 = min(Fo, warp * per);
  *r1 = min(Fo, *r0 + per);
}

// Walks rows [r0, r1) of a staged pair in flat order, 32 lanes at a time:
// fn(m, r, c) for each lane, called by the whole warp together (it may
// ballot); stops when fn returns false.  NC > 0: F_in = 32 * NC, and a
// lane keeps its NC inner columns in registers; NC = 0: any F_in.
template <int NC, class Fn>
__device__ __forceinline__ void walk_rows(const Pair& s, int r0, int r1,
                                          int Fo, int Fi, Fn fn) {
  const int lane = threadIdx.x % kWarp;
  if constexpr (NC > 0) {
    float ilx[NC], ily[NC], ihx[NC], ihy[NC];
    int ct[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int c = t * kWarp + lane;
      ilx[t] = s.i[c];
      ily[t] = s.i[Fi + c];
      ihx[t] = s.i[2 * Fi + c];
      ihy[t] = s.i[3 * Fi + c];
      ct[t] = s.ctile[c];
    }
    for (int r = r0; r < r1; ++r) {
      const int fm = s.rowfm[r];
      if (fm <= 0) continue;                 // uniform: the row has no hit
      const float olx = s.o[r], oly = s.o[Fo + r];
      const float ohx = s.o[2 * Fo + r], ohy = s.o[3 * Fo + r];
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const bool m = ct[t] < fm && boxes_meet(olx, oly, ohx, ohy, ilx[t],
                                                ily[t], ihx[t], ihy[t]);
        if (!fn(m, r, t * kWarp + lane)) return;
      }
    }
  } else {
    const int dr = kWarp / Fi, dc = kWarp % Fi;
    const int end = r1 * Fi;
    int g = r0 * Fi + lane;
    int r = g / Fi, c = g - r * Fi;
    for (int g0 = r0 * Fi; g0 < end; g0 += kWarp) {
      bool m = false;
      if (g < end) {
        m = s.ctile[c] < s.rowfm[r] &&
            boxes_meet(s.o[r], s.o[Fo + r], s.o[2 * Fo + r], s.o[3 * Fo + r],
                       s.i[c], s.i[Fi + c], s.i[2 * Fi + c], s.i[3 * Fi + c]);
      }
      if (!fn(m, r, c)) return;
      g += kWarp;
      c += dc;
      r += dr;
      if (c >= Fi) {
        c -= Fi;
        ++r;
      }
    }
  }
}

// The pair slots of this block in a persistent grid: slot
// blockIdx.x + gridDim.x * k, walked in batches of 32 (k = k0 + j).
__device__ __forceinline__ int64_t batch_slot(int64_t k0, int j) {
  return (int64_t)blockIdx.x + (int64_t)gridDim.x * (k0 + j);
}

// A batch of 32 pair slots of one block: which are live, and their ids
// and alive_cnt, loaded by warp 0 at once so a pair's rows are one load
// away.
struct Batch {
  unsigned live;
  int oid[kWarp];
  int iid[kWarp];
  int alive[kWarp];
};

// Warp 0, lane `lane`: slot p's ids and alive_cnt into the batch; true
// when the pair is live (both ids >= 0 and alive_cnt > 0).
__device__ __forceinline__ bool load_ids(Batch& bt,
                                         const int* __restrict__ o_ids,
                                         const int* __restrict__ i_ids,
                                         const int* __restrict__ alive_cnt,
                                         int64_t p, int lane) {
  const int oid = o_ids[p], iid = i_ids[p], alive = alive_cnt[p];
  bt.oid[lane] = oid;
  bt.iid[lane] = iid;
  bt.alive[lane] = alive;
  return oid >= 0 && iid >= 0 && alive > 0;
}

template <int NC>
__global__ void __launch_bounds__(kPairThreads)
join_count_kernel(const int* __restrict__ o_ids, const int* __restrict__ i_ids,
                  const int* __restrict__ alive_cnt,
                  const int* __restrict__ flip_max,
                  const float* __restrict__ oc, const float* __restrict__ ic,
                  const int* __restrict__ o_ptr, const int* __restrict__ i_ptr,
                  int* __restrict__ counts, int* __restrict__ warp_counts,
                  int P, int Fo, int Fi, int to, int ti, int na) {
  extern __shared__ float smem[];
  __shared__ Batch bt;
  __shared__ int s_wt[kPairWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int r0, r1;
  warp_rows(Fo, &r0, &r1);
  for (int64_t k0 = 0; batch_slot(k0, 0) < P; k0 += kWarp) {
    if (warp == 0) {
      const int64_t p = batch_slot(k0, lane);
      bool live = false;
      if (p < P) {
        live = load_ids(bt, o_ids, i_ids, alive_cnt, p, lane);
        if (!live) counts[p] = 0;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (lane == 0) bt.live = bal;
    }
    __syncthreads();
    for (unsigned live = bt.live; live != 0; live &= live - 1) {
      const int j = __ffs(live) - 1;
      const int64_t p = batch_slot(k0, j);
      __syncthreads();                 // the previous pair's reads are done
      const Pair s = stage_pair(smem, oc, ic, flip_max, o_ptr, i_ptr,
                                bt.oid[j], bt.iid[j], bt.alive[j], p, Fo, Fi,
                                to, ti, na);
      int n = 0;
      walk_rows<NC>(s, r0, r1, Fo, Fi, [&](bool m, int, int) {
        n += __popc(__ballot_sync(0xffffffffu, m));
        return true;
      });
      if (lane == 0) {
        s_wt[warp] = n;
        warp_counts[p * kPairWarps + warp] = n;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < kPairWarps; ++w) total += s_wt[w];
        counts[p] = total;
      }
    }
    __syncthreads();                   // bt is rewritten next batch
  }
}

// Block-wide exclusive scan of one int64 per thread (blockDim.x ==
// kScanThreads); returns the thread's exclusive prefix, *total the sum.
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long* total) {
  __shared__ long long warp_incl[kScanWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  long long x = v;
  for (int d = 1; d < kWarp; d <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += up;
  }
  if (lane == kWarp - 1) warp_incl[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_incl[lane];
    for (int d = 1; d < kWarp; d <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    warp_incl[lane] = w;
  }
  __syncthreads();
  const long long excl = x - v + (warp == 0 ? 0 : warp_incl[warp - 1]);
  *total = warp_incl[kScanWarps - 1];
  __syncthreads();                      // warp_incl is reused by the caller
  return excl;
}

__global__ void __launch_bounds__(kScanThreads)
join_scan_tiles_kernel(const int* __restrict__ counts,
                       long long* __restrict__ offsets,
                       long long* __restrict__ tile_tot, int P) {
  const int64_t first = (int64_t)blockIdx.x * kScanTile +
                        (int64_t)threadIdx.x * kScanItems;
  int c[kScanItems];
  long long sum = 0;
  for (int j = 0; j < kScanItems; ++j) {
    c[j] = first + j < P ? counts[first + j] : 0;
    sum += c[j];
  }
  long long total;
  long long run = block_exclusive_scan(sum, &total);
  for (int j = 0; j < kScanItems; ++j) {
    if (first + j < P) offsets[first + j] = run;
    run += c[j];
  }
  if (threadIdx.x == 0) tile_tot[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
join_scan_carry_kernel(const long long* __restrict__ tile_tot,
                       long long* __restrict__ tile_base,
                       long long* __restrict__ total64,
                       int* __restrict__ count, bool* __restrict__ overflow,
                       int n_tiles, long long cap) {
  long long carry = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    long long total;
    const long long excl =
        block_exclusive_scan(t < n_tiles ? tile_tot[t] : 0, &total);
    if (t < n_tiles) tile_base[t] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) {
    *total64 = carry;
    *count = (int)carry;               // int32, as the reference's count
    *overflow = carry > cap;
  }
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

template <int NC>
__global__ void __launch_bounds__(kPairThreads)
join_scatter_kernel(const int* __restrict__ o_ids, const int* __restrict__ i_ids,
                    const int* __restrict__ alive_cnt,
                    const int* __restrict__ flip_max,
                    const float* __restrict__ oc, const float* __restrict__ ic,
                    const int* __restrict__ o_ptr, const int* __restrict__ i_ptr,
                    const int* __restrict__ counts,
                    const int* __restrict__ warp_counts,
                    const long long* __restrict__ offsets,
                    const long long* __restrict__ tile_base,
                    const long long* __restrict__ total64,
                    int* __restrict__ out_o, int* __restrict__ out_i, int P,
                    int Fo, int Fi, int to, int ti, int na, long long cap) {
  extern __shared__ float smem[];
  __shared__ Batch bt;
  __shared__ long long s_off[kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned lt_mask = (1u << lane) - 1u;
  int r0, r1;
  warp_rows(Fo, &r0, &r1);
  for (int64_t k0 = 0; batch_slot(k0, 0) < P; k0 += kWarp) {
    if (warp == 0) {
      const int64_t p = batch_slot(k0, lane);
      bool live = false;
      if (p < P) {
        const int n = counts[p];
        const long long off = tile_base[p / kScanTile] + offsets[p];
        load_ids(bt, o_ids, i_ids, alive_cnt, p, lane);
        s_off[lane] = off;
        live = n > 0 && off < cap;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (lane == 0) bt.live = bal;
    }
    __syncthreads();
    for (unsigned live = bt.live; live != 0; live &= live - 1) {
      const int j = __ffs(live) - 1;
      const int64_t p = batch_slot(k0, j);
      // in flight while the pair is staged
      const int wc = lane < kPairWarps ? warp_counts[p * kPairWarps + lane]
                                       : 0;
      __syncthreads();                 // the previous pair's reads are done
      const Pair s = stage_pair(smem, oc, ic, flip_max, o_ptr, i_ptr,
                                bt.oid[j], bt.iid[j], bt.alive[j], p, Fo, Fi,
                                to, ti, na);
      // this warp's start: the pair's offset and the earlier warps' counts
      int before = lane < warp ? wc : 0;
      for (int d = kWarp / 2; d > 0; d >>= 1)
        before += __shfl_xor_sync(0xffffffffu, before, d);
      long long run = s_off[j] + before;
      const long long stop =
          min(run + __shfl_sync(0xffffffffu, wc, warp), cap);
      if (run < stop) {
        walk_rows<NC>(s, r0, r1, Fo, Fi, [&](bool m, int r, int c) {
          const unsigned bal = __ballot_sync(0xffffffffu, m);
          if (m) {
            const long long pos = run + __popc(bal & lt_mask);
            if (pos < cap) {
              out_o[pos] = s.optr[r];
              out_i[pos] = s.iptr[c];
            }
          }
          run += __popc(bal);
          return run < stop;
        });
      }
    }
    __syncthreads();                   // bt, s_off rewritten next batch
  }
  const long long lo = min(*total64, cap);
  fill_tail(out_o, lo, cap, blockIdx.x, gridDim.x);
  fill_tail(out_i, lo, cap, blockIdx.x, gridDim.x);
}

// Dynamic shared memory of one B3 block (stage()'s layout).
size_t masks_smem_bytes(int Fo, int Fi, int na) {
  return sizeof(float) * 4 * (size_t)(Fo + Fi) + sizeof(int) * (size_t)na;
}

int scan_tiles(int P) { return (P + kScanTile - 1) / kScanTile; }

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

// The persistent grid of a B4 kernel for P pair slots: as many blocks as
// fit on the card at once, so no block waits for another to finish.
template <class Kernel>
int fused_grid(Kernel kernel, size_t smem, int P) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPairThreads,
                                                smem);
  const int full = sm_count() * (per_sm > 0 ? per_sm : 1);
  return P < full ? P : full;
}

template <int NC>
int launch_fused(const int* o_ids, const int* i_ids, const int* alive_cnt,
                 const int* flip_max, const float* oc, const float* ic,
                 const int* o_ptr, const int* i_ptr, int* out_o, int* out_i,
                 int* count, bool* overflow, int* counts, long long* scratch,
                 int P, int Fo, int Fi, int to, int ti, long long cap,
                 cudaStream_t st) {
  const int na = Fo / to;
  const int n_tiles = scan_tiles(P);
  long long* offsets = scratch;                       // (P,)
  long long* tile_tot = offsets + P;                  // (n_tiles,)
  long long* tile_base = tile_tot + n_tiles;          // (n_tiles,)
  long long* total64 = tile_base + n_tiles;           // (1,)
  int* warp_counts = reinterpret_cast<int*>(total64 + 1);   // (P, 8) int32
  const size_t smem = fused_smem_bytes(Fo, Fi);
  const int count_grid = fused_grid(join_count_kernel<NC>, smem, P);
  const int scatter_grid = fused_grid(join_scatter_kernel<NC>, smem, P);
  cudaError_t err;
  join_count_kernel<NC><<<count_grid, kPairThreads, smem, st>>>(
      o_ids, i_ids, alive_cnt, flip_max, oc, ic, o_ptr, i_ptr, counts,
      warp_counts, P, Fo, Fi, to, ti, na);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  join_scan_tiles_kernel<<<n_tiles, kScanThreads, 0, st>>>(counts, offsets,
                                                           tile_tot, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  join_scan_carry_kernel<<<1, kScanThreads, 0, st>>>(
      tile_tot, tile_base, total64, count, overflow, n_tiles, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  join_scatter_kernel<NC><<<scatter_grid, kPairThreads, smem, st>>>(
      o_ids, i_ids, alive_cnt, flip_max, oc, ic, o_ptr, i_ptr, counts,
      warp_counts, offsets, tile_base, total64, out_o, out_i, P, Fo, Fi, to,
      ti, na, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Layout queries for the wrapper, so that the sizes live here only: the
// dynamic shared memory of one pair block (B3 with ptrs = 0, B4 with
// ptrs = 1; the wrapper keeps it under the 48 KB a launch gets without
// opting in), and the int64 elements of B4's scratch for P pairs (the
// offsets, the tile totals and bases, the total, then eight int32 warp
// counts a pair).
extern "C" long long rtree_join_pair_smem(int Fo, int Fi, int to, int ptrs) {
  return (long long)(ptrs ? fused_smem_bytes(Fo, Fi)
                          : masks_smem_bytes(Fo, Fi, Fo / to));
}

extern "C" long long rtree_join_fused_scratch(int P) {
  return (long long)P + 2LL * scan_tiles(P) + 1 +
         (long long)P * kPairWarps / 2;
}

extern "C" int rtree_join_masks(const void* o_ids, const void* i_ids,
                                const void* alive_cnt, const void* flip_max,
                                const void* oc, const void* ic, void* mask,
                                int P, int Fo, int Fi, int to, int ti,
                                void* stream) {
  const int na = Fo / to;
  join_masks_kernel<<<P, kPairThreads, masks_smem_bytes(Fo, Fi, na),
                      (cudaStream_t)stream>>>(
      (const int*)o_ids, (const int*)i_ids, (const int*)alive_cnt,
      (const int*)flip_max, (const float*)oc, (const float*)ic, (int*)mask,
      Fo, Fi, to, ti, na);
  return (int)cudaGetLastError();
}

extern "C" int rtree_join_fused(const void* o_ids, const void* i_ids,
                                const void* alive_cnt, const void* flip_max,
                                const void* oc, const void* ic,
                                const void* o_ptr, const void* i_ptr,
                                void* out_o, void* out_i, void* count,
                                void* overflow, void* counts, void* scratch,
                                int P, int Fo, int Fi, int to, long long cap,
                                void* stream) {
  const int ti = Fi < 128 ? Fi : 128;
  const int nc = (Fi % kWarp == 0 && Fi <= 4 * kWarp) ? Fi / kWarp : 0;
  auto go = [&](auto launch) {
    return launch((const int*)o_ids, (const int*)i_ids, (const int*)alive_cnt,
                  (const int*)flip_max, (const float*)oc, (const float*)ic,
                  (const int*)o_ptr, (const int*)i_ptr, (int*)out_o,
                  (int*)out_i, (int*)count, (bool*)overflow, (int*)counts,
                  (long long*)scratch, P, Fo, Fi, to, ti, cap,
                  (cudaStream_t)stream);
  };
  switch (nc) {
    case 1: return go(launch_fused<1>);
    case 2: return go(launch_fused<2>);
    case 3: return go(launch_fused<3>);
    case 4: return go(launch_fused<4>);
    default: return go(launch_fused<0>);
  }
}
