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
//     filled with -1; count (may exceed cap) and overflow = count > cap.
//     The output equals compact_pairs over the flat lanes, order included.
//     The TPU kernel carries a running SMEM offset across its sequential
//     grid; blocks on the GPU run in no order, so the offset becomes an
//     ordered scan in three steps, none of which allocates a slot with an
//     atomic:
//       1. join_count_kernel: per pair, the number of qualifying lanes
//          (__syncthreads_count over tiles of blockDim lanes);
//       2. join_scan_tiles_kernel + join_scan_carry_kernel: the exclusive
//          scan of those counts over P — tiles of kScanTile pairs scanned by
//          many blocks, then the tile totals scanned by one block walking
//          them in order (int64 throughout), which also writes the count
//          and the overflow flag;
//       3. join_scatter_kernel: per pair, the lanes ranked inside the block
//          with __ballot_sync/__popc and a scan of the warp totals, stored at
//          offset[p] + rank while that is < cap.  Pairs with no hit, or whose
//          offset is already past cap, return at once.
//     Bound on the card: memory — the live pairs' node rows (coords and
//     child pointers), the ids and the metadata read, 2 x cap int32 written.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPairThreads = 256;                 // B3 / B4 threads per pair
constexpr int kPairWarps = kPairThreads / kWarp;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;                     // counts per scan thread
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / kWarp;

static_assert(kPairWarps <= kWarp, "one warp scans the warp totals");
static_assert(kScanWarps == kWarp, "one warp scans the warp totals");

// One pair's staged rows: coords (4 x F, rows lx, ly, hx, hy) of both
// nodes, the pair's flip_max row, and (B4) both child-pointer rows.
struct Staged {
  const float* o;
  const float* i;
  const int* fm;
  const int* optr;
  const int* iptr;
};

__device__ __forceinline__ Staged stage(
    float* smem, const float* __restrict__ oc, const float* __restrict__ ic,
    const int* __restrict__ flip_max, const int* __restrict__ o_ptr,
    const int* __restrict__ i_ptr, int oid, int iid, int p, int Fo, int Fi,
    int na) {
  float* s_o = smem;
  float* s_i = s_o + 4 * Fo;
  int* s_fm = reinterpret_cast<int*>(s_i + 4 * Fi);
  int* s_op = s_fm + na;
  int* s_ip = s_op + Fo;
  const float* orow = oc + (int64_t)oid * 4 * Fo;
  const float* irow = ic + (int64_t)iid * 4 * Fi;
  for (int k = threadIdx.x; k < 4 * Fo; k += blockDim.x) s_o[k] = orow[k];
  for (int k = threadIdx.x; k < 4 * Fi; k += blockDim.x) s_i[k] = irow[k];
  for (int k = threadIdx.x; k < na; k += blockDim.x)
    s_fm[k] = flip_max[(int64_t)p * na + k];
  if (o_ptr != nullptr) {
    for (int k = threadIdx.x; k < Fo; k += blockDim.x)
      s_op[k] = o_ptr[(int64_t)oid * Fo + k];
    for (int k = threadIdx.x; k < Fi; k += blockDim.x)
      s_ip[k] = i_ptr[(int64_t)iid * Fi + k];
  }
  __syncthreads();
  return Staged{s_o, s_i, s_fm, s_op, s_ip};
}

// The intersect test and the tile skip of lane (r, c).
__device__ __forceinline__ bool lane_hits(const Staged& s, int r, int c,
                                          int Fo, int Fi, int to, int ti,
                                          int alive) {
  const int a = r / to;
  return (a * to < alive) && ((c / ti) * ti < s.fm[a]) &&
         (s.o[r] <= s.i[2 * Fi + c]) && (s.o[2 * Fo + r] >= s.i[c]) &&
         (s.o[Fo + r] <= s.i[3 * Fi + c]) &&
         (s.o[3 * Fo + r] >= s.i[Fi + c]);
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
  const Staged s = stage(smem, oc, ic, flip_max, nullptr, nullptr, oid, iid,
                         p, Fo, Fi, na);
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

// B4 lane predicate: lane_hits and both child pointers valid.
__device__ __forceinline__ bool fused_lane(const Staged& s, int64_t g,
                                           int64_t lanes, int Fo, int Fi,
                                           int to, int ti, int alive) {
  if (g >= lanes) return false;
  const int r = (int)(g / Fi);
  const int c = (int)(g - (int64_t)r * Fi);
  return s.optr[r] >= 0 && s.iptr[c] >= 0 &&
         lane_hits(s, r, c, Fo, Fi, to, ti, alive);
}

__global__ void __launch_bounds__(kPairThreads)
join_count_kernel(const int* __restrict__ o_ids, const int* __restrict__ i_ids,
                  const int* __restrict__ alive_cnt,
                  const int* __restrict__ flip_max,
                  const float* __restrict__ oc, const float* __restrict__ ic,
                  const int* __restrict__ o_ptr, const int* __restrict__ i_ptr,
                  int* __restrict__ counts, int Fo, int Fi, int to, int ti,
                  int na) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int oid = o_ids[p], iid = i_ids[p];
  const int alive = (oid < 0 || iid < 0) ? 0 : alive_cnt[p];
  if (alive <= 0) {
    if (threadIdx.x == 0) counts[p] = 0;
    return;
  }
  const Staged s = stage(smem, oc, ic, flip_max, o_ptr, i_ptr, oid, iid, p,
                         Fo, Fi, na);
  const int64_t lanes = (int64_t)Fo * Fi;
  int total = 0;
  for (int64_t t0 = 0; t0 < lanes; t0 += blockDim.x)
    total += __syncthreads_count(
        fused_lane(s, t0 + threadIdx.x, lanes, Fo, Fi, to, ti, alive));
  if (threadIdx.x == 0) counts[p] = total;
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
    *count = (int)carry;               // int32, as the reference's count
    *overflow = carry > cap;
  }
}

__global__ void __launch_bounds__(kPairThreads)
join_scatter_kernel(const int* __restrict__ o_ids, const int* __restrict__ i_ids,
                    const int* __restrict__ alive_cnt,
                    const int* __restrict__ flip_max,
                    const float* __restrict__ oc, const float* __restrict__ ic,
                    const int* __restrict__ o_ptr, const int* __restrict__ i_ptr,
                    const int* __restrict__ counts,
                    const long long* __restrict__ offsets,
                    const long long* __restrict__ tile_base,
                    int* __restrict__ out_o, int* __restrict__ out_i, int Fo,
                    int Fi, int to, int ti, int na, long long cap) {
  extern __shared__ float smem[];
  __shared__ int warp_incl[kPairWarps];
  const int p = blockIdx.x;
  const int n = counts[p];
  long long run = tile_base[p / kScanTile] + offsets[p];
  if (n == 0 || run >= cap) return;
  const Staged s = stage(smem, oc, ic, flip_max, o_ptr, i_ptr, o_ids[p],
                         i_ids[p], p, Fo, Fi, na);
  const int alive = alive_cnt[p];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int64_t lanes = (int64_t)Fo * Fi;
  const long long end = run + n;
  for (int64_t t0 = 0; t0 < lanes && run < end && run < cap;
       t0 += blockDim.x) {                // run is uniform over the block
    const int64_t g = t0 + threadIdx.x;
    const bool m = fused_lane(s, g, lanes, Fo, Fi, to, ti, alive);
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_incl[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      int v = lane < kPairWarps ? warp_incl[lane] : 0;
      for (int d = 1; d < kPairWarps; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += up;
      }
      if (lane < kPairWarps) warp_incl[lane] = v;
    }
    __syncthreads();
    if (m) {
      const long long pos = run + (warp == 0 ? 0 : warp_incl[warp - 1]) +
                            __popc(bal & lt_mask);
      if (pos < cap) {
        const int r = (int)(g / Fi);
        out_o[pos] = s.optr[r];
        out_i[pos] = s.iptr[g - (int64_t)r * Fi];
      }
    }
    run += warp_incl[kPairWarps - 1];
    __syncthreads();                      // warp_incl is rewritten next tile
  }
}

// Dynamic shared memory of one pair block (stage()'s layout).
size_t pair_smem_bytes(int Fo, int Fi, int na, bool ptrs) {
  return sizeof(float) * 4 * (size_t)(Fo + Fi) +
         sizeof(int) * ((size_t)na + (ptrs ? (size_t)(Fo + Fi) : 0));
}

int scan_tiles(int P) { return (P + kScanTile - 1) / kScanTile; }

}  // namespace

// Layout queries for the wrapper, so that the sizes live here only: the
// dynamic shared memory of one pair block (B3 with ptrs = 0, B4 with
// ptrs = 1; the wrapper keeps it under the 48 KB a launch gets without
// opting in), and the int64 elements of B4's scratch for P pairs (the
// offsets, then the tile totals and the tile bases).
extern "C" long long rtree_join_pair_smem(int Fo, int Fi, int to, int ptrs) {
  return (long long)pair_smem_bytes(Fo, Fi, Fo / to, ptrs != 0);
}

extern "C" long long rtree_join_fused_scratch(int P) {
  return (long long)P + 2LL * scan_tiles(P);
}

extern "C" int rtree_join_masks(const void* o_ids, const void* i_ids,
                                const void* alive_cnt, const void* flip_max,
                                const void* oc, const void* ic, void* mask,
                                int P, int Fo, int Fi, int to, int ti,
                                void* stream) {
  const int na = Fo / to;
  join_masks_kernel<<<P, kPairThreads, pair_smem_bytes(Fo, Fi, na, false),
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
  cudaStream_t st = (cudaStream_t)stream;
  const int na = Fo / to;
  const int ti = Fi < 128 ? Fi : 128;
  const int n_tiles = scan_tiles(P);
  long long* offsets = (long long*)scratch;           // (P,)
  long long* tile_tot = offsets + P;                  // (n_tiles,)
  long long* tile_base = tile_tot + n_tiles;          // (n_tiles,)
  const size_t smem = pair_smem_bytes(Fo, Fi, na, true);
  cudaError_t err;
  if (cap > 0) {
    err = cudaMemsetAsync(out_o, 0xFF, sizeof(int) * (size_t)cap, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(out_i, 0xFF, sizeof(int) * (size_t)cap, st);
    if (err != cudaSuccess) return (int)err;
  }
  join_count_kernel<<<P, kPairThreads, smem, st>>>(
      (const int*)o_ids, (const int*)i_ids, (const int*)alive_cnt,
      (const int*)flip_max, (const float*)oc, (const float*)ic,
      (const int*)o_ptr, (const int*)i_ptr, (int*)counts, Fo, Fi, to, ti, na);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  join_scan_tiles_kernel<<<n_tiles, kScanThreads, 0, st>>>(
      (const int*)counts, offsets, tile_tot, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  join_scan_carry_kernel<<<1, kScanThreads, 0, st>>>(
      tile_tot, tile_base, (int*)count, (bool*)overflow, n_tiles, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  join_scatter_kernel<<<P, kPairThreads, smem, st>>>(
      (const int*)o_ids, (const int*)i_ids, (const int*)alive_cnt,
      (const int*)flip_max, (const float*)oc, (const float*)ic,
      (const int*)o_ptr, (const int*)i_ptr, (const int*)counts, offsets,
      tile_base, (int*)out_o, (int*)out_i, Fo, Fi, to, ti, na, cap);
  return (int)cudaGetLastError();
}
