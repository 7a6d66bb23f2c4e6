// The paper's DFS range-select baselines, hand-written for Hopper (sm_90a).
//
// Two kernels, each behind a plain C entry point (loaded with ctypes by
// kernels/_build.py and wrapped by kernels/rtree_dfs.py).  Both walk the
// flat node table of core/flat.py (levels concatenated leaf first, child
// ids globalized) for ONE query per launch with an explicit DFS stack in
// shared memory, as the reference's jitted lax.while_loop programs do.
// Neither replaces a Pallas kernel: the reference runs these loops as XLA
// while_loops.
//
// S   rtree_select_dfs_scalar — replaces
//     src/repro/core/select_scalar.py:make_select_dfs (line 95).  One
//     thread walks the tree: pop a node, then its F children one at a time
//     (one child per step, the paper's scalar variant); a child with
//     j < count and an intersecting box is pushed (internal node) or
//     emitted (leaf).  predicates grows by 4 per child with j < count.
// V   rtree_select_dfs_vector — replaces
//     src/repro/core/select_vector.py:make_select_dfs_vector (line 259).
//     One warp walks the tree: each pop tests the node's F lanes in
//     ceil(F/32) chunks of 32, one lane a child, and compacts the
//     qualifying children in lane order with __ballot_sync and __popc (the
//     reference's compaction.compact_1d) before they are pushed or
//     emitted; the paper's partially vectorized variant.
//
// Both reproduce the reference's overflow semantics exactly.  JAX clamps
// an out-of-range gather and drops an out-of-range scatter, so:
//   * a pop reads stack[min(sp, stack_cap - 1)];
//   * a push at sp >= stack_cap and an emit at rc >= result_cap vanish,
//     while sp and rc keep counting;
//   * overflow |= sp > stack_cap || rc > result_cap after every node.
// An overflowed walk can re-read stack[stack_cap - 1] without end (the
// reference's loop would not end either); both kernels stop after
// max_steps pops with overflow set, and so does the twin.
//
// Bound on the card: latency, not bytes.  Each pop is a chain of
// dependent loads (the stack slot, then the node's count and leaf flag,
// then its rows), so a query costs about nodes_visited dependent global
// loads however few bytes it reads: at a 2M-point fanout-64 tree a query
// of selectivity 0.001 visits a few dozen nodes and reads ~1.3 KB a node.
// The bytes bound (each visited node's rows read once at 3.35 TB/s) is a
// thousand times lower.  Design: the stack lives in shared memory
// (stack_cap int32, dynamic), the result slots are filled with -1 by the
// whole block first, and S reads only the count-valid lanes of a node,
// each lane's four coordinates with independent loads the compiler can
// overlap; V reads 32 lanes a chunk with coalesced loads.  One query per
// launch is the reference's signature and the paper's per-query
// measurement; a batch is a loop of launches.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.
// stats[0..3] = rc (may exceed result_cap), nodes visited, predicates
// (S only; V leaves 0), overflow (0/1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kFillThreads = 128;      // S: threads that fill res and stack

struct Query {
  float qlx, qly, qhx, qhy;
};

__device__ __forceinline__ bool hits(const Query& q, float lx, float ly,
                                     float hx, float hy) {
  return (q.qlx <= hx) & (q.qhx >= lx) & (q.qly <= hy) & (q.qhy >= ly);
}

// res[0:result_cap] = -1 and stack[0:stack_cap] = 0 by every thread of
// the block, stack[0] = root; the caller synchronizes.
__device__ __forceinline__ void init_walk(int* res, int* stack, int root,
                                          int stack_cap, int result_cap) {
  for (int i = threadIdx.x; i < result_cap; i += blockDim.x) res[i] = -1;
  for (int i = threadIdx.x; i < stack_cap; i += blockDim.x)
    stack[i] = i == 0 ? root : 0;
}

__global__ void dfs_scalar_kernel(
    const float* __restrict__ lx, const float* __restrict__ ly,
    const float* __restrict__ hx, const float* __restrict__ hy,
    const int* __restrict__ child, const int* __restrict__ count,
    const uint8_t* __restrict__ is_leaf, const float* __restrict__ qv,
    int root, int f, int stack_cap, int result_cap, int max_steps,
    int* __restrict__ res, int* __restrict__ stats) {
  extern __shared__ int stack[];
  init_walk(res, stack, root, stack_cap, result_cap);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const Query q{qv[0], qv[1], qv[2], qv[3]};
  int sp = 1, rc = 0, nodes = 0, preds = 0, ovf = 0;
  while (sp > 0) {
    if (nodes == max_steps) {         // the reference would not end
      ovf = 1;
      break;
    }
    sp -= 1;
    const int nid = stack[min(sp, stack_cap - 1)];
    const bool leaf = is_leaf[nid] != 0;
    const int n = min(max(count[nid], 0), f);
    const size_t row = static_cast<size_t>(nid) * f;
    preds += 4 * n;
    for (int j = 0; j < n; ++j) {     // one child per step
      if (!hits(q, lx[row + j], ly[row + j], hx[row + j], hy[row + j]))
        continue;
      const int cid = child[row + j];
      if (leaf) {
        if (rc < result_cap) res[rc] = cid;
        ++rc;
      } else {
        if (sp < stack_cap) stack[sp] = cid;
        ++sp;
      }
    }
    ovf |= (sp > stack_cap) | (rc > result_cap);
    ++nodes;
  }
  stats[0] = rc;
  stats[1] = nodes;
  stats[2] = preds;
  stats[3] = ovf;
}

__global__ void dfs_vector_kernel(
    const float* __restrict__ lx, const float* __restrict__ ly,
    const float* __restrict__ hx, const float* __restrict__ hy,
    const int* __restrict__ child, const uint8_t* __restrict__ is_leaf,
    const float* __restrict__ qv, int root, int f, int stack_cap,
    int result_cap, int max_steps, int* __restrict__ res,
    int* __restrict__ stats) {
  extern __shared__ int stack[];
  init_walk(res, stack, root, stack_cap, result_cap);
  __syncwarp();
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const Query q{qv[0], qv[1], qv[2], qv[3]};
  int sp = 1, rc = 0, nodes = 0, ovf = 0;
  while (sp > 0) {
    if (nodes == max_steps) {
      ovf = 1;
      break;
    }
    sp -= 1;
    const int nid = stack[min(sp, stack_cap - 1)];
    const bool leaf = is_leaf[nid] != 0;
    __syncwarp();                     // every lane has read nid
    const size_t row = static_cast<size_t>(nid) * f;
    int k = 0;                        // qualifying children so far
    for (int j0 = 0; j0 < f; j0 += kWarp) {
      const int j = j0 + lane;
      bool m = false;
      int cid = -1;
      if (j < f) {
        cid = child[row + j];
        m = cid >= 0 &&
            hits(q, lx[row + j], ly[row + j], hx[row + j], hy[row + j]);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, m);
      if (m) {
        const int pos = k + __popc(ballot & below);
        if (leaf) {
          if (rc + pos < result_cap) res[rc + pos] = cid;
        } else {
          if (sp + pos < stack_cap) stack[sp + pos] = cid;
        }
      }
      k += __popc(ballot);
    }
    __syncwarp();                     // the pushes land before the next pop
    if (leaf) rc += k; else sp += k;
    ovf |= (sp > stack_cap) | (rc > result_cap);
    ++nodes;
  }
  if (lane == 0) {
    stats[0] = rc;
    stats[1] = nodes;
    stats[2] = 0;
    stats[3] = ovf;
  }
}

cudaError_t prepare_smem(const void* kernel, int stack_cap) {
  const int bytes = stack_cap * static_cast<int>(sizeof(int));
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

int rtree_select_dfs_scalar(const float* lx, const float* ly,
                            const float* hx, const float* hy,
                            const int* child, const int* count,
                            const uint8_t* is_leaf, const float* q, int* res,
                            int* stats, int root, int f, int stack_cap,
                            int result_cap, int max_steps,
                            cudaStream_t stream) {
  cudaError_t err = prepare_smem(
      reinterpret_cast<const void*>(dfs_scalar_kernel), stack_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  dfs_scalar_kernel<<<1, kFillThreads, stack_cap * sizeof(int), stream>>>(
      lx, ly, hx, hy, child, count, is_leaf, q, root, f, stack_cap,
      result_cap, max_steps, res, stats);
  return static_cast<int>(cudaGetLastError());
}

int rtree_select_dfs_vector(const float* lx, const float* ly,
                            const float* hx, const float* hy,
                            const int* child, const int* count,
                            const uint8_t* is_leaf, const float* q, int* res,
                            int* stats, int root, int f, int stack_cap,
                            int result_cap, int max_steps,
                            cudaStream_t stream) {
  (void)count;                        // V tests child >= 0, as the reference
  cudaError_t err = prepare_smem(
      reinterpret_cast<const void*>(dfs_vector_kernel), stack_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  dfs_vector_kernel<<<1, kWarp, stack_cap * sizeof(int), stream>>>(
      lx, ly, hx, hy, child, is_leaf, q, root, f, stack_cap, result_cap,
      max_steps, res, stats);
  return static_cast<int>(cudaGetLastError());
}

// Largest stack_cap the kernels take: the stack is dynamic shared memory.
long long rtree_dfs_max_stack_cap() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024 / sizeof(int);
  return bytes / sizeof(int);
}

}  // extern "C"
