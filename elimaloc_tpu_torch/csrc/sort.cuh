// The stable radix sort of kernels B (assign.cu) and C (downsample.cu).
//
// Replaces the sort inside the JAX hot ops K4 and K5: the jax.lax.sort of
// elimaloc_tpu/map/tiles.py:609 (assign_slots, payload lanes sorted by tile)
// and of elimaloc_tpu/map/grid.py:300 (voxel_downsample, sorted by the
// mixed voxel key). On the TPU both sorts carry their payload lanes because
// gathers there are scalar-core-bound; here the sort carries one int32
// payload, the input index, and the kernels gather the rest by it.
//
// Design: one thread-block cluster of kSortCtas = 16 CTAs of 512 threads,
// launched once by the kernel that owns the sort (16 is past the portable
// size of 8: the launch sets cudaFuncAttributeNonPortableClusterSizeAllowed
// and checks cudaOccupancyMaxActiveClusters). An LSD radix sort of uint32
// keys with 8-bit digits, the number of passes set by the caller from the
// key's bit length; stable, so equal keys keep input order. Each CTA owns a
// contiguous stripe of the elements, in order. Per pass:
//   1. each CTA counts the digits of its stripe in shared memory (a warp's
//      equal digits are added at once: __match_any_sync + one atomic);
//   2. cluster.sync(); every CTA reads the others' counts through
//      distributed shared memory, so the first position of digit d in CTA r
//      is the count of all lower digits plus digit d in CTAs before r;
//   3. the CTA ranks its stripe chunk by chunk (4 elements a thread, 2,048
//      a chunk, so one chunk covers a CTA's stripe at the headline; chunk
//      order = input order): inside a warp's run of 128 elements by
//      __match_any_sync, a lane-mask popcount and the digit's count of the
//      run's earlier rounds, across warps by a scan in (digit, warp) order,
//      across chunks by running per-digit positions. It stages the chunk in
//      shared memory in digit order and writes key and payload out from
//      there, so that a digit's run goes to consecutive addresses (scattered
//      4-byte stores were a pass's largest cost on the H100), into the other half of
//      a ping-pong scratch in global memory (the wrapper's torch.empty; at
//      the headline 26,215 x 8 B per half, which stays in the 50 MB L2);
//   4. __threadfence() and cluster.sync(): the pass's output is complete.
// Bound: latency. The bytes are a few hundred kB; each pass is a handful of
// block barriers and two cluster barriers. The cluster keeps the whole
// function in one launch, with no host round trip and no library kernel,
// and spreads the per-element work of the kernels around the sort (keys,
// gathers, IEEE divisions) over 16 SMs: on the H100 16 x 512 took B and C
// 0.031 / 0.049 ms on the device against 0.040 / 0.064 ms for 8 x 1024.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace elm {

constexpr int kSortThreads = 512;   // threads per CTA
constexpr int kSortCtas = 16;       // CTAs of the one cluster
constexpr int kSortItems = 4;       // elements a thread holds per chunk
constexpr int kSortChunk = kSortThreads * kSortItems;
constexpr int kWarpRun = 32 * kSortItems;  // a warp's run of consecutive elements
constexpr int kRadix = 256;         // 8-bit digits
constexpr int kSortWarps = kSortThreads / 32;
static_assert(kSortThreads >= kRadix, "one thread per digit in the offset and scan steps");

// Dynamic shared memory of a sorting CTA; the kernels append their own
// tables after it.
struct SortShared {
  unsigned hist[kRadix];               // this CTA's digit counts (read by the cluster)
  unsigned next[kRadix];               // the next output position per digit
  unsigned first[kRadix];              // a chunk's first place of each digit
  unsigned delta[kRadix];              // output position - place in the chunk
  unsigned warp[kSortWarps][kRadix];   // per-warp digit counts, then offsets
  uint32_t stage_k[kSortChunk];        // a chunk in digit order
  int stage_v[kSortChunk];
  int scan[32];                        // block_scan scratch
  int count[2];                        // per-CTA counts the cluster reads
  int offset[2], total[2];             // this CTA's prefix of ``count``, and the sum
  int drop;                            // CTA 0: the cluster's dropped queries (assign.cu)
};

// This CTA's stripe [lo, hi) of n elements split over the cluster.
__device__ __forceinline__ void sort_stripe(int n, int rank, int* lo, int* hi) {
  const int per = (n + kSortCtas - 1) / kSortCtas;
  *lo = min(n, rank * per);
  *hi = min(n, *lo + per);
}

// Element j of this thread in the chunk at ``base``: warp w owns the run
// [base + w * kWarpRun, + kWarpRun), and within it round j covers 32
// consecutive elements, one a lane. Chunk order (warp, round, lane) is input
// order.
__device__ __forceinline__ int chunk_index(int base, int j) {
  return base + (threadIdx.x >> 5) * kWarpRun + j * 32 + (threadIdx.x & 31);
}

// Stable sort of the cluster's n (key, value) pairs by the low 8 * passes
// bits of the key. On entry this CTA's stripe of (k0, v0) holds its part of
// the input, written by this CTA; (k1, v1) is scratch of the same size. On
// return every CTA sees the sorted pairs at (*ks, *vs): (k0, v0) after an
// even number of passes, (k1, v1) after an odd one.
__device__ inline void cluster_sort(uint32_t* k0, int* v0, uint32_t* k1, int* v1, int n,
                                    int passes, SortShared& sm, uint32_t** ks, int** vs) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int rank = (int)cluster.block_rank();
  int lo, hi;
  sort_stripe(n, rank, &lo, &hi);
  uint32_t* src_k = k0;
  int* src_v = v0;
  uint32_t* dst_k = k1;
  int* dst_v = v1;
  __syncthreads();
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 8 * pass;
    // 1. this stripe's digit counts
    for (int d = tid; d < kRadix; d += kSortThreads) sm.hist[d] = 0;
    __syncthreads();
    for (int base = lo; base < hi; base += kSortChunk) {
      unsigned dig[kSortItems];
#pragma unroll
      for (int j = 0; j < kSortItems; ++j) {
        const int i = chunk_index(base, j);
        dig[j] = i < hi ? (src_k[i] >> shift) & (kRadix - 1) : kRadix;
      }
#pragma unroll
      for (int j = 0; j < kSortItems; ++j) {
        const unsigned peers = __match_any_sync(0xffffffffu, dig[j]);
        if (dig[j] < kRadix && (peers & lanes_below) == 0)
          atomicAdd(&sm.hist[dig[j]], (unsigned)__popc(peers));
      }
    }
    cluster.sync();
    // 2. the first output position of each digit in this CTA
    unsigned before = 0, count = 0;
    if (tid < kRadix) {
      for (int r = 0; r < kSortCtas; ++r) {
        const unsigned c = cluster.map_shared_rank(sm.hist, r)[tid];
        count += c;
        before += r < rank ? c : 0u;
      }
    }
    int all;
    const int incl = block_scan((int)count, AddOp(), sm.scan, &all);
    if (tid < kRadix) sm.next[tid] = (unsigned)incl - count + before;
    __syncthreads();
    // 3. rank the stripe in input order and scatter
    for (int base = lo; base < hi; base += kSortChunk) {
      for (int j = tid; j < kSortWarps * kRadix; j += kSortThreads) (&sm.warp[0][0])[j] = 0;
      uint32_t key[kSortItems];
      int val[kSortItems];
      unsigned dig[kSortItems], rk[kSortItems];
#pragma unroll
      for (int j = 0; j < kSortItems; ++j) {
        const int i = chunk_index(base, j);
        const bool in = i < hi;
        key[j] = in ? src_k[i] : 0u;
        val[j] = in ? src_v[i] : 0;
        dig[j] = in ? (key[j] >> shift) & (kRadix - 1) : kRadix;
      }
      __syncthreads();
      // within the warp's run: round by round, the lanes of one digit by
      // their lane-mask popcount after the digit's count of earlier rounds
#pragma unroll
      for (int j = 0; j < kSortItems; ++j) {
        const unsigned peers = __match_any_sync(0xffffffffu, dig[j]);
        const unsigned below = __popc(peers & lanes_below);
        const unsigned seen = dig[j] < kRadix ? sm.warp[w][dig[j]] : 0u;
        __syncwarp();
        if (dig[j] < kRadix && below == 0) sm.warp[w][dig[j]] = seen + __popc(peers);
        __syncwarp();
        rk[j] = seen + below;
      }
      __syncthreads();
      // across warps: per digit, an exclusive scan in warp order; then the
      // chunk's digits in order (``first``) and the shift from a place in
      // the chunk's digit order to the output (``delta``)
      unsigned in_chunk = 0;
      if (tid < kRadix) {
        for (int ww = 0; ww < kSortWarps; ++ww) {
          const unsigned c = sm.warp[ww][tid];
          sm.warp[ww][tid] = in_chunk;
          in_chunk += c;
        }
      }
      int chunk_n;
      const unsigned first = block_scan((int)in_chunk, AddOp(), sm.scan, &chunk_n) - in_chunk;
      if (tid < kRadix) {
        sm.first[tid] = first;
        sm.delta[tid] = sm.next[tid] - first;
        sm.next[tid] += in_chunk;
      }
      __syncthreads();
      // stage the chunk in digit order, then write it out in runs: equal
      // digits go to consecutive places, so neighbouring threads store to
      // neighbouring addresses
#pragma unroll
      for (int j = 0; j < kSortItems; ++j) {
        if (dig[j] < kRadix) {
          const unsigned at = sm.first[dig[j]] + sm.warp[w][dig[j]] + rk[j];
          sm.stage_k[at] = key[j];
          sm.stage_v[at] = val[j];
        }
      }
      __syncthreads();
      for (int at = tid; at < chunk_n; at += kSortThreads) {
        const uint32_t k = sm.stage_k[at];
        const unsigned pos = sm.delta[(k >> shift) & (kRadix - 1)] + at;
        dst_k[pos] = k;
        dst_v[pos] = sm.stage_v[at];
      }
      __syncthreads();
    }
    // 4. the pass's output is complete for the whole cluster
    __threadfence();
    cluster.sync();
    uint32_t* tk = src_k;
    int* tv = src_v;
    src_k = dst_k;
    src_v = dst_v;
    dst_k = tk;
    dst_v = tv;
  }
  *ks = src_k;
  *vs = src_v;
}

// Two per-CTA counts summed over the cluster: sm.total[k] the sum of
// ``a`` (k = 0) or ``b`` (k = 1), sm.offset[k] the sum over the CTAs before
// this one. ``a`` and ``b`` are the same in every thread of the CTA. Ends
// with the CTA's threads synced; the caller keeps the cluster alive (a final
// cluster.sync) while others may still read sm.count.
__device__ inline void cluster_exclusive(int a, int b, SortShared& sm) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    sm.count[0] = a;
    sm.count[1] = b;
  }
  cluster.sync();
  if (threadIdx.x < 2) {
    const int k = threadIdx.x;
    const int rank = (int)cluster.block_rank();
    int off = 0, all = 0;
    for (int r = 0; r < kSortCtas; ++r) {
      const int c = cluster.map_shared_rank(sm.count, r)[k];
      all += c;
      off += r < rank ? c : 0;
    }
    sm.offset[k] = off;
    sm.total[k] = all;
  }
  __syncthreads();
}

// The cluster's lane when a launch holds one cluster a lane (a fleet frame,
// kernels B and C): clusters tile the grid in x, so cluster l is CTAs
// [l * kSortCtas, (l + 1) * kSortCtas). No state crosses clusters, and the
// card may run them in waves.
__device__ __forceinline__ int cluster_lane() { return (int)blockIdx.x / kSortCtas; }

// Launches ``kernel`` as ``lanes`` clusters of kSortCtas x kSortThreads
// with ``smem`` bytes of dynamic shared memory. At first use it raises the
// kernel's dynamic shared memory limit to ``max_smem`` and asks
// cudaOccupancyMaxActiveClusters whether such a cluster fits the card:
// if none does, kNoCluster comes back and nothing is launched.
constexpr int kNoCluster = -1;

template <class... Params, class... Args>
int launch_cluster(void (*kernel)(Params...), size_t smem, size_t max_smem,
                   bool* checked, cudaStream_t stream, int lanes, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSortCtas * lanes, 1, 1);
  cfg.blockDim = dim3(kSortThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSortCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!*checked) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)max_smem);
    if (e == cudaSuccess && kSortCtas > 8)  // past the portable cluster size
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    cfg.dynamicSmemBytes = max_smem;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters == 0) return kNoCluster;
    *checked = true;
  }
  cfg.dynamicSmemBytes = smem;
  cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)cudaGetLastError();
}

}  // namespace elm
