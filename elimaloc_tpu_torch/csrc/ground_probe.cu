// Kernel Z: the relocalization's ground probe over the hash grid (K13,
// FindGroundHeight) — kernel R redesigned for the H100.
//
// Replaces elimaloc_tpu/map/grid.py:find_ground_height (:320): over the map
// points of voxels 0 .. V-1, keep those with a finite x and dx dx + dy dy
// <= r^2 in XY; found = more than 3 kept; ground z = the mean of the k
// lowest z (their sum in ascending order over k; +inf with fewer than k
// kept, as top_k's -inf fill gives). Its reference is kernel R
// (ground_height.cu), which launches on no path: Z's (found, z) equal R's
// bit for bit.
//
// What held R back: it streams the whole [V, M, 3] plane (55 MB at the
// headline map, 151,644 voxels x 30 slots), most of it the builder's +inf
// padding past each voxel's count, in three scalar loads a slot, and
// merges its partials in a second launch. Z:
//   1. reads only real points: thread t of the grid takes voxel t (a grid
//      stride past V), reads its count (consecutive threads, consecutive
//      counts: coalesced; clamped to [0, M]) and then only the slots below
//      it, 4 slots' x, y, z loaded together a step. This is exact because
//      the MapGrid guarantees that the slots at or past a voxel's count are
//      +inf (map/grid.py MapGrid; a tier-1 test holds every grid the port
//      builds to it), which R's isfinite(x) test dropped; Z keeps that test
//      on the points it reads;
//   2. keeps, per thread, a count and the kGroundK (8 >= k) smallest kept
//      z in a register list sorted ascending (R's compare-exchange insert).
//      A butterfly of shuffles merges a warp's lists, warp 0 the CTA's 8
//      warp lists, each step the bitonic merge of two sorted lists (c_j =
//      min(a_j, b_{7-j}) holds the 8 smallest; 12 compare-exchanges sort
//      them), skipped where every count is 0 (every list then +inf). Few
//      points lie within r of the probe, so most warps skip it;
//   3. is one launch: T's hand-off (scan_front.cu). Thread 0 writes the
//      CTA's count and list to the workspace and counts the CTA done after
//      a __threadfence; the last CTA to arrive reads every CTA's count and
//      the lists of those that kept a point with __ldcg in CTA order,
//      merges them as in 2, resets the done counter to 0 for the next call
//      and writes (found, z). The k smallest values of a multiset and an
//      integer count do not depend on the merge order, so (found, z) is
//      the same on every run and equals R's. The workspace belongs to one
//      stream (the wrapper keeps one a device and stream), so calls on two
//      streams never share a counter.
// A flattened walk (a warp's 32 voxels' points numbered by a prefix sum and
// read 32 at a time) and 2 voxels or 8 slots a thread measured slower on
// the H100 (PERF.md §6).
// Bound: bytes, what the probe must read: 4 B a voxel count, 12 B a point
// below its count and the two outputs (at most ~7.8 MB at the headline
// map, 151,644 voxels and 600k points); ~8 operations a point.
#include "common.cuh"

using namespace elm;

namespace {

constexpr int kProbeThreads = 256;
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kGroundK = 8;          // the largest k
constexpr int kSlotStep = 4;         // slots loaded together
constexpr int kMaxProbeCtas = 2048;  // the workspace's CTA lists
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void insert(float* top, float v) {
#pragma unroll
  for (int j = 0; j < kGroundK; ++j) {
    if (v < top[j]) {
      const float t = top[j];
      top[j] = v;
      v = t;
    }
  }
}

__device__ __forceinline__ void exchange(float& a, float& b) {
  const float lo = b < a ? b : a, hi = b < a ? a : b;
  a = lo;
  b = hi;
}

// ``top`` := the 8 smallest of the ascending lists ``top`` and ``other``,
// ascending: c_j = min(top_j, other_{7-j}) is bitonic and holds them, and a
// bitonic merger of 12 compare-exchanges sorts it.
__device__ __forceinline__ void merge_sorted(float* top, const float* other) {
#pragma unroll
  for (int j = 0; j < kGroundK; ++j) {
    const float o = other[kGroundK - 1 - j];
    if (o < top[j]) top[j] = o;
  }
#pragma unroll
  for (int h = kGroundK / 2; h > 0; h >>= 1)
#pragma unroll
    for (int j = 0; j < kGroundK; ++j)
      if ((j & h) == 0) exchange(top[j], top[j + h]);
}

// Merges the warp's lists and counts; every lane ends with the warp's.
__device__ __forceinline__ void warp_merge(float* top, int& count) {
  if (!__any_sync(kFull, count > 0)) return;  // every list +inf, every count 0
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    float other[kGroundK];
#pragma unroll
    for (int j = 0; j < kGroundK; ++j) other[j] = __shfl_xor_sync(kFull, top[j], s);
    merge_sorted(top, other);
    count += __shfl_xor_sync(kFull, count, s);
  }
}

// Merges the CTA's lists and counts into thread 0's ``top`` / ``count``.
// Every thread must call it.
__device__ __forceinline__ void cta_merge(float* top, int& count, float (*s_top)[kGroundK],
                                         int* s_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_merge(top, count);
  if (lane == 0) {
    for (int j = 0; j < kGroundK; ++j) s_top[warp][j] = top[j];
    s_count[warp] = count;
  }
  __syncthreads();
  if (warp == 0) {
    for (int j = 0; j < kGroundK; ++j) top[j] = lane < kProbeWarps ? s_top[lane][j] : inf();
    count = lane < kProbeWarps ? s_count[lane] : 0;
    warp_merge(top, count);
  }
}

// ``work``: [0] the done counter (0 between calls), [1, 1 + kMaxProbeCtas)
// the CTAs' counts, then the CTAs' lists (kMaxProbeCtas x 8 floats).
__global__ void __launch_bounds__(kProbeThreads) ground_probe_kernel(
    const float* __restrict__ points, const int* __restrict__ counts, int v, int m, float x,
    float y, float r2, int k, int* __restrict__ work, bool* __restrict__ found,
    float* __restrict__ ground_z) {
  __shared__ float s_top[kProbeWarps][kGroundK];
  __shared__ int s_count[kProbeWarps];
  __shared__ bool s_last;
  int* cta_count = work + 1;
  float* cta_top = reinterpret_cast<float*>(work + 1 + kMaxProbeCtas);
  float top[kGroundK];
  for (int j = 0; j < kGroundK; ++j) top[j] = inf();
  int count = 0;
  for (int w = blockIdx.x * kProbeThreads + threadIdx.x; w < v;
       w += gridDim.x * kProbeThreads) {
    const int cnt = min(max(counts[w], 0), m);
    const float* p = points + (size_t)w * m * 3;
    for (int k0 = 0; k0 < cnt; k0 += kSlotStep) {
      float px[kSlotStep], py[kSlotStep], pz[kSlotStep];
#pragma unroll
      for (int u = 0; u < kSlotStep; ++u) {
        const bool in = k0 + u < cnt;
        px[u] = in ? p[3 * (k0 + u)] : inf();
        py[u] = in ? p[3 * (k0 + u) + 1] : 0.0f;
        pz[u] = in ? p[3 * (k0 + u) + 2] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kSlotStep; ++u) {
        if (isfinite(px[u])) {
          const float dx = sub(px[u], x), dy = sub(py[u], y);
          if (add(mul(dx, dx), mul(dy, dy)) <= r2) {
            ++count;
            insert(top, pz[u]);
          }
        }
      }
    }
  }
  cta_merge(top, count, s_top, s_count);
  if (threadIdx.x == 0) {
    for (int j = 0; j < kGroundK; ++j) cta_top[blockIdx.x * kGroundK + j] = top[j];
    cta_count[blockIdx.x] = count;
    __threadfence();
    s_last = atomicAdd(work, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last CTA: every CTA's list is in
  __threadfence();
  for (int j = 0; j < kGroundK; ++j) top[j] = inf();
  count = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kProbeThreads) {
    const int c = __ldcg(&cta_count[b]);
    if (c > 0) {  // a CTA that kept nothing left a +inf list
      float other[kGroundK];
      for (int j = 0; j < kGroundK; ++j) other[j] = __ldcg(&cta_top[b * kGroundK + j]);
      merge_sorted(top, other);
      count += c;
    }
  }
  cta_merge(top, count, s_top, s_count);
  if (threadIdx.x == 0) {
    work[0] = 0;
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s = add(s, top[j]);
    *found = count > 3;
    *ground_z = s / (float)k;
  }
}

}  // namespace

// ``points`` [v + 1, m, 3] and ``counts`` [v + 1] (the grid's, the sentinel
// row last and not read), the XY position, r^2 and k (1..8); ``work`` the
// stream's workspace (1 + 9 x 2048 words, the first 0); ``found`` /
// ``ground_z`` device scalars.
extern "C" int elm_ground_probe(const float* points, const int* counts, int v, int m, float x,
                                float y, float r2, int k, int* work, bool* found,
                                float* ground_z, cudaStream_t stream) {
  if (k < 1 || k > kGroundK || v < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int ctas = max(1, min((v + kProbeThreads - 1) / kProbeThreads, kMaxProbeCtas));
  ground_probe_kernel<<<ctas, kProbeThreads, 0, stream>>>(points, counts, v, m, x, y, r2, k,
                                                          work, found, ground_z);
  return (int)cudaGetLastError();
}
