// Kernel R: the relocalization's ground probe over the hash grid's points
// (K13, FindGroundHeight).
//
// Replaces elimaloc_tpu/map/grid.py:find_ground_height (:320): over the
// V x M map points (the sentinel row excluded), keep those with a finite x
// and dx dx + dy dy <= r^2 in XY; found = more than 3 kept; ground z = the
// mean of the k lowest z (sum / k). With fewer than k kept, top_k fills in
// -inf and the mean is +inf; so does this kernel (+inf entries). On the TPU
// it is a masked [V*M] plane and one top_k. On Hopper:
//   1. each thread walks the points with a grid stride, keeping a count and
//      its kGroundK (8 >= k) smallest kept z in a register list sorted
//      ascending (a compare-exchange pass per point);
//   2. each CTA merges its threads' lists in a fixed shared-memory tree and
//      writes its count and list; a single CTA merges the CTAs' lists the
//      same way. The k smallest values of a set do not depend on the merge
//      order, and the counts are integers, so the result is exact and the
//      same on every run; thread 0 sums the k lowest in ascending order.
// Bound: bytes, the 12 B of each map point read once (55 MB at the headline
// map, 151,644 voxels x 30); ~6 operations a point.
#include "common.cuh"

using namespace elm;

namespace {

constexpr int kGroundThreads = 256;
constexpr int kGroundK = 8;  // the largest k

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

// Merges the threads' lists in ``lists`` [kGroundThreads, kGroundK] and sums
// ``counts`` [kGroundThreads]; thread 0 holds the result in ``top`` / the
// return value. Every thread must call it.
__device__ __forceinline__ int merge_block(float* top, int count, float* lists, int* counts) {
  const int t = threadIdx.x;
  for (int j = 0; j < kGroundK; ++j) lists[t * kGroundK + j] = top[j];
  counts[t] = count;
  __syncthreads();
  for (int h = kGroundThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      for (int j = 0; j < kGroundK; ++j) insert(top, lists[(t + h) * kGroundK + j]);
      counts[t] += counts[t + h];
    }
    __syncthreads();
    if (t < h)
      for (int j = 0; j < kGroundK; ++j) lists[t * kGroundK + j] = top[j];
    __syncthreads();
  }
  return counts[0];
}

__global__ void __launch_bounds__(kGroundThreads) ground_partial_kernel(
    const float* __restrict__ points, long long n, float x, float y, float r2,
    float* __restrict__ block_top, int* __restrict__ block_count) {
  __shared__ float lists[kGroundThreads * kGroundK];
  __shared__ int counts[kGroundThreads];
  float top[kGroundK];
  for (int j = 0; j < kGroundK; ++j) top[j] = __int_as_float(0x7f800000);
  int count = 0;
  const long long stride = (long long)gridDim.x * kGroundThreads;
  for (long long i = (long long)blockIdx.x * kGroundThreads + threadIdx.x; i < n; i += stride) {
    const float* p = points + 3 * i;
    if (!isfinite(p[0])) continue;
    const float dx = sub(p[0], x), dy = sub(p[1], y);
    if (!(add(mul(dx, dx), mul(dy, dy)) <= r2)) continue;
    ++count;
    insert(top, p[2]);
  }
  const int total = merge_block(top, count, lists, counts);
  if (threadIdx.x == 0) {
    for (int j = 0; j < kGroundK; ++j) block_top[blockIdx.x * kGroundK + j] = top[j];
    block_count[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kGroundThreads) ground_merge_kernel(
    const float* __restrict__ block_top, const int* __restrict__ block_count, int blocks,
    int k, bool* __restrict__ found, float* __restrict__ ground_z) {
  __shared__ float lists[kGroundThreads * kGroundK];
  __shared__ int counts[kGroundThreads];
  float top[kGroundK];
  for (int j = 0; j < kGroundK; ++j) top[j] = __int_as_float(0x7f800000);
  int count = 0;
  for (int b = threadIdx.x; b < blocks; b += kGroundThreads) {
    for (int j = 0; j < kGroundK; ++j) insert(top, block_top[b * kGroundK + j]);
    count += block_count[b];
  }
  const int total = merge_block(top, count, lists, counts);
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s = add(s, top[j]);
    *found = total > 3;
    *ground_z = s / (float)k;
  }
}

}  // namespace

// ``points`` [n, 3] (the grid's points without the sentinel row), the XY
// position, r^2 and k (1..8); ``block_top`` [blocks, 8] and
// ``block_count`` [blocks] scratch; ``found`` / ``ground_z`` device scalars.
extern "C" int elm_ground_height(const float* points, long long n, float x, float y, float r2,
                                 int k, int blocks, float* block_top, int* block_count,
                                 bool* found, float* ground_z, cudaStream_t stream) {
  if (k < 1 || k > kGroundK || blocks < 1) return (int)cudaErrorInvalidValue;
  ground_partial_kernel<<<blocks, kGroundThreads, 0, stream>>>(points, n, x, y, r2, block_top,
                                                               block_count);
  ground_merge_kernel<<<1, kGroundThreads, 0, stream>>>(block_top, block_count, blocks, k,
                                                        found, ground_z);
  return (int)cudaGetLastError();
}
