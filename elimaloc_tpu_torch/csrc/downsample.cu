// Kernel C: first-point-per-voxel downsample with a static output budget.
//
// Replaces elimaloc_tpu/map/grid.py:voxel_downsample (:271) and _mix (:127).
// The TPU form sorts a tuple of eight lanes through XLA's sort because
// payload gathers are scalar-core-bound there. On Hopper: (1) a per-point
// kernel writes the mixed 32-bit voxel key (0xFFFFFFFF for invalid rows,
// valid keys clamped to 0xFFFFFFFE) widened to int64, plus the int32 voxel
// coords; (2) torch.sort(stable=True) orders the keys — stability is part of
// the semantics, "first" means first in input order; (3) one CTA walks the
// sorted order in 1024-element chunks, keeps an element when its voxel
// coords differ from its sorted neighbour's (coords, not keys: a rare hash
// collision must not swallow a voxel) and it is valid, and compacts the kept
// points with a block prefix scan that carries its offset across chunks.
// Bound: launch latency and the serial chunk walk (26k points = 26 chunks);
// the bytes are ~1 MB.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t mix(int x, int y, int z) {
  const uint32_t cx = (uint32_t)x, cy = (uint32_t)y, cz = (uint32_t)z;
  uint32_t h = 0x9E3779B1u ^ (cx * 0x85EBCA6Bu);
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  h = h ^ (cy * 0x27D4EB2Fu);
  h = (h ^ (h >> 13)) * 0x165667B1u;
  h = h ^ (cz * 0x9E3779B1u);
  h = h ^ (h >> 16);
  h = h * 0x7FEB352Du;
  h = h ^ (h >> 15);
  h = h * 0x846CA68Bu;
  h = h ^ (h >> 16);
  return h;
}

__global__ void voxel_keys_kernel(const float* __restrict__ points,
                                  const bool* __restrict__ valid, int n,
                                  const float* __restrict__ voxel,
                                  long long* __restrict__ key,
                                  int* __restrict__ coords) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = voxel[0];
  const int cx = (int)floorf(points[3 * i] / v);
  const int cy = (int)floorf(points[3 * i + 1] / v);
  const int cz = (int)floorf(points[3 * i + 2] / v);
  coords[3 * i] = cx;
  coords[3 * i + 1] = cy;
  coords[3 * i + 2] = cz;
  uint32_t h = mix(cx, cy, cz);
  if (h > 0xFFFFFFFEu) h = 0xFFFFFFFEu;
  key[i] = valid[i] ? (long long)h : (long long)0xFFFFFFFFu;
}

__global__ void voxel_compact_kernel(const float* __restrict__ points,
                                     const bool* __restrict__ valid,
                                     const int* __restrict__ coords,
                                     const long long* __restrict__ perm, int n,
                                     int out_size, float* __restrict__ out,
                                     bool* __restrict__ out_valid,
                                     long long* __restrict__ kept_out) {
  __shared__ int sh[32];
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int keep = 0;
    long long p = 0;
    if (i < n) {
      p = perm[i];
      bool first = true;
      if (i > 0) {
        const long long q = perm[i - 1];
        first = coords[3 * p] != coords[3 * q] ||
                coords[3 * p + 1] != coords[3 * q + 1] ||
                coords[3 * p + 2] != coords[3 * q + 2];
      }
      keep = (first && valid[p]) ? 1 : 0;
    }
    int total;
    const int incl = elm::block_scan(keep, elm::AddOp(), sh, &total);
    const int rank = carry + incl - 1;
    if (keep && rank < out_size) {
      out[3 * rank] = points[3 * p];
      out[3 * rank + 1] = points[3 * p + 1];
      out[3 * rank + 2] = points[3 * p + 2];
    }
    carry += total;
  }
  for (int j = threadIdx.x; j < out_size; j += blockDim.x) out_valid[j] = j < carry;
  if (threadIdx.x == 0) kept_out[0] = carry < out_size ? carry : out_size;
}

}  // namespace

extern "C" int elm_voxel_keys(const float* points, const bool* valid, int n,
                              const float* voxel, long long* key, int* coords,
                              cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    voxel_keys_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        points, valid, n, voxel, key, coords);
  }
  return (int)cudaGetLastError();
}

extern "C" int elm_voxel_compact(const float* points, const bool* valid,
                                 const int* coords, const long long* perm, int n,
                                 int out_size, float* out, bool* out_valid,
                                 long long* kept, cudaStream_t stream) {
  voxel_compact_kernel<<<1, 1024, 0, stream>>>(points, valid, coords, perm, n,
                                               out_size, out, out_valid, kept);
  return (int)cudaGetLastError();
}
