// Shared helpers for the elimaloc_tpu_torch CUDA kernels (sm_90a).
//
// Every kernel file exposes plain C entry points: device pointers, sizes and
// the CUDA stream come in from the Python wrapper (ctypes), each entry
// returns cudaGetLastError() right after its launches.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace elm {

// Exact-rounding float helpers: the intrinsics are never contracted into
// FMAs, so a kernel and its plain PyTorch version (separate mul and add
// kernels) round the same way where the tests demand bit equality.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct AddOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};
struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide inclusive scan of one int per thread, for ops whose identity is
// 0 on the non-negative values the kernels scan (sum, max). blockDim.x must
// be a multiple of 32 and at most 1024; ``sh`` holds 32 ints of shared
// memory. Returns the thread's inclusive prefix and writes the block total.
template <class Op>
__device__ int block_scan(int v, Op op, int* sh, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op(v, u);
  }
  if (lane == 31) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int x = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = op(x, u);
    }
    sh[lane] = x;
  }
  __syncthreads();
  if (wid > 0) v = op(v, sh[wid - 1]);
  *total = sh[nw - 1];
  __syncthreads();  // ``sh`` is reused by the next call
  return v;
}

}  // namespace elm
