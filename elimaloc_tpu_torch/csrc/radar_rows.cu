// Kernel X: the radar covariances of one registration, kernel P redesigned
// for Hopper.
//
// Replaces elimaloc_tpu/register/icp.py:radar_point_cov (:251; CalPointCov,
// registration.hpp:186-208) on the initially transformed cloud (:619-623),
// with the slot packing of run_register's _assign (:652-655) on the tile
// backend and the rows in query order on the hash backend. Per point, with
// d its horizontal range in the WORLD frame, S = diag(range var, max(0.1, d
// sin(azimuth var)), max(0.1, d sin(elevation var))) and R = Rz(azi)
// Ry(ele), the product R S (no R^T: a reference quirk kept), written where
// the row is live and zero elsewhere. Kernel P (radar_cov.cu) computes the
// same rows and stays as X's bit-for-bit reference; it launches on no path.
//
// Bound: bytes (per row its index and mask, its point, 36 B out), a few
// microseconds at the shapes of a registration; kernel P took ten times its
// device time on the host. Design, against P:
// - a null qidx / qmask means the rows 0..N-1, all live (the hash
//   backend's query order): no index or mask tensor is made on the card;
// - the three variances come as one record of pointers, which the wrapper
//   checks once per IcpParams object;
// - the two variance-angle sines once per CTA, into shared memory, by the
//   same sinf(mul(...)) expression every thread of P evaluated;
// - each CTA stages its rows in shared memory and writes them as
//   contiguous 16-byte stores (P: nine 4-byte stores a thread, 36 bytes
//   apart).
// The arithmetic of a row is P's (radar_cov.cu:53-64), one IEEE-rounded
// operation at a time with the CUDA math library's sinf / cosf / atan2f /
// sqrtf, so X's rows equal P's bit for bit.
//
// Lanes: one launch serves a fleet frame's B registrations (replay_fused_
// fleet's vmap of run_register, elimaloc_tpu/parallel/sharding.py:256-281),
// the lane as blockIdx.y: src [B, n, 3], qidx / qmask [B, rows] (null on
// the hash backend: each lane's rows 0..n-1), pose [B, 4, 4], out [B, rows,
// 9], each at its lane stride. A lane's rows are those of its single
// launch, bit for bit (the same code on offset pointers); a lane's first
// row is 16-byte aligned only when rows * 9 is a multiple of 4, so the
// staged rows go out as float4 stores where the lane's output is aligned
// and as floats where not.
#include <math.h>

#include "common.cuh"

using namespace elm;

namespace {

constexpr int kRowThreads = 256;
constexpr double kDegToRad = 3.14159265358979323846 / 180.0;  // math.pi / 180.0

__global__ void __launch_bounds__(kRowThreads) radar_rows_kernel(
    const float* __restrict__ src, int n, const int* __restrict__ qidx,
    const bool* __restrict__ qmask, int rows, const float* __restrict__ pose,
    const float* __restrict__ range_var, const float* __restrict__ azi_var_deg,
    const float* __restrict__ ele_var_deg, float* __restrict__ out) {
  __shared__ float sines[3];
  __shared__ __align__(16) float tile[kRowThreads * 9];
  const size_t lane = blockIdx.y;  // the lane's inputs and rows
  src += 3 * n * lane;
  if (qidx != nullptr) qidx += rows * lane;
  if (qmask != nullptr) qmask += rows * lane;
  pose += 16 * lane;
  out += 9 * rows * lane;
  const float d2r = (float)kDegToRad;
  if (threadIdx.x == 0) {
    sines[0] = *range_var;
    sines[1] = sinf(mul(*azi_var_deg, d2r));
    sines[2] = sinf(mul(*ele_var_deg, d2r));
  }
  __syncthreads();
  const int first = blockIdx.x * kRowThreads;
  const int row = first + threadIdx.x;
  float* o = tile + threadIdx.x * 9;
  if (row < rows) {
    if (qmask != nullptr && !qmask[row]) {
      for (int k = 0; k < 9; ++k) o[k] = 0.0f;
    } else {
      const int i = qidx == nullptr ? row : min(qidx[row], n - 1);
      const float p[3] = {src[3 * i], src[3 * i + 1], src[3 * i + 2]};
      float q[3];
      for (int r = 0; r < 3; ++r)
        q[r] = add(add(add(mul(p[0], pose[4 * r]), mul(p[1], pose[4 * r + 1])),
                       mul(p[2], pose[4 * r + 2])), pose[4 * r + 3]);
      const float dist = sqrtf(add(mul(q[0], q[0]), mul(q[1], q[1])));
      const float s[3] = {sines[0], fmaxf(mul(dist, sines[1]), 0.1f),
                          fmaxf(mul(dist, sines[2]), 0.1f)};
      const float ele = atan2f(q[2], dist), azi = atan2f(q[1], q[0]);
      const float cy = cosf(azi), sy = sinf(azi), cp = cosf(ele), sp = sinf(ele);
      const float R[9] = {mul(cy, cp), -sy, mul(cy, sp), mul(sy, cp), cy, mul(sy, sp),
                          -sp, 0.0f, cp};
      for (int k = 0; k < 9; ++k) o[k] = mul(R[k], s[k % 3]);
    }
  }
  __syncthreads();
  // the CTA's rows are contiguous in ``out``: float4 stores where they are
  // aligned, then the tail
  const int nf = min(kRowThreads, rows - first) * 9;
  float* dst = out + (size_t)first * 9;
  const int n4 = ((uintptr_t)dst & 15) == 0 ? nf / 4 : 0;
  for (int k = threadIdx.x; k < n4; k += kRowThreads)
    reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(tile)[k];
  for (int k = 4 * n4 + threadIdx.x; k < nf; k += kRowThreads) dst[k] = tile[k];
}

}  // namespace

// ``lanes`` registrations' rows (1 <= lanes <= 65535), each lane's inputs
// and rows at its lane stride (see above); one lane is the single launch.
extern "C" int elm_radar_rows(const float* src, int n, const int* qidx, const bool* qmask,
                              int rows, const float* pose, const float* const* variances,
                              int lanes, float* out, cudaStream_t stream) {
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    radar_rows_kernel<<<dim3((rows + kRowThreads - 1) / kRowThreads, lanes), kRowThreads, 0,
                        stream>>>(src, n, qidx, qmask, rows, pose, variances[0], variances[1],
                                  variances[2], out);
  return (int)cudaGetLastError();
}
