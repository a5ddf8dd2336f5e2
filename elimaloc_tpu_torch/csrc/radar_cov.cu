// Kernel P: the slot-packed radar covariances of one registration (K12).
//
// Replaces elimaloc_tpu/register/icp.py:radar_point_cov (:251; CalPointCov,
// registration.hpp:186-208) on the initially transformed cloud (:619-623)
// and the slot packing of run_register's _assign (:652-655): per point,
// with d its horizontal range in the WORLD frame (before any window-origin
// shift), S = diag(range var, max(0.1, d sin(azimuth var)), max(0.1, d
// sin(elevation var))) and R = Rz(azi) Ry(ele), the product R S, with no
// R^T (a reference quirk kept: the result is not symmetric), written where
// the slot row is live and zero elsewhere. On the TPU these are [N] planes
// of transcendentals and a gather into [S, QB, 3, 3]; the plain PyTorch
// version is ~40 eager launches over all N points, then the gather.
//
// Bound: bytes. Per slot row it reads the row's index and mask (5 B) and
// its point (12 B) and writes 36 B, once per registration; ~40 FLOP and
// four transcendentals. Design: one thread per slot row, so only the rows
// the GN loop reads are computed and the gather is the point read. The
// arithmetic is the plain version's, one IEEE-rounded operation at a time
// in its order, with the CUDA math library's sinf / cosf / atan2f / sqrtf
// (the package builds without fast math).
#include <math.h>

#include "common.cuh"

using namespace elm;

namespace {

constexpr int kRadarThreads = 256;
constexpr double kD2R = 3.14159265358979323846 / 180.0;  // math.pi / 180.0

__global__ void __launch_bounds__(kRadarThreads) radar_cov_kernel(
    const float* __restrict__ src, int n, const int* __restrict__ qidx,
    const bool* __restrict__ qmask, int rows, const float* __restrict__ pose,
    const float* __restrict__ range_var, const float* __restrict__ azi_var_deg,
    const float* __restrict__ ele_var_deg, float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float* o = out + (size_t)row * 9;
  if (!qmask[row]) {
    for (int k = 0; k < 9; ++k) o[k] = 0.0f;
    return;
  }
  const int i = min(qidx[row], n - 1);
  const float p[3] = {src[3 * i], src[3 * i + 1], src[3 * i + 2]};
  float q[3];
  for (int r = 0; r < 3; ++r)
    q[r] = add(add(add(mul(p[0], pose[4 * r]), mul(p[1], pose[4 * r + 1])),
                   mul(p[2], pose[4 * r + 2])), pose[4 * r + 3]);
  const float dist = sqrtf(add(mul(q[0], q[0]), mul(q[1], q[1])));
  const float d2r = (float)kD2R;
  const float s[3] = {*range_var, fmaxf(mul(dist, sinf(mul(*azi_var_deg, d2r))), 0.1f),
                      fmaxf(mul(dist, sinf(mul(*ele_var_deg, d2r))), 0.1f)};
  const float ele = atan2f(q[2], dist), azi = atan2f(q[1], q[0]);
  const float cy = cosf(azi), sy = sinf(azi), cp = cosf(ele), sp = sinf(ele);
  const float R[9] = {mul(cy, cp), -sy, mul(cy, sp), mul(sy, cp), cy, mul(sy, sp),
                      -sp, 0.0f, cp};
  for (int k = 0; k < 9; ++k) o[k] = mul(R[k], s[k % 3]);
}

}  // namespace

extern "C" int elm_radar_cov(const float* src, int n, const int* qidx, const bool* qmask,
                             int rows, const float* pose, const float* range_var,
                             const float* azi_var_deg, const float* ele_var_deg, float* out,
                             cudaStream_t stream) {
  if (rows > 0)
    radar_cov_kernel<<<(rows + kRadarThreads - 1) / kRadarThreads, kRadarThreads, 0, stream>>>(
        src, n, qidx, qmask, rows, pose, range_var, azi_var_deg, ele_var_deg, out);
  return (int)cudaGetLastError();
}
