// Kernel D: per-point LiDAR deskew, the points' times relative to the scan
// start read from device memory.
//
// Replaces elimaloc_tpu/deskew.py:_find_rotation_batch (:196) +
// deskew_points (:229); see deskew.cuh, which holds its body. Bound: HBM
// bytes (~0.75 MB at 26k points, far below launch latency). Design: one
// thread per point, the block's interval table in shared memory; scalars
// (scan times, flags, last index) are read from device memory, so the
// launch needs no host sync. The pipeline runs the same body as kernel T's
// second launch (scan_front.cu); this entry is the reference T is held to.
#include "deskew.cuh"

using namespace elm::desk;

namespace {

__global__ void __launch_bounds__(kDeskewThreads) deskew_kernel(
    const float* __restrict__ points, const float* __restrict__ rel,
    const bool* __restrict__ valid, int n,
    const float* __restrict__ imu_time, const float* __restrict__ imu_rot,
    const bool* __restrict__ imu_inc, int w,
    const long long* __restrict__ last_idx, const float* __restrict__ incre,
    const float* __restrict__ scan_cur, const float* __restrict__ scan_end,
    const bool* __restrict__ imu_ok, const bool* __restrict__ odom_ok,
    int bug_compat_z, float* __restrict__ out) {
  extern __shared__ float table[];  // [w] t_prev, [w] dt, [3w] d_rot
  stage_table(table, imu_time, imu_rot, imu_inc, w);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  deskew_point(i, points, rel[i], valid[i], table, w, imu_rot, last_idx, incre, scan_cur,
               scan_end, imu_ok, odom_ok, bug_compat_z, out);
}

}  // namespace

extern "C" int elm_deskew(const float* points, const float* rel, const bool* valid,
                          int n, const float* imu_time, const float* imu_rot,
                          const bool* imu_inc, int w, const long long* last_idx,
                          const float* incre, const float* scan_cur,
                          const float* scan_end, const bool* imu_ok,
                          const bool* odom_ok, int bug_compat_z, float* out,
                          cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kDeskewThreads - 1) / kDeskewThreads;
    const size_t smem = sizeof(float) * 5 * (size_t)w;
    deskew_kernel<<<blocks, kDeskewThreads, smem, stream>>>(
        points, rel, valid, n, imu_time, imu_rot, imu_inc, w, last_idx, incre,
        scan_cur, scan_end, imu_ok, odom_ok, bug_compat_z, out);
  }
  return (int)cudaGetLastError();
}
