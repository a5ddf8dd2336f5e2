// Kernel D: per-point LiDAR deskew.
//
// Replaces elimaloc_tpu/deskew.py:_find_rotation_batch (:196) +
// deskew_points (:229). The TPU form builds a dense [N, W] clipped-weight
// plane and one [N,W]x[W,3] matmul because per-point gathers are
// scalar-core-bound there. On Hopper the op is a pure elementwise stream:
// per point 16 bytes in (xyz + time) and 12 out, plus a W-entry table that
// every thread reads. Bound: HBM bytes (~0.75 MB at 26k points, far below
// launch latency). Design: one thread per point; the block stages the
// interval table (t_{k-1}, dt_k, d_rot_k) once in shared memory, each thread
// accumulates rot(t) = sum_k d_rot_k * clip((t - t_{k-1}) / dt_k, 0, 1) in k
// order with no [N, W] tensor; scalars (scan times, flags, last index) are
// read from device memory, so the launch needs no host sync.
#include "common.cuh"

namespace {

__global__ void deskew_kernel(
    const float* __restrict__ points, const float* __restrict__ rel,
    const bool* __restrict__ valid, int n,
    const float* __restrict__ imu_time, const float* __restrict__ imu_rot,
    const bool* __restrict__ imu_inc, int w,
    const long long* __restrict__ last_idx, const float* __restrict__ incre,
    const float* __restrict__ scan_cur, const float* __restrict__ scan_end,
    const bool* __restrict__ imu_ok, const bool* __restrict__ odom_ok,
    int bug_compat_z, float* __restrict__ out) {
  extern __shared__ float table[];  // [w] t_prev, [w] dt, [3w] d_rot
  float* t_prev = table;
  float* dt = table + w;
  float* d_rot = table + 2 * w;
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    const float tp = imu_time[k > 0 ? k - 1 : 0];
    const bool pair = imu_inc[k] && k > 0 && imu_inc[k - 1];
    float d = pair ? imu_time[k] - tp : 1.0f;
    if (d == 0.0f) d = 1.0f;
    t_prev[k] = tp;
    dt[k] = d;
    for (int c = 0; c < 3; ++c) {
      const float prev = k > 0 ? imu_rot[3 * (k - 1) + c] : 0.0f;
      d_rot[3 * k + c] = pair ? imu_rot[3 * k + c] - prev : 0.0f;
    }
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float px = points[3 * i], py = points[3 * i + 1], pz = points[3 * i + 2];
  if (!(valid[i] && imu_ok[0] && odom_ok[0])) {
    out[3 * i] = px;
    out[3 * i + 1] = py;
    out[3 * i + 2] = pz;
    return;
  }
  const float cur = scan_cur[0];
  const float t = cur + rel[i];
  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  for (int k = 0; k < w; ++k) {
    const float wk = fminf(fmaxf((t - t_prev[k]) / dt[k], 0.0f), 1.0f);
    r0 += wk * d_rot[3 * k];
    r1 += wk * d_rot[3 * k + 1];
    r2 += wk * d_rot[3 * k + 2];
  }
  const long long last = last_idx[0];
  const float span = scan_end[0] - cur;
  const float ratio = rel[i] / (span == 0.0f ? 1.0f : span);
  const float ix = incre[0], iy = incre[1], iz = incre[2];
  const float roll = r0 - imu_rot[3 * last];
  const float pitch = r1 - imu_rot[3 * last + 1];
  const float yaw = r2 - imu_rot[3 * last + 2];
  const float tx = ratio * ix - ix;
  const float ty = ratio * iy - iy;
  const float tz = bug_compat_z ? r2 - iz : ratio * iz - iz;

  // euler_to_rot (elimaloc_tpu/ops/lie.py:174): Rz(yaw) Ry(pitch) Rx(roll)
  const float cr = cosf(roll), sr = sinf(roll);
  const float cp = cosf(pitch), sp = sinf(pitch);
  const float cy = cosf(yaw), sy = sinf(yaw);
  const float m00 = cy * cp, m01 = cy * sp * sr - sy * cr, m02 = cy * sp * cr + sy * sr;
  const float m10 = sy * cp, m11 = sy * sp * sr + cy * cr, m12 = sy * sp * cr - cy * sr;
  const float m20 = -sp, m21 = cp * sr, m22 = cp * cr;
  out[3 * i] = m00 * px + m01 * py + m02 * pz + tx;
  out[3 * i + 1] = m10 * px + m11 * py + m12 * pz + ty;
  out[3 * i + 2] = m20 * px + m21 * py + m22 * pz + tz;
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
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    const size_t smem = sizeof(float) * 5 * (size_t)w;
    deskew_kernel<<<blocks, threads, smem, stream>>>(
        points, rel, valid, n, imu_time, imu_rot, imu_inc, w, last_idx, incre,
        scan_cur, scan_end, imu_ok, odom_ok, bug_compat_z, out);
  }
  return (int)cudaGetLastError();
}
