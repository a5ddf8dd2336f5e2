// The per-point LiDAR deskew (K6), shared by kernel D (deskew.cu: the
// points' times relative to the scan start read from device memory) and
// kernel T's second launch (scan_front.cu: those times formed in
// registers from the raw times).
//
// Replaces elimaloc_tpu/deskew.py:_find_rotation_batch (:196) +
// deskew_points (:229). The TPU form builds a dense [N, W] clipped-weight
// plane and one [N,W]x[W,3] matmul because per-point gathers are
// scalar-core-bound there. On Hopper the op is a pure elementwise stream:
// per point 16 bytes in (xyz + time) and 12 out, plus a W-entry table that
// every thread reads. The block stages the interval table (t_{k-1}, dt_k,
// d_rot_k) once in shared memory (5 w floats); each thread accumulates
// rot(t) = sum_k d_rot_k * clip((t - t_{k-1}) / dt_k, 0, 1) in k order with
// no [N, W] tensor. Both kernels run these bodies in blocks of
// kDeskewThreads, one thread a point, so they contract and round alike.
#pragma once

#include "common.cuh"

namespace elm {
namespace desk {

constexpr int kDeskewThreads = 256;

// The whole CTA: the interval table of the W-wide IMU window into
// ``table`` ([w] t_prev, [w] dt, [3w] d_rot). Ends without a barrier.
__device__ __forceinline__ void stage_table(float* table, const float* __restrict__ imu_time,
                                            const float* __restrict__ imu_rot,
                                            const bool* __restrict__ imu_inc, int w) {
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
}

// Point i, whose time from the scan start is ``rel``, to the scan-end
// frame; an invalid point, or any point when the deskew info is
// unavailable, passes through.
__device__ __forceinline__ void deskew_point(
    int i, const float* __restrict__ points, float rel, bool valid, const float* table, int w,
    const float* __restrict__ imu_rot, const long long* __restrict__ last_idx,
    const float* __restrict__ incre, const float* __restrict__ scan_cur,
    const float* __restrict__ scan_end, const bool* __restrict__ imu_ok,
    const bool* __restrict__ odom_ok, int bug_compat_z, float* __restrict__ out) {
  const float* t_prev = table;
  const float* dt = table + w;
  const float* d_rot = table + 2 * w;
  const float px = points[3 * i], py = points[3 * i + 1], pz = points[3 * i + 2];
  if (!(valid && imu_ok[0] && odom_ok[0])) {
    out[3 * i] = px;
    out[3 * i + 1] = py;
    out[3 * i + 2] = pz;
    return;
  }
  const float cur = scan_cur[0];
  const float t = cur + rel;
  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  for (int k = 0; k < w; ++k) {
    const float wk = fminf(fmaxf((t - t_prev[k]) / dt[k], 0.0f), 1.0f);
    r0 += wk * d_rot[3 * k];
    r1 += wk * d_rot[3 * k + 1];
    r2 += wk * d_rot[3 * k + 2];
  }
  const long long last = last_idx[0];
  const float span = scan_end[0] - cur;
  const float ratio = rel / (span == 0.0f ? 1.0f : span);
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

}  // namespace desk
}  // namespace elm
