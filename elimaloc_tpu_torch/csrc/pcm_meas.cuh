// The PCM measurement of a registered scan (K8, the scan-tail half), shared
// by kernel L (pcm_meas.cu: the measurement alone, written out for kernel
// I) and kernel S (pcm_stage.cu: the measurement, the PCM update and the
// frame's outputs in one launch).
//
// Replaces elimaloc_tpu/pipeline/runtime.py:shape_icp_covariance (:275),
// elimaloc_tpu/pipeline/rings.py:gnss_time_compensation (:251) and the
// glue of scan_step around them (runtime.py:341-358): the ICP pose into the
// ego frame (lie.compose with tf_lidar_to_ego), its quaternion
// (lie.rot_to_quat), the covariance shaping (rotate, normalise by the
// smallest diagonal with the 1e-9 rescale, clamp at 5, scale by the
// fitness), the latency compensation against the ego ring (the entry after
// the measurement, linear-ratio extrapolation of position and wrapped Euler
// angles to the ring's newest time), and ``apply``.
//
// The search for the first ring entry newer than the measurement runs
// across the block (a shared atomicMin); thread 0 does the rest with
// ekf.cuh's helpers, in the plain version's order and rounding.
#pragma once

#include <limits.h>

#include "ekf.cuh"

namespace elm {
namespace ekf {

// The measurement in kernel L's output layout (42 floats: icp_pose [4, 4],
// t, pos [3], quat [4], pos_cov [3, 3], rot_cov [3, 3], row-major), then
// ``apply``.
struct PcmMeas {
  float pose[16], t, pos[3], quat[4], pos_cov[9], rot_cov[9];
  bool apply;
};
constexpr int kPcmMeasWords = 42;
static_assert(offsetof(PcmMeas, apply) == kPcmMeasWords * 4, "PcmMeas is L's layout");

// torch.clamp(x, max=m): NaN stays NaN.
__device__ __forceinline__ float clamp_max(float x, float m) { return x > m ? m : x; }
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }

// runtime.shape_icp_covariance's normalize: by the smallest diagonal entry,
// with the 1e-9 rescale, clamped at 5, then scaled by s twice.
__device__ __forceinline__ void normalize_cov(const float* cov, float s, float* o) {
  const float min_diag = fminf(fminf(cov[0], cov[4]), cov[8]);
  const bool up = min_diag <= 1e-9f;
  float c2[9];
  for (int e = 0; e < 9; ++e) c2[e] = up ? mul(cov[e], 1e9f) : cov[e];
  const float min2 = clamp_min(fminf(fminf(c2[0], c2[4]), c2[8]), 1e-9f);
  for (int e = 0; e < 9; ++e) o[e] = mul(mul(clamp_max(dv(c2[e], min2), 5.0f), s), s);
}

// The measurement into ``m`` (shared memory). Every thread of the block
// calls it (its barriers are block-uniform); thread 0 writes ``m``, which
// the caller's next barrier publishes. ``s_closest`` is a shared int.
__device__ __forceinline__ void pcm_measure(
    const float* __restrict__ icp_pose, const float* __restrict__ tf_lidar_to_ego,
    const float* __restrict__ local_cov, const float* __restrict__ fitness,
    const bool* __restrict__ success, const bool* __restrict__ usable,
    const float* __restrict__ ring_t, const float* __restrict__ ring_pos,
    const float* __restrict__ ring_rpy, const int* __restrict__ ring_count, int cap,
    const float* __restrict__ scan_end, int use_pcm, int& s_closest, PcmMeas& m) {
  const float meas_t = *scan_end;
  const int count = *ring_count;
  if (threadIdx.x == 0) s_closest = INT_MAX;
  __syncthreads();
  int first = INT_MAX;
  for (int i = threadIdx.x; i < cap; i += blockDim.x)
    if (i < count && ring_t[i] > meas_t) first = min(first, i);
  atomicMin(&s_closest, first);
  __syncthreads();
  if (threadIdx.x != 0) return;

  // the ICP pose in the ego frame, its quaternion
  compose(icp_pose, tf_lidar_to_ego, m.pose);
  float rot[9], quat[4];
  rot_of(m.pose, rot);
  rot_to_quat(rot, quat);

  // covariance shaping (runtime.py:275-296): R C R^T on the translation
  // block, the rotation block as it is
  const float std = clamp_min(*fitness, 0.25f);
  const float angle_std = divs(mul(std, (float)kPi), 180.0f);
  float c3[9], tmp[9], t_cov[9], r_cov[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      c3[3 * i + j] = local_cov[6 * i + j];
      r_cov[3 * i + j] = local_cov[6 * (i + 3) + j + 3];
    }
  matmul3(rot, c3, tmp, false);
  matmul3(tmp, rot, t_cov, true);
  normalize_cov(t_cov, std, m.pos_cov);
  normalize_cov(r_cov, angle_std, m.rot_cov);

  // latency compensation (rings.py:251-288)
  const int last = count > 0 ? count - 1 : 0;
  const bool ok = count > 0 && ring_t[0] <= meas_t;
  const int closest = s_closest != INT_MAX ? s_closest : last;
  const float cur_t = ring_t[last];
  const float dt = sub(cur_t, meas_t);
  const bool need = dt > 0.0f;
  const float span = sub(cur_t, ring_t[closest]);
  const bool run = need && fabsf(span) > 1e-5f;
  const float ratio = run ? dv(dt, span == 0.0f ? 1.0f : span) : 0.0f;
  float drpy[3], dq_rot[9], dq[4], q[4];
  m.t = need ? cur_t : meas_t;
  for (int c = 0; c < 3; ++c) {
    const float dpos = mul(sub(ring_pos[3 * last + c], ring_pos[3 * closest + c]), ratio);
    m.pos[c] = add(m.pose[4 * c + 3], need ? dpos : 0.0f);
    const float d = mul(norm_angle_rad(sub(ring_rpy[3 * last + c], ring_rpy[3 * closest + c])),
                        ratio);
    drpy[c] = need ? d : 0.0f;
  }
  euler_to_rot(drpy, dq_rot);
  rot_to_quat(dq_rot, dq);
  quat_mul(quat, dq, q);
  quat_normalize(q, m.quat);
  m.apply = use_pcm && *usable && *success && ok;
}

}  // namespace ekf
}  // namespace elm
