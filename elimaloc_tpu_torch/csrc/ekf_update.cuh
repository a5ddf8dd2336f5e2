// The measurement set-ups of the EKF updates (K8, the update half), shared
// by kernel I (ekf_update.cu: the CAN samples, the GPS fixes and a PCM pose
// from global memory) and kernel S (pcm_stage.cu: the PCM pose kernel L's
// body has just computed in shared memory).
//
// Replaces the parts of elimaloc_tpu/ekf/filter.py:update_gnss (:616, the
// regular path: flag refresh, PCM warm-up release and counter, GNSS
// minimum covariance, the 3-DOF position path with the antenna inflation
// while yaw is uninitialised) and update_can (:705, with ZuptCan) before and
// after the Kalman update, which ekf.cuh's measurement_update runs. Each
// runs on thread 0, in the plain version's order and rounding.
#pragma once

#include "ekf.cuh"

namespace elm {
namespace ekf {

enum Source { NOVATEL = 0, NAVSATFIX = 1, BESTPOS = 2, PCM = 3 };  // config.GnssSource

struct Gnss {
  int src;
  float t, pos[3], rot[4], pos_cov[9], rot_cov[9];
};

// Thread 0: update_can's measurement (filter.update_can); false when the
// sample falls within 0.01 s of the last CAN update.
__device__ __forceinline__ bool can_setup(const State& s, const Params& prm, float t, float vx,
                                          float yaw, Update& u) {
  if (!(fabsf(sub(t, s.prev_can_t)) >= 0.01f)) return false;
  float rm[9], cvg[3], rl[9], tmp[9], R3[9];
  quat_to_rot(s.rot, rm);
  const float uv[3] = {mul(vx, prm.v[CAN_VEL_SCALE]), 0.0f, 0.0f};
  matvec(rm, uv, cvg);
  const float unc = prm.v[CAN_UNC_VEL], unc2 = sq(mul(2.0f, unc));
  for (int e = 0; e < 9; ++e) rl[e] = 0.0f;
  rl[0] = sq(unc);
  rl[4] = unc2;
  rl[8] = unc2;
  matmul3(rm, rl, tmp, false);
  matmul3(tmp, rm, R3, true);
  u.m = 4;
  const int idx[4] = {6, 7, 8, 11};
  for (int i = 0; i < 4; ++i) u.idx[i] = idx[i];
  for (int i = 0; i < 3; ++i) u.Y[i] = sub(cvg[i], s.vel[i]);
  u.Y[3] = sub(sub(yaw, s.can_bias), s.gyro[2]);
  for (int e = 0; e < 16; ++e) u.R[e] = 0.0f;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) u.R[4 * a + b] = R3[3 * a + b];
  u.R[15] = sq(prm.v[CAN_UNC_YAW]);
  return true;
}

// Thread 0: ZuptCan on the raw input, after the update (cpp:567-587).
__device__ __forceinline__ void can_finish(State& s, float t, float vx, float yaw) {
  s.prev_can_t = t;
  if (sqrtf(add(add(sq(vx), 0.0f), 0.0f)) <= 0.05f) {
    s.can_bias = add(mul(0.05f, yaw), mul(0.95f, s.can_bias));
    for (int i = 0; i < 3; ++i) s.vel[i] = mul(0.95f, s.vel[i]);
  }
}

// Thread 0: update_gnss's regular path up to the Kalman update.
__device__ __forceinline__ void gnss_setup(State& s, const Params& prm, const Gnss& g,
                                           Update& u) {
  refresh_flags(s);
  if (g.src == PCM && s.pcm_init_going) {
    if (s.pcm_count > 10) s.pcm_init_going = false;
    s.pcm_count += 1;
  }
  float R6[36];
  for (int e = 0; e < 36; ++e) R6[e] = 0.0f;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      R6[6 * a + b] = g.pos_cov[3 * a + b];
      R6[6 * (a + 3) + b + 3] = g.rot_cov[3 * a + b];
    }
  if (g.src != PCM)
    for (int i = 0; i < 6; ++i) R6[7 * i] = add(R6[7 * i], prm.v[GNSS_MIN_COV + i]);
  float mq[4], res[3];
  quat_normalize(g.rot, mq);
  euler_residual_from_quats(s.rot, mq, res);
  for (int i = 0; i < 3; ++i) {
    u.Y[i] = sub(g.pos[i], s.pos[i]);
    u.Y[3 + i] = res[i];
  }
  if (g.src == NAVSATFIX || g.src == BESTPOS) {
    const float inflate = s.yaw_init ? 0.0f : 3.0f;
    u.m = 3;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        u.R[3 * a + b] = add(R6[6 * a + b], a == b && a < 2 ? inflate : 0.0f);
  } else {
    u.m = 6;
    copy(R6, u.R, 36);
  }
  for (int i = 0; i < u.m; ++i) u.idx[i] = i;
}

}  // namespace ekf
}  // namespace elm
