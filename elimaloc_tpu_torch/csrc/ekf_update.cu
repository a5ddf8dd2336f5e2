// Kernel I: the EKF measurement updates of a frame (K8, the update half).
//
// Replaces elimaloc_tpu/ekf/filter.py:_ekf_measurement_update (:221),
// update_gnss (:616, the regular path: flag refresh, PCM warm-up release
// and counter, GNSS minimum covariance, the 3-DOF position path with the
// antenna inflation while yaw is uninitialised, prev_gnss_timestamp) and
// update_can (:705, with ZuptCan), as the fused frame runs them:
// elimaloc_tpu/pipeline/runtime.py:453-475 (the CAN then the GPS sub-batch,
// each sample masked by validity, a GPS fix also by the variance gate of
// gps_step :205) and :358-360 (the PCM update masked by ``apply``). On the
// TPU these are XLA-fused selects; the plain PyTorch version is dozens of
// eager launches per update plus a select over the whole state.
//
// Bound: latency. Each update is an m x m solve (m = 3, 4 or 6) and a
// rank-m correction of the 27x27 P (~4k FLOP); a frame holds ~5 CAN
// samples, at most one GPS fix and one PCM pose. Design: one CTA with P in
// shared memory (ekf.cuh; the state and the parameters in by one packed
// record each, the state out by one) walks the CAN samples, then the GPS fixes, then
// the PCM pose, in one launch or in one launch per call site: the fused
// frame calls it once for CAN + GPS before the scan and once for PCM at the
// scan's end. Thread 0 sets each measurement up and solves S (LU with
// partial pivoting for m = 4, 6, no library call); the gain rows and the
// P update run across the block, in the reference's P -= K H P form or,
// with ``joseph``, the Joseph form (ekf.cuh: measurement_update). The masks
// are device flags, read in the kernel: no host sync.
#include "ekf.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

enum Source { NOVATEL = 0, NAVSATFIX = 1, BESTPOS = 2, PCM = 3 };  // config.GnssSource

struct Gnss {
  int src;
  float t, pos[3], rot[4], pos_cov[9], rot_cov[9];
};

// Thread 0: update_can's measurement (filter.update_can); false when the
// sample falls within 0.01 s of the last CAN update.
__device__ bool can_setup(const State& s, const Params& prm, float t, float vx, float yaw,
                          Update& u) {
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
__device__ void can_finish(State& s, float t, float vx, float yaw) {
  s.prev_can_t = t;
  if (sqrtf(add(add(sq(vx), 0.0f), 0.0f)) <= 0.05f) {
    s.can_bias = add(mul(0.05f, yaw), mul(0.95f, s.can_bias));
    for (int i = 0; i < 3; ++i) s.vel[i] = mul(0.95f, s.vel[i]);
  }
}

// Thread 0: update_gnss's regular path up to the Kalman update.
__device__ void gnss_setup(State& s, const Params& prm, const Gnss& g, Update& u) {
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

struct Ctrl {
  bool run;
  float t, vx, yaw;
  Gnss g;
};

__global__ void __launch_bounds__(kThreads) ekf_update_kernel(
    const int* __restrict__ rec_in, int* __restrict__ rec_out,
    const float* __restrict__ prm_rec, int n_can, const float* __restrict__ can_t,
    const float* __restrict__ can_vel, const float* __restrict__ can_yaw,
    const bool* __restrict__ can_valid, int n_gps, int gps_src,
    const float* __restrict__ gnss_max, const float* __restrict__ gps_t,
    const float* __restrict__ gps_pos, const float* __restrict__ gps_cov,
    const bool* __restrict__ gps_valid, int has_pcm, const float* __restrict__ pcm_t,
    const float* __restrict__ pcm_pos, const float* __restrict__ pcm_rot,
    const float* __restrict__ pcm_pos_cov, const float* __restrict__ pcm_rot_cov,
    const bool* __restrict__ pcm_apply, bool joseph) {
  __shared__ State s;
  __shared__ Params prm;
  __shared__ Update u;
  __shared__ Ctrl c;
  load_state(rec_in, s);
  load_params(prm_rec, prm);
  __syncthreads();
  const int n = n_can + n_gps + (has_pcm ? 1 : 0);
  for (int k = 0; k < n; ++k) {
    const bool is_can = k < n_can;
    if (threadIdx.x == 0) {
      if (is_can) {
        c.t = can_t[k];
        c.vx = can_vel[k];
        c.yaw = can_yaw[k];
        c.run = can_valid[k] && can_setup(s, prm, c.t, c.vx, c.yaw, u);
      } else if (k < n_can + n_gps) {
        // gps_step: the re-squared NavSatFix variance, its gate, identity
        // rotation, zero rotation covariance
        const int j = k - n_can;
        Gnss& g = c.g;
        g.src = gps_src;
        g.t = gps_t[j];
        float var[3];
        for (int i = 0; i < 3; ++i) {
          var[i] = sq(gps_cov[3 * j + i]);
          g.pos[i] = gps_pos[3 * j + i];
        }
        for (int e = 0; e < 9; ++e) g.pos_cov[e] = g.rot_cov[e] = 0.0f;
        for (int i = 0; i < 3; ++i) g.pos_cov[4 * i] = var[i];
        g.rot[0] = 1.0f;
        g.rot[1] = g.rot[2] = g.rot[3] = 0.0f;
        c.run = gps_valid[j] && var[0] <= *gnss_max && var[1] <= *gnss_max;
        if (c.run) gnss_setup(s, prm, g, u);
      } else {
        Gnss& g = c.g;
        g.src = PCM;
        g.t = *pcm_t;
        copy(pcm_pos, g.pos, 3);
        copy(pcm_rot, g.rot, 4);
        copy(pcm_pos_cov, g.pos_cov, 9);
        copy(pcm_rot_cov, g.rot_cov, 9);
        c.run = *pcm_apply;
        if (c.run) gnss_setup(s, prm, g, u);
      }
    }
    __syncthreads();
    if (c.run) {
      measurement_update(s, u, joseph);
      if (threadIdx.x == 0) {
        if (is_can)
          can_finish(s, c.t, c.vx, c.yaw);
        else
          s.prev_gnss_t = c.g.t;
      }
    }
    __syncthreads();
  }
  store_state(s, rec_out);
}

}  // namespace

extern "C" int elm_ekf_update(const void* rec_in, void* rec_out, const float* params,
                              int n_can, const float* can_t, const float* can_vel,
                              const float* can_yaw, const bool* can_valid, int n_gps,
                              int gps_src, const float* gnss_max, const float* gps_t,
                              const float* gps_pos, const float* gps_cov,
                              const bool* gps_valid, int has_pcm, const float* pcm_t,
                              const float* pcm_pos, const float* pcm_rot,
                              const float* pcm_pos_cov, const float* pcm_rot_cov,
                              const bool* pcm_apply, int joseph, cudaStream_t stream) {
  ekf_update_kernel<<<1, kThreads, 0, stream>>>(
      (const int*)rec_in, (int*)rec_out, params, n_can, can_t, can_vel, can_yaw, can_valid,
      n_gps, gps_src, gnss_max, gps_t, gps_pos, gps_cov, gps_valid, has_pcm, pcm_t, pcm_pos,
      pcm_rot, pcm_pos_cov, pcm_rot_cov, pcm_apply, joseph != 0);
  return (int)cudaGetLastError();
}
