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
// frame calls it once for CAN + GPS before the scan; the PCM pose at the
// scan's end runs in kernel S (pcm_stage.cu) with the same set-up
// (ekf_update.cuh) and update, and this entry's PCM leg is the reference S
// is held to. Thread 0 sets each measurement up and solves the innovation
// covariance (LU with partial pivoting for m = 4, 6, no library call); the
// gain rows and the P update run across the block, in the reference's P -= K H P form or,
// with ``joseph``, the Joseph form (ekf.cuh: measurement_update). The masks
// are device flags, read in the kernel: no host sync.
#include "ekf_update.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

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
