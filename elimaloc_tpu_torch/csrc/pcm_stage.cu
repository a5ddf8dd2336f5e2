// Kernel S: the scan's end in one launch — the PCM measurement, the PCM
// update and the frame's published outputs (K8's scan-tail half and its
// PCM update, and the fused frame's epilogue).
//
// Replaces elimaloc_tpu/pipeline/runtime.py:341-362, the tail of scan_step:
// lie.compose with tf_lidar_to_ego and rot_to_quat, shape_icp_covariance
// (:275), rings.gnss_time_compensation (rings.py:251), ``apply`` = usable &
// success & compensation ok & use_pcm, then update_gnss with the PCM source
// (ekf/filter.py:616, with _ekf_measurement_update :221) and _select_state;
// and fused_frame's epilogue (runtime.py:481-490): ego_state's pos, rpy and
// timestamp, max |P - P^T| and min diag P. Before it the port ran kernel L
// (the measurement, written to global memory), kernel I (one CTA reading it
// back for the update) and some 70 eager launches of the epilogue on the
// state I had just written.
//
// Bound: latency. One CTA, one 6x6 LU on thread 0 and a rank-6 correction
// of the 27x27 P; it moves ~21 KB (two 3,072-byte state records, the
// 128-byte params and the ego ring's t, pos and rpy). Design: one CTA of
// kThreads, the same block as kernel I, so measurement_update's work split
// and rounding are I's. The state and the parameters come in by one packed
// record each (ekf.cuh); kernel L's body (pcm_meas.cuh) computes the
// measurement into shared memory, never through global memory; if
// ``apply``, I's PCM set-up (ekf_update.cuh: gnss_setup) and
// measurement_update (the Joseph form as its own instantiation), then
// prev_gnss_timestamp; the state out to a fresh record; then the outputs
// into one small buffer: the measurement in L's layout (icp_pose first),
// ego pos, rpy (quat_to_euler, the library atan2f / asinf) and time, and
// the two P statistics as block reductions over P in shared memory (max
// and min are exact in any order: no float atomics). The state and the
// measurement are bit-equal to kernel L then kernel I on the same inputs.
// Lanes: a fleet frame (replay_fused_fleet's vmap, elimaloc_tpu/parallel/
// sharding.py:256-281) launches one CTA a lane, each on its lane's record,
// registration, ego ring and outputs at their lane strides; one lane is the
// single launch.
#include <math.h>

#include "ekf_update.cuh"
#include "pcm_meas.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

constexpr int kWarps = kThreads / 32;
// the output buffer, in floats: the measurement (kernel L's 42), ego pos
// [3], rpy [3], t, p_asym, p_min_diag; ``applied`` follows as a byte
constexpr int kEgoPos = kPcmMeasWords, kEgoRpy = kEgoPos + 3, kEgoT = kEgoRpy + 3,
              kAsym = kEgoT + 1, kMinDiag = kAsym + 1, kOutFloats = kMinDiag + 1;

// torch.max / torch.min: a NaN anywhere wins.
__device__ __forceinline__ float max_nan(float a, float b) { return b > a || b != b ? b : a; }
__device__ __forceinline__ float min_nan(float a, float b) { return b < a || b != b ? b : a; }

template <bool kJoseph>
__global__ void __launch_bounds__(kThreads) pcm_stage_kernel(
    const int* __restrict__ rec_in, int* __restrict__ rec_out,
    const float* __restrict__ prm_rec, const float* __restrict__ icp_pose,
    const float* __restrict__ tf_lidar_to_ego, const float* __restrict__ local_cov,
    const float* __restrict__ fitness, const bool* __restrict__ success,
    const bool* __restrict__ usable, const float* __restrict__ ring_t,
    const float* __restrict__ ring_pos, const float* __restrict__ ring_rpy,
    const int* __restrict__ ring_count, int cap, const float* __restrict__ scan_end,
    int use_pcm, float* __restrict__ out, bool* __restrict__ applied, int usable_stride,
    int scan_end_stride) {
  // this CTA's lane: its inputs and outputs at their lane strides
  const int l = blockIdx.x;
  rec_in += l * kRecordWords;
  rec_out += l * kRecordWords;
  icp_pose += 16 * l;
  local_cov += 36 * l;
  fitness += l;
  success += l;
  usable += l * usable_stride;
  ring_t += (size_t)l * cap;
  ring_pos += (size_t)3 * l * cap;
  ring_rpy += (size_t)3 * l * cap;
  ring_count += l;
  scan_end += l * scan_end_stride;
  out += l * kOutFloats;
  applied += l;
  __shared__ State s;
  __shared__ Params prm;
  __shared__ Update u;
  __shared__ PcmMeas m;
  __shared__ int s_closest;
  __shared__ float red[2][kWarps];
  load_state(rec_in, s);
  load_params(prm_rec, prm);
  // its first barrier publishes the state and the parameters
  pcm_measure(icp_pose, tf_lidar_to_ego, local_cov, fitness, success, usable, ring_t, ring_pos,
              ring_rpy, ring_count, cap, scan_end, use_pcm, s_closest, m);
  __syncthreads();
  if (m.apply) {  // block-uniform
    if (threadIdx.x == 0) {
      Gnss g;
      g.src = PCM;
      g.t = m.t;
      copy(m.pos, g.pos, 3);
      copy(m.quat, g.rot, 4);
      copy(m.pos_cov, g.pos_cov, 9);
      copy(m.rot_cov, g.rot_cov, 9);
      gnss_setup(s, prm, g, u);
    }
    __syncthreads();
    measurement_update(s, u, kJoseph);
    if (threadIdx.x == 0) s.prev_gnss_t = m.t;
  }
  __syncthreads();
  store_state(s, rec_out);

  // max |P - P^T| and min diag P
  float asym = 0.0f, dmin = INFINITY;
  for (int e = threadIdx.x; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    asym = max_nan(asym, fabsf(sub(s.P[e], s.P[j * kN + i])));
    if (i == j) dmin = min_nan(dmin, s.P[e]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    asym = max_nan(asym, __shfl_down_sync(0xffffffffu, asym, o));
    dmin = min_nan(dmin, __shfl_down_sync(0xffffffffu, dmin, o));
  }
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = asym;
    red[1][threadIdx.x / 32] = dmin;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (blockDim.x + 31) / 32; ++w) {
    asym = max_nan(asym, red[0][w]);
    dmin = min_nan(dmin, red[1][w]);
  }
  copy(reinterpret_cast<const float*>(&m), out, kPcmMeasWords);
  copy(s.pos, out + kEgoPos, 3);
  quat_to_euler(s.rot, out + kEgoRpy);
  out[kEgoT] = s.prev_t;
  out[kAsym] = asym;
  out[kMinDiag] = dmin;
  *applied = m.apply;
}

}  // namespace

// out: icp_pose [4, 4], t, pos [3], quat [4], pos_cov [3, 3], rot_cov [3, 3]
// (kernel L's layout), ego pos [3], ego rpy [3], ego t, p_asym, p_min_diag.
// ``lanes`` frames, one CTA each: the records, icp_pose [lanes, 4, 4],
// local_cov [lanes, 6, 6], fitness, success, the ego ring ([lanes, cap],
// [lanes, cap, 3], [lanes]), out [lanes, 51] and applied [lanes] at their
// lane strides; usable and scan_end every ``usable_stride`` bytes and
// ``scan_end_stride`` floats (views of kernel T's lane outputs).
extern "C" int elm_pcm_stage(const void* rec_in, void* rec_out, const float* params,
                             const float* icp_pose, const float* tf_lidar_to_ego,
                             const float* local_cov, const float* fitness, const bool* success,
                             const bool* usable, const float* ring_t, const float* ring_pos,
                             const float* ring_rpy, const int* ring_count, int cap,
                             const float* scan_end, int use_pcm, int joseph, float* out,
                             bool* applied, int lanes, int usable_stride, int scan_end_stride,
                             cudaStream_t stream) {
  auto kernel = joseph ? pcm_stage_kernel<true> : pcm_stage_kernel<false>;
  kernel<<<lanes, kThreads, 0, stream>>>((const int*)rec_in, (int*)rec_out, params, icp_pose,
                                         tf_lidar_to_ego, local_cov, fitness, success, usable,
                                         ring_t, ring_pos, ring_rpy, ring_count, cap, scan_end,
                                         use_pcm, out, applied, usable_stride,
                                         scan_end_stride);
  return (int)cudaGetLastError();
}
