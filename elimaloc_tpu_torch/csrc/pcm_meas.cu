// Kernel L: the PCM measurement of a registered scan (K8, the scan-tail
// half), written out to global memory.
//
// Replaces elimaloc_tpu/pipeline/runtime.py:shape_icp_covariance (:275),
// elimaloc_tpu/pipeline/rings.py:gnss_time_compensation (:251) and the
// glue of scan_step around them (runtime.py:341-358); see pcm_meas.cuh,
// which holds its body. It writes the GnssMeas kernel I reads (t, pos,
// quat, pos_cov, rot_cov, row-major) and the scan's ``icp_pose`` output.
// On the TPU these are XLA-fused selects; the plain PyTorch version is
// ~120 small launches. The pipeline runs the same body inside kernel S
// (pcm_stage.cu), which keeps the measurement in shared memory; this entry
// is the reference S is held to (L, then I, bit for bit).
//
// Bound: latency (~2 KB of the ego ring read, ~200 B written). Design: one
// CTA, the body of pcm_meas.cuh.
#include "pcm_meas.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

constexpr int kMeasThreads = 128;

__global__ void __launch_bounds__(kMeasThreads) pcm_measurement_kernel(
    const float* __restrict__ icp_pose, const float* __restrict__ tf_lidar_to_ego,
    const float* __restrict__ local_cov, const float* __restrict__ fitness,
    const bool* __restrict__ success, const bool* __restrict__ usable,
    const float* __restrict__ ring_t, const float* __restrict__ ring_pos,
    const float* __restrict__ ring_rpy, const int* __restrict__ ring_count, int cap,
    const float* __restrict__ scan_end, int use_pcm, float* __restrict__ out,
    bool* __restrict__ apply) {
  __shared__ int s_closest;
  __shared__ PcmMeas m;
  pcm_measure(icp_pose, tf_lidar_to_ego, local_cov, fitness, success, usable, ring_t, ring_pos,
              ring_rpy, ring_count, cap, scan_end, use_pcm, s_closest, m);
  if (threadIdx.x != 0) return;
  copy(reinterpret_cast<const float*>(&m), out, kPcmMeasWords);
  *apply = m.apply;
}

}  // namespace

// out: icp_pose [4, 4], t, pos [3], quat [4], pos_cov [3, 3], rot_cov [3, 3].
extern "C" int elm_pcm_measurement(const float* icp_pose, const float* tf_lidar_to_ego,
                                   const float* local_cov, const float* fitness,
                                   const bool* success, const bool* usable,
                                   const float* ring_t, const float* ring_pos,
                                   const float* ring_rpy, const int* ring_count, int cap,
                                   const float* scan_end, int use_pcm, float* out, bool* apply,
                                   cudaStream_t stream) {
  pcm_measurement_kernel<<<1, kMeasThreads, 0, stream>>>(
      icp_pose, tf_lidar_to_ego, local_cov, fitness, success, usable, ring_t, ring_pos, ring_rpy,
      ring_count, cap, scan_end, use_pcm, out, apply);
  return (int)cudaGetLastError();
}
