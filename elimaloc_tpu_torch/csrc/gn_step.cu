// Kernel M: one Gauss-Newton / Levenberg-Marquardt step of the
// registration loop after the search + reduction (K3).
//
// Replaces elimaloc_tpu/register/icp.py:_solve_step (:202), _step_transform
// (:209) and the while-loop body around them (:761-774, 790-795); the step
// itself is gn_step.cuh's gn_update, which the P2P loop kernel
// (p2p_register.cu) runs too. It writes one stop flag (done | failed), the
// one value the host reads per iteration of the GICP / VGICP / AVGICP loops
// and of the hash backend's. On the TPU these are fused into the
// lax.while_loop body; the plain PyTorch version is ~40 small launches and a
// cuSOLVER call per iteration.
//
// Bound: latency (~0.5k FLOP on 200 B of sums and carries). Design: one
// warp; thread 0 runs the step serially.
#include "gn_step.cuh"

using namespace elm;

namespace {

__global__ void __launch_bounds__(32) gn_step_kernel(
    const float* __restrict__ sums, int n_sums, const float* __restrict__ pose,
    const float* __restrict__ fitness, const float* __restrict__ local_cov,
    const float* __restrict__ total, const float* __restrict__ min_overlap_ratio,
    const float* __restrict__ lm_lambda, const float* __restrict__ termination_threshold,
    int gicp, float* __restrict__ out, bool* __restrict__ flags) {
  if (threadIdx.x == 0)
    gn_update(sums, n_sums, pose, *fitness, local_cov, *total, *min_overlap_ratio,
              *lm_lambda, *termination_threshold, gicp, out, flags);
}

}  // namespace

// out: pose [4, 4], local_cov [6, 6], fitness, overlap; flags: stop, failed.
extern "C" int elm_gn_step(const float* sums, int n_sums, const float* pose,
                           const float* fitness, const float* local_cov, const float* total,
                           const float* min_overlap_ratio, const float* lm_lambda,
                           const float* termination_threshold, int gicp, float* out,
                           bool* flags, cudaStream_t stream) {
  gn_step_kernel<<<1, 32, 0, stream>>>(sums, n_sums, pose, fitness, local_cov, total,
                                       min_overlap_ratio, lm_lambda, termination_threshold,
                                       gicp, out, flags);
  return (int)cudaGetLastError();
}
