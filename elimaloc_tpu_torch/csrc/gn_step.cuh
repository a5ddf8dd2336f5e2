// The Gauss-Newton / Levenberg-Marquardt step of the registration loop
// (K3), shared by kernel M (gn_step.cu, after kernels A, E, F, G and Q) and
// the P2P loop kernel (p2p_register.cu).
//
// Replaces elimaloc_tpu/register/icp.py:_solve_step (:202), _step_transform
// (:209) and the while-loop body around them (:761-774, 790-795): the
// normal equations from the reduced sums (assemble_p2p's 18-sum layout of
// kernel A, or assemble_gn's 44-sum layout of kernels E, F, G), the
// fitness and the overlap ratio with its gate, the LM damping
// reg = JTJ + lambda diag(JTJ), the 6x6 solve reg x = JTr (reg is not
// symmetric for E, F, G: no transposed system), the SE(3) step
// (lie.so3_exp) and lie.compose, the termination norm |so3_log| + |t|,
// the fitness carry and, for GICP only, local_cov = reg^-1.
//
// One thread runs it serially with ekf.cuh's helpers (the LU with partial
// pivoting of lu_factor, the inverse as six lu_solve columns), in the plain
// version's order and rounding. Every operation is an explicitly rounded
// intrinsic (mul / add / sub / __fdiv_rn) or a libm call, never contracted,
// so kernel M, which inlines it, and the loop kernel, which calls it
// through a __noinline__ wrapper (the LU's registers stay out of its
// search), round alike.
#pragma once

#include <math.h>

#include "ekf.cuh"

namespace elm {

constexpr int kP2pSums = 18;  // kernel A's layout; E, F, G write common.cuh's kGnSums

// The normal equations of one iteration (icp.assemble_p2p / assemble_gn).
__device__ __forceinline__ void gn_assemble(const float* s, int n_sums, float* JTJ, float* JTr,
                                            float& fit_num, float& matched) {
  if (n_sums == kP2pSums) {
    const float sw = s[0], x = s[1], y = s[2], z = s[3];
    const float* pp = s + 4;
    const float ppT[9] = {pp[0], pp[1], pp[2], pp[1], pp[3], pp[4], pp[2], pp[4], pp[5]};
    const float tr = add(add(pp[0], pp[3]), pp[5]);
    const float S[9] = {0.0f, -z, y, z, 0.0f, -x, -y, x, 0.0f};  // skew(sum w p)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        JTJ[6 * i + j] = i == j ? sw : 0.0f;
        JTJ[6 * i + j + 3] = -S[3 * i + j];
        JTJ[6 * (i + 3) + j] = S[3 * i + j];
        JTJ[6 * (i + 3) + j + 3] = sub(i == j ? tr : 0.0f, ppT[3 * i + j]);
      }
    for (int i = 0; i < 6; ++i) JTr[i] = s[10 + i];
    fit_num = s[16];
    matched = rintf(s[17]);
  } else {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        JTJ[6 * i + j] = s[3 * i + j];
        JTJ[6 * i + j + 3] = s[9 + 3 * i + j];
        JTJ[6 * (i + 3) + j] = s[18 + 3 * i + j];
        JTJ[6 * (i + 3) + j + 3] = s[27 + 3 * i + j];
      }
    for (int i = 0; i < 6; ++i) JTr[i] = s[36 + i];
    fit_num = s[42];
    matched = rintf(s[43]);
  }
}

// One LM step from the reduced ``sums`` ([kP2pSums] or [kGnSums]) and the
// carry (pose [16], fitness, local_cov [36]); ``total`` and the three
// parameters are the loop's constants. Writes out: pose [16], local_cov
// [36], fitness, overlap; flags: stop (done | failed), failed. ``out`` must
// not alias ``pose`` or ``local_cov``.
__device__ __forceinline__ void gn_update(const float* sums, int n_sums, const float* pose,
                                          float fitness, const float* local_cov, float total,
                                          float min_overlap_ratio, float lambda,
                                          float termination_threshold, int gicp, float* out,
                                          bool* flags) {
  using namespace elm::ekf;
  float JTJ[36], JTr[6], fit_num, matched;
  gn_assemble(sums, n_sums, JTJ, JTr, fit_num, matched);
  const float fit = dv(fit_num, fmaxf(matched, 1.0f));
  const float ratio = dv(matched, total);
  const bool ok = ratio >= min_overlap_ratio;

  // LM-damped solve (cpp:55-56)
  float reg[36], lu[36], b[6], x[6];
  int piv[6];
  for (int e = 0; e < 36; ++e)
    reg[e] = add(JTJ[e], e % 7 == 0 ? mul(lambda, JTJ[e]) : 0.0f);
  for (int e = 0; e < 36; ++e) lu[e] = reg[e];
  lu_factor(lu, piv, 6);
  for (int i = 0; i < 6; ++i) b[i] = JTr[i];
  lu_solve(lu, piv, b, x, 6);
  for (int i = 0; i < 6; ++i) x[i] = ok ? x[i] : 0.0f;

  // the SE(3) step, the new pose, the termination norm (cpp:58-62, 380-391)
  float r[9], step[16], w[3];
  so3_exp(x + 3, r);
  make_transform(r, x, step);
  compose(pose, step, out);
  if (!ok)
    for (int e = 0; e < 16; ++e) out[e] = pose[e];
  so3_log(r, w);
  const float transform_norm = add(norm3(w), norm3(x));
  const bool done = ok && transform_norm < termination_threshold;

  // the carries: local_cov = reg^-1 for GICP only (cpp:140-142)
  float* cov = out + 16;
  for (int e = 0; e < 36; ++e) cov[e] = local_cov[e];
  if (gicp && ok)
    for (int j = 0; j < 6; ++j) {
      float col[6];
      for (int i = 0; i < 6; ++i) b[i] = i == j ? 1.0f : 0.0f;
      lu_solve(lu, piv, b, col, 6);
      for (int i = 0; i < 6; ++i) cov[6 * i + j] = col[i];
    }
  out[52] = ok ? fit : fitness;
  out[53] = ratio;
  flags[0] = done || !ok;
  flags[1] = !ok;
}

}  // namespace elm
