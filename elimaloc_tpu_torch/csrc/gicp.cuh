// One slot of the fused GICP correspondence search + Gauss-Newton partials
// (K1 with the point covariances + K11a), shared by kernel E (gicp.cu:
// gicp_search_kernel, one CTA per slot, one GN iteration) and the GICP loop
// kernel (gicp.cu: gicp_register_kernel, each CTA walks slots, every
// iteration of the registration in one launch). See gicp.cu for the design.
// The slot body is __noinline__ and included by gicp.cu alone: both kernels
// call one compiled copy, so they round alike.
#pragma once

#include "common.cuh"

namespace elm {

// Slot ``slot`` at ``pose``: its 44 partial sums to partials[slot] (the
// rows staged in ``part``, [qb, kGnSums] floats of shared memory), and, when
// ``cov_out`` is given, each query's (cov, mean, ok). Every thread of the
// CTA must call it (its barriers are CTA-uniform); a CTA may call it for
// several slots in turn.
template <bool kRadar>
__device__ __noinline__ void gicp_slot(
    int slot, const float* __restrict__ halo, const float* __restrict__ pcov,
    const float* __restrict__ pmean, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb, const float* pose,
    const float* __restrict__ max_dist, float voxel, float tile_size, int tx0, int ty0,
    int ty_dim, const float* __restrict__ radar, float* partials, float* cov_out,
    float* mean_out, bool* ok_out, CubeShared& sm, float* part) {
  const SlotQuery u = slot_query(slot, slot_tile, sbuf, qmask, qb, pose, voxel, tile_size,
                                 tx0, ty0, ty_dim);
  const bool live_slot = slot_any_live(u, &sm.any_live);
  const size_t base = (size_t)u.tile * mhp;
  float best_d2;
  int best;
  cube_argmin(u, live_slot, mhp, PointStage{halo + base * 3, u.c0, u.c1, voxel}, sm.cl,
              sm.cv, best_d2, best);

  if (u.gl == 0) {
    const float md = max_dist[0];
    const bool ok = u.live && best_d2 < mul(md, md);
    float C[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    float mu[3] = {u.q[0], u.q[1], u.q[2]};
    if (ok) {
      for (int k = 0; k < 9; ++k) C[k] = pcov[(base + best) * 9 + k];
      for (int k = 0; k < 3; ++k) mu[k] = pmean[(base + best) * 3 + k];
    }
    if (cov_out != nullptr) {
      for (int k = 0; k < 9; ++k) cov_out[(size_t)u.row * 9 + k] = C[k];
      for (int k = 0; k < 3; ++k) mean_out[(size_t)u.row * 3 + k] = mu[k];
      ok_out[u.row] = ok;
    }
    gicp_row<kRadar>(u, ok, C, mu, md, radar, part + u.j * kGnSums);
  }
  __syncthreads();
  slot_partials(part, qb, kGnSums, partials + (size_t)slot * kGnSums);
}

}  // namespace elm
