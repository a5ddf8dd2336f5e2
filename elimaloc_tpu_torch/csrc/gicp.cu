// Kernel E: fused GICP correspondence search + Gauss-Newton partials.
//
// Replaces elimaloc_tpu/map/tiles.py:nearest_point_slots with
// with_point_cov=True (:712, the selection at :752-765) and
// register/icp.py:_gicp_tail (:324) with _accumulate_gn (:175),
// _smallest_eigvec (:214) and ops/lie.py:inv3x3 (:383). On the TPU the
// winner's point, 3x3 covariance and neighbourhood mean ride one [MHP, 15]
// payload selected by a one-hot matmul per slot, and the GN blocks run as
// [S*QB, 3, 3] einsums. On Hopper one CTA owns one slot:
//   1. the search is kernel A's, bit for bit (common.cuh: cube_argmin over
//      the PointStage-staged halo row);
//   2. the winner's covariance C (9 floats) and mean mu (3 floats) are read
//      from device memory by the query's first thread; a query with no
//      match takes the identity and the query, as the plain version does,
//      and adds exactly zero;
//   3. that thread forms M = (R^T C R)^-1 in closed form, the sensor-frame
//      residual against the MEAN (icp.py:335-339), the weight
//      0.8 th^2 / (th + r^2)^2 + 0.2, the row's J^T M J blocks (all four:
//      the regularised covariances are U diag V^T, not symmetric) and
//      J^T M r, and the fitness term |r . n| with n = R^T v / |R^T v| for v
//      the smallest eigenvector of C;
//   4. the slot's 44 partial sums (tl, tr, bl, br, J^T r top and bottom,
//      fitness numerator, matched count) are summed over its queries in
//      query order from dynamic shared memory (QB x 44 floats), and a
//      single-CTA kernel reduces the [S, 44] partials in a fixed order. No
//      atomics: a float32 result is the same on every run.
// Radar form (use_radar_cov): a non-null ``radar`` [S, QB, 9] (kernel P's
// slot-packed R S) adds the row's 9 floats to R^T C R before the inverse
// (icp.py:331-333); M is then not symmetric, which gn_row already takes.
// A live row without a match still forms its M, as the plain sums do
// (common.cuh: masked_radar_row).
// Bound: the search, as kernel A (S * QB * MHP cube tests and distances per
// GN iteration); the tail is ~300 FLOP per query, the covariance gather
// 48 B per query (84 B with radar).
#include "common.cuh"

using namespace elm;

namespace {

template <bool kRadar>
__global__ void gicp_search_kernel(
    const float* __restrict__ halo, const float* __restrict__ pcov,
    const float* __restrict__ pmean, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb,
    const float* __restrict__ pose, const float* __restrict__ max_dist,
    float voxel, float tile_size, int tx0, int ty0, int ty_dim,
    const float* __restrict__ radar, float* __restrict__ partials,
    float* __restrict__ cov_out, float* __restrict__ mean_out, bool* __restrict__ ok_out) {
  __shared__ float cl[kChunk * 3];
  __shared__ int cv[kChunk * 3];
  __shared__ int any_live;
  extern __shared__ float part[];  // [qb, kGnSums]

  const SlotQuery u = slot_query(blockIdx.x, slot_tile, sbuf, qmask, qb, pose, voxel,
                                 tile_size, tx0, ty0, ty_dim);
  const bool live_slot = slot_any_live(u, &any_live);
  const size_t base = (size_t)u.tile * mhp;
  float best_d2;
  int best;
  cube_argmin(u, live_slot, mhp, PointStage{halo + base * 3, u.c0, u.c1, voxel},
              cl, cv, best_d2, best);

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
  slot_partials(part, qb, kGnSums, partials + (size_t)blockIdx.x * kGnSums);
}

}  // namespace

extern "C" int elm_gicp_search_reduce(
    const float* halo, const float* pcov, const float* pmean, int mhp,
    const int* slot_tile, const float* sbuf, const bool* qmask, int s, int qb,
    const float* pose, const float* max_dist, float voxel, float tile_size, int tx0,
    int ty0, int ty_dim, const float* radar, float* partials, float* sums, float* cov_out,
    float* mean_out, bool* ok_out, cudaStream_t stream) {
  const int smem = qb * kGnSums * (int)sizeof(float);
  // the radar form is its own instantiation: the reference form keeps its
  // registers
  const auto kernel =
      radar != nullptr ? gicp_search_kernel<true> : gicp_search_kernel<false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (s > 0) {
    kernel<<<s, kThreads, smem, stream>>>(
        halo, pcov, pmean, mhp, slot_tile, sbuf, qmask, qb, pose, max_dist, voxel,
        tile_size, tx0, ty0, ty_dim, radar, partials, cov_out, mean_out, ok_out);
  }
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(partials, s, kGnSums, sums);
  return (int)cudaGetLastError();
}
