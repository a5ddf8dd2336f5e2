// Kernel F: fused VGICP correspondence search + Gauss-Newton partials.
//
// Replaces elimaloc_tpu/map/tiles.py:nearest_voxel_cov_slots (:803) and
// register/icp.py:_voxcov_tail (:354) with _accumulate_gn (:175) and
// ops/lie.py:inv3x3 (:383). On the TPU the search is a dense [QB, MHV]
// distance plane over the slot's halo voxel means plus a one-hot matmul of
// a [MHV, 12] cov|mean payload. On Hopper one CTA owns one slot:
//   1. the halo voxel row (MHV means + int coords, MHV = 152 at halo margin
//      1) is staged in shared memory (common.cuh: VoxelStage); unoccupied
//      pads carry the coord sentinel 2^30 and +inf means and are staged as
//      a far voxel, so they fail the cube test and +inf never enters
//      arithmetic;
//   2. the search is kernel A's over the means, with the STORED voxel
//      coords in the cube test (common.cuh: cube_argmin): exact tile-local
//      diff^2 distances, ties to the first index;
//   3. the query's first thread reads the winner's covariance and mean from
//      device memory and forms M = (R^T C R)^-1, the sensor-frame residual
//      against the mean and the weight th^2 / (th + r^2)^2; rows with
//      w < 0.01 leave the sums and the fitness numerator (sqrt r^2), but
//      every valid match counts (cpp:199-207);
//   4. the slot's 44 partial sums, summed in query order, and the
//      fixed-order single-CTA reduction of the [S, 44] partials, as kernel E.
// Radar form (use_radar_cov): a non-null ``radar`` [S, QB, 9] adds the row's
// 9 floats to R^T C R before the inverse (icp.py:361-363), as kernel E,
// masked rows included (common.cuh: masked_radar_row).
// Bound: the S * QB * MHV cube tests and distances (~2000 * 16 * 152 = 5M
// per GN iteration at the headline scan), FP32 issue and shared memory.
#include "common.cuh"

using namespace elm;

namespace {

template <bool kRadar>
__global__ void vgicp_search_kernel(
    const float* __restrict__ vmean, const float* __restrict__ vcov,
    const int* __restrict__ vcoord, int mhv, const int* __restrict__ slot_tile,
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
  const size_t base = (size_t)u.tile * mhv;
  float best_d2;
  int best;
  cube_argmin(u, live_slot, mhv,
              VoxelStage{vmean + base * 3, vcoord + base * 3, u.c0, u.c1}, cl, cv,
              best_d2, best);

  if (u.gl == 0) {
    const float md = max_dist[0];
    const bool ok = u.live && best_d2 < mul(md, md);
    float C[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    float mu[3] = {u.q[0], u.q[1], u.q[2]};
    if (ok) {
      for (int k = 0; k < 9; ++k) C[k] = vcov[(base + best) * 9 + k];
      for (int k = 0; k < 3; ++k) mu[k] = vmean[(base + best) * 3 + k];
    }
    if (cov_out != nullptr) {
      for (int k = 0; k < 9; ++k) cov_out[(size_t)u.row * 9 + k] = C[k];
      for (int k = 0; k < 3; ++k) mean_out[(size_t)u.row * 3 + k] = mu[k];
      ok_out[u.row] = ok;
    }
    vgicp_row<kRadar>(u, ok, C, mu, md, radar, part + u.j * kGnSums);
  }
  __syncthreads();
  slot_partials(part, qb, kGnSums, partials + (size_t)blockIdx.x * kGnSums);
}

}  // namespace

extern "C" int elm_vgicp_search_reduce(
    const float* vmean, const float* vcov, const int* vcoord, int mhv,
    const int* slot_tile, const float* sbuf, const bool* qmask, int s, int qb,
    const float* pose, const float* max_dist, float voxel, float tile_size, int tx0,
    int ty0, int ty_dim, const float* radar, float* partials, float* sums, float* cov_out,
    float* mean_out, bool* ok_out, cudaStream_t stream) {
  const int smem = qb * kGnSums * (int)sizeof(float);
  // the radar form is its own instantiation: the reference form keeps its
  // registers
  const auto kernel =
      radar != nullptr ? vgicp_search_kernel<true> : vgicp_search_kernel<false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (s > 0) {
    kernel<<<s, kThreads, smem, stream>>>(
        vmean, vcov, vcoord, mhv, slot_tile, sbuf, qmask, qb, pose, max_dist, voxel,
        tile_size, tx0, ty0, ty_dim, radar, partials, cov_out, mean_out, ok_out);
  }
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(partials, s, kGnSums, sums);
  return (int)cudaGetLastError();
}
