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
// Kernel F's one-iteration entry (elm_vgicp_search_reduce) is the reference
// the VGICP loop below is held to, and serves the matches (with_matches).
//
// The VGICP registration loop on the card (vgicp_register_kernel): kernels F
// and M as one cooperative launch per registration on the tile backend
// (K9 + K11b + K3 and the loop around them).
//
// Replaces elimaloc_tpu/register/icp.py:run_register's lax.while_loop
// (:588-821, the loop at :821) for VGICP on the tile backend: every
// iteration's search + GN partials (tiles.py:nearest_voxel_cov_slots :803 +
// icp.py:_voxcov_tail :354; the radar form :361-363), the fixed-order
// reduction, the LM step (icp.py:_solve_step :202, _step_transform :209,
// the body :761-795) and the termination test, with the same trip count and
// carry. The host loop it replaces on the card was three launches (kernel
// F's search, reduce_partials_kernel, kernel M) and one stop-flag readback
// per iteration.
//
// Design: as the GICP loop (gicp.cu) around kernel F's slot code
// (vgicp.cuh: vgicp_slot, one __noinline__ copy in this translation unit
// that kernel F and the loop both call), M's step with gicp = 0; the radar
// form is its own instantiation. The shared memory is F's: the staged
// voxel means and coords (24 KB static) and the slot's [qb, 44] rows
// (dynamic), which the reduction reuses. The result equals the
// three-launch chain's bit for bit. Lanes: as the GICP loop's (gicp.cu),
// an instantiation of its own on gn_loop_lanes, and the radar form's
// lane form another.
// Bound: as kernel F's per iteration, times the iterations; grid.sync and
// the serial LM step are latency.
#include "gn_loop.cuh"
#include "vgicp.cuh"

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
  __shared__ CubeShared sm;
  extern __shared__ float part[];  // [qb, kGnSums]
  vgicp_slot<kRadar>(blockIdx.x, vmean, vcov, vcoord, mhv, slot_tile, sbuf, qmask, qb, pose,
                     max_dist, voxel, tile_size, tx0, ty0, ty_dim, radar, partials, cov_out,
                     mean_out, ok_out, sm, part);
}

// One slot of kernel F at the staged pose, as GicpSlots (gicp.cu): lane
// ``lane``'s slot block and partial rows; one registration's is lane 0.
template <bool kRadar>
struct VgicpSlots {
  const float* vmean;
  const float* vcov;
  const int* vcoord;
  int mhv;
  const int* slot_tile;
  const float* sbuf;
  const bool* qmask;
  int s, qb, rows;
  const float* max_dist;
  float voxel, tile_size;
  int tx0, ty0, ty_dim;
  const float* radar;
  float* partials;
  CubeShared* sm;
  float* part;
  __device__ __forceinline__ void operator()(int lane, int slot, const float* pose) const {
    const size_t block = (size_t)lane * s * qb;
    vgicp_slot<kRadar>(slot, vmean, vcov, vcoord, mhv, slot_tile + (size_t)lane * s,
                       sbuf + 3 * block, qmask + block, qb, pose, max_dist, voxel, tile_size,
                       tx0, ty0, ty_dim, kRadar ? radar + 9 * block : radar,
                       partials + (size_t)lane * rows * kGnSums,
                       nullptr, nullptr, nullptr, *sm, part);
  }
  __device__ __forceinline__ void operator()(int slot, const float* pose) const {
    (*this)(0, slot, pose);
  }
};

template <bool kRadar, bool kLanes>
__global__ void __launch_bounds__(kThreads) vgicp_register_kernel(
    const float* __restrict__ vmean, const float* __restrict__ vcov,
    const int* __restrict__ vcoord, int mhv, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int s, int qb,
    const float* __restrict__ max_dist, float voxel, float tile_size, int tx0, int ty0,
    int ty_dim, const float* __restrict__ radar, const GnLoop loop) {
  __shared__ CubeShared sm;
  extern __shared__ float part[];  // [qb, kGnSums]; the reduction's 256 floats after
  const VgicpSlots<kRadar> slots{vmean,     vcov, vcoord, mhv,       slot_tile, sbuf,
                                 qmask,     s,    qb,     loop.rows, max_dist,  voxel,
                                 tile_size, tx0,  ty0,    ty_dim,    radar,     loop.partials,
                                 &sm,       part};
  if constexpr (kLanes)
    gn_loop_lanes(loop, s, slots, part);
  else
    gn_loop(loop, s, slots, part);
}

const void* loop_kernel(TileLoop form) {
  switch (form) {
    case kRadarForm:
      return (const void*)vgicp_register_kernel<true, false>;
    case kLaneForm:
      return (const void*)vgicp_register_kernel<false, true>;
    case kRadarLaneForm:
      return (const void*)vgicp_register_kernel<true, true>;
    default:
      return (const void*)vgicp_register_kernel<false, false>;
  }
}

}  // namespace

extern "C" int elm_vgicp_search_reduce(
    const float* vmean, const float* vcov, const int* vcoord, int mhv,
    const int* slot_tile, const float* sbuf, const bool* qmask, int s, int qb,
    const float* pose, const float* max_dist, float voxel, float tile_size, int tx0,
    int ty0, int ty_dim, const float* radar, float* partials, float* sums, float* cov_out,
    float* mean_out, bool* ok_out, cudaStream_t stream) {
  const int smem = rows_smem(qb);
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

// The co-resident CTAs of the loop kernel on the current device for slot
// blocks of ``qb`` queries: the radar form with ``radar`` != 0, the lane
// form of either with ``lanes`` > 1.
extern "C" int elm_vgicp_register_capacity(int qb, int radar, int lanes, int* ctas) {
  const TileLoop form = tile_loop(radar != 0, lanes);
  return tile_loop_capacity(loop_kernel(form), qb, form, ctas);
}

// ``lanes`` registrations, as elm_gicp_register (gicp.cu): the inputs, the
// carry, the flags, the iterations and the scratch at their lane strides;
// the radar forms take ``radar`` [lanes, s, qb, 3, 3].
extern "C" int elm_vgicp_register(
    const float* vmean, const float* vcov, const int* vcoord, int mhv, const int* slot_tile,
    const float* sbuf, const bool* qmask, int s, int qb, const float* pose,
    const float* fitness, const float* local_cov, const float* total, const float* max_dist,
    const float* min_overlap_ratio, const float* lm_lambda,
    const float* termination_threshold, int max_iteration, float voxel, float tile_size,
    int tx0, int ty0, int ty_dim, const float* radar, int lanes, float* partials,
    float* sums, int* counters, float* carry, bool* flags, int* iterations,
    cudaStream_t stream) {
  const bool r = radar != nullptr;
  if (lanes < 1 || lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  const GnLoop loop{pose, fitness, local_cov, total, min_overlap_ratio, lm_lambda,
                    termination_threshold, max_iteration, kGnSums, 0, partials, sums,
                    counters, carry, flags, iterations, lanes, s > 1 ? s : 1};
  void* args[] = {&vmean, &vcov, &vcoord, &mhv, &slot_tile, &sbuf, &qmask, &s, &qb,
                  &max_dist, &voxel, &tile_size, &tx0, &ty0, &ty_dim, &radar,
                  (void*)&loop};
  const TileLoop form = tile_loop(r, lanes);
  return launch_tile_loop(loop_kernel(form), s * lanes, qb, form, args, stream);
}
