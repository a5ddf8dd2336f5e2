// Kernel G: fused AVGICP correspondence search + Gauss-Newton partials.
//
// Replaces elimaloc_tpu/map/tiles.py:all_voxel_cov_slots (:869) and
// register/icp.py:_avg_voxcov_tail (:381) with ops/lie.py:inv3x3 (:383). On
// the TPU each query's 7 face-adjacent voxel coords (map/grid.py:36
// OFFSETS_7) are matched against the whole halo row as a dense
// [QB, 7, MHV] equality tensor that doubles as a one-hot selector of the
// covs and means. On Hopper one CTA owns one slot:
//   1. the halo voxel coords (MHV = 240 at the halo margin 2 AVGICP maps
//      use) are staged in shared memory; unoccupied pads (coord sentinel
//      2^30) are staged as a far voxel that matches no offset;
//   2. each thread of a query's group scans its share of the candidates:
//      a candidate whose coord minus the query voxel is one of the 7
//      offsets claims that offset's slot (a coord occurs at most once per
//      halo row; the lowest index wins otherwise), then a shuffle min over
//      the group;
//   3. the query's first thread, for each found offset in OFFSETS_7 order,
//      reads the voxel's mean and covariance from device memory, gates on
//      d2 < max_dist^2 with d2 = |mu - q|^2 in WORLD coordinates
//      (tiles.py:893), weights w = th^2 / (th + d2)^2 (pairs with w < 0.01
//      leave the sums and the fitness), and accumulates P = sum w C^-1 and
//      bw = sum w C^-1 (mu - q) in the world frame; then A = R^T P R and
//      b = R^T bw once per point feed the row's J^T M J blocks and J^T M r.
//      ``matched`` counts (point, voxel) PAIRS, so the overlap ratio can
//      exceed 1 (a reference quirk, icp.py:22-24);
//   4. the slot's 44 partial sums, summed in query order, and the
//      fixed-order single-CTA reduction of the [S, 44] partials, as kernel E.
// Radar form (use_radar_cov, icp.py:551-562): the radar term inside the
// inverse breaks the world-frame reduction, so with a non-null ``radar``
// [S, QB, 9] the query's first thread takes each matched pair on its own,
// as the flattened _voxcov_tail does: the sensor-frame residual against the
// voxel mean, w = th^2 / (th + r^2)^2 with r^2 its squared norm, the 0.01
// cutoff, M = (R^T C R + radar)^-1 and the pair's J^T M J / J^T M r blocks
// added into the row's partials; the fitness numerator sums sqrt r^2 over
// the kept pairs and ``matched`` counts the matched pairs; the pairs the
// plain sums mask out still form their M (common.cuh: masked_radar_row).
// The partial-sum layout and the fixed-order reduction are the same.
// Bound: the S * QB * MHV coord comparisons (~2000 * 16 * 240 = 8M per GN
// iteration at the headline scan) and up to 7 3x3 inverses per query, FP32
// issue; the mean/cov reads are 48 B per found pair.
// Kernel G's one-iteration entry (elm_avgicp_search_reduce) is the
// reference the AVGICP loop below is held to.
//
// The AVGICP registration loop on the card (avgicp_register_kernel): kernels
// G and M as one cooperative launch per registration on the tile backend
// (K10 + K11c + K3 and the loop around them).
//
// Replaces elimaloc_tpu/register/icp.py:run_register's lax.while_loop
// (:728-821) for AVGICP on the tile backend: every iteration's search + GN
// partials (tiles.py:all_voxel_cov_slots :869 + icp.py:_avg_voxcov_tail
// :381; the radar form the flattened pairs of _voxcov_tail, :551-562), the
// fixed-order reduction, the LM step and the termination test, with the
// same trip count and carry. The host loop it replaces on the card was
// three launches (kernel G's search, reduce_partials_kernel, kernel M) and
// one stop-flag readback per iteration, ~8 iterations a headline frame.
//
// Design: gn_loop.cuh's loop (a cooperative grid of min(S, co-resident
// CTAs) CTAs of 256 threads, slots from an alternating atomic counter, the
// 44 columns reduced one a CTA in reduce_partials_kernel's order, M's step
// out of line on CTA 0, the stop flag after the last grid.sync()) around
// kernel G's slot code (avgicp.cuh: avgicp_slot, the matches not written;
// one __noinline__ copy in this translation unit, which kernel G and the
// loop both call, so the loop rounds as G does instruction for instruction:
// the body inlined into two kernels in two files rounded an AVGICP radar
// registration differently in its last bits),
// the same [S, 44] partials, each in its slot's row; the radar form is its
// own instantiation. The shared memory is G's: the staged voxel coords
// (12 KB static) and the slot's [qb, 44] rows (dynamic), which the
// reduction reuses. The grid is sized per instantiation and qb with
// cudaOccupancyMaxActiveBlocksPerMultiprocessor. G ignores the tile
// geometry (its gate runs in world coordinates), so a window swap only
// hands new tensors to the next launch. The result equals the
// three-launch chain's bit for bit. Lanes: as the GICP loop's (gicp.cu),
// an instantiation of its own on gn_loop_lanes, and the radar form's
// lane form another. A fleet frame's launch iterates until its slowest lane
// stops.
// Bound: as kernel G's per iteration (the S * QB * MHV coord comparisons
// and up to 7 3x3 inverses a query, FP32 issue), times the iterations;
// grid.sync and the serial LM step are latency.
#include "avgicp.cuh"
#include "gn_loop.cuh"

using namespace elm;

namespace {

template <bool kRadar>
__global__ void avgicp_search_kernel(
    const float* __restrict__ vmean, const float* __restrict__ vcov,
    const int* __restrict__ vcoord, int mhv, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb,
    const float* __restrict__ pose, const float* __restrict__ max_dist,
    float voxel, const float* __restrict__ radar, float* __restrict__ partials,
    float* __restrict__ cov_out, float* __restrict__ mean_out, bool* __restrict__ ok_out) {
  __shared__ AvgShared sm;
  extern __shared__ float part[];  // [qb, kGnSums]
  avgicp_slot<kRadar>(blockIdx.x, vmean, vcov, vcoord, mhv, slot_tile, sbuf, qmask, qb, pose,
                      max_dist, voxel, radar, partials, cov_out, mean_out, ok_out, sm, part);
}

// One slot of kernel G at the staged pose, as GicpSlots (gicp.cu): lane
// ``lane``'s slot block and partial rows; one registration's is lane 0.
template <bool kRadar>
struct AvgSlots {
  const float* vmean;
  const float* vcov;
  const int* vcoord;
  int mhv;
  const int* slot_tile;
  const float* sbuf;
  const bool* qmask;
  int s, qb, rows;
  const float* max_dist;
  float voxel;
  const float* radar;
  float* partials;
  AvgShared* sm;
  float* part;
  __device__ __forceinline__ void operator()(int lane, int slot, const float* pose) const {
    const size_t block = (size_t)lane * s * qb;
    avgicp_slot<kRadar>(slot, vmean, vcov, vcoord, mhv, slot_tile + (size_t)lane * s,
                        sbuf + 3 * block, qmask + block, qb, pose, max_dist, voxel,
                        kRadar ? radar + 9 * block : radar,
                        partials + (size_t)lane * rows * kGnSums, nullptr, nullptr, nullptr,
                        *sm, part);
  }
  __device__ __forceinline__ void operator()(int slot, const float* pose) const {
    (*this)(0, slot, pose);
  }
};

template <bool kRadar, bool kLanes>
__global__ void __launch_bounds__(kThreads, 3) avgicp_register_kernel(
    const float* __restrict__ vmean, const float* __restrict__ vcov,
    const int* __restrict__ vcoord, int mhv, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int s, int qb,
    const float* __restrict__ max_dist, float voxel, const float* __restrict__ radar,
    const GnLoop loop) {
  __shared__ AvgShared sm;
  extern __shared__ float part[];  // [qb, kGnSums]; the reduction's 256 floats after
  const AvgSlots<kRadar> slots{vmean, vcov, vcoord,   mhv,   slot_tile, sbuf,          qmask,
                               s,     qb,   loop.rows, max_dist, voxel, radar, loop.partials,
                               &sm,   part};
  if constexpr (kLanes)
    gn_loop_lanes(loop, s, slots, part);
  else
    gn_loop(loop, s, slots, part);
}

const void* loop_kernel(TileLoop form) {
  switch (form) {
    case kRadarForm:
      return (const void*)avgicp_register_kernel<true, false>;
    case kLaneForm:
      return (const void*)avgicp_register_kernel<false, true>;
    case kRadarLaneForm:
      return (const void*)avgicp_register_kernel<true, true>;
    default:
      return (const void*)avgicp_register_kernel<false, false>;
  }
}

}  // namespace

extern "C" int elm_avgicp_search_reduce(
    const float* vmean, const float* vcov, const int* vcoord, int mhv,
    const int* slot_tile, const float* sbuf, const bool* qmask, int s, int qb,
    const float* pose, const float* max_dist, float voxel, const float* radar,
    float* partials, float* sums, float* cov_out, float* mean_out, bool* ok_out,
    cudaStream_t stream) {
  const int smem = qb * kGnSums * (int)sizeof(float);
  // the radar form is its own instantiation: the reference form keeps its
  // registers
  const auto kernel =
      radar != nullptr ? avgicp_search_kernel<true> : avgicp_search_kernel<false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (s > 0) {
    kernel<<<s, kThreads, smem, stream>>>(
        vmean, vcov, vcoord, mhv, slot_tile, sbuf, qmask, qb, pose, max_dist, voxel,
        radar, partials, cov_out, mean_out, ok_out);
  }
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(partials, s, kGnSums, sums);
  return (int)cudaGetLastError();
}

// The co-resident CTAs of the loop kernel on the current device for slot
// blocks of ``qb`` queries: the radar form with ``radar`` != 0, the lane
// form of either with ``lanes`` > 1.
extern "C" int elm_avgicp_register_capacity(int qb, int radar, int lanes, int* ctas) {
  const TileLoop form = tile_loop(radar != 0, lanes);
  return tile_loop_capacity(loop_kernel(form), qb, form, ctas);
}

// ``lanes`` registrations, as elm_gicp_register (gicp.cu): the inputs, the
// carry, the flags, the iterations and the scratch at their lane strides;
// the radar forms take ``radar`` [lanes, s, qb, 3, 3].
extern "C" int elm_avgicp_register(
    const float* vmean, const float* vcov, const int* vcoord, int mhv, const int* slot_tile,
    const float* sbuf, const bool* qmask, int s, int qb, const float* pose,
    const float* fitness, const float* local_cov, const float* total, const float* max_dist,
    const float* min_overlap_ratio, const float* lm_lambda,
    const float* termination_threshold, int max_iteration, float voxel, const float* radar,
    int lanes, float* partials, float* sums, int* counters, float* carry, bool* flags,
    int* iterations, cudaStream_t stream) {
  const bool r = radar != nullptr;
  if (lanes < 1 || lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  const GnLoop loop{pose, fitness, local_cov, total, min_overlap_ratio, lm_lambda,
                    termination_threshold, max_iteration, kGnSums, 0, partials, sums,
                    counters, carry, flags, iterations, lanes, s > 1 ? s : 1};
  void* args[] = {&vmean, &vcov, &vcoord, &mhv, &slot_tile, &sbuf, &qmask, &s, &qb,
                  &max_dist, &voxel, &radar, (void*)&loop};
  const TileLoop form = tile_loop(r, lanes);
  return launch_tile_loop(loop_kernel(form), s * lanes, qb, form, args, stream);
}
