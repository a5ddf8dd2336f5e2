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
// Kernel E's one-iteration entry (elm_gicp_search_reduce) is the reference
// the GICP loop below is held to, and serves the matches (with_matches).
//
// The GICP registration loop on the card (gicp_register_kernel): kernels E
// and M as one cooperative launch per registration on the tile backend
// (K1 with the point covariances + K11a + K3 and the loop around them).
//
// Replaces elimaloc_tpu/register/icp.py:run_register's lax.while_loop
// (:588-821, the loop at :821) for GICP on the tile backend: every
// iteration's search + GN partials (tiles.py:nearest_point_slots :712 with
// with_point_cov + icp.py:_gicp_tail :324; the radar form :331-333), the
// fixed-order reduction, the LM step (icp.py:_solve_step :202,
// _step_transform :209, the body :761-795, local_cov = inv(JTJ + lambda
// diag) exported as GICP's) and the termination test, with the same trip
// count and carry. The host loop it replaces on the card was three launches
// (kernel E's search, reduce_partials_kernel, kernel M) and one stop-flag
// readback per iteration.
//
// Design: gn_loop.cuh's loop (a cooperative grid of min(S, co-resident
// CTAs) CTAs of 256 threads, slots from an alternating atomic counter, the
// 44 columns reduced one a CTA in reduce_partials_kernel's order, M's step
// out of line on CTA 0 with gicp = 1, the stop flag after the last
// grid.sync()) around kernel E's slot code (gicp.cuh: gicp_slot, the
// matches not written; one __noinline__ copy in this translation unit,
// which kernel E and the loop both call, so the loop rounds as E does
// instruction for instruction), the same [S, 44] partials, each in its
// slot's row; the radar form is its own instantiation. The shared memory
// is E's: the staged candidates (24 KB static) and the slot's [qb, 44]
// rows (dynamic), which the reduction reuses. The grid is sized per
// instantiation and qb with cudaOccupancyMaxActiveBlocksPerMultiprocessor.
// The tile geometry comes in as host ints, so a window swap only hands new
// tensors and ints to the next launch. The result equals the three-launch
// chain's bit for bit.
// Lanes: one launch serves a fleet of B registrations (replay_fused_fleet's
// vmap of run_register, elimaloc_tpu/parallel/sharding.py:256-281), lane l
// on its own slots (slot_tile [B, S], sbuf [B, S, qb, 3], qmask [B, S, qb])
// and carry, through gn_loop_lanes (gn_loop.cuh), as the P2P loop's
// (p2p_register.cu): the grid is min(B x S, co-resident CTAs), the counter
// hands out (lane, slot) over the lanes still iterating, each lane's LM step
// (local_cov exported per lane) runs on one CTA; each lane is its single
// registration, bit for bit. The lane form is an instantiation of its own
// (kLanes, launched for lanes > 1): on gn_loop_lanes the single loop took
// 110 registers (2 CTAs an SM, 80 on gn_loop) and ~5% more device time a
// registration. The launch bound keeps both at 80 registers, 3 CTAs an
// SM. The radar form has its lane form too (kRadarLaneForm: radar
// [B, S, qb, 3, 3] at the lane stride, a lane's rows where its slots are).
// A fleet frame of more than kMaxLanes lanes is launched in parts by the
// wrapper.
// Bound: as kernel E's per iteration, times the iterations; grid.sync and
// the serial LM step are latency.
#include "gicp.cuh"
#include "gn_loop.cuh"

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
  __shared__ CubeShared sm;
  extern __shared__ float part[];  // [qb, kGnSums]
  gicp_slot<kRadar>(blockIdx.x, halo, pcov, pmean, mhp, slot_tile, sbuf, qmask, qb, pose,
                    max_dist, voxel, tile_size, tx0, ty0, ty_dim, radar, partials, cov_out,
                    mean_out, ok_out, sm, part);
}

// One slot of kernel E at the staged pose: gn_loop_lanes' ``slots(lane,
// slot, pose)``, lane ``lane``'s slot block and partial rows at its lane
// stride; gn_loop's ``slots(slot, pose)`` (one registration) is lane 0.
template <bool kRadar>
struct GicpSlots {
  const float* halo;
  const float* pcov;
  const float* pmean;
  int mhp;
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
    gicp_slot<kRadar>(slot, halo, pcov, pmean, mhp, slot_tile + (size_t)lane * s,
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
__global__ void __launch_bounds__(kThreads, 3) gicp_register_kernel(
    const float* __restrict__ halo, const float* __restrict__ pcov,
    const float* __restrict__ pmean, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int s, int qb,
    const float* __restrict__ max_dist, float voxel, float tile_size, int tx0, int ty0,
    int ty_dim, const float* __restrict__ radar, const GnLoop loop) {
  __shared__ CubeShared sm;
  extern __shared__ float part[];  // [qb, kGnSums]; the reduction's 256 floats after
  const GicpSlots<kRadar> slots{halo,     pcov,  pmean,     mhp, slot_tile, sbuf,
                                qmask,    s,     qb,        loop.rows, max_dist, voxel,
                                tile_size, tx0,  ty0,       ty_dim, radar,    loop.partials,
                                &sm,      part};
  if constexpr (kLanes)
    gn_loop_lanes(loop, s, slots, part);
  else
    gn_loop(loop, s, slots, part);
}

const void* loop_kernel(TileLoop form) {
  switch (form) {
    case kRadarForm:
      return (const void*)gicp_register_kernel<true, false>;
    case kLaneForm:
      return (const void*)gicp_register_kernel<false, true>;
    case kRadarLaneForm:
      return (const void*)gicp_register_kernel<true, true>;
    default:
      return (const void*)gicp_register_kernel<false, false>;
  }
}

}  // namespace

extern "C" int elm_gicp_search_reduce(
    const float* halo, const float* pcov, const float* pmean, int mhp,
    const int* slot_tile, const float* sbuf, const bool* qmask, int s, int qb,
    const float* pose, const float* max_dist, float voxel, float tile_size, int tx0,
    int ty0, int ty_dim, const float* radar, float* partials, float* sums, float* cov_out,
    float* mean_out, bool* ok_out, cudaStream_t stream) {
  const int smem = rows_smem(qb);
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

// The co-resident CTAs of the loop kernel on the current device for slot
// blocks of ``qb`` queries: the radar form with ``radar`` != 0, the lane
// form of either with ``lanes`` > 1.
extern "C" int elm_gicp_register_capacity(int qb, int radar, int lanes, int* ctas) {
  const TileLoop form = tile_loop(radar != 0, lanes);
  return tile_loop_capacity(loop_kernel(form), qb, form, ctas);
}

// ``lanes`` registrations (1 <= lanes <= kMaxLanes), each lane's inputs and outputs at its lane stride: slot_tile
// [lanes, s], sbuf [lanes, s, qb, 3], qmask [lanes, s, qb], pose [lanes, 4,
// 4], fitness [lanes], local_cov [lanes, 6, 6], total [lanes]. carry: pose
// [lanes, 4, 4], local_cov [lanes, 6, 6], fitness [lanes], overlap [lanes];
// flags: stop [lanes], failed [lanes]; iterations: int32 [lanes]. Scratch:
// partials [lanes, max(s, 1), 44], sums [lanes, 44], counters [2]. ``radar``
// [lanes, s, qb, 3, 3] or null (the radar forms).
extern "C" int elm_gicp_register(
    const float* halo, const float* pcov, const float* pmean, int mhp, const int* slot_tile,
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
                    termination_threshold, max_iteration, kGnSums, 1, partials, sums,
                    counters, carry, flags, iterations, lanes, s > 1 ? s : 1};
  void* args[] = {&halo, &pcov, &pmean, &mhp, &slot_tile, &sbuf, &qmask, &s, &qb,
                  &max_dist, &voxel, &tile_size, &tx0, &ty0, &ty_dim, &radar,
                  (void*)&loop};
  const TileLoop form = tile_loop(r, lanes);
  return launch_tile_loop(loop_kernel(form), s * lanes, qb, form, args, stream);
}
