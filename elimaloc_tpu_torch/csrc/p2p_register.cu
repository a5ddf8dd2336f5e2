// The P2P registration loop on the card: kernels A and M as one cooperative
// launch per registration (K1 + K2 + K3 and the loop around them).
//
// Replaces elimaloc_tpu/register/icp.py:run_register's lax.while_loop
// (:728-821) for P2P on the tile backend: every iteration's search + GN
// partials (tiles.py:nearest_point_slots :712 + icp.py:_p2p_tail :283), the
// fixed-order reduction, the LM step (icp.py:_solve_step :202,
// _step_transform :209, the body :761-795) and the termination test, with
// the same trip count and carry. The host loop it replaces on the card was
// three launches (kernel A's search, reduce_partials_kernel, kernel M) and
// one stop-flag readback per iteration; this kernel is one launch and no
// readback: the host reads nothing until the frame's outputs are read.
//
// Design: gn_loop.cuh's loop (a cooperative grid of min(S, co-resident
// CTAs) CTAs of 256 threads, slots from an alternating atomic counter, the
// 18 columns reduced one a CTA in reduce_partials_kernel's order, M's step
// out of line on CTA 0, the stop flag after the last grid.sync()) around
// kernel A's slot code (correspond.cuh: p2p_slot), the same [S, 18]
// partials, each in its slot's row. The result equals the three-launch
// chain's bit for bit.
// Lanes: one launch serves a fleet of B registrations (replay_fused_fleet's
// vmap of run_register, elimaloc_tpu/parallel/sharding.py:256-281), lane l
// on its own slots (slot_tile [B, S], sbuf [B, S, qb, 3], qmask [B, S, qb])
// and carry, through gn_loop_lanes (gn_loop.cuh): the grid is min(B x S,
// co-resident CTAs), the counter hands out (lane, slot) over the lanes
// still iterating, each lane's LM step runs on one CTA. One lane is the
// single registration, bit for bit.
// Bound: as kernel A's per iteration, times the iterations (FP32 issue and
// shared memory in the candidate scan; grid.sync and the serial LM step are
// latency).
#include "correspond.cuh"
#include "gn_loop.cuh"

using namespace elm;

namespace {

// One slot of kernel A at the staged pose (gn_loop_lanes' ``slots``): lane
// ``lane``'s slot block and partial rows.
struct P2pSlots {
  const float* halo;
  int mhp;
  const int* slot_tile;
  const float* sbuf;
  const bool* qmask;
  int s, qb, rows;
  float md, voxel, tile_size;
  int tx0, ty0, ty_dim;
  float* partials;
  P2pShared* sm;
  __device__ __forceinline__ void operator()(int lane, int slot, const float* pose) const {
    const size_t block = (size_t)lane * s * qb;
    p2p_slot(slot, halo, mhp, slot_tile + (size_t)lane * s, sbuf + 3 * block, qmask + block,
             qb, pose, md, voxel, tile_size, tx0, ty0, ty_dim,
             partials + (size_t)lane * rows * kP2pParts, nullptr, nullptr, *sm);
  }
};

__global__ void __launch_bounds__(kThreads, 4) p2p_register_kernel(
    const float* __restrict__ halo, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int s, int qb,
    const float* __restrict__ max_dist, float voxel, float tile_size, int tx0, int ty0,
    int ty_dim, const GnLoop loop) {
  __shared__ P2pShared sm;
  const P2pSlots slots{halo, mhp, slot_tile, sbuf, qmask, s, qb, loop.rows, *max_dist, voxel,
                       tile_size, tx0, ty0, ty_dim, loop.partials, &sm};
  gn_loop_lanes(loop, s, slots, sm.part);
}

// The loop kernel's co-resident CTAs (one cache key: no dynamic shared
// memory).
int capacity(int* ctas) {
  return co_resident((const void*)p2p_register_kernel, kThreads, 0, 0, 0, ctas);
}

}  // namespace

// The co-resident CTAs of the loop kernel on the current device.
extern "C" int elm_p2p_register_capacity(int* ctas) { return capacity(ctas); }

// ``lanes`` registrations (1 <= lanes <= kMaxLanes), each lane's inputs
// and outputs at its lane stride: slot_tile [lanes, s], sbuf [lanes, s, qb,
// 3], qmask [lanes, s, qb], pose [lanes, 4, 4], fitness [lanes], local_cov
// [lanes, 6, 6], total [lanes]. carry: pose [lanes, 4, 4], local_cov
// [lanes, 6, 6], fitness [lanes], overlap [lanes]; flags: stop [lanes],
// failed [lanes]; iterations: int32 [lanes]. Scratch: partials [lanes,
// max(s, 1), 18], sums [lanes, 18], counters [2].
extern "C" int elm_p2p_register(
    const float* halo, int mhp, const int* slot_tile, const float* sbuf, const bool* qmask,
    int s, int qb, const float* pose, const float* fitness, const float* local_cov,
    const float* total, const float* max_dist, const float* min_overlap_ratio,
    const float* lm_lambda, const float* termination_threshold, int max_iteration,
    float voxel, float tile_size, int tx0, int ty0, int ty_dim, int lanes, float* partials,
    float* sums, int* counters, float* carry, bool* flags, int* iterations,
    cudaStream_t stream) {
  if (lanes < 1 || lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  const GnLoop loop{pose, fitness, local_cov, total, min_overlap_ratio, lm_lambda,
                    termination_threshold, max_iteration, kP2pParts, 0, partials, sums,
                    counters, carry, flags, iterations, lanes, s > 1 ? s : 1};
  void* args[] = {&halo, &mhp, &slot_tile, &sbuf, &qmask, &s, &qb, &max_dist, &voxel,
                  &tile_size, &tx0, &ty0, &ty_dim, (void*)&loop};
  return launch_loop((const void*)p2p_register_kernel, s * lanes, kThreads, 0, 0, 0, args,
                     stream);
}
