// The registration's GN/LM loop on the card, shared by the loop kernels
// (p2p_register.cu; gicp.cu, vgicp.cu, avgicp.cu and hash_correspond.cu,
// beside their one-iteration kernels E, F, G and Q): one cooperative
// launch runs every iteration of one registration (K1 + K2 + K3 and the
// loop around them), with no readback.
//
// Replaces elimaloc_tpu/register/icp.py:run_register's lax.while_loop
// (:728-821): per iteration the method's search + GN partials, the
// fixed-order reduction, the LM step (icp.py:_solve_step :202,
// _step_transform :209, the body :761-795) and the termination test, with
// the same trip count and carry. The host loop it replaces on the card was
// three launches (the method's search, reduce_partials_kernel, kernel M) and
// one stop-flag readback per iteration.
//
// A loop kernel is a cooperative (persistent) grid of min(S, co-resident
// CTAs) CTAs, S the method's slots (rows of the [S, n_sums] partials). Per
// iteration (gn_loop):
//   1. each CTA stages the current pose in shared memory (the carry, read
//      past L1 with __ldcg: CTA 0 wrote it in the previous iteration of this
//      launch) and takes slots from a global counter (one atomicAdd per
//      slot, as the block scheduler hands the one-iteration kernel's
//      one-slot CTAs to free SMs: the live slots are the first ones, so a
//      fixed stride would leave some CTAs a slot behind), running the
//      method's slot code, which writes the slot's partials into its row,
//      so the order of the sums does not depend on who took it;
//   2. grid.sync(); CTAs 0..n_sums-1 reduce one column each in
//      reduce_partials_kernel's order (lane t of 256 adds rows t, t + 256,
//      ... in order, then the same shared-memory tree; a CTA of fewer
//      threads forms several lanes a thread): one CTA doing every column,
//      as that kernel does, waits on n_sums x S / 256 L2 loads a thread;
//   3. grid.sync(); thread 0 of CTA 0 runs kernel M's step (gn_step.cuh:
//      gn_update, out of line) on the sums into the carry and the flags;
//   4. grid.sync(); every thread reads the stop flag (volatile) and the
//      loop ends on it or at max_iteration.
// The two slot counters alternate between iterations: CTA 0 zeroes the next
// one during the LM step, both before a first grid.sync at the start.
// The pose, local_cov, fitness, overlap and flags are kernel M's, the
// iteration count the host loop's, so the result equals the three-launch
// chain's bit for bit. max_iteration == 0 returns the initial carry after 0
// iterations; S == 0 (one CTA, zero sums) fails the overlap gate after 1.
//
// The lane form (gn_loop_lanes, the lane instantiations of the P2P loop,
// of the GICP, VGICP and AVGICP loops and their radar forms, and of the hash
// loop for every method and radar form: a fleet of B registrations,
// each against its own slots, in one cooperative launch; replaces the
// jax.vmap of run_register inside replay_fused_fleet,
// elimaloc_tpu/parallel/sharding.py:256-281): the carry, the flags and the
// iteration count are per lane, field-major (pose [B, 16], local_cov
// [B, 36], fitness [B], overlap [B]; stop [B], failed [B]; iterations
// [B]), the partials [B, max(S, 1), n_sums], the sums [B, n_sums]. Per
// iteration each CTA lists the lanes not yet stopped (their stop flags,
// volatile, in lane order: every CTA finds the same list); the slot counter
// hands out (lane, slot) pairs over them, lane-major, and a CTA stages a
// lane's pose when the lane it takes changes; CTAs reduce the B x n_sums
// columns of the live lanes, each in reduce_column's order; then CTA j runs
// the LM step of live lanes j, j + grid, ... on its thread 0 (in parallel
// across CTAs), which writes that lane's carry, flags and iteration count.
// A stopped lane keeps its carry and its count; the loop ends when no lane
// is live or at max_iteration. Per lane the slots, the sums and the step
// are the single registration's, so lane l equals a one-lane launch on its
// inputs bit for bit, and one lane is the single loop; a lane with no live
// slot fails the overlap gate after one iteration, as a single run does.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "gn_step.cuh"

namespace elm {

// What a loop entry returns when the card cannot launch a cooperative
// kernel, or when not one CTA of the loop kernel fits an SM (the wrapper
// raises).
constexpr int kNoCooperative = -2;
constexpr int kNoRoom = -3;

// The loop's carry in, its constants and its outputs: carry = pose [16],
// local_cov [36], fitness, overlap; flags = stop, failed; scratch: partials
// [max(S, 1), n_sums], sums [n_sums], counters [2].
struct GnLoop {
  const float* pose0;
  const float* fitness0;
  const float* local_cov0;
  const float* total;
  const float* min_overlap_ratio;
  const float* lm_lambda;
  const float* termination_threshold;
  int max_iteration, n_sums, gicp;
  float* partials;
  float* sums;
  int* counters;
  float* carry;
  bool* flags;
  int* iterations;
  // the lane form's lanes and partial rows a lane (max(S, 1)); the single
  // loop reads neither
  int lanes, rows;
};

// The most lanes one launch of a lane form takes (its live-lane list is in
// shared memory); the wrappers run a larger fleet frame in launches of at
// most this many lanes (the lanes are independent: each one's result is
// the same in any launch).
constexpr int kMaxLanes = 128;

}  // namespace elm

namespace {

// Kernel M's step (gn_step.cuh) out of line: the LU's registers and stack
// stay out of the search's register allocation. (In an unnamed namespace: a
// non-static __noinline__ device function in a header gets a host symbol in
// every object that includes it.)
__device__ __noinline__ void lm_step(const float* sums, int n_sums, const float* pose,
                                     float fitness, const float* local_cov, float total,
                                     float min_overlap_ratio, float lambda,
                                     float termination_threshold, int gicp, float* out,
                                     bool* flags) {
  elm::gn_update(sums, n_sums, pose, fitness, local_cov, total, min_overlap_ratio, lambda,
                 termination_threshold, gicp, out, flags);
}

// Column k of the [s, np] slot partials summed into sums[k] exactly as
// reduce_partials_kernel sums it: lane t of its 256 adds rows t, t + 256,
// ... in order, then the same shared-memory tree over ``buf`` (256 floats).
// A CTA of fewer threads forms several lanes a thread. Every thread of the
// CTA calls it.
__device__ __forceinline__ void reduce_column(const float* partials, int s, int np, int k,
                                              float* buf, float* sums) {
  constexpr int kLanes = elm::kThreads;
  for (int l = threadIdx.x; l < kLanes; l += blockDim.x) {
    float acc = 0.0f;
    for (int r = l; r < s; r += kLanes) acc += __ldcg(partials + (size_t)r * np + k);
    buf[l] = acc;
  }
  __syncthreads();
  for (int h = kLanes / 2; h > 0; h >>= 1) {
    for (int l = threadIdx.x; l < h; l += blockDim.x) buf[l] += buf[l + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[k] = buf[0];
  __syncthreads();
}

// Every iteration of one registration (see above): ``slots(slot, pose)``
// runs one slot of the method's search at the staged ``pose`` (shared
// memory) and writes its partials into row ``slot``; every thread of the CTA
// calls it, for each slot the CTA takes. ``red``: 256 floats of shared
// memory for the reduction, free after the slots' grid.sync().
template <class Slots>
__device__ __forceinline__ void gn_loop(const elm::GnLoop& a, int n_slots, const Slots& slots,
                                        float* red) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ float pose[16];
  __shared__ int taken;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if (lead) {  // the initial carry (run_register: fitness = overlap = 0, not failed)
    for (int e = 0; e < 16; ++e) a.carry[e] = a.pose0[e];
    for (int e = 0; e < 36; ++e) a.carry[16 + e] = a.local_cov0[e];
    a.carry[52] = *a.fitness0;
    a.carry[53] = 0.0f;
    a.flags[0] = a.flags[1] = false;
    a.counters[0] = a.counters[1] = 0;
  }
  int it = 0;
  if (a.max_iteration > 0) grid.sync();  // the counters are zero
  while (it < a.max_iteration) {
    if (threadIdx.x < 16)
      pose[threadIdx.x] = it == 0 ? a.pose0[threadIdx.x] : __ldcg(a.carry + threadIdx.x);
    int* counter = a.counters + (it & 1);
    for (;;) {
      if (threadIdx.x == 0) taken = atomicAdd(counter, 1);
      __syncthreads();  // (also publishes the staged pose)
      const int slot = taken;
      if (slot >= n_slots) break;  // the whole CTA leaves together
      slots(slot, pose);
    }
    grid.sync();
    for (int k = blockIdx.x; k < a.n_sums; k += gridDim.x)
      reduce_column(a.partials, n_slots, a.n_sums, k, red, a.sums);
    grid.sync();
    if (lead) {
      float p[16], cov[36], sum[elm::kGnSums];
      for (int k = 0; k < a.n_sums; ++k) sum[k] = __ldcg(a.sums + k);
      for (int e = 0; e < 16; ++e) p[e] = a.carry[e];
      for (int e = 0; e < 36; ++e) cov[e] = a.carry[16 + e];
      lm_step(sum, a.n_sums, p, a.carry[52], cov, *a.total, *a.min_overlap_ratio,
              *a.lm_lambda, *a.termination_threshold, a.gicp, a.carry, a.flags);
      a.counters[(it + 1) & 1] = 0;  // no CTA takes from it until the next iteration
    }
    ++it;
    grid.sync();
    if (*(volatile const bool*)a.flags) break;
  }
  if (lead) *a.iterations = it;
}

// The lane form of gn_loop (see above): ``slots(lane, slot, pose)`` runs
// slot ``slot`` of lane ``lane`` at the staged ``pose`` and writes its
// partials into that lane's row ``slot``.
template <class Slots>
__device__ __forceinline__ void gn_loop_lanes(const elm::GnLoop& a, int n_slots,
                                              const Slots& slots, float* red) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ float pose[16];
  __shared__ int taken, n_live;
  __shared__ int live[elm::kMaxLanes];
  const int lanes = a.lanes, np = a.n_sums;
  float* c_pose = a.carry;
  float* c_cov = a.carry + 16 * lanes;
  float* c_fit = a.carry + 52 * lanes;
  float* c_overlap = a.carry + 53 * lanes;
  bool* stop = a.flags;
  bool* failed = a.flags + lanes;
  if (blockIdx.x == 0) {  // the initial carries (fitness = overlap = 0, not failed)
    for (int e = threadIdx.x; e < 16 * lanes; e += blockDim.x) c_pose[e] = a.pose0[e];
    for (int e = threadIdx.x; e < 36 * lanes; e += blockDim.x) c_cov[e] = a.local_cov0[e];
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
      c_fit[l] = a.fitness0[l];
      c_overlap[l] = 0.0f;
      stop[l] = failed[l] = false;
      a.iterations[l] = 0;
    }
    if (threadIdx.x == 0) a.counters[0] = a.counters[1] = 0;
  }
  if (a.max_iteration > 0) grid.sync();  // the counters are zero, the flags false
  for (int it = 0; it < a.max_iteration; ++it) {
    if (threadIdx.x == 0) {
      int n = 0;
      for (int l = 0; l < lanes; ++l)
        if (!*(volatile const bool*)(stop + l)) live[n++] = l;
      n_live = n;
    }
    __syncthreads();
    const int nl = n_live;
    if (nl == 0) break;  // every CTA read the same flags
    const int work = nl * n_slots;
    int* counter = a.counters + (it & 1);
    int staged = -1;
    for (;;) {
      if (threadIdx.x == 0) taken = atomicAdd(counter, 1);
      __syncthreads();
      const int g = taken;
      if (g >= work) break;  // the whole CTA leaves together
      const int k = g / n_slots;
      const int lane = live[k], slot = g - k * n_slots;
      if (lane != staged) {  // every thread is past the previous slot
        if (threadIdx.x < 16)
          pose[threadIdx.x] = it == 0 ? a.pose0[16 * lane + threadIdx.x]
                                      : __ldcg(c_pose + 16 * lane + threadIdx.x);
        staged = lane;
        __syncthreads();
      }
      slots(lane, slot, pose);
    }
    grid.sync();
    for (int c = blockIdx.x; c < nl * np; c += gridDim.x) {
      const int lane = live[c / np];
      reduce_column(a.partials + (size_t)lane * a.rows * np, n_slots, np, c % np, red,
                    a.sums + lane * np);
    }
    grid.sync();
    if (threadIdx.x == 0) {
      for (int j = blockIdx.x; j < nl; j += gridDim.x) {
        const int lane = live[j];
        float p[16], cov[36], sum[elm::kGnSums], out[54];
        bool fl[2];
        for (int k = 0; k < np; ++k) sum[k] = __ldcg(a.sums + lane * np + k);
        for (int e = 0; e < 16; ++e) p[e] = __ldcg(c_pose + 16 * lane + e);
        for (int e = 0; e < 36; ++e) cov[e] = __ldcg(c_cov + 36 * lane + e);
        lm_step(sum, np, p, __ldcg(c_fit + lane), cov, a.total[lane], *a.min_overlap_ratio,
                *a.lm_lambda, *a.termination_threshold, a.gicp, out, fl);
        for (int e = 0; e < 16; ++e) c_pose[16 * lane + e] = out[e];
        for (int e = 0; e < 36; ++e) c_cov[36 * lane + e] = out[16 + e];
        c_fit[lane] = out[52];
        c_overlap[lane] = out[53];
        stop[lane] = fl[0];
        failed[lane] = fl[1];
        a.iterations[lane] = it + 1;
      }
      // no CTA takes from the other counter until the next iteration
      if (blockIdx.x == 0) a.counters[(it + 1) & 1] = 0;
    }
    grid.sync();
  }
}

// The most CTAs of ``kernel`` (``threads`` a CTA, ``smem`` bytes of dynamic
// shared memory, opted into up to ``max_smem``) that the current device
// holds at once (0 when none fits), or kNoCooperative; cached per device
// and ``key`` (< 32: one per kernel instantiation and shared-memory size
// the file launches).
inline int co_resident(const void* kernel, int threads, int smem, int max_smem, int key,
                       int* ctas) {
  constexpr int kDevices = 64, kKeys = 32;
  static int cached[kDevices][kKeys];
  static bool known[kDevices][kKeys];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool keep = dev < kDevices && key >= 0 && key < kKeys;
  if (keep && known[dev][key]) {
    *ctas = cached[dev][key];
    return 0;
  }
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return elm::kNoCooperative;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && max_smem > 0)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  *ctas = per_sm * sms;
  if (keep) {
    cached[dev][key] = *ctas;
    known[dev][key] = true;
  }
  return 0;
}

// One cooperative launch of a loop kernel over min(n_slots, co-resident
// CTAs) CTAs (at least one), or the error / kNoRoom.
inline int launch_loop(const void* kernel, int n_slots, int threads, int smem, int max_smem,
                       int key, void** args, cudaStream_t stream) {
  int ctas = 0;
  const int rc = co_resident(kernel, threads, smem, max_smem, key, &ctas);
  if (rc != 0) return rc;
  if (ctas == 0) return elm::kNoRoom;
  const int grid = n_slots < 1 ? 1 : (n_slots < ctas ? n_slots : ctas);
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The tile loops around kernels E, F and G (gicp.cu, vgicp.cu, avgicp.cu):
// the slot's [qb, kGnSums] rows are dynamic shared memory, which the
// reduction reuses (256 floats: qb >= 8), opted into up to the largest slot
// block a launch takes (kMaxQb, kernels/__init__.py _qb_of); one
// co-residency cache key per instantiation (TileLoop) and qb (a power of
// two in [8, 256]). Each tile loop has four instantiations: the single
// registration's on gn_loop (the lane form's extra live state would cost it
// registers), its radar form (single too), and the lane forms of both on
// gn_loop_lanes.
constexpr int kMaxQb = 256;

enum TileLoop { kSingle = 0, kRadarForm = 1, kLaneForm = 2, kRadarLaneForm = 3 };

// The instantiation a launch of ``lanes`` registrations takes (one lane:
// the single forms).
inline TileLoop tile_loop(bool radar, int lanes) {
  if (lanes > 1) return radar ? kRadarLaneForm : kLaneForm;
  return radar ? kRadarForm : kSingle;
}

inline int rows_smem(int qb) { return qb * elm::kGnSums * (int)sizeof(float); }

inline int qb_key(int qb, TileLoop form) {
  int k = 0;
  while ((8 << k) < qb) ++k;
  return 8 * (int)form + k;
}

// The co-resident CTAs of a tile loop kernel for slot blocks of ``qb``.
inline int tile_loop_capacity(const void* kernel, int qb, TileLoop form, int* ctas) {
  return co_resident(kernel, elm::kThreads, rows_smem(qb), rows_smem(kMaxQb), qb_key(qb, form),
                     ctas);
}

// One cooperative launch of a tile loop kernel over ``s`` slots of ``qb``.
inline int launch_tile_loop(const void* kernel, int s, int qb, TileLoop form, void** args,
                            cudaStream_t stream) {
  if (qb < 8 || qb > kMaxQb) return (int)cudaErrorInvalidValue;
  return launch_loop(kernel, s, elm::kThreads, rows_smem(qb), rows_smem(kMaxQb),
                     qb_key(qb, form), args, stream);
}

}  // namespace
