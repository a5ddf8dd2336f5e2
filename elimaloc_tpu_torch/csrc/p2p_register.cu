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
// Design: a cooperative (persistent) grid of min(S, co-resident CTAs)
// CTAs of 256 threads. Per iteration:
//   1. each CTA stages the current pose in shared memory (the carry, read
//      past L1 with __ldcg: CTA 0 wrote it in the previous iteration of this
//      launch) and takes slots from a global counter (one atomicAdd per
//      slot, as the block scheduler hands kernel A's one-slot CTAs to free
//      SMs: the live slots are the first ones, so a fixed stride would
//      leave a third of the CTAs a slot behind): kernel A's slot code
//      (correspond.cuh: p2p_slot), the same [S, 18] partials, each in its
//      slot's row, so the order of the sums does not depend on who took it;
//   2. grid.sync(); CTAs 0-17 reduce one column of the partials each, in
//      reduce_partials_kernel's order (thread t adds rows t, t + 256, ...
//      in order, then the same shared-memory tree): one CTA doing all 18
//      columns, as that kernel does, waits on 18 x S / 256 L2 loads a
//      thread, several times the column's own latency;
//   3. grid.sync(); thread 0 of CTA 0 runs kernel M's step (gn_step.cuh:
//      gn_update, out of line) on the 18 sums into the carry and the flags;
//   4. grid.sync(); every thread reads the stop flag (volatile) and the
//      loop ends on it or at max_iteration.
// The two slot counters alternate between iterations: CTA 0 zeroes the next
// one during the LM step, both before a first grid.sync at the start.
// The pose, local_cov, fitness, overlap and flags are kernel M's, the
// iteration count the host loop's, so the result equals the three-launch
// chain's bit for bit. max_iteration == 0 returns the initial carry after 0
// iterations; S == 0 (one CTA, zero sums) fails the overlap gate after 1.
// Bound: as kernel A's per iteration, times the iterations (FP32 issue and
// shared memory in the candidate scan; grid.sync and the serial LM step are
// latency).
#include <cooperative_groups.h>

#include <algorithm>

#include "correspond.cuh"
#include "gn_step.cuh"

namespace cg = cooperative_groups;
using namespace elm;

namespace {

// What the entry returns when the card cannot launch a cooperative kernel,
// or when not one CTA of this one fits an SM (the wrapper raises).
constexpr int kNoCooperative = -2;
constexpr int kNoRoom = -3;

// Kernel M's step (gn_step.cuh) out of line: the LU's registers and stack
// stay out of the search's register allocation.
__device__ __noinline__ void lm_step(const float* sums, const float* pose, float fitness,
                                     const float* local_cov, float total,
                                     float min_overlap_ratio, float lambda,
                                     float termination_threshold, float* out, bool* flags) {
  gn_update(sums, kP2pSums, pose, fitness, local_cov, total, min_overlap_ratio, lambda,
            termination_threshold, 0, out, flags);
}

// Column k of the [s, 18] slot partials summed into sums[k] exactly as
// reduce_partials_kernel sums it: thread t adds rows t, t + 256, ... in
// order, then the same shared-memory tree over ``buf`` (kThreads floats).
// Every thread of the CTA calls it.
__device__ __forceinline__ void reduce_column(const float* partials, int s, int k, float* buf,
                                              float* sums) {
  float acc = 0.0f;
  for (int r = threadIdx.x; r < s; r += kThreads)
    acc += __ldcg(partials + (size_t)r * kP2pParts + k);
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[k] = buf[0];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 4) p2p_register_kernel(
    const float* __restrict__ halo, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int s, int qb,
    const float* __restrict__ pose0, const float* __restrict__ fitness0,
    const float* __restrict__ local_cov0, const float* __restrict__ total,
    const float* __restrict__ max_dist, const float* __restrict__ min_overlap_ratio,
    const float* __restrict__ lm_lambda, const float* __restrict__ termination_threshold,
    int max_iteration, float voxel, float tile_size, int tx0, int ty0, int ty_dim,
    float* partials, float* sums, int* counters, float* carry, bool* flags,
    int* iterations) {
  cg::grid_group grid = cg::this_grid();
  __shared__ P2pShared sm;
  __shared__ float pose[16];
  __shared__ int taken;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if (lead) {  // the initial carry (run_register: fitness = overlap = 0, not failed)
    for (int e = 0; e < 16; ++e) carry[e] = pose0[e];
    for (int e = 0; e < 36; ++e) carry[16 + e] = local_cov0[e];
    carry[52] = *fitness0;
    carry[53] = 0.0f;
    flags[0] = flags[1] = false;
    counters[0] = counters[1] = 0;
  }
  const float md = *max_dist;
  int it = 0;
  if (max_iteration > 0) grid.sync();  // the counters are zero
  while (it < max_iteration) {
    if (threadIdx.x < 16)
      pose[threadIdx.x] = it == 0 ? pose0[threadIdx.x] : __ldcg(carry + threadIdx.x);
    int* counter = counters + (it & 1);
    for (;;) {
      if (threadIdx.x == 0) taken = atomicAdd(counter, 1);
      __syncthreads();  // (also publishes the staged pose)
      const int slot = taken;
      if (slot >= s) break;  // the whole CTA leaves together
      p2p_slot(slot, halo, mhp, slot_tile, sbuf, qmask, qb, pose, md, voxel, tile_size, tx0,
               ty0, ty_dim, partials, nullptr, nullptr, sm);
    }
    grid.sync();
    for (int k = blockIdx.x; k < kP2pParts; k += gridDim.x)
      reduce_column(partials, s, k, sm.part, sums);
    grid.sync();
    if (blockIdx.x == 0) {
      if (threadIdx.x == 0) {
        float p[16], cov[36], sum[kP2pSums];
        for (int k = 0; k < kP2pSums; ++k) sum[k] = __ldcg(sums + k);
        for (int e = 0; e < 16; ++e) p[e] = carry[e];
        for (int e = 0; e < 36; ++e) cov[e] = carry[16 + e];
        lm_step(sum, p, carry[52], cov, *total, *min_overlap_ratio, *lm_lambda,
                *termination_threshold, carry, flags);
        counters[(it + 1) & 1] = 0;  // no CTA takes from it until the next iteration
      }
    }
    ++it;
    grid.sync();
    if (*(volatile const bool*)flags) break;
  }
  if (lead) *iterations = it;
}

// The most CTAs of the loop kernel that the current device holds at once
// (0 when none fits), or kNoCooperative; cached per device.
int capacity(int* ctas) {
  constexpr int kDevices = 64;
  static int cached[kDevices];
  static bool known[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kDevices && known[dev]) {
    *ctas = cached[dev];
    return 0;
  }
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return kNoCooperative;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p2p_register_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *ctas = per_sm * sms;
  if (dev < kDevices) {
    cached[dev] = *ctas;
    known[dev] = true;
  }
  return 0;
}

}  // namespace

// The co-resident CTAs of the loop kernel on the current device.
extern "C" int elm_p2p_register_capacity(int* ctas) { return capacity(ctas); }

// carry: pose [4, 4], local_cov [6, 6], fitness, overlap; flags: stop,
// failed; iterations: int32. Scratch: partials [max(s, 1), 18], sums
// [18], counters [2].
extern "C" int elm_p2p_register(
    const float* halo, int mhp, const int* slot_tile, const float* sbuf, const bool* qmask,
    int s, int qb, const float* pose, const float* fitness, const float* local_cov,
    const float* total, const float* max_dist, const float* min_overlap_ratio,
    const float* lm_lambda, const float* termination_threshold, int max_iteration,
    float voxel, float tile_size, int tx0, int ty0, int ty_dim, float* partials, float* sums,
    int* counters, float* carry, bool* flags, int* iterations, cudaStream_t stream) {
  int ctas = 0;
  const int rc = capacity(&ctas);
  if (rc != 0) return rc;
  if (ctas == 0) return kNoRoom;
  const int grid = std::max(1, std::min(s, ctas));
  void* args[] = {&halo, &mhp, &slot_tile, &sbuf, &qmask, &s, &qb, &pose, &fitness,
                  &local_cov, &total, &max_dist, &min_overlap_ratio, &lm_lambda,
                  &termination_threshold, &max_iteration, &voxel, &tile_size, &tx0, &ty0,
                  &ty_dim, &partials, &sums, &counters, &carry, &flags, &iterations};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)p2p_register_kernel,
                                                    dim3(grid), dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
