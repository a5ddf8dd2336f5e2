// One slot of the fused AVGICP correspondence search + Gauss-Newton partials
// (K10 + K11c), shared by kernel G (avgicp.cu: avgicp_search_kernel, one CTA
// per slot, one GN iteration) and the AVGICP loop kernel (avgicp.cu:
// avgicp_register_kernel, each CTA walks slots, every iteration of the
// registration in one launch). See avgicp.cu for the design. The slot body
// is __noinline__ and included by avgicp.cu alone: both kernels call one
// compiled copy, so they round alike.
#pragma once

#include "common.cuh"

namespace elm {

constexpr int kNone = 0x7fffffff;

// Index into OFFSETS_7 of the voxel offset (d0, d1, d2), or -1.
__device__ __forceinline__ int offset_index(int d0, int d1, int d2) {
  if (abs(d0) > 1 || abs(d1) > 1 || abs(d2) > 1) return -1;
  if (abs(d0) + abs(d1) + abs(d2) > 1) return -1;
  if (d0 != 0) return d0 > 0 ? 1 : 2;
  if (d1 != 0) return d1 > 0 ? 3 : 4;
  if (d2 != 0) return d2 > 0 ? 5 : 6;
  return 0;
}

// A CTA's static shared memory for the search: the staged voxel coords and
// the slot's live flag (the slot's [qb, kGnSums] rows are dynamic).
struct AvgShared {
  int cv[kChunk * 3];
  int any_live;
};

// Slot ``slot`` at ``pose``: its 44 partial sums to partials[slot] (the
// rows staged in ``part``, [qb, kGnSums] floats of shared memory), and,
// when ``cov_out`` is given, each query's 7 (cov, mean, ok). Every thread of
// the CTA must call it (its barriers are CTA-uniform); a CTA may call it for
// several slots in turn.
template <bool kRadar>
__device__ __noinline__ void avgicp_slot(
    int slot, const float* __restrict__ vmean, const float* __restrict__ vcov,
    const int* __restrict__ vcoord, int mhv, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb, const float* pose,
    const float* __restrict__ max_dist, float voxel, const float* __restrict__ radar,
    float* partials, float* cov_out, float* mean_out, bool* ok_out, AvgShared& sm,
    float* part) {
  int* cv = sm.cv;
  // tile centres are not needed: the gate runs in world coordinates
  const SlotQuery u = slot_query(slot, slot_tile, sbuf, qmask, qb, pose, voxel, 1.0f,
                                 0, 0, 1);
  const bool live_slot = slot_any_live(u, &sm.any_live);
  const size_t base = (size_t)u.tile * mhv;
  int found[7];
  for (int o = 0; o < 7; ++o) found[o] = kNone;
  if (live_slot) {
    for (int c0 = 0; c0 < mhv; c0 += kChunk) {
      const int cn = min(kChunk, mhv - c0);
      __syncthreads();
      for (int k = threadIdx.x; k < cn; k += kThreads) {
        const int* src = vcoord + (base + c0 + k) * 3;
        const bool occupied = src[0] != kCoordSentinel;
        for (int d = 0; d < 3; ++d) cv[3 * k + d] = occupied ? src[d] : kFarVoxel;
      }
      __syncthreads();
      if (!u.live) continue;
      for (int k = u.gl; k < cn; k += u.tpq) {
        const int o = offset_index(cv[3 * k] - u.qv[0], cv[3 * k + 1] - u.qv[1],
                                   cv[3 * k + 2] - u.qv[2]);
        if (o >= 0 && found[o] == kNone) found[o] = c0 + k;
      }
    }
  }
  for (int o = 0; o < 7; ++o)
    for (int sh = u.tpq / 2; sh > 0; sh >>= 1)
      found[o] = min(found[o], __shfl_down_sync(0xffffffffu, found[o], sh, u.tpq));

  if (u.gl == 0) {
    const float md = max_dist[0];
    AvgAcc acc = avg_acc();
    float* pr = part + u.j * kGnSums;
    for (int k = 0; k < kGnSums; ++k) pr[k] = 0.0f;
    for (int o = 0; o < 7; ++o) {
      float C[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
      float mu[3] = {u.q[0], u.q[1], u.q[2]};
      bool ok = false;
      float d[3] = {0.0f, 0.0f, 0.0f}, d2 = 0.0f;
      if (u.live && found[o] != kNone) {
        const size_t v = base + found[o];
        for (int k = 0; k < 3; ++k) d[k] = sub(vmean[v * 3 + k], u.q[k]);
        d2 = add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2]));
        ok = d2 < mul(md, md);
        if (ok) {
          for (int k = 0; k < 9; ++k) C[k] = vcov[v * 9 + k];
          for (int k = 0; k < 3; ++k) mu[k] = vmean[v * 3 + k];
        }
      }
      if (cov_out != nullptr) {
        const size_t pair = (size_t)u.row * 7 + o;
        for (int k = 0; k < 9; ++k) cov_out[pair * 9 + k] = C[k];
        for (int k = 0; k < 3; ++k) mean_out[pair * 3 + k] = mu[k];
        ok_out[pair] = ok;
      }
      avgicp_pair<kRadar>(u, ok, C, mu, d, d2, md, radar, acc, pr);
    }
    avgicp_finish<kRadar>(u, acc, pr);
  }
  __syncthreads();
  slot_partials(part, qb, kGnSums, partials + (size_t)slot * kGnSums);
}

}  // namespace elm
