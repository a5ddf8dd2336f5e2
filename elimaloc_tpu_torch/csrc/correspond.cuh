// One slot of the fused P2P correspondence search + Gauss-Newton partials
// (K1 + K2), shared by kernel A (correspond.cu: one CTA per slot, one GN
// iteration) and the P2P loop kernel (p2p_register.cu: each CTA walks
// slots, every iteration of the registration in one launch). See
// correspond.cu for the design.
#pragma once

#include "common.cuh"

namespace elm {

constexpr int kP2pParts = 18;  // partial sums per slot

// A CTA's shared memory for the search: the staged candidates, the slot's
// per-query partial rows and its live flag.
struct P2pShared {
  float cl[kChunk * 3];
  int cv[kChunk * 3];
  float part[kThreads * kP2pParts];  // qb <= 256 rows of kP2pParts
  int any_live;
};

// Slot ``slot`` at ``pose``: its 18 partial sums to partials[slot], and,
// when ``tgt_out`` is given, each query's target (its own q where
// unmatched) and match flag. Every thread of the CTA must call it (its
// barriers are CTA-uniform); a CTA may call it for several slots in turn.
__device__ __forceinline__ void p2p_slot(
    int slot, const float* __restrict__ halo, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb, const float* pose,
    float md, float voxel, float tile_size, int tx0, int ty0, int ty_dim, float* partials,
    float* tgt_out, bool* ok_out, P2pShared& sm) {
  const SlotQuery u = slot_query(slot, slot_tile, sbuf, qmask, qb, pose, voxel, tile_size,
                                 tx0, ty0, ty_dim);
  const bool live_slot = slot_any_live(u, &sm.any_live);
  const float* hrow = halo + (size_t)u.tile * mhp * 3;
  float best_d2;
  int best;
  cube_argmin(u, live_slot, mhp, PointStage{hrow, u.c0, u.c1, voxel}, sm.cl, sm.cv, best_d2,
              best);

  if (u.gl == 0) {
    const bool ok = u.live && best_d2 < mul(md, md);
    float g0 = u.q[0], g1 = u.q[1], g2 = u.q[2];
    if (ok) {
      g0 = hrow[3 * best];
      g1 = hrow[3 * best + 1];
      g2 = hrow[3 * best + 2];
    }
    const int row = u.row;
    if (tgt_out != nullptr) {
      tgt_out[3 * row] = g0;
      tgt_out[3 * row + 1] = g1;
      tgt_out[3 * row + 2] = g2;
      ok_out[row] = ok;
    }
    float* pr = sm.part + u.j * kP2pParts;
    for (int k = 0; k < kP2pParts; ++k) pr[k] = 0.0f;
    if (ok) {
      const float g[3] = {g0, g1, g2};
      p2p_row(u, g, md, pr);
    }
  }
  __syncthreads();
  slot_partials(sm.part, qb, kP2pParts, partials + (size_t)slot * kP2pParts);
}

}  // namespace elm
