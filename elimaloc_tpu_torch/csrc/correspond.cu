// Kernel A: fused P2P correspondence search + Gauss-Newton partials.
//
// Replaces elimaloc_tpu/map/tiles.py:nearest_point_slots (:712, with
// _slot_centers :648 and _cube_mask :663) and register/icp.py:_p2p_tail
// (:283). On the TPU the search is a dense [QB, MHP] distance plane per slot
// plus a one-hot matmul to select the winner, because gathers are
// scalar-core-bound there; the GN sums run as separate reductions over the
// [S*QB] rows. On Hopper one CTA owns one slot:
//   1-3. the slot search shared with kernels E, F and G (common.cuh:
//      slot_query, PointStage, cube_argmin): the slot's halo row (MHP
//      points, 8.5 KB at MHP=711) is staged in shared memory in
//      1024-candidate chunks as tile-local coordinates and voxel coords
//      (non-finite pads get a far voxel so the cube test rejects them and
//      +inf never enters arithmetic); each query q = R s + t is formed in the
//      fixed order ((R0 s0 + R1 s1) + R2 s2) + t with its voxel
//      floor(q / voxel); QB groups of 256/QB threads scan the candidates:
//      the 27-voxel cube test, d2 as the exact ((dx^2 + dy^2) + dz^2) sum
//      with no FMA (so it equals the plain PyTorch version bit for bit), the
//      argmin with ties to the lower candidate index, then a shuffle
//      reduction inside the group with the same tie rule;
//   4. the d2 < max_dist^2 gate, the sensor-frame residual, the robust weight
//      th^2 / (th + r^2)^2, and the slot's 18 partial sums (sum w, sum w p,
//      sum w p p^T, sum w r, sum w p x r, fitness numerator, matched count)
//      summed over the slot's queries in query order;
//   5. a second single-CTA kernel (common.cuh: reduce_partials_kernel)
//      reduces the [S, 18] partials in a fixed order, so a float32 result is
//      the same on every run. No atomics.
// Bound: the distance plane, S * QB * MHP candidate tests (~2000 * 16 * 711
// = 23M per GN iteration at the headline scan), i.e. FP32 instruction rate and shared
// memory bandwidth, not HBM (the halo rows read are ~17 MB per pass).
#include "common.cuh"

using namespace elm;

namespace {

constexpr int kParts = 18;    // partial sums per slot

__global__ void p2p_search_kernel(
    const float* __restrict__ halo, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb,
    const float* __restrict__ pose, const float* __restrict__ max_dist,
    float voxel, float tile_size, int tx0, int ty0, int ty_dim,
    float* __restrict__ partials, float* __restrict__ tgt_out,
    bool* __restrict__ ok_out) {
  __shared__ float cl[kChunk * 3];
  __shared__ int cv[kChunk * 3];
  __shared__ float part[kThreads * kParts];  // qb <= 256 rows of kParts
  __shared__ int any_live;

  const SlotQuery u = slot_query(slot_tile, sbuf, qmask, qb, pose, voxel,
                                 tile_size, tx0, ty0, ty_dim);
  const bool live_slot = slot_any_live(u, &any_live);
  const float* hrow = halo + (size_t)u.tile * mhp * 3;
  float best_d2;
  int best;
  cube_argmin(u, live_slot, mhp, PointStage{hrow, u.c0, u.c1, voxel}, cl, cv,
              best_d2, best);

  if (u.gl == 0) {
    const float md = max_dist[0];
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
    float* pr = part + u.j * kParts;
    for (int k = 0; k < kParts; ++k) pr[k] = 0.0f;
    if (ok) {
      const float r00 = u.r[0], r01 = u.r[1], r02 = u.r[2];
      const float r10 = u.r[3], r11 = u.r[4], r12 = u.r[5];
      const float r20 = u.r[6], r21 = u.r[7], r22 = u.r[8];
      const float t0 = u.t[0], t1 = u.t[1], t2 = u.t[2];
      const float s0 = u.s[0], s1 = u.s[1], s2 = u.s[2];
      // tgt in the sensor frame: R^T tgt - R^T t (lie.transform_inverse)
      const float it0 = -(r00 * t0 + r10 * t1 + r20 * t2);
      const float it1 = -(r01 * t0 + r11 * t1 + r21 * t2);
      const float it2 = -(r02 * t0 + r12 * t1 + r22 * t2);
      const float e0 = r00 * g0 + r10 * g1 + r20 * g2 + it0 - s0;
      const float e1 = r01 * g0 + r11 * g1 + r21 * g2 + it1 - s1;
      const float e2 = r02 * g0 + r12 * g1 + r22 * g2 + it2 - s2;
      const float r2 = e0 * e0 + e1 * e1 + e2 * e2;
      const float th = md;
      const float den = th + r2;
      const float w = th * th / (den * den);
      const float wp0 = w * s0, wp1 = w * s1, wp2 = w * s2;
      pr[0] = w;
      pr[1] = wp0;
      pr[2] = wp1;
      pr[3] = wp2;
      pr[4] = wp0 * s0;   // sum w p p^T: xx xy xz yy yz zz
      pr[5] = wp0 * s1;
      pr[6] = wp0 * s2;
      pr[7] = wp1 * s1;
      pr[8] = wp1 * s2;
      pr[9] = wp2 * s2;
      pr[10] = w * e0;    // sum w r
      pr[11] = w * e1;
      pr[12] = w * e2;
      pr[13] = wp1 * e2 - wp2 * e1;  // sum (w p) x r
      pr[14] = wp2 * e0 - wp0 * e2;
      pr[15] = wp0 * e1 - wp1 * e0;
      pr[16] = sqrtf(r2);
      pr[17] = 1.0f;
    }
  }
  __syncthreads();
  slot_partials(part, qb, kParts, partials + (size_t)blockIdx.x * kParts);
}

}  // namespace

extern "C" int elm_p2p_search_reduce(
    const float* halo, int mhp, const int* slot_tile, const float* sbuf,
    const bool* qmask, int s, int qb, const float* pose, const float* max_dist,
    float voxel, float tile_size, int tx0, int ty0, int ty_dim, float* partials,
    float* sums, float* tgt_out, bool* ok_out, cudaStream_t stream) {
  if (s > 0) {
    p2p_search_kernel<<<s, kThreads, 0, stream>>>(
        halo, mhp, slot_tile, sbuf, qmask, qb, pose, max_dist, voxel, tile_size,
        tx0, ty0, ty_dim, partials, tgt_out, ok_out);
  }
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(partials, s, kParts, sums);
  return (int)cudaGetLastError();
}
