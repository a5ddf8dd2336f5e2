// Kernel A: fused P2P correspondence search + Gauss-Newton partials.
//
// Replaces elimaloc_tpu/map/tiles.py:nearest_point_slots (:712, with
// _slot_centers :648 and _cube_mask :663) and register/icp.py:_p2p_tail
// (:283) for one GN iteration. The P2P registration on the card runs the
// same slot code (correspond.cuh: p2p_slot) for every iteration in one
// launch of the loop kernel (p2p_register.cu); this one-iteration entry is
// the reference that loop is held to. On the TPU the search is a dense
// [QB, MHP] distance plane per slot plus a one-hot matmul to select the
// winner, because gathers are scalar-core-bound there; the GN sums run as
// separate reductions over the [S*QB] rows. On Hopper one CTA owns one
// slot:
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
#include "correspond.cuh"

using namespace elm;

namespace {

__global__ void p2p_search_kernel(
    const float* __restrict__ halo, int mhp, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb,
    const float* __restrict__ pose, const float* __restrict__ max_dist,
    float voxel, float tile_size, int tx0, int ty0, int ty_dim,
    float* __restrict__ partials, float* __restrict__ tgt_out,
    bool* __restrict__ ok_out) {
  __shared__ P2pShared sm;
  p2p_slot(blockIdx.x, halo, mhp, slot_tile, sbuf, qmask, qb, pose, max_dist[0], voxel,
           tile_size, tx0, ty0, ty_dim, partials, tgt_out, ok_out, sm);
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
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(partials, s, kP2pParts, sums);
  return (int)cudaGetLastError();
}
