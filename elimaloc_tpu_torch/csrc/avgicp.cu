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
#include "common.cuh"

using namespace elm;

namespace {

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

template <bool kRadar>
__global__ void avgicp_search_kernel(
    const float* __restrict__ vmean, const float* __restrict__ vcov,
    const int* __restrict__ vcoord, int mhv, const int* __restrict__ slot_tile,
    const float* __restrict__ sbuf, const bool* __restrict__ qmask, int qb,
    const float* __restrict__ pose, const float* __restrict__ max_dist,
    float voxel, const float* __restrict__ radar, float* __restrict__ partials,
    float* __restrict__ cov_out, float* __restrict__ mean_out, bool* __restrict__ ok_out) {
  __shared__ int cv[kChunk * 3];
  __shared__ int any_live;
  extern __shared__ float part[];  // [qb, kGnSums]

  // tile centres are not needed: the gate runs in world coordinates
  const SlotQuery u = slot_query(blockIdx.x, slot_tile, sbuf, qmask, qb, pose, voxel, 1.0f,
                                 0, 0, 1);
  const bool live_slot = slot_any_live(u, &any_live);
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
  slot_partials(part, qb, kGnSums, partials + (size_t)blockIdx.x * kGnSums);
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
