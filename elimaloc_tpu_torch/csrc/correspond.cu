// Kernel A: fused P2P correspondence search + Gauss-Newton partials.
//
// Replaces elimaloc_tpu/map/tiles.py:nearest_point_slots (:712, with
// _slot_centers :648 and _cube_mask :663) and register/icp.py:_p2p_tail
// (:283). On the TPU the search is a dense [QB, MHP] distance plane per slot
// plus a one-hot matmul to select the winner, because gathers are
// scalar-core-bound there; the GN sums run as separate reductions over the
// [S*QB] rows. On Hopper one CTA owns one slot:
//   1. the slot's halo row (MHP points, 8.5 KB at MHP=711) is staged in
//      shared memory in 1024-candidate chunks as tile-local coordinates and
//      voxel coords (non-finite pads get a far voxel so the cube test
//      rejects them and +inf never enters arithmetic);
//   2. each query q = R s + t is formed from the sensor-frame point and the
//      pose in the fixed order ((R0 s0 + R1 s1) + R2 s2) + t, and its voxel
//      floor(q / voxel);
//   3. QB groups of 256/QB threads scan the candidates: the 27-voxel cube
//      test, d2 as the exact ((dx^2 + dy^2) + dz^2) sum with no FMA (so it
//      equals the plain PyTorch version bit for bit), the argmin kept in
//      registers with ties to the lower candidate index, then a shuffle
//      reduction inside the group with the same tie rule;
//   4. the d2 < max_dist^2 gate, the sensor-frame residual, the robust weight
//      th^2 / (th + r^2)^2, and the slot's 18 partial sums (sum w, sum w p,
//      sum w p p^T, sum w r, sum w p x r, fitness numerator, matched count)
//      summed over the slot's queries in query order;
//   5. a second single-CTA kernel reduces the [S, 18] partials in a fixed
//      order, so a float32 result is the same on every run. No atomics.
// Bound: the distance plane, S * QB * MHP candidate tests (~2000 * 16 * 711
// = 23M per GN iteration at the headline scan), i.e. FP32 instruction rate and shared
// memory bandwidth, not HBM (the halo rows read are ~17 MB per pass).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // candidates staged per pass
constexpr int kParts = 18;    // partial sums per slot
constexpr int kFarVoxel = 1 << 29;

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

  using namespace elm;
  const int s = blockIdx.x;
  const int tpq = kThreads / qb;        // threads per query
  const int j = threadIdx.x / tpq;      // query row in the slot
  const int gl = threadIdx.x % tpq;   // lane inside the query's group
  const int row = s * qb + j;

  // pose (row-major 4x4) and the query in world and tile-local coordinates
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], t0 = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], t1 = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], t2 = pose[11];
  const float s0 = sbuf[3 * row], s1 = sbuf[3 * row + 1], s2 = sbuf[3 * row + 2];
  const float q0 = add(add(add(mul(r00, s0), mul(r01, s1)), mul(r02, s2)), t0);
  const float q1 = add(add(add(mul(r10, s0), mul(r11, s1)), mul(r12, s2)), t1);
  const float q2 = add(add(add(mul(r20, s0), mul(r21, s1)), mul(r22, s2)), t2);
  const int qv0 = (int)floorf(q0 / voxel);
  const int qv1 = (int)floorf(q1 / voxel);
  const int qv2 = (int)floorf(q2 / voxel);
  const int tile = slot_tile[s];
  const float c0 = mul(add((float)(tile / ty_dim + tx0), 0.5f), tile_size);
  const float c1 = mul(add((float)(tile % ty_dim + ty0), 0.5f), tile_size);
  const float ql0 = sub(q0, c0), ql1 = sub(q1, c1), ql2 = q2;  // centre z = 0
  const bool live = qmask[row];

  if (threadIdx.x == 0) any_live = 0;
  __syncthreads();
  if (live && gl == 0) any_live = 1;
  __syncthreads();

  float best_d2 = __int_as_float(0x7f800000);  // +inf
  int best = 0x7fffffff;
  const float* hrow = halo + (size_t)tile * mhp * 3;
  if (any_live) {
    for (int c0i = 0; c0i < mhp; c0i += kChunk) {
      const int cn = min(kChunk, mhp - c0i);
      __syncthreads();
      for (int k = threadIdx.x; k < cn; k += kThreads) {
        const float x = hrow[3 * (c0i + k)];
        const float y = hrow[3 * (c0i + k) + 1];
        const float z = hrow[3 * (c0i + k) + 2];
        if (isfinite(x)) {
          cl[3 * k] = sub(x, c0);
          cl[3 * k + 1] = sub(y, c1);
          cl[3 * k + 2] = z;
          cv[3 * k] = (int)floorf(x / voxel);
          cv[3 * k + 1] = (int)floorf(y / voxel);
          cv[3 * k + 2] = (int)floorf(z / voxel);
        } else {
          cl[3 * k] = cl[3 * k + 1] = cl[3 * k + 2] = 0.0f;
          cv[3 * k] = cv[3 * k + 1] = cv[3 * k + 2] = kFarVoxel;
        }
      }
      __syncthreads();
      if (live) {
        for (int k = gl; k < cn; k += tpq) {
          if (abs(cv[3 * k] - qv0) > 1 || abs(cv[3 * k + 1] - qv1) > 1 ||
              abs(cv[3 * k + 2] - qv2) > 1)
            continue;
          const float d0 = sub(ql0, cl[3 * k]);
          const float d1 = sub(ql1, cl[3 * k + 1]);
          const float d2 = sub(ql2, cl[3 * k + 2]);
          const float dd = add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
          if (dd < best_d2) {
            best_d2 = dd;
            best = c0i + k;
          }
        }
      }
    }
  }
  // argmin across the query's thread group: smaller d2, then lower index
  for (int o = tpq / 2; o > 0; o >>= 1) {
    const float od = __shfl_down_sync(0xffffffffu, best_d2, o, tpq);
    const int oi = __shfl_down_sync(0xffffffffu, best, o, tpq);
    if (od < best_d2 || (od == best_d2 && oi < best)) {
      best_d2 = od;
      best = oi;
    }
  }

  if (gl == 0) {
    const float md = max_dist[0];
    const bool ok = live && best_d2 < mul(md, md);
    float g0 = q0, g1 = q1, g2 = q2;
    if (ok) {
      g0 = hrow[3 * best];
      g1 = hrow[3 * best + 1];
      g2 = hrow[3 * best + 2];
    }
    if (tgt_out != nullptr) {
      tgt_out[3 * row] = g0;
      tgt_out[3 * row + 1] = g1;
      tgt_out[3 * row + 2] = g2;
      ok_out[row] = ok;
    }
    float* pr = part + j * kParts;
    for (int k = 0; k < kParts; ++k) pr[k] = 0.0f;
    if (ok) {
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
  if (threadIdx.x < kParts) {
    float acc = 0.0f;
    for (int q = 0; q < qb; ++q) acc += part[q * kParts + threadIdx.x];
    partials[(size_t)s * kParts + threadIdx.x] = acc;
  }
}

// Fixed-order reduction of the [S, 18] slot partials: thread t sums rows
// t, t+256, ... in order, then a fixed shared-memory tree.
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int s,
                                       float* __restrict__ out) {
  __shared__ float buf[kThreads];
  for (int k = 0; k < kParts; ++k) {
    float acc = 0.0f;
    for (int r = threadIdx.x; r < s; r += kThreads) acc += partials[(size_t)r * kParts + k];
    buf[threadIdx.x] = acc;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[k] = buf[0];
    __syncthreads();
  }
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
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(partials, s, sums);
  return (int)cudaGetLastError();
}
