// Shared helpers for the elimaloc_tpu_torch CUDA kernels (sm_90a).
//
// Every kernel file exposes plain C entry points: device pointers, sizes and
// the CUDA stream come in from the Python wrapper (ctypes), each entry
// returns cudaGetLastError() right after its launches.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace elm {

// Exact-rounding float helpers: the intrinsics are never contracted into
// FMAs, so a kernel and its plain PyTorch version (separate mul and add
// kernels) round the same way where the tests demand bit equality.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct AddOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};

// floor(p / voxel) per axis: the voxel coords of a point, with the IEEE
// division of the plain versions (grid.div), so both agree at boundaries.
__device__ __forceinline__ int3 voxel_of(const float* __restrict__ p, float voxel) {
  return make_int3((int)floorf(p[0] / voxel), (int)floorf(p[1] / voxel),
                   (int)floorf(p[2] / voxel));
}

// Block-wide inclusive scan of one int per thread, for ops whose identity is
// 0 on the non-negative values the kernels scan (sums). blockDim.x must
// be a multiple of 32 and at most 1024; ``sh`` holds 32 ints of shared
// memory. Returns the thread's inclusive prefix and writes the block total.
template <class Op>
__device__ int block_scan(int v, Op op, int* sh, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op(v, u);
  }
  if (lane == 31) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int x = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = op(x, u);
    }
    sh[lane] = x;
  }
  __syncthreads();
  if (wid > 0) v = op(v, sh[wid - 1]);
  *total = sh[nw - 1];
  __syncthreads();  // ``sh`` is reused by the next call
  return v;
}

// --------------------------------------------------------------------------
// The slot search shared by kernels A, E, F and G (one CTA per slot, QB
// groups of kThreads / QB threads, one group per query).
// --------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kChunk = 1024;              // candidates staged per pass
constexpr int kFarVoxel = 1 << 29;        // voxel coord that fails every cube test
constexpr int kCoordSentinel = 1 << 30;   // halo_vox_coord pad (map/tiles.py)
constexpr int kGnSums = 44;               // partial sums per slot of E, F, G

// One query of a slot: the pose, the sensor-frame point s, the world query
// q = R s + t formed in the fixed order ((R0 s0 + R1 s1) + R2 s2) + t of the
// plain transform_slots, its voxel floor(q / voxel), and q on tile-local
// coordinates (tile centre c, z centre 0).
struct SlotQuery {
  float r[9], t[3], s[3], q[3], ql[3], c0, c1;
  int qv[3], tile, row, j, gl, tpq;
  bool live;
};

// The pose, the sensor point s (3 floats at ``src``), q = R s + t and its
// voxel floor(q / voxel) (IEEE division: a reciprocal product can move a
// point across a voxel boundary).
__device__ __forceinline__ void pose_query(SlotQuery& u, const float* pose, const float* src,
                                           float voxel) {
  for (int i = 0; i < 3; ++i) {
    u.r[3 * i] = pose[4 * i];
    u.r[3 * i + 1] = pose[4 * i + 1];
    u.r[3 * i + 2] = pose[4 * i + 2];
    u.t[i] = pose[4 * i + 3];
    u.s[i] = src[i];
  }
  for (int i = 0; i < 3; ++i) {
    u.q[i] = add(add(add(mul(u.r[3 * i], u.s[0]), mul(u.r[3 * i + 1], u.s[1])),
                     mul(u.r[3 * i + 2], u.s[2])), u.t[i]);
    u.qv[i] = (int)floorf(u.q[i] / voxel);
  }
}

// Slot ``s``'s query of this thread (a CTA owns one slot at a time: kernels
// E, F, G take s = blockIdx.x, A's and the P2P loop's CTAs walk slots).
__device__ __forceinline__ SlotQuery slot_query(
    int s, const int* slot_tile, const float* sbuf, const bool* qmask, int qb,
    const float* pose, float voxel, float tile_size, int tx0, int ty0, int ty_dim) {
  SlotQuery u;
  u.tpq = kThreads / qb;
  u.j = threadIdx.x / u.tpq;
  u.gl = threadIdx.x % u.tpq;
  u.row = s * qb + u.j;
  pose_query(u, pose, sbuf + 3 * u.row, voxel);
  u.tile = slot_tile[s];
  u.c0 = mul(add((float)(u.tile / ty_dim + tx0), 0.5f), tile_size);
  u.c1 = mul(add((float)(u.tile % ty_dim + ty0), 0.5f), tile_size);
  u.ql[0] = sub(u.q[0], u.c0);
  u.ql[1] = sub(u.q[1], u.c1);
  u.ql[2] = u.q[2];
  u.live = qmask[u.row];
  return u;
}

// 1 when any query of the slot is live (the whole CTA agrees).
__device__ __forceinline__ bool slot_any_live(const SlotQuery& u, int* flag) {
  if (threadIdx.x == 0) *flag = 0;
  __syncthreads();
  if (u.live && u.gl == 0) *flag = 1;
  __syncthreads();
  return *flag != 0;
}

// Stages halo point i as candidate k: tile-local coords and voxel coords;
// non-finite pads get a far voxel so +inf never enters arithmetic.
struct PointStage {
  const float* row;
  float c0, c1, voxel;
  __device__ __forceinline__ void operator()(int i, int k, float* cl, int* cv) const {
    const float x = row[3 * i], y = row[3 * i + 1], z = row[3 * i + 2];
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
};

// Stages halo voxel i as candidate k: its mean on tile-local coords and its
// stored voxel coords; unoccupied pads (sentinel coords, +inf means) get a
// far voxel.
struct VoxelStage {
  const float* mean;
  const int* coord;
  float c0, c1;
  __device__ __forceinline__ void operator()(int i, int k, float* cl, int* cv) const {
    if (coord[3 * i] != kCoordSentinel) {
      cl[3 * k] = sub(mean[3 * i], c0);
      cl[3 * k + 1] = sub(mean[3 * i + 1], c1);
      cl[3 * k + 2] = mean[3 * i + 2];
      cv[3 * k] = coord[3 * i];
      cv[3 * k + 1] = coord[3 * i + 1];
      cv[3 * k + 2] = coord[3 * i + 2];
    } else {
      cl[3 * k] = cl[3 * k + 1] = cl[3 * k + 2] = 0.0f;
      cv[3 * k] = cv[3 * k + 1] = cv[3 * k + 2] = kFarVoxel;
    }
  }
};

// Nearest of a halo row's m candidates inside the query's 27-voxel cube:
// d2 as the exact ((dx^2 + dy^2) + dz^2) sum with no FMA (equal to the plain
// PyTorch version bit for bit), the argmin kept with ties to the lower
// candidate index inside the thread and across its group. Every thread of
// the CTA must call it (it stages through ``cl``/``cv`` with barriers).
// Returns best_d2 = +inf and best = INT_MAX where the cube is empty.
template <class Stage>
__device__ __forceinline__ void cube_argmin(
    const SlotQuery& u, bool any_live, int m, const Stage& stage, float* cl, int* cv,
    float& best_d2, int& best) {
  best_d2 = __int_as_float(0x7f800000);  // +inf
  best = 0x7fffffff;
  if (any_live) {
    for (int base = 0; base < m; base += kChunk) {
      const int cn = min(kChunk, m - base);
      __syncthreads();
      for (int k = threadIdx.x; k < cn; k += kThreads) stage(base + k, k, cl, cv);
      __syncthreads();
      if (!u.live) continue;
      for (int k = u.gl; k < cn; k += u.tpq) {
        if (abs(cv[3 * k] - u.qv[0]) > 1 || abs(cv[3 * k + 1] - u.qv[1]) > 1 ||
            abs(cv[3 * k + 2] - u.qv[2]) > 1)
          continue;
        const float d0 = sub(u.ql[0], cl[3 * k]);
        const float d1 = sub(u.ql[1], cl[3 * k + 1]);
        const float d2 = sub(u.ql[2], cl[3 * k + 2]);
        const float dd = add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
        if (dd < best_d2) {
          best_d2 = dd;
          best = base + k;
        }
      }
    }
  }
  for (int o = u.tpq / 2; o > 0; o >>= 1) {
    const float od = __shfl_down_sync(0xffffffffu, best_d2, o, u.tpq);
    const int oi = __shfl_down_sync(0xffffffffu, best, o, u.tpq);
    if (od < best_d2 || (od == best_d2 && oi < best)) {
      best_d2 = od;
      best = oi;
    }
  }
}

// A CTA's static shared memory for kernels E and F's slot search: the staged
// candidates and the slot's live flag (the slot's [qb, kGnSums] rows are
// dynamic).
struct CubeShared {
  float cl[kChunk * 3];
  int cv[kChunk * 3];
  int any_live;
};

// Threads < np sum the slot's [qb, np] rows of ``part`` in query order into
// ``out`` (the slot's partials). Call after a barrier.
__device__ __forceinline__ void slot_partials(const float* part, int qb, int np,
                                              float* out) {
  if (threadIdx.x < np) {
    float acc = 0.0f;
    for (int q = 0; q < qb; ++q) acc += part[q * np + threadIdx.x];
    out[threadIdx.x] = acc;
  }
}

// --------------------------------------------------------------------------
// Small 3x3 algebra of the GN tails (row-major float[9]).
// --------------------------------------------------------------------------

// Closed-form inverse, adjugate / det (ops/lie.py:inv3x3).
__device__ __forceinline__ void inv3x3(const float* m, float* o) {
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5];
  const float g = m[6], h = m[7], i = m[8];
  const float A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
  const float inv_det = 1.0f / (a * A + b * B + c * C);
  o[0] = A * inv_det;
  o[1] = -(b * i - c * h) * inv_det;
  o[2] = (b * f - c * e) * inv_det;
  o[3] = B * inv_det;
  o[4] = (a * i - c * g) * inv_det;
  o[5] = -(a * f - c * d) * inv_det;
  o[6] = C * inv_det;
  o[7] = -(a * h - b * g) * inv_det;
  o[8] = (a * e - b * d) * inv_det;
}

// R^T M R for the pose rotation r.
__device__ __forceinline__ void conj_rt(const float* r, const float* m, float* o) {
  float mr[9];
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l)
      mr[3 * i + l] = m[3 * i] * r[l] + m[3 * i + 1] * r[3 + l] + m[3 * i + 2] * r[6 + l];
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l)
      o[3 * i + l] = r[i] * mr[l] + r[3 + i] * mr[3 + l] + r[6 + i] * mr[6 + l];
}

// The radar form of kernels E, F and G (use_radar_cov, icp.py:331-333,
// 361-363): row ``row``'s slot-packed radar covariance (kernel P's 9 floats,
// R S, not symmetric) added to R^T C R before the inverse; nothing when
// ``radar`` is null.
__device__ __forceinline__ void add_radar(const float* radar, int row, float* rcr) {
  if (radar == nullptr) return;
  for (int k = 0; k < 9; ++k) rcr[k] += radar[(size_t)row * 9 + k];
}

// R^T v.
__device__ __forceinline__ void rot_t(const float* r, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = r[i] * v[0] + r[3 + i] * v[1] + r[6 + i] * v[2];
}

// Residual in the sensor frame: R^T mu - R^T t - s (lie.transform_inverse).
__device__ __forceinline__ void sensor_residual(const SlotQuery& u, const float* mu,
                                                float* e) {
  float a[3], b[3];
  rot_t(u.r, mu, a);
  rot_t(u.r, u.t, b);
  for (int i = 0; i < 3; ++i) e[i] = a[i] - b[i] - u.s[i];
}

// Unit eigenvector of the smallest eigenvalue of a symmetric 3x3 in closed
// form (register/icp.py:_smallest_eigvec): trigonometric eigenvalues, then
// the longest cross product of two rows of C - lambda I (first on ties);
// (0, 0, 1) when all are ~0.
__device__ __forceinline__ void smallest_eigvec(const float* a, float* v) {
  const float q = (a[0] + a[4] + a[8]) / 3.0f;
  float b[9];
  for (int k = 0; k < 9; ++k) b[k] = a[k];
  b[0] -= q;
  b[4] -= q;
  b[8] -= q;
  float p2 = 0.0f;
  for (int k = 0; k < 9; ++k) p2 += b[k] * b[k];
  const float p = sqrtf(fmaxf(p2 / 6.0f, 1e-30f));
  for (int k = 0; k < 9; ++k) b[k] /= p;
  const float det = b[0] * (b[4] * b[8] - b[5] * b[7]) -
                    b[1] * (b[3] * b[8] - b[5] * b[6]) +
                    b[2] * (b[3] * b[7] - b[4] * b[6]);
  const float phi = acosf(fminf(fmaxf(det / 2.0f, -1.0f), 1.0f)) / 3.0f;
  const float lam = q + 2.0f * p * cosf(phi + 2.0943951023931953f);  // + 2 pi / 3
  float c[9];
  for (int k = 0; k < 9; ++k) c[k] = a[k];
  c[0] -= lam;
  c[4] -= lam;
  c[8] -= lam;
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  float best_n = -1.0f;
  float w[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) {
    const float* x = c + 3 * pairs[k][0];
    const float* y = c + 3 * pairs[k][1];
    const float cx[3] = {x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
                         x[0] * y[1] - x[1] * y[0]};
    const float n = sqrtf(cx[0] * cx[0] + cx[1] * cx[1] + cx[2] * cx[2]);
    if (n > best_n) {
      best_n = n;
      w[0] = cx[0];
      w[1] = cx[1];
      w[2] = cx[2];
    }
  }
  if (best_n > 1e-20f) {
    const float inv = 1.0f / fmaxf(best_n, 1e-30f);
    v[0] = w[0] * inv;
    v[1] = w[1] * inv;
    v[2] = w[2] * inv;
  } else {
    v[0] = v[1] = 0.0f;
    v[2] = 1.0f;
  }
}

// One row's J^T M J and J^T M r for J = [I | -skew(p)], given A = w M and
// A r in the sensor frame, written to out[0..41] (added to it with
// ``accumulate``: kernel G's radar form sums a row's pairs): the blocks
// tl = A, tr = -A S, bl = S A, br = -S A S (row-major 3x3 each; A need not
// be symmetric), then A r and S A r (register/icp.py:_gn_blocks).
__device__ __forceinline__ void gn_row(const float* A, const float* Ar, const float* p,
                                       float* out, bool accumulate) {
  const float S[9] = {0.0f, -p[2], p[1], p[2], 0.0f, -p[0], -p[1], p[0], 0.0f};
  auto put = [&](int k, float v) { out[k] = accumulate ? out[k] + v : v; };
  float AS[9];
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l) {
      AS[3 * i + l] = A[3 * i] * S[l] + A[3 * i + 1] * S[3 + l] + A[3 * i + 2] * S[6 + l];
      put(3 * i + l, A[3 * i + l]);
      put(9 + 3 * i + l, -AS[3 * i + l]);
    }
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l) {
      put(18 + 3 * i + l, S[3 * i] * A[l] + S[3 * i + 1] * A[3 + l] + S[3 * i + 2] * A[6 + l]);
      put(27 + 3 * i + l,
          -(S[3 * i] * AS[l] + S[3 * i + 1] * AS[3 + l] + S[3 * i + 2] * AS[6 + l]));
    }
  for (int i = 0; i < 3; ++i) {
    put(36 + i, Ar[i]);
    put(39 + i, S[3 * i] * Ar[0] + S[3 * i + 1] * Ar[1] + S[3 * i + 2] * Ar[2]);
  }
}

// A row of the radar form that the plain sums mask out (unmatched, or
// under a weight cutoff): the plain version (and JAX) still forms
// M = (R^T C R + radar)^-1 for it and multiplies it by a zero weight, so a
// non-finite M (R^T C R + R S is not symmetric and can be singular) turns
// the sums NaN there. Where M is finite the row adds exact zeros and is
// skipped; otherwise it is added with A = 0 * M, whose NaNs reach the same
// sums as the plain version's.
__device__ __forceinline__ void masked_radar_row(const SlotQuery& u, const float* radar,
                                                 const float* C, const float* mu,
                                                 float* out) {
  float rcr[9], A[9], e[3], Ar[3];
  conj_rt(u.r, C, rcr);
  add_radar(radar, u.row, rcr);
  inv3x3(rcr, A);
  bool finite = true;
  for (int k = 0; k < 9; ++k) finite = finite && isfinite(A[k]);
  if (finite) return;
  for (int k = 0; k < 9; ++k) A[k] *= 0.0f;
  sensor_residual(u, mu, e);
  for (int i = 0; i < 3; ++i) Ar[i] = A[3 * i] * e[0] + A[3 * i + 1] * e[1] + A[3 * i + 2] * e[2];
  gn_row(A, Ar, u.s, out, true);
}

// --------------------------------------------------------------------------
// The per-row GN tails shared by the tile kernels (A, E, F, G) and the hash
// kernel Q. ``u`` carries the pose, the sensor point, the query and the row
// (the radar covariance's index); ``pr`` the row's partial sums.
// --------------------------------------------------------------------------

// One matched row's 18 P2P partial sums (register/icp.py:_p2p_tail): the
// target g in the sensor frame, the robust weight th^2 / (th + r^2)^2, then
// sum w, w p, w p p^T (xx xy xz yy yz zz), w r, (w p) x r, |r|, 1.
__device__ __forceinline__ void p2p_row(const SlotQuery& u, const float* g, float md,
                                        float* pr) {
  const float r00 = u.r[0], r01 = u.r[1], r02 = u.r[2];
  const float r10 = u.r[3], r11 = u.r[4], r12 = u.r[5];
  const float r20 = u.r[6], r21 = u.r[7], r22 = u.r[8];
  const float t0 = u.t[0], t1 = u.t[1], t2 = u.t[2];
  const float s0 = u.s[0], s1 = u.s[1], s2 = u.s[2];
  const float g0 = g[0], g1 = g[1], g2 = g[2];
  // tgt in the sensor frame: R^T tgt - R^T t (lie.transform_inverse)
  const float it0 = -(r00 * t0 + r10 * t1 + r20 * t2);
  const float it1 = -(r01 * t0 + r11 * t1 + r21 * t2);
  const float it2 = -(r02 * t0 + r12 * t1 + r22 * t2);
  const float e0 = r00 * g0 + r10 * g1 + r20 * g2 + it0 - s0;
  const float e1 = r01 * g0 + r11 * g1 + r21 * g2 + it1 - s1;
  const float e2 = r02 * g0 + r12 * g1 + r22 * g2 + it2 - s2;
  const float r2 = e0 * e0 + e1 * e1 + e2 * e2;
  const float den = md + r2;
  const float w = md * md / (den * den);
  const float wp0 = w * s0, wp1 = w * s1, wp2 = w * s2;
  pr[0] = w;
  pr[1] = wp0;
  pr[2] = wp1;
  pr[3] = wp2;
  pr[4] = wp0 * s0;
  pr[5] = wp0 * s1;
  pr[6] = wp0 * s2;
  pr[7] = wp1 * s1;
  pr[8] = wp1 * s2;
  pr[9] = wp2 * s2;
  pr[10] = w * e0;
  pr[11] = w * e1;
  pr[12] = w * e2;
  pr[13] = wp1 * e2 - wp2 * e1;
  pr[14] = wp2 * e0 - wp0 * e2;
  pr[15] = wp0 * e1 - wp1 * e0;
  pr[16] = sqrtf(r2);
  pr[17] = 1.0f;
}

// One row of GICP's 44 partial sums (register/icp.py:_gicp_tail), written
// over ``pr``: with a match (``ok``), M = (R^T C R [+ radar])^-1 with the
// match's covariance C, the sensor-frame residual against its mean mu, the
// weight 0.8 th^2 / (th + r^2)^2 + 0.2, the J^T M J blocks and J^T M r, the
// fitness term |r . n| (n = R^T v / |R^T v|, v the smallest eigenvector of
// C) and 1. Without one, zeros; in the radar form a ``u.live`` row still
// forms its M (masked_radar_row) with the C and mu given.
template <bool kRadar>
__device__ __forceinline__ void gicp_row(const SlotQuery& u, bool ok, const float* C,
                                         const float* mu, float md, const float* radar,
                                         float* pr) {
  for (int k = 0; k < kGnSums; ++k) pr[k] = 0.0f;
  if (ok) {
    float rcr[9], A[9], e[3], Ar[3];
    conj_rt(u.r, C, rcr);
    if (kRadar) add_radar(radar, u.row, rcr);
    inv3x3(rcr, A);
    sensor_residual(u, mu, e);
    const float r2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
    const float den = md + r2;
    const float w = md * md / (den * den) * 0.8f + 0.2f;
    for (int k = 0; k < 9; ++k) A[k] *= w;
    for (int i = 0; i < 3; ++i) Ar[i] = A[3 * i] * e[0] + A[3 * i + 1] * e[1] + A[3 * i + 2] * e[2];
    gn_row(A, Ar, u.s, pr, false);
    float v[3], n[3];
    smallest_eigvec(C, v);
    rot_t(u.r, v, n);
    const float nn = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1e-30f);
    pr[42] = fabsf((e[0] * n[0] + e[1] * n[1] + e[2] * n[2]) / nn);
    pr[43] = 1.0f;
  } else if (kRadar && u.live) {
    masked_radar_row(u, radar, C, mu, pr);
  }
}

// One row of VGICP's 44 partial sums (register/icp.py:_voxcov_tail), over
// ``pr``: a match with weight w = th^2 / (th + r^2)^2 >= 0.01 adds its
// blocks (M = (R^T C R [+ radar])^-1) and |r| to the fitness; every match
// counts 1. Rows the sums mask out form their M in the radar form, as in
// gicp_row.
template <bool kRadar>
__device__ __forceinline__ void vgicp_row(const SlotQuery& u, bool ok, const float* C,
                                          const float* mu, float md, const float* radar,
                                          float* pr) {
  for (int k = 0; k < kGnSums; ++k) pr[k] = 0.0f;
  if (ok) {
    float e[3];
    sensor_residual(u, mu, e);
    const float r2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
    const float den = md + r2;
    const float w = md * md / (den * den);
    if (w >= 0.01f) {
      float rcr[9], A[9], Ar[3];
      conj_rt(u.r, C, rcr);
      if (kRadar) add_radar(radar, u.row, rcr);
      inv3x3(rcr, A);
      for (int k = 0; k < 9; ++k) A[k] *= w;
      for (int i = 0; i < 3; ++i)
        Ar[i] = A[3 * i] * e[0] + A[3 * i + 1] * e[1] + A[3 * i + 2] * e[2];
      gn_row(A, Ar, u.s, pr, false);
      pr[42] = sqrtf(r2);
    } else if (kRadar) {
      masked_radar_row(u, radar, C, mu, pr);
    }
    pr[43] = 1.0f;
  } else if (kRadar && u.live) {
    masked_radar_row(u, radar, C, mu, pr);
  }
}

// AVGICP's running sums over one point's (point, voxel) pairs: P = sum w
// C^-1 and bw = sum w C^-1 (mu - q) in the world frame, the fitness
// numerator and the matched pair count.
struct AvgAcc {
  float P[9], bw[3], fit, matched;
};

__device__ __forceinline__ AvgAcc avg_acc() {
  AvgAcc a;
  for (int k = 0; k < 9; ++k) a.P[k] = 0.0f;
  for (int k = 0; k < 3; ++k) a.bw[k] = 0.0f;
  a.fit = a.matched = 0.0f;
  return a;
}

// One (point, voxel) pair of AVGICP (register/icp.py:_avg_voxcov_tail;
// radar form: the flattened pairs of _voxcov_tail): d = mu - q, d2 its
// squared norm in the world frame. A matched pair (``ok``) counts; pairs
// with w = th^2 / (th + d2)^2 < 0.01 leave the sums and the fitness. The
// reference form adds w C^-1 and w C^-1 d to ``a``; the radar form (the
// radar term inside the inverse breaks the world-frame reduction) adds the
// pair's own sensor-frame blocks (w from its residual's norm) to ``pr``.
// Pairs the sums mask out form their M in the radar form when ``u.live``.
template <bool kRadar>
__device__ __forceinline__ void avgicp_pair(const SlotQuery& u, bool ok, const float* C,
                                            const float* mu, const float* d, float d2,
                                            float md, const float* radar, AvgAcc& a,
                                            float* pr) {
  if (!ok) {
    if (kRadar && u.live) masked_radar_row(u, radar, C, mu, pr);
    return;
  }
  a.matched += 1.0f;
  if (kRadar) {
    float e[3];
    sensor_residual(u, mu, e);
    const float r2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
    const float den = md + r2;
    const float w = md * md / (den * den);
    if (w < 0.01f) {
      masked_radar_row(u, radar, C, mu, pr);
      return;
    }
    float rcr[9], A[9], Ar[3];
    conj_rt(u.r, C, rcr);
    add_radar(radar, u.row, rcr);
    inv3x3(rcr, A);
    for (int k = 0; k < 9; ++k) A[k] *= w;
    for (int i = 0; i < 3; ++i)
      Ar[i] = A[3 * i] * e[0] + A[3 * i + 1] * e[1] + A[3 * i + 2] * e[2];
    gn_row(A, Ar, u.s, pr, true);
    a.fit += sqrtf(r2);
    return;
  }
  const float den = md + d2;
  const float w = md * md / (den * den);
  if (w < 0.01f) return;
  float ci[9];
  inv3x3(C, ci);
  for (int k = 0; k < 9; ++k) a.P[k] += w * ci[k];
  for (int i = 0; i < 3; ++i)
    a.bw[i] += w * (ci[3 * i] * d[0] + ci[3 * i + 1] * d[1] + ci[3 * i + 2] * d[2]);
  a.fit += sqrtf(d2);
}

// After a point's pairs: the reference form's A = R^T P R and b = R^T bw
// feed one row's blocks; both forms write the fitness and the pair count.
template <bool kRadar>
__device__ __forceinline__ void avgicp_finish(const SlotQuery& u, const AvgAcc& a, float* pr) {
  if (!kRadar) {
    float A[9], b[3];
    conj_rt(u.r, a.P, A);
    rot_t(u.r, a.bw, b);
    gn_row(A, b, u.s, pr, false);
  }
  pr[42] = a.fit;
  pr[43] = a.matched;
}

// The dynamic shared memory a kernel of this family needs above the 48 KB
// default is opted into per launch.
template <class K>
__host__ inline cudaError_t allow_dynamic_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace elm

// One unnamed namespace per translation unit (a second one inside ``elm``
// would make nvcc's generated launch stubs ambiguous).
namespace {

// Fixed-order reduction of [S, np] slot partials: thread t sums rows t,
// t + 256, ... in order, then a fixed shared-memory tree; no atomics, so a
// float32 result is the same on every run. One CTA of elm::kThreads.
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int s,
                                       int np, float* __restrict__ out) {
  constexpr int kThreads = elm::kThreads;
  __shared__ float buf[kThreads];
  for (int k = 0; k < np; ++k) {
    float acc = 0.0f;
    for (int r = threadIdx.x; r < s; r += kThreads) acc += partials[(size_t)r * np + k];
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
