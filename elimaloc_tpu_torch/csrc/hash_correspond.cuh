// One GN iteration's per-point search + GN partials of kernel Q, the hash
// grid's fused entry (K13), shared by kernel Q's fused entry
// (hash_correspond.cu: hash_search_kernel, one CTA per block of
// kHashThreads points, one GN iteration) and the hash loop kernel
// (hash_correspond.cu: hash_register_kernel, each CTA walks blocks, every
// iteration of the registration in one launch). See hash_correspond.cu for
// the design. The per-point body is __noinline__ and included by
// hash_correspond.cu alone: both kernels call one compiled copy, so they
// round alike.
#pragma once

#include "common.cuh"
#include "hash.cuh"

using namespace elm;

namespace {

constexpr int kHashThreads = 128;
constexpr int kP2PSums = 18;
enum Method { kP2P = 0, kGICP = 1, kVGICP = 2, kAVGICP = 3 };

struct Nearest {
  int row, slot;
  float d2;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float sq_dist(const float* p, const float* q) {
  const float d0 = sub(p[0], q[0]), d1 = sub(p[1], q[1]), d2 = sub(p[2], q[2]);
  return add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
}

__device__ __forceinline__ int neighbour(const HashGrid& g, const int* qv, int o, bool seven) {
  int d[3], c[3];
  if (seven) {
    offset7(o, d);
  } else {
    offset27(o, d);
  }
  for (int i = 0; i < 3; ++i) c[i] = qv[i] + d[i];
  return lookup(g, c);
}

// The nearest map point of the 27-voxel neighbourhood (grid.py:181-208).
__device__ __forceinline__ Nearest nearest_point(const HashGrid& g, const float* q,
                                                 const int* qv) {
  Nearest b{0, 0, inf()};
  for (int o = 0; o < 27; ++o) {
    const int row = neighbour(g, qv, o, false);
    if (o == 0) b.row = row;
    const float* p = g.points + (size_t)row * g.m * 3;
    const int cnt = g.counts[row];
    for (int k = 0; k < cnt; ++k) {
      const float dd = sq_dist(p + 3 * k, q);
      if (dd < b.d2) {
        b.d2 = dd;
        b.row = row;
        b.slot = k;
      }
    }
  }
  return b;
}

// The neighbourhood voxel whose mean is nearest (grid.py:233-251).
__device__ __forceinline__ Nearest nearest_voxel(const HashGrid& g, const float* q,
                                                 const int* qv) {
  Nearest b{0, 0, inf()};
  for (int o = 0; o < 27; ++o) {
    const int row = neighbour(g, qv, o, false);
    if (o == 0) b.row = row;
    if (g.counts[row] <= 0) continue;
    const float dd = sq_dist(g.vmean + (size_t)row * 3, q);
    if (dd < b.d2) {
      b.d2 = dd;
      b.row = row;
    }
  }
  return b;
}

__device__ __forceinline__ void identity(float* C) {
  for (int k = 0; k < 9; ++k) C[k] = (k % 4 == 0) ? 1.0f : 0.0f;
}

__device__ __forceinline__ void copy(const float* from, int n, float* to) {
  for (int k = 0; k < n; ++k) to[k] = from[k];
}

// Point ``i``'s row of ``kMethod``'s partial sums at ``pose`` into ``pr``
// (zeroed by the caller): steps 1-4 of hash_correspond.cu.
template <int kMethod, bool kRadar>
__device__ __noinline__ void hash_point(const HashGrid& g, const float* __restrict__ src,
                                           const bool* __restrict__ valid, int i,
                                           const float* pose,
                                           const float* __restrict__ max_dist,
                                           const float* __restrict__ radar, float* pr) {
  SlotQuery u;
  pose_query(u, pose, src + 3 * (size_t)i, g.voxel);
  u.row = i;
  u.live = true;  // every row reaches the tails (the radar form's masked M)
  const bool live = valid[i];
  const float md = max_dist[0];
  const float md2 = mul(md, md);
  if (kMethod == kP2P || kMethod == kGICP) {
    const Nearest b = nearest_point(g, u.q, u.qv);
    const bool near = b.d2 < md2;
    const size_t at = (size_t)b.row * g.m + b.slot;
    if (kMethod == kP2P) {
      if (near && live) p2p_row(u, g.points + at * 3, md, pr);
    } else {
      float C[9], mu[3] = {u.q[0], u.q[1], u.q[2]};
      identity(C);
      if (near) {
        copy(g.pcov + at * 9, 9, C);
        copy(g.pmean + at * 3, 3, mu);
      }
      gicp_row<kRadar>(u, near && live, C, mu, md, radar, pr);
    }
  } else if (kMethod == kVGICP) {
    const Nearest b = nearest_voxel(g, u.q, u.qv);
    const bool near = b.d2 < md2;
    float C[9], mu[3] = {u.q[0], u.q[1], u.q[2]};
    identity(C);
    if (near) {
      copy(g.vcov + (size_t)b.row * 9, 9, C);
      copy(g.vmean + (size_t)b.row * 3, 3, mu);
    }
    vgicp_row<kRadar>(u, near && live, C, mu, md, radar, pr);
  } else {
    AvgAcc acc = avg_acc();
    for (int o = 0; o < 7; ++o) {
      const int row = neighbour(g, u.qv, o, true);
      float C[9], mu[3] = {u.q[0], u.q[1], u.q[2]};
      float d[3] = {0.0f, 0.0f, 0.0f}, d2 = 0.0f;
      bool near = false;
      identity(C);
      if (g.counts[row] > 0) {
        const float* vm = g.vmean + (size_t)row * 3;
        for (int k = 0; k < 3; ++k) d[k] = sub(vm[k], u.q[k]);
        d2 = add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2]));
        near = d2 < md2;
      }
      if (near) {
        copy(g.vcov + (size_t)row * 9, 9, C);
        copy(g.vmean + (size_t)row * 3, 3, mu);
      }
      avgicp_pair<kRadar>(u, near && live, C, mu, d, d2, md, radar, acc, pr);
    }
    avgicp_finish<kRadar>(u, acc, pr);
  }
}

// Block ``block`` of the scan (points block * kHashThreads ...) at ``pose``:
// each thread's row in ``part`` ([kHashThreads, 18 or 44] floats of shared
// memory), then the block's partials summed in thread order into
// partials[block]. Every thread of the CTA must call it (one barrier); a
// CTA may call it for several blocks in turn.
template <int kMethod, bool kRadar>
__device__ __forceinline__ void hash_block(int block, const HashGrid& g,
                                           const float* __restrict__ src,
                                           const bool* __restrict__ valid, int n,
                                           const float* pose,
                                           const float* __restrict__ max_dist,
                                           const float* __restrict__ radar, float* part,
                                           float* partials) {
  constexpr int kParts = kMethod == kP2P ? kP2PSums : kGnSums;
  const int i = block * kHashThreads + threadIdx.x;
  float* pr = part + threadIdx.x * kParts;
  for (int k = 0; k < kParts; ++k) pr[k] = 0.0f;
  if (i < n) hash_point<kMethod, kRadar>(g, src, valid, i, pose, max_dist, radar, pr);
  __syncthreads();
  slot_partials(part, kHashThreads, kParts, partials + (size_t)block * kParts);
}

}  // namespace
