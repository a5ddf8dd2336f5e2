// The batch push of kernel J (rings.cu), shared with kernel H (imu_chain.cu),
// which pushes both rings at the end of the frame's IMU stage.
//
// One ring, one CTA: a time regression at the first valid sample clears the
// ring, the eps-dedupe acceptance chain runs sample by sample on thread 0
// (sequential by definition) and records the sample of each accepted rank,
// the ring rolls once by its overflow, and every thread writes its strided
// output rows, each from the rolled old ring or from the sample of its rank
// (a rejected row is dropped). The ring is written out of place, so no
// thread reads a row another one has already overwritten. The new samples
// may lie in global or in shared memory (generic pointers).
#pragma once

#include <math.h>

#include "common.cuh"

namespace elm {
namespace ring {

constexpr int kMaxFields = 4;

// One ring: its [cap] times and [cap, 3] fields in and out, and the new
// samples' [m] times and [m, 3] fields.
struct Ring {
  int cap, nf;
  float eps;
  const float* t_in;
  const float* f_in[kMaxFields];
  const int* count_in;
  float* t_out;
  float* f_out[kMaxFields];
  int* count_out;
  const float* new_t;
  const float* new_f[kMaxFields];
};

// The whole CTA: m samples, masked by ``valid``, into ring g; ``rank_src``
// holds min(m, cap) ints of shared memory. Ends without a barrier.
__device__ __forceinline__ void push(const Ring& g, int m, const bool* valid, int* rank_src) {
  __shared__ int s_roll, s_base, s_nacc;
  const int cap = g.cap;
  if (threadIdx.x == 0) {
    // a batch longer than the ring keeps its last cap samples
    const int off = m > cap ? m - cap : 0;
    int count0 = *g.count_in;
    const float last0 = g.t_in[count0 > 0 ? count0 - 1 : 0];
    int first = off;
    while (first < m && !valid[first]) ++first;
    const bool any = first < m;
    const float first_t = g.new_t[any ? first : off];
    if (any && count0 > 0 && last0 > first_t) count0 = 0;
    float last = count0 > 0 ? g.t_in[count0 - 1] : -INFINITY;
    int n = 0;
    for (int j = off; j < m; ++j) {
      const float t = g.new_t[j];
      if (valid[j] && add(last, g.eps) < t) {
        last = t;
        rank_src[n++] = j;
      }
    }
    const int roll = count0 + n > cap ? count0 + n - cap : 0;
    s_roll = roll;
    s_base = count0 - roll;
    s_nacc = n;
    *g.count_out = count0 + n < cap ? count0 + n : cap;
  }
  __syncthreads();
  const int roll = s_roll, base = s_base, n = s_nacc;
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const int r = i - base;
    const bool fresh = r >= 0 && r < n;
    const int j = fresh ? rank_src[r] : 0;
    const int s = (i + roll) % cap;
    g.t_out[i] = fresh ? g.new_t[j] : g.t_in[s];
    for (int f = 0; f < g.nf; ++f)
      for (int c = 0; c < 3; ++c)
        g.f_out[f][3 * i + c] = fresh ? g.new_f[f][3 * j + c] : g.f_in[f][3 * s + c];
  }
}

// Lane ``l`` of a lane-stacked ring (its [lanes, cap] times, [lanes, cap, 3]
// fields and [lanes] counts, in and out): each pointer at its lane stride.
__device__ __forceinline__ Ring lane_of(Ring g, int l) {
  const size_t t = (size_t)l * g.cap;
  g.t_in += t;
  g.t_out += t;
  for (int f = 0; f < g.nf; ++f) {
    g.f_in[f] += 3 * t;
    g.f_out[f] += 3 * t;
  }
  g.count_in += l;
  g.count_out += l;
  return g;
}

// ptrs: t_in, nf fields in, count_in (the ego ring's nf = 4, the IMU ring's
// 2), as the wrappers pass a ring.
__host__ __forceinline__ void fill_in(Ring& g, int cap, int nf, float eps,
                                      void* const* p) {
  g.cap = cap;
  g.nf = nf;
  g.eps = eps;
  g.t_in = (const float*)p[0];
  for (int f = 0; f < nf; ++f) g.f_in[f] = (const float*)p[1 + f];
  g.count_in = (const int*)p[1 + nf];
}

// The out-of-place ring at ``out``: its [cap] times, then its nf [cap, 3]
// fields one after another; the count apart. Of ``lanes`` rings: the
// [lanes, cap] times, then each field's [lanes, cap, 3], the [lanes]
// counts apart (lane_of picks one).
__host__ __forceinline__ void fill_out(Ring& g, float* out, int* count_out, int lanes = 1) {
  g.t_out = out;
  for (int f = 0; f < g.nf; ++f) g.f_out[f] = out + (size_t)lanes * g.cap * (1 + 3 * f);
  g.count_out = count_out;
}

}  // namespace ring
}  // namespace elm
