// Kernel J: a frame's pushes into the ego and IMU rings (K8, the ring half).
//
// Replaces elimaloc_tpu/pipeline/rings.py:_push_arrays_batch (:126) as
// push_ego_batch (:183, eps 1e-5) and push_imu_batch (:192, eps 0) drive it
// from runtime.imu_subbatch, and the one-sample _push_arrays (:75) of
// imu_step, which is the batch push of one row: a time regression at the
// first valid sample clears the ring, the eps-dedupe acceptance chain runs
// sample by sample, the accepted samples take ranks, the ring rolls once by
// its overflow, and the rows scatter in (a rejected row is dropped). On the
// TPU these are a lax.scan and two roll + scatter passes per field; the plain
// PyTorch version is a Python loop of a dozen launches per sample.
//
// Bound: latency. A frame moves ~11 samples into rings of 512 and 256 rows
// (~30 KB read and written); no bandwidth or FLOP limit is near. Design: one
// launch, one CTA per ring; a ring passed as null is left out (the tick
// mode's ego push after kernel O, and its IMU-only intake). Thread 0 runs the acceptance chain (sequential
// by definition) and records the sample of each rank in shared memory; then
// every thread writes its strided output rows, each from the rolled old ring
// or from the sample of its rank. The rings are written out of place, so no
// thread reads a row another one has already overwritten.
#include <math.h>

#include "common.cuh"

using namespace elm;

namespace {

constexpr int kRingThreads = 128;
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

struct Rings {
  Ring r[2];
};

__global__ void __launch_bounds__(kRingThreads) ring_push_kernel(Rings rings, int m,
                                                                 const bool* __restrict__ valid) {
  extern __shared__ int rank_src[];  // sample index of each accepted rank
  __shared__ int s_roll, s_base, s_nacc;
  const Ring& g = rings.r[blockIdx.x];
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

// ptrs: per ring, t_in, nf fields in, count_in, t_out, nf fields out,
// count_out, new_t, nf new fields (the ego ring's nf = 4, the IMU ring's 2).
void fill(Ring& g, int cap, int nf, float eps, void* const* p) {
  g.cap = cap;
  g.nf = nf;
  g.eps = eps;
  int k = 0;
  g.t_in = (const float*)p[k++];
  for (int f = 0; f < nf; ++f) g.f_in[f] = (const float*)p[k++];
  g.count_in = (const int*)p[k++];
  g.t_out = (float*)p[k++];
  for (int f = 0; f < nf; ++f) g.f_out[f] = (float*)p[k++];
  g.count_out = (int*)p[k++];
  g.new_t = (const float*)p[k++];
  for (int f = 0; f < nf; ++f) g.new_f[f] = (const float*)p[k++];
}

}  // namespace

extern "C" int elm_ring_push(void* const* ego, int ego_cap, void* const* imu, int imu_cap,
                             int m, const bool* valid, cudaStream_t stream) {
  Rings rings;
  int nr = 0, cap = 0;
  if (ego != nullptr) {
    fill(rings.r[nr++], ego_cap, 4, 1e-5f, ego);
    cap = ego_cap;
  }
  if (imu != nullptr) {
    fill(rings.r[nr++], imu_cap, 2, 0.0f, imu);
    cap = imu_cap > cap ? imu_cap : cap;
  }
  if (nr == 0) return 0;
  const int ranks = m < cap ? m : cap;
  ring_push_kernel<<<nr, kRingThreads, (ranks > 0 ? ranks : 1) * sizeof(int), stream>>>(
      rings, m, valid);
  return (int)cudaGetLastError();
}
