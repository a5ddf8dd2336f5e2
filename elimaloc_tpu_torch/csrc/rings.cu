// Kernel J: pushes into the ego and IMU rings (K8, the ring half) on the
// paths that do not run kernel H.
//
// Replaces elimaloc_tpu/pipeline/rings.py:_push_arrays_batch (:126) as
// push_ego_batch (:183, eps 1e-5) and push_imu_batch (:192, eps 0) drive it,
// with the one-sample _push_arrays (:75) as the batch push of one row. The
// frame's and the IMU event's pushes run inside kernel H (imu_chain.cu);
// this entry is the reference of the tick mode's kernels U and V (the ego
// push of kernel O's row after each CA tick, runtime.py:174 _push_ego, and
// the IMU-only intake, runtime.py:237 imu_ring_step) and the card form of
// push_ego (:106) and push_imu (:116), one row into one ring. On the TPU
// these are a lax.scan and two roll + scatter passes per field; the plain
// PyTorch version is a Python loop of a dozen launches per sample.
//
// Bound: latency (one row into the pipeline's rings of 1024 and 512 rows).
// Design: one launch, one CTA per ring given (a ring passed as null is left
// out), the push of rings.cuh.
#include "rings.cuh"

using namespace elm;
using namespace elm::ring;

namespace {

constexpr int kRingThreads = 128;

struct Rings {
  Ring r[2];
};

__global__ void __launch_bounds__(kRingThreads) ring_push_kernel(Rings rings, int m,
                                                                 const bool* __restrict__ valid) {
  extern __shared__ int rank_src[];  // sample index of each accepted rank
  push(rings.r[blockIdx.x], m, valid, rank_src);
}

// ptrs: per ring, t_in, nf fields in, count_in, t_out, nf fields out,
// count_out, new_t, nf new fields (the ego ring's nf = 4, the IMU ring's 2).
void fill(Ring& g, int cap, int nf, float eps, void* const* p) {
  fill_in(g, cap, nf, eps, p);
  int k = 2 + nf;
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
