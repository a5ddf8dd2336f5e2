// Kernels O and U: one constant-acceleration tick of the use_imu=False mode
// (K7b); U also pushes the tick's ego row into the ego ring.
//
// Replaces elimaloc_tpu/ekf/filter.py:predict (:568), RunPrediction
// (ekf_algorithm.cpp:81-165), as elimaloc_tpu/pipeline/runtime.py:tick_step
// (:249) runs it on every system-clock tick (100 Hz): the reset and PCM-init
// gates and the |dt| < 1e-6 gate, the nominal CA step (pos += v dt +
// a dt^2 / 2, rot = rot (x) exp(gyro dt), v += a dt) and P <- F P F^T + Q
// with F the identity plus the dt and dt^2 / 2 blocks and Q diagonal (the
// gyro std in deg/s unconverted, cpp:138-139), then prev_timestamp and the
// reset flag; kernel U adds tick_step's _push_ego (runtime.py:172-179,
// pipeline/rings.py:126 as :183, eps 1e-5). On the TPU this is one XLA
// fusion with a dense [27, 27] einsum; the plain PyTorch version is ~60
// eager launches per tick and a dozen more for the push.
//
// Bound: latency. A tick reads and writes the 3 KB filter and does ~4k FLOP
// (two passes of at most 3 terms per entry); U also copies the ego ring
// (512 rows x 13 floats, 26 KB each way); no bandwidth or FLOP limit is
// near. Design: one CTA with the state in shared memory (ekf.cuh's State,
// in and out as one packed record, load_state / store_state, as kernel H).
// The tick's body (ca_tick.cuh: ca_tick_body, one __noinline__ copy that
// both kernels call) runs the gates and the nominal step on thread 0; the
// CTA forms G = F P, then P = G F^T + Q, each entry a sum over the at most
// 3 nonzeros of F's row in column order (F's sparsity, the dense product's
// order with its zero terms left out). Thread 0 then writes the tick's
// ego-ring row (t, pos, rpy, vel_local, gyro), as kernel H writes one per
// IMU sample.
//
// Kernel O writes that row to global memory and kernel J's one-ring entry
// (rings.cu) pushed it: O and J stay as U's bit-exact reference and launch
// on no path. Kernel U keeps the row in shared memory and, after a
// barrier, the whole CTA pushes it into the ego ring with rings.cuh's push
// (m = 1, eps 1e-5; the dedupe, the clear on a time regression and the
// roll, the ring written out of place), as kernel H pushes its ego rows:
// one launch a tick.
#include "ca_tick.cuh"
#include "rings.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

__global__ void __launch_bounds__(kThreads) ca_tick_kernel(
    const int* __restrict__ rec_in, int* __restrict__ rec_out,
    const float* __restrict__ prm_rec, const float* __restrict__ t_in,
    float* __restrict__ h_t, float* __restrict__ h_pos, float* __restrict__ h_rpy,
    float* __restrict__ h_vloc, float* __restrict__ h_gyro) {
  __shared__ State s;
  __shared__ Params prm;
  __shared__ Tick w;
  load_state(rec_in, s);
  load_params(prm_rec, prm);
  __syncthreads();
  ca_tick_body(s, prm, w, *t_in, h_t, h_pos, h_rpy, h_vloc, h_gyro);
  __syncthreads();
  store_state(s, rec_out);
}

// ego: the ring in (fill_in) and out (fill_out); its new samples are the
// tick's row in shared memory.
__global__ void __launch_bounds__(kThreads) tick_stage_kernel(
    const int* __restrict__ rec_in, int* __restrict__ rec_out,
    const float* __restrict__ prm_rec, const float* __restrict__ t_in,
    const __grid_constant__ ring::Ring ego) {
  __shared__ State s;
  __shared__ Params prm;
  __shared__ Tick w;
  __shared__ float row[13];  // t, pos, rpy, vel_local, gyro
  __shared__ bool valid;
  __shared__ int rank_src;
  load_state(rec_in, s);
  load_params(prm_rec, prm);
  if (threadIdx.x == 0) valid = true;
  __syncthreads();
  ca_tick_body(s, prm, w, *t_in, row, row + 1, row + 4, row + 7, row + 10);
  __syncthreads();
  store_state(s, rec_out);
  ring::Ring g = ego;
  g.new_t = row;
  for (int f = 0; f < 4; ++f) g.new_f[f] = row + 1 + 3 * f;
  ring::push(g, 1, &valid, &rank_src);
}

}  // namespace

extern "C" int elm_ca_tick(const void* rec_in, void* rec_out, const float* params,
                           const float* t, float* h_t, float* h_pos, float* h_rpy,
                           float* h_vloc, float* h_gyro, cudaStream_t stream) {
  ca_tick_kernel<<<1, kThreads, 0, stream>>>((const int*)rec_in, (int*)rec_out, params, t,
                                             h_t, h_pos, h_rpy, h_vloc, h_gyro);
  return (int)cudaGetLastError();
}

// ego: t, pos, rpy, vel_local, gyro, count of the ego ring in; ring_out:
// its t [ego_cap] and its four [ego_cap, 3] fields, then the int32 count.
extern "C" int elm_tick_stage(const void* rec_in, void* rec_out, const float* params,
                              const float* t, void* const* ego, int ego_cap, float* ring_out,
                              cudaStream_t stream) {
  ring::Ring g;
  ring::fill_in(g, ego_cap, 4, 1e-5f, ego);
  ring::fill_out(g, ring_out, (int*)(ring_out + 13 * ego_cap));
  tick_stage_kernel<<<1, kThreads, 0, stream>>>((const int*)rec_in, (int*)rec_out, params, t,
                                                g);
  return (int)cudaGetLastError();
}
