// Kernel O: one constant-acceleration tick of the use_imu=False mode (K7b).
//
// Replaces elimaloc_tpu/ekf/filter.py:predict (:568), RunPrediction
// (ekf_algorithm.cpp:81-165), as elimaloc_tpu/pipeline/runtime.py:tick_step
// (:249) runs it on every system-clock tick (100 Hz): the reset and PCM-init
// gates and the |dt| < 1e-6 gate, the nominal CA step (pos += v dt +
// a dt^2 / 2, rot = rot (x) exp(gyro dt), v += a dt) and P <- F P F^T + Q
// with F the identity plus the dt and dt^2 / 2 blocks and Q diagonal (the
// gyro std in deg/s unconverted, cpp:138-139), then prev_timestamp and the
// reset flag. On the TPU this is one XLA fusion with a dense [27, 27]
// einsum; the plain PyTorch version is ~60 eager launches per tick.
//
// Bound: latency. A tick reads and writes the 3 KB filter and does ~4k FLOP
// (two passes of at most 3 terms per entry); no bandwidth or FLOP limit is
// near. Design: one CTA with the state in shared memory (ekf.cuh's State,
// in and out as one packed record, load_state / store_state, as kernel H). Thread 0 runs the gates and the
// nominal step; the CTA forms G = F P, then P = G F^T + Q, each entry a sum
// over the at most 3 nonzeros of F's row in column order (F's sparsity, the
// dense product's order with its zero terms left out). Thread 0 then writes
// the tick's ego-ring entry (t, pos, rpy, vel_local, gyro), as kernel H
// writes one per IMU sample.
//
// The ego push: O emits the one-row history and the wrapper's caller pushes
// it through kernel J with J's IMU side left out (rings.cu takes a null
// ring), so the dedupe, the clear on a time regression and the roll keep
// one implementation. The pcm_imu event's IMU-ring-only push is J with its
// ego side left out.
#include "ekf.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

struct Tick {
  bool do_predict;
  float dt;
  float G[kN * kN];  // F P
  float qd[kN];      // Q's diagonal
};

// Row r of F as (column, value) pairs in column order; returns their count.
__device__ __forceinline__ int f_row(int r, float dt, float hdt2, int* col, float* val) {
  col[0] = r;
  val[0] = 1.0f;
  const int blk = r / 3, i = r % 3;
  if (blk == 0) {  // position: dt on velocity, dt^2 / 2 on acceleration
    col[1] = 6 + i;
    val[1] = dt;
    col[2] = 12 + i;
    val[2] = hdt2;
    return 3;
  }
  if (blk == 1 || blk == 2) {  // rotation: dt on the body rates; velocity: dt on acceleration
    col[1] = (blk == 1 ? 9 : 12) + i;
    val[1] = dt;
    return 2;
  }
  return 1;
}

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
  const float t = *t_in;
  if (threadIdx.x == 0) {
    const bool gate_early = s.reset || s.pcm_init_going;
    const float dt = sub(t, s.prev_t);
    w.do_predict = !gate_early && fabsf(dt) >= 1e-6f;
    w.dt = dt;
    if (w.do_predict) {
      float dq[4], q[4];
      exp_gyro_to_quat(s.gyro, dt, dq);
      quat_mul(s.rot, dq, q);
      quat_normalize(q, s.rot);
      for (int i = 0; i < 3; ++i) {
        s.pos[i] = add(add(s.pos[i], mul(s.vel[i], dt)), mul(mul(mul(0.5f, s.acc[i]), dt), dt));
        s.vel[i] = add(s.vel[i], mul(s.acc[i], dt));
      }
      const float dt2 = mul(dt, dt);
      const int std_of_block[9] = {STD_POS, STD_ROT, STD_VEL, STD_GYRO_DPS, STD_ACC,
                                   -1, -1, -1, -1};
      for (int b = 0; b < 9; ++b) {
        const float v = std_of_block[b] < 0 ? 0.0f : mul(sq(prm.v[std_of_block[b]]), dt2);
        w.qd[3 * b] = w.qd[3 * b + 1] = w.qd[3 * b + 2] = v;
      }
    }
    if (gate_early || w.do_predict) s.prev_t = t;
    s.reset = false;
  }
  __syncthreads();
  if (w.do_predict) {
    const float dt = w.dt, hdt2 = mul(0.5f, mul(dt, dt));  // F's 0.5 dt2
    for (int e = threadIdx.x; e < kN * kN; e += blockDim.x) {
      const int i = e / kN, j = e % kN;
      int col[3];
      float val[3];
      const int nz = f_row(i, dt, hdt2, col, val);
      float acc = 0.0f;
      for (int k = 0; k < nz; ++k) acc = add(acc, mul(val[k], s.P[col[k] * kN + j]));
      w.G[e] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kN * kN; e += blockDim.x) {
      const int i = e / kN, j = e % kN;
      int col[3];
      float val[3];
      const int nz = f_row(j, dt, hdt2, col, val);
      float acc = 0.0f;
      for (int k = 0; k < nz; ++k) acc = add(acc, mul(w.G[i * kN + col[k]], val[k]));
      s.P[e] = add(acc, i == j ? w.qd[i] : 0.0f);
    }
  }
  if (threadIdx.x == 0) {
    float rpy[3], vloc[3];
    quat_to_euler(s.rot, rpy);
    global_to_local(s.vel, rpy, vloc);
    *h_t = s.prev_t;
    for (int i = 0; i < 3; ++i) {
      h_pos[i] = s.pos[i];
      h_rpy[i] = rpy[i];
      h_vloc[i] = vloc[i];
      h_gyro[i] = s.gyro[i];
    }
  }
  __syncthreads();
  store_state(s, rec_out);
}

}  // namespace

extern "C" int elm_ca_tick(const void* rec_in, void* rec_out, const float* params,
                           const float* t, float* h_t, float* h_pos, float* h_rpy,
                           float* h_vloc, float* h_gyro, cudaStream_t stream) {
  ca_tick_kernel<<<1, kThreads, 0, stream>>>((const int*)rec_in, (int*)rec_out, params, t,
                                             h_t, h_pos, h_rpy, h_vloc, h_gyro);
  return (int)cudaGetLastError();
}
