// One constant-acceleration tick (K7b), shared by kernel O (ca_tick.cu:
// ca_tick_kernel, the reference) and kernel U (ca_tick.cu:
// tick_stage_kernel, the tick with its ego push). See ca_tick.cu for the
// design. The body is __noinline__ and included by ca_tick.cu alone: both
// kernels call one compiled copy, so they round alike.
#pragma once

#include "ekf.cuh"

namespace elm {
namespace ekf {

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

// The whole CTA, after the barrier that publishes the staged state ``s``
// and params ``prm``: the tick at ``t`` (the gates, the nominal step on
// thread 0, P <- F P F^T + Q over F's sparsity), then thread 0 writes the
// tick's ego-ring row (t, pos, rpy, vel_local, gyro) through the five
// pointers (global or shared memory). Ends without a barrier.
static __device__ __noinline__ void ca_tick_body(State& s, const Params& prm, Tick& w, float t,
                                                 float* h_t, float* h_pos, float* h_rpy,
                                                 float* h_vloc, float* h_gyro) {
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
}

}  // namespace ekf
}  // namespace elm
