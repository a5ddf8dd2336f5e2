// Kernel H: the frame's IMU chain (K7).
//
// Replaces elimaloc_tpu/ekf/filter.py:predict_imu (:520) with
// _propagate_imu (:344), _fpf_sparse (:306), _zupt_imu (:390),
// _complementary_filter (:424) and _calibrate_vehicle_to_imu (:493), as
// driven by elimaloc_tpu/pipeline/runtime.py:imu_subbatch (:405): a
// lax.scan over the frame's ~10 IMU samples. The TPU form fuses each sample
// into VPU code; the plain PyTorch version is several hundred eager launches
// per sample, and their latency was 75-82% of a frame on the H100.
//
// Bound: latency. The work is ~10 samples x (~25k FLOP for F P F^T + the
// two small Kalman updates) on 3 KB of state; a serial chain, no bandwidth
// or FLOP limit is near. Design: one CTA for the whole frame. The 27x27 P
// and the nominal state live in shared memory for every sample (ekf.cuh);
// the nominal propagation, the gates and the measurement set-up run on
// thread 0, the covariance work across the block: B = A P (15x27),
// C = A B^T (15x15), then P += B + B^T + C + Q, the sparse form the plain
// f32 version takes. ZUPT, the complementary filter (m = 2 on roll, pitch)
// and the mounting calibration (m = 3) follow in the reference's gate
// order, each in the reference's P -= K H P form or, with the Joseph flag
// bit, the Joseph form (ekf.cuh: measurement_update). Each sample's (t,
// pos, rpy, vel_local, gyro), the ego ring's fields, is written for the
// batch push, so the batched Euler and local-velocity conversions of the
// plain path need no launch either.
#include "ekf.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

constexpr int kUseZupt = 1, kRunCf = 2, kGravity = 4, kCalibration = 8, kJoseph = 16;

struct Step {
  // the sample's gates, set by thread 0 before the barrier that the CTA
  // reads them after (one flag per update: no flag is rewritten while
  // another thread may still read it)
  bool valid, gate_early, initialized, do_predict, cf_run, cal_run;
  float t, dt, acc[3], gyro[3];
  float G[9], J[9], qd[kN];     // F's blocks and Q's diagonal
  float B[15 * kN], C[15 * 15];
};

// Rows 0:15 of A X at column j (filter._fpf_sparse a_rows), X [27, n]
// given by its element accessor.
template <class X>
__device__ __forceinline__ float a_row(const Step& w, bool gravity, int r, int j, X x) {
  const int blk = r / 3, i = r % 3;
  float gx = 0.0f;
  if (blk != 1 && blk != 3)
    for (int k = 0; k < 3; ++k) gx = add(gx, mul(w.G[3 * i + k], x(18 + k, j)));
  const float hdt2 = mul(mul(0.5f, w.dt), w.dt);
  const bool gz = gravity && i == 2;
  switch (blk) {
    case 0: {  // position
      float v = sub(mul(w.dt, x(6 + i, j)), mul(hdt2, gx));
      return gz ? sub(v, mul(hdt2, x(23, j))) : v;
    }
    case 1: {  // rotation
      float jx = 0.0f;
      for (int k = 0; k < 3; ++k) jx = add(jx, mul(w.J[3 * i + k], x(15 + k, j)));
      return -jx;
    }
    case 2: {  // velocity
      const float v = mul(-w.dt, gx);
      return gz ? sub(v, mul(w.dt, x(23, j))) : v;
    }
    case 3:    // body rates
      return -x(15 + i, j);
    default:   // acceleration
      return gz ? sub(-gx, x(23, j)) : -gx;
  }
}

// Thread 0: the nominal propagation and F's blocks (filter._propagate_imu).
__device__ void propagate_nominal(State& s, Step& w, const Params& prm) {
  const float dt = w.dt;
  quat_to_rot(s.rot, w.G);
  float cg[3], ca[3], dq[4], q[4], ag[3];
  for (int i = 0; i < 3; ++i) {
    cg[i] = sub(w.gyro[i], s.bg[i]);
    ca[i] = sub(w.acc[i], s.ba[i]);
  }
  exp_gyro_to_quat(cg, dt, dq);
  quat_mul(s.rot, dq, q);
  quat_normalize(q, s.rot);
  matvec(w.G, ca, ag);
  for (int i = 0; i < 3; ++i) {
    ag[i] = sub(ag[i], s.grav[i]);
    s.pos[i] = add(add(s.pos[i], mul(s.vel[i], dt)), mul(mul(mul(0.5f, ag[i]), dt), dt));
    s.vel[i] = add(s.vel[i], mul(ag[i], dt));
    s.gyro[i] = cg[i];
    s.acc[i] = ag[i];
  }
  // Process noise Q (cpp:256-272): std^2 dt^2 per 3-block
  const int order[9] = {STD_POS, STD_ROT, STD_VEL, IMU_STD_GYRO, IMU_STD_ACC,
                        BIAS_COV_GYRO, BIAS_COV_ACC, BIAS_COV_ACC, STD_ROT};
  const float dt2 = mul(dt, dt);
  for (int b = 0; b < 9; ++b) {
    const float v = mul(sq(*prm.f[order[b]]), dt2);
    w.qd[3 * b] = w.qd[3 * b + 1] = w.qd[3 * b + 2] = v;
  }
  right_jacobian_d_rot_d_gyro(cg, dt, w.J);
}

// Every thread: P <- F P F^T + Q in the sparse block form.
__device__ void propagate_cov(State& s, Step& w, bool gravity) {
  auto p = [&](int r, int c) { return s.P[r * kN + c]; };
  for (int e = threadIdx.x; e < 15 * kN; e += blockDim.x)
    w.B[e] = a_row(w, gravity, e / kN, e % kN, p);
  __syncthreads();
  auto bt = [&](int r, int c) { return w.B[c * kN + r]; };
  for (int e = threadIdx.x; e < 15 * 15; e += blockDim.x)
    w.C[e] = a_row(w, gravity, e / 15, e % 15, bt);
  __syncthreads();
  for (int e = threadIdx.x; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    float v = s.P[e];
    if (i < 15) v = add(v, w.B[i * kN + j]);
    if (j < 15) v = add(v, w.B[j * kN + i]);
    if (i < 15 && j < 15) v = add(v, w.C[i * 15 + j]);
    s.P[e] = add(v, i == j ? w.qd[i] : 0.0f);
  }
  __syncthreads();
}

// Thread 0: zero-velocity potential update (filter._zupt_imu).
__device__ void zupt(State& s, const Step& w, bool gravity) {
  float vl[3], gl[3], aeg[3], am[3];
  quat_rotate(s.rot, s.vel, vl, true);
  const float avx = fabsf(vl[0]);
  const bool vel_ok = avx <= 0.1f;
  const float vc = mul(divs(sub(0.1f, avx), 0.1f), 0.1f);
  const bool bias_ok = vel_ok && norm3(s.gyro) <= 0.1f && norm2(s.acc[0], s.acc[1]) <= 0.1f;
  quat_rotate(s.rot, s.grav, gl, true);
  for (int i = 0; i < 3; ++i) am[i] = sub(w.acc[i], s.ba[i]);
  quat_rotate(s.rot, am, aeg);
  const float g2 = add(s.grav[2], mul(0.01f, sub(aeg[2], s.grav[2])));
  for (int i = 0; i < 3; ++i) {
    const float ael = sub(w.acc[i], add(gl[i], s.ba[i]));
    if (vel_ok) s.vel[i] = add(s.vel[i], mul(vc, -s.vel[i]));
    if (bias_ok) {
      s.bg[i] = add(s.bg[i], mul(0.01f, sub(w.gyro[i], s.bg[i])));
      s.ba[i] = add(s.ba[i], mul(0.01f, ael));
    }
  }
  if (gravity && bias_ok) s.grav[2] = g2;
}

// Thread 0: the complementary filter's measurement (filter.
// _complementary_filter); returns whether the m = 2 update runs. The C++
// statics advance on both branches.
__device__ bool cf_setup(State& s, const Step& w, Update& u, float& vx_now) {
  float am[3], vl[3], rpy[3];
  for (int i = 0; i < 3; ++i) am[i] = sub(w.acc[i], s.ba[i]);
  quat_rotate(s.rot, s.vel, vl, true);
  const float centr = mul(vl[0], s.gyro[2]);
  const bool first = !s.cf_init;
  const float prev_t = first ? w.t : s.cf_prev_t;
  const float prev_vx = first ? vl[0] : s.cf_prev_vx;
  const float dt = sub(w.t, prev_t);
  bool run = dt >= 1e-6f;
  const float est = dv(sub(vl[0], prev_vx), run ? dt : 1.0f);
  float comp[3] = {am[0], sub(am[1], centr), am[2]};
  if (s.rot_stab) comp[0] = sub(comp[0], est);
  const float acc_diff = sub(norm3(am), norm3(s.grav));
  const float nc = norm3(comp);
  run = run && nc > 1e-12f;
  const float d = nc > 1e-12f ? nc : 1.0f;
  const float g[3] = {dv(comp[0], d), dv(comp[1], d), dv(comp[2], d)};
  quat_to_euler(s.rot, rpy);
  u.m = 2;
  u.idx[0] = 3;
  u.idx[1] = 4;
  u.Y[0] = norm_angle_rad(sub(atan2f(g[1], g[2]), rpy[0]));
  u.Y[1] = norm_angle_rad(sub(-asinf(fminf(fmaxf(g[0], -1.0f), 1.0f)), rpy[1]));
  const float base = s.state_init ? (float)(1.0 * kD2R) : (float)(10.0 * kD2R);
  const float accd = mul(divs(fabsf(acc_diff), 9.81f), 10.0f);
  const float lat = add(add(1.0f, accd), mul(divs(fabsf(centr), 9.81f), 10.0f));
  const float lon = add(add(1.0f, accd), mul(divs(fabsf(est), 9.81f), 10.0f));
  const float min_r = (float)(kD2R * kD2R);
  u.R[0] = fmaxf(sq(mul(base, lat)), min_r);
  u.R[1] = u.R[2] = 0.0f;
  u.R[3] = fmaxf(sq(mul(base, lon)), min_r);
  s.cf_init = true;
  vx_now = vl[0];
  if (!run) {
    s.cf_prev_vx = prev_vx;
    s.cf_prev_t = prev_t;
  }
  return run;
}

// Thread 0: the mounting calibration's measurement (filter.
// _calibrate_vehicle_to_imu; the adaptive R is overwritten by (1 deg)^2).
__device__ bool calib_setup(const State& s, Update& u) {
  const bool run = norm3(s.vel) >= 3.0f && s.rot_stab;
  float ci[4], q[4], vl[3];
  quat_conj(s.imu_rot, ci);
  quat_mul(s.rot, ci, q);
  quat_rotate(q, s.vel, vl, true);
  const float n = norm3(vl), d = n > 1e-12f ? n : 1.0f;
  const float v[3] = {dv(vl[0], d), dv(vl[1], d), dv(vl[2], d)};
  u.m = 3;
  for (int i = 0; i < 3; ++i) u.idx[i] = 24 + i;
  u.Y[0] = 0.0f;
  u.Y[1] = asinf(fminf(fmaxf(v[2], -1.0f), 1.0f));  // -pitch
  u.Y[2] = -atan2f(v[1], v[0]);                     // -yaw
  for (int e = 0; e < 9; ++e) u.R[e] = e % 4 == 0 ? (float)(kD2R * kD2R) : 0.0f;
  return run;
}

__global__ void __launch_bounds__(kThreads) imu_chain_kernel(
    Fields in, Fields out, Params prm, const float* __restrict__ ts,
    const float* __restrict__ acc, const float* __restrict__ gyro,
    const bool* __restrict__ valid, int n, int flags, float* __restrict__ h_t,
    float* __restrict__ h_pos, float* __restrict__ h_rpy, float* __restrict__ h_vloc,
    float* __restrict__ h_gyro) {
  __shared__ State s;
  __shared__ Step w;
  __shared__ Update u;
  const bool gravity = flags & kGravity;
  const bool joseph = flags & kJoseph;
  load_state(in, s);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (threadIdx.x == 0) {
      w.valid = valid[k];
      w.t = ts[k];
      for (int i = 0; i < 3; ++i) {
        w.acc[i] = acc[3 * k + i];
        w.gyro[i] = gyro[3 * k + i];
      }
      // predict_imu's gates, in the reference's order
      w.gate_early = s.reset || s.pcm_init_going;
      w.initialized = s.state_init;
      w.dt = sub(w.t, s.prev_t);
      w.do_predict = w.valid && !w.gate_early && w.initialized && fabsf(w.dt) >= 1e-6f;
      if (w.valid && !w.gate_early) s.rot_stab = rotation_stabilized(s);
      if (w.do_predict) propagate_nominal(s, w, prm);
    }
    __syncthreads();
    if (w.do_predict) {
      propagate_cov(s, w, gravity);
      if ((flags & kUseZupt) && threadIdx.x == 0) zupt(s, w, gravity);
    }
    if (w.valid && (flags & kRunCf)) {
      float vx_now = 0.0f;
      if (threadIdx.x == 0)
        w.cf_run = (w.do_predict || (!w.gate_early && !w.initialized && s.yaw_init)) &&
                   cf_setup(s, w, u, vx_now);
      __syncthreads();
      if (w.cf_run) {
        measurement_update(s, u, joseph);
        if (threadIdx.x == 0) {
          s.cf_prev_vx = vx_now;
          s.cf_prev_t = w.t;
        }
      }
    }
    if ((flags & kCalibration) && w.do_predict) {
      if (threadIdx.x == 0) w.cal_run = calib_setup(s, u);
      __syncthreads();
      if (w.cal_run) {
        measurement_update(s, u, joseph);
        if (threadIdx.x == 0) s.calib_started = true;
      }
    }
    if (threadIdx.x == 0) {
      if (w.valid) {
        if (w.gate_early || !w.initialized || w.do_predict) s.prev_t = w.t;
        s.reset = false;
      }
      // the sample's ego-ring entry
      float rpy[3], vloc[3];
      quat_to_euler(s.rot, rpy);
      global_to_local(s.vel, rpy, vloc);
      h_t[k] = s.prev_t;
      for (int i = 0; i < 3; ++i) {
        h_pos[3 * k + i] = s.pos[i];
        h_rpy[3 * k + i] = rpy[i];
        h_vloc[3 * k + i] = vloc[i];
        h_gyro[3 * k + i] = s.gyro[i];
      }
    }
    __syncthreads();
  }
  store_state(s, out);
}

}  // namespace

extern "C" int elm_imu_chain(void* const* in, void* const* out, const float* const* params,
                             const float* ts, const float* acc, const float* gyro,
                             const bool* valid, int n, int flags, float* h_t, float* h_pos,
                             float* h_rpy, float* h_vloc, float* h_gyro,
                             cudaStream_t stream) {
  Fields fi, fo;
  Params prm;
  for (int i = 0; i < kFields; ++i) {
    fi.f[i] = in[i];
    fo.f[i] = out[i];
  }
  for (int i = 0; i < kParams; ++i) prm.f[i] = params[i];
  imu_chain_kernel<<<1, kThreads, 0, stream>>>(fi, fo, prm, ts, acc, gyro, valid, n, flags,
                                               h_t, h_pos, h_rpy, h_vloc, h_gyro);
  return (int)cudaGetLastError();
}
