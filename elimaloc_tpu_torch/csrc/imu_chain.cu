// Kernel H: the frame's IMU stage (K7 and the K8 ring pushes), one launch.
//
// Replaces elimaloc_tpu/pipeline/runtime.py:imu_subbatch (:405-441), which
// the JAX package runs as one XLA program: the sensor-frame conversion
// (ops/frames.py:imu_to_ego with its lever-arm term, and PCM's rotation-only
// intake, runtime.py:420-423), the lax.scan of elimaloc_tpu/ekf/filter.py:
// predict_imu (:520) over the frame's IMU samples with _propagate_imu (:344),
// _fpf_sparse (:306), _zupt_imu (:390), _complementary_filter (:424) and
// _calibrate_vehicle_to_imu (:493), the ego-ring rows (:435-436) and the
// batch pushes into the ego and IMU rings (pipeline/rings.py:183, :192). The
// event loop's imu_step is the same stage on one sample.
//
// Bound: latency. The work is ~10 samples x (~25k FLOP for F P F^T + the
// two small Kalman updates) on a 3 KB state and rings of a few hundred rows;
// a serial chain, no bandwidth or FLOP limit is near. Design: one launch of
// two CTAs that share nothing.
//   CTA 1 rotates the samples into the ego frame (no lever arm) and pushes
//   the IMU ring (rings.cuh), which depends on the raw samples alone: it
//   runs beside the chain (imu_intake, which kernel V runs alone).
//   CTA 0 stages the state record, the params record and every sample (each
//   converted by one thread, acc + w x (w x (-r)) after the rotation) into
//   shared memory, so no serial step reads global memory. Per sample thread
//   0 runs the gates and the nominal step (F's blocks, Q); then warp 0 runs
//   ZUPT and the complementary filter's set-up, which read only the nominal
//   state, while warps 1.. form B = A P (15x27), C = A B^T (15x15) and
//   P += B + B^T + C + Q (the sparse form of the plain f32 version) under
//   their own named barrier; then the CTA runs the complementary filter's
//   m = 2 and the mounting calibration's m = 3 update (each in the
//   reference's P -= K H P form or, with the Joseph bit, the Joseph form:
//   ekf.cuh measurement_update), and thread 0 records the sample's
//   (t, pos, rot, vel, gyro). After the chain every thread converts its
//   samples' rows (Euler angles, local velocity), the CTA writes the state
//   record and pushes the ego ring from those rows in shared memory.
// Every arithmetic step is the plain version's, in its order, with the
// rounding helpers of common.cuh and ekf.cuh (no FMA contraction).
// Lanes: a fleet frame (replay_fused_fleet's vmap, elimaloc_tpu/parallel/
// sharding.py:256-281) launches a grid of (2, B): CTA pair l runs lane l,
// its record, samples and rings at their lane strides; the serial chain
// stays one lane's. One lane is the single launch.
//
// Kernel V: the tick mode's IMU-only intake (use_imu=False), one launch an
// IMU sample. Replaces elimaloc_tpu/pipeline/runtime.py:imu_ring_step
// (:237-246): the sample rotated by ego_to_imu_rot without lever-arm
// compensation, pushed into the IMU ring (pipeline/rings.py:126 as :192,
// eps 0). Bound: latency (a 256 x 7-float ring copied each way). Design:
// H's CTA-1 work (imu_intake) run as one CTA, so V's ring is H's bit for
// bit on the same sample.
#include "ekf.cuh"
#include "rings.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

constexpr int kUseZupt = 1, kRunCf = 2, kGravity = 4, kCalibration = 8, kJoseph = 16;

struct Step {
  // the sample's gates, set by thread 0 before the barrier that the CTA
  // reads them after (one flag per update: no flag is rewritten while
  // another thread may still read it)
  bool valid, gate_early, initialized, do_predict, cf_run, cal_run;
  float t, dt, acc[3], gyro[3], vx_now;
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
    const float v = mul(sq(prm.v[order[b]]), dt2);
    w.qd[3 * b] = w.qd[3 * b + 1] = w.qd[3 * b + 2] = v;
  }
  right_jacobian_d_rot_d_gyro(cg, dt, w.J);
}

// Warps 1..: P <- F P F^T + Q in the sparse block form, while warp 0 runs
// the nominal-state work that reads no P; their own barrier (bar 1) between
// the passes, the caller's __syncthreads after the last.
__device__ __forceinline__ void cov_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

__device__ void propagate_cov(State& s, Step& w, bool gravity) {
  const int tid = threadIdx.x - 32, nt = blockDim.x - 32;
  auto p = [&](int r, int c) { return s.P[r * kN + c]; };
  for (int e = tid; e < 15 * kN; e += nt) w.B[e] = a_row(w, gravity, e / kN, e % kN, p);
  cov_sync(nt);
  auto bt = [&](int r, int c) { return w.B[c * kN + r]; };
  for (int e = tid; e < 15 * 15; e += nt) w.C[e] = a_row(w, gravity, e / 15, e % 15, bt);
  cov_sync(nt);
  for (int e = tid; e < kN * kN; e += nt) {
    const int i = e / kN, j = e % kN;
    float v = s.P[e];
    if (i < 15) v = add(v, w.B[i * kN + j]);
    if (j < 15) v = add(v, w.B[j * kN + i]);
    if (i < 15 && j < 15) v = add(v, w.C[i * 15 + j]);
    s.P[e] = add(v, i == j ? w.qd[i] : 0.0f);
  }
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

// Per-sample arrays in dynamic shared memory: the times, the converted acc
// and gyro [n, 3] and, on CTA 0, the ego rows (t, pos, rpy, vel_local,
// gyro: 13 floats a sample) and the chain's snapshots of rot and vel; then
// the push's ranks and the validity flags.
struct Samples {
  float *t, *a, *g, *ht, *hpos, *hrpy, *hvloc, *hgyro, *rot, *vel;
  int* ranks;
  bool* valid;
};

__host__ __device__ constexpr size_t samples_bytes(int n, int cap) {
  return (size_t)27 * n * sizeof(float) + (size_t)(n < cap ? n : cap) * sizeof(int) + n;
}

__device__ __forceinline__ Samples carve(char* base, int n, int cap) {
  float* f = reinterpret_cast<float*>(base);
  Samples m;
  m.t = f;
  m.a = f + n;
  m.g = f + 4 * n;
  m.ht = f + 7 * n;
  m.hpos = f + 8 * n;
  m.hrpy = f + 11 * n;
  m.hvloc = f + 14 * n;
  m.hgyro = f + 17 * n;
  m.rot = f + 20 * n;
  m.vel = f + 24 * n;
  m.ranks = reinterpret_cast<int*>(f + 27 * n);
  m.valid = reinterpret_cast<bool*>(m.ranks + (n < cap ? n : cap));
  return m;
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
  o[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  o[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  o[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

struct Args {
  const int* rec_in;
  int* rec_out;
  const float* prm;
  const float *ts, *acc, *gyro;
  const bool* valid;  // null: every sample valid
  int n, flags;
  const float *rot, *trans;  // ego_to_imu [3, 3], [3]
  ring::Ring ego, imu;
};

// The whole CTA (H's CTA 1, kernel V's one): the n samples rotated by
// ``rot`` (ego_to_imu_rot [3, 3], no lever arm: runtime.py:420-423,
// :237-246) into ``m``'s t, g and a, then pushed into the IMU ring ``g``.
__device__ void imu_intake(const float* __restrict__ ts, const float* __restrict__ acc,
                           const float* __restrict__ gyro, const bool* __restrict__ valid,
                           int n, const float* __restrict__ rot, ring::Ring g,
                           const Samples& m) {
  __shared__ float R[9];
  if (threadIdx.x < 9) R[threadIdx.x] = rot[threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    m.t[j] = ts[j];
    m.valid[j] = valid == nullptr || valid[j];
    float ai[3], gi[3];
    for (int c = 0; c < 3; ++c) {
      ai[c] = acc[3 * j + c];
      gi[c] = gyro[3 * j + c];
    }
    matvec(R, gi, m.g + 3 * j);
    matvec(R, ai, m.a + 3 * j);
  }
  __syncthreads();
  g.new_t = m.t;
  g.new_f[0] = m.g;
  g.new_f[1] = m.a;
  ring::push(g, n, m.valid, m.ranks);
}

// Args ``a`` at lane ``l``: the record, the samples and the rings at their
// lane strides.
__device__ __forceinline__ Args lane_args(const Args& in, int l) {
  Args a = in;
  a.rec_in += l * kRecordWords;
  a.rec_out += l * kRecordWords;
  a.ts += (size_t)l * a.n;
  a.acc += (size_t)3 * l * a.n;
  a.gyro += (size_t)3 * l * a.n;
  if (a.valid != nullptr) a.valid += (size_t)l * a.n;
  a.ego = ring::lane_of(a.ego, l);
  a.imu = ring::lane_of(a.imu, l);
  return a;
}

__global__ void __launch_bounds__(kThreads) imu_stage_kernel(const __grid_constant__ Args in) {
  extern __shared__ __align__(16) char smem[];
  __shared__ State s;
  __shared__ Params prm;
  __shared__ Step w;
  __shared__ Update u;
  __shared__ float R[9], neg_r[3];
  const Args a = lane_args(in, blockIdx.y);
  const int n = a.n;
  if (blockIdx.x == 1) {
    imu_intake(a.ts, a.acc, a.gyro, a.valid, n, a.rot, a.imu, carve(smem, n, a.imu.cap));
    return;
  }
  const Samples m = carve(smem, n, a.ego.cap);
  if (threadIdx.x < 9) R[threadIdx.x] = a.rot[threadIdx.x];
  if (threadIdx.x < 3) neg_r[threadIdx.x] = -a.trans[threadIdx.x];
  load_state(a.rec_in, s);
  load_params(a.prm, prm);
  __syncthreads();
  // the samples in the ego frame (ops/frames.py imu_to_ego: the rotation,
  // then the lever arm)
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    m.t[j] = a.ts[j];
    m.valid[j] = a.valid == nullptr || a.valid[j];
    float ai[3], gi[3], ar[3], gr[3], c1[3], c2[3];
    for (int c = 0; c < 3; ++c) {
      ai[c] = a.acc[3 * j + c];
      gi[c] = a.gyro[3 * j + c];
    }
    matvec(R, gi, gr);
    matvec(R, ai, ar);
    cross(gr, neg_r, c1);
    cross(gr, c1, c2);
    for (int c = 0; c < 3; ++c) {
      m.a[3 * j + c] = add(ar[c], c2[c]);
      m.g[3 * j + c] = gr[c];
    }
  }
  __syncthreads();
  const bool gravity = a.flags & kGravity, joseph = a.flags & kJoseph;
  const bool run_cf = a.flags & kRunCf, use_zupt = a.flags & kUseZupt;
  for (int k = 0; k < n; ++k) {
    if (threadIdx.x == 0) {
      w.valid = m.valid[k];
      w.t = m.t[k];
      for (int i = 0; i < 3; ++i) {
        w.acc[i] = m.a[3 * k + i];
        w.gyro[i] = m.g[3 * k + i];
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
    const bool cf_here = w.valid && run_cf;
    if (w.do_predict || cf_here) {
      if (threadIdx.x == 0) {
        if (w.do_predict && use_zupt) zupt(s, w, gravity);
        w.cf_run = cf_here &&
                   (w.do_predict || (!w.gate_early && !w.initialized && s.yaw_init)) &&
                   cf_setup(s, w, u, w.vx_now);
      } else if (threadIdx.x >= 32 && w.do_predict) {
        propagate_cov(s, w, gravity);
      }
      __syncthreads();
      if (w.cf_run) {
        measurement_update(s, u, joseph);
        if (threadIdx.x == 0) {
          s.cf_prev_vx = w.vx_now;
          s.cf_prev_t = w.t;
        }
      }
    }
    if ((a.flags & kCalibration) && w.do_predict) {
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
      // the sample's ego-ring entry, converted after the chain
      m.ht[k] = s.prev_t;
      for (int i = 0; i < 3; ++i) {
        m.hpos[3 * k + i] = s.pos[i];
        m.hgyro[3 * k + i] = s.gyro[i];
        m.vel[3 * k + i] = s.vel[i];
      }
      for (int i = 0; i < 4; ++i) m.rot[4 * k + i] = s.rot[i];
    }
    __syncthreads();
  }
  // ego_history: one sample a thread
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    quat_to_euler(m.rot + 4 * j, m.hrpy + 3 * j);
    global_to_local(m.vel + 3 * j, m.hrpy + 3 * j, m.hvloc + 3 * j);
  }
  __syncthreads();
  store_state(s, a.rec_out);
  ring::Ring g = a.ego;
  g.new_t = m.ht;
  g.new_f[0] = m.hpos;
  g.new_f[1] = m.hrpy;
  g.new_f[2] = m.hvloc;
  g.new_f[3] = m.hgyro;
  ring::push(g, n, m.valid, m.ranks);
}

// Kernel V: one sample through imu_intake, its staging in static shared
// memory.
__global__ void __launch_bounds__(kThreads) imu_intake_kernel(
    const float* __restrict__ t, const float* __restrict__ acc,
    const float* __restrict__ gyro, const float* __restrict__ rot,
    const __grid_constant__ ring::Ring imu) {
  __shared__ __align__(16) char smem[samples_bytes(1, 1)];
  imu_intake(t, acc, gyro, nullptr, 1, rot, imu, carve(smem, 1, 1));
}

}  // namespace

// ego: t, pos, rpy, vel_local, gyro, count of the ego ring in; imu: t, gyro,
// acc, count of the IMU ring in; rings_out: the ego ring's t [ego_cap] and
// its four [ego_cap, 3] fields, the IMU ring's t [imu_cap] and its two
// [imu_cap, 3] fields, then the two int32 counts. ``lanes`` frames, one pair
// of CTAs each: the records, the samples ([lanes, n], [lanes, n, 3]) and
// the rings in at their lane strides; rings_out holds the ego ring's t
// [lanes, ego_cap] and each of its fields [lanes, ego_cap, 3], the IMU
// ring's likewise, then the ego counts [lanes] and the IMU counts [lanes].
extern "C" int elm_imu_stage(const void* rec_in, void* rec_out, const float* params,
                             const float* ts, const float* acc, const float* gyro,
                             const bool* valid, int n, const float* rot, const float* trans,
                             int flags, void* const* ego, int ego_cap, void* const* imu,
                             int imu_cap, int lanes, float* rings_out, cudaStream_t stream) {
  Args a;
  a.rec_in = (const int*)rec_in;
  a.rec_out = (int*)rec_out;
  a.prm = params;
  a.ts = ts;
  a.acc = acc;
  a.gyro = gyro;
  a.valid = valid;
  a.n = n;
  a.flags = flags;
  a.rot = rot;
  a.trans = trans;
  ring::fill_in(a.ego, ego_cap, 4, 1e-5f, ego);
  ring::fill_in(a.imu, imu_cap, 2, 0.0f, imu);
  float* imu_out = rings_out + (size_t)13 * lanes * ego_cap;
  int* counts = (int*)(imu_out + (size_t)7 * lanes * imu_cap);
  ring::fill_out(a.ego, rings_out, counts, lanes);
  ring::fill_out(a.imu, imu_out, counts + lanes, lanes);
  const size_t bytes = samples_bytes(n, ego_cap > imu_cap ? ego_cap : imu_cap);
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    const cudaError_t rc = cudaFuncSetAttribute(
        imu_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
    allowed = bytes;
  }
  imu_stage_kernel<<<dim3(2, lanes), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// imu: t, gyro, acc, count of the IMU ring in; ring_out: its t [imu_cap]
// and its two [imu_cap, 3] fields, then the int32 count. One sample (t,
// acc [3], gyro [3], raw) and ego_to_imu_rot [3, 3].
extern "C" int elm_imu_intake(void* const* imu, int imu_cap, const float* t, const float* acc,
                              const float* gyro, const float* rot, float* ring_out,
                              cudaStream_t stream) {
  ring::Ring g;
  ring::fill_in(g, imu_cap, 2, 0.0f, imu);
  ring::fill_out(g, ring_out, (int*)(ring_out + 7 * imu_cap));
  imu_intake_kernel<<<1, kThreads, 0, stream>>>(t, acc, gyro, rot, g);
  return (int)cudaGetLastError();
}
