// Shared device code of kernels H (imu_chain.cu) and I (ekf_update.cu): the
// 27-state EKF held in shared memory by one CTA, the quaternion / rotation
// helpers of ops/lie.py, the right Jacobian, and one Kalman update over an
// index list for m = 2, 3, 4, 6 (ekf/filter.py:_ekf_measurement_update), in
// the reference's P -= K H P form or the Joseph form. Kernel O
// (ca_tick.cu) shares the state, its load and store and the helpers.
//
// The state and the parameters come and go as packed records (ekf/state.py
// RECORD_FIELDS, PARAM_FIELDS): ``State`` below IS the state record's
// layout, so load_state / store_state are one coalesced copy of 768 words
// by the whole CTA, and ``Params`` the params record's; after them no
// serial step of a kernel reads global memory for the filter.
// Kernels K (scan_ring.cu), L (pcm_meas.cu) and M (gn_step.cu) use its
// rotation helpers too, with so3_log, the 4x4 rigid transforms of lie.py
// (compose, transform_inverse, interpolate_tf_with_time) and the LU with
// partial pivoting (lu_factor / lu_solve) that kernel I's m = 4, 6 solves
// and kernel M's 6x6 LM step share.
//
// Numerics. Each helper repeats the plain PyTorch version's arithmetic in
// its order, one IEEE-rounded operation at a time (elm::mul / add / sub /
// __fdiv_rn: nvcc never contracts them into FMAs), with the CUDA math
// library's sinf / cosf / atan2f / asinf / sqrtf, never the __sinf family
// (the package builds without --use_fast_math). That matters most in the
// right Jacobian: at the headline rates |w| dt ~ 1.3e-3, and the f32 terms
// (1 - cos t) / t^2 and (t - sin t) / t^3 cancel catastrophically, so one
// ulp of t or of cos t moves them by percent. Small dot products are summed
// left to right, as PyTorch's reductions over 2-6 terms are. PyTorch's CUDA
// tensor / Python-scalar division multiplies by the float reciprocal; divs()
// does the same.
//
// Every loop that the CTA shares is strided by blockDim.x and every serial
// step runs on thread 0 between barriers, so the result does not depend on
// the block size.
#pragma once

#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace elm {
namespace ekf {

constexpr int kN = 27;          // STATE_ORDER
constexpr double kPi = 3.14159265358979323846;
constexpr double kD2R = kPi / 180.0;  // math.pi / 180.0 in the plain version

// EkfParams' fields: each one's offset in the params record, in floats
// (ekf/state.py PARAM_FIELDS; INIT_POS, INIT_RPY [3], GNSS_MIN_COV [6]).
enum Param {
  INIT_POS = 0, INIT_RPY = 3, IMU_GRAVITY = 6, STD_POS = 7, STD_ROT = 8, STD_VEL = 9,
  STD_GYRO_DPS = 10, STD_ACC = 11, IMU_STD_GYRO = 12, IMU_STD_ACC = 13, BIAS_COV_GYRO = 14,
  BIAS_COV_ACC = 15, GNSS_MIN_COV = 16, CAN_VEL_SCALE = 22, CAN_UNC_VEL = 23, CAN_UNC_YAW = 24,
  kParamWords = 32
};

struct Params {
  float v[kParamWords];
};

// The filter in shared memory, in the state record's layout (ekf/state.py
// RECORD_FIELDS for float32): P, the nominal vectors, the float scalars,
// the counter, the eight flags, padding to 16 bytes.
struct State {
  float P[kN * kN];
  float pos[3], rot[4], vel[3], gyro[3], acc[3], bg[3], ba[3], grav[3], imu_rot[4];
  float can_bias, prev_t, prev_gnss_t, prev_can_t, cf_prev_vx, cf_prev_t;
  int pcm_count;
  bool reset, state_init, yaw_init, rot_stab, state_stab, pcm_init_going, calib_started,
      cf_init;
  char pad[4];
};

// Byte offsets of the record's fields in RECORD_FIELDS order, and its size;
// the wrappers' layout (ekf/state.py record_layout(float32)) is held to them
// by tests/test_torch_kernels.py.
constexpr int kRecordOffsets[] = {0,    2916, 2928, 2944, 2956, 2968, 2980, 2992, 3004,
                                  3016, 3032, 3036, 3040, 3044, 3048, 3052, 3056, 3060,
                                  3061, 3062, 3063, 3064, 3065, 3066, 3067};
constexpr int kRecordBytes = 3072;
constexpr int kRecordWords = kRecordBytes / 4;
static_assert(sizeof(State) == kRecordBytes, "State is the record");
static_assert(offsetof(State, pos) == kRecordOffsets[1] &&
                  offsetof(State, imu_rot) == kRecordOffsets[9] &&
                  offsetof(State, can_bias) == kRecordOffsets[10] &&
                  offsetof(State, cf_prev_t) == kRecordOffsets[15] &&
                  offsetof(State, pcm_count) == kRecordOffsets[16] &&
                  offsetof(State, reset) == kRecordOffsets[17] &&
                  offsetof(State, cf_init) == kRecordOffsets[24],
              "State's members at the record's offsets");

// Scratch of one Kalman update (m <= 6); Pi holds H P, then in the Joseph
// form the observed columns of (I - K H) P, and KR holds K R.
struct Update {
  int m, idx[6], piv[6];
  float Y[6], R[36], S[36], Pi[6 * kN], K[kN * 6], KR[kN * 6], su[kN];
};

__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
// PyTorch's CUDA ``tensor / python_float``: a times the float reciprocal.
__device__ __forceinline__ float divs(float a, float c) { return mul(a, 1.0f / c); }
__device__ __forceinline__ float sq(float a) { return mul(a, a); }

__device__ __forceinline__ void copy(const float* a, float* o, int n) {
  for (int i = 0; i < n; ++i) o[i] = a[i];
}

// ---- lie.py -------------------------------------------------------------

__device__ __forceinline__ float norm2(float a, float b) { return sqrtf(add(sq(a), sq(b))); }
__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(add(add(sq(v[0]), sq(v[1])), sq(v[2])));
}
__device__ __forceinline__ float norm4(const float* v) {
  return sqrtf(add(add(add(sq(v[0]), sq(v[1])), sq(v[2])), sq(v[3])));
}

// m v (lie.matvec), row-major m.
__device__ __forceinline__ void matvec(const float* m, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = add(add(mul(m[3 * i], v[0]), mul(m[3 * i + 1], v[1])), mul(m[3 * i + 2], v[2]));
}

// a b for row-major 3x3 (bt: b transposed).
__device__ __forceinline__ void matmul3(const float* a, const float* b, float* o, bool bt) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc = add(acc, mul(a[3 * i + k], bt ? b[3 * j + k] : b[3 * k + j]));
      o[3 * i + j] = acc;
    }
}

__device__ __forceinline__ void quat_normalize(const float* q, float* o) {
  float n = norm4(q);
  if (n < 1e-30f) n = 1.0f;
  for (int i = 0; i < 4; ++i) o[i] = dv(q[i], n);
}

// Hamilton product a (x) b.
__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* o) {
  const float aw = a[0], ax = a[1], ay = a[2], az = a[3];
  const float bw = b[0], bx = b[1], by = b[2], bz = b[3];
  o[0] = sub(sub(sub(mul(aw, bw), mul(ax, bx)), mul(ay, by)), mul(az, bz));
  o[1] = sub(add(add(mul(aw, bx), mul(ax, bw)), mul(ay, bz)), mul(az, by));
  o[2] = add(add(sub(mul(aw, by), mul(ax, bz)), mul(ay, bw)), mul(az, bx));
  o[3] = add(sub(add(mul(aw, bz), mul(ax, by)), mul(ay, bx)), mul(az, bw));
}

__device__ __forceinline__ void quat_conj(const float* q, float* o) {
  o[0] = q[0];
  o[1] = -q[1];
  o[2] = -q[2];
  o[3] = -q[3];
}

// Unit quaternion -> rotation matrix (normalizes first).
__device__ __forceinline__ void quat_to_rot(const float* q_in, float* r) {
  float q[4];
  quat_normalize(q_in, q);
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  r[0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  r[1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
  r[2] = mul(2.0f, add(mul(x, z), mul(w, y)));
  r[3] = mul(2.0f, add(mul(x, y), mul(w, z)));
  r[4] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  r[5] = mul(2.0f, sub(mul(y, z), mul(w, x)));
  r[6] = mul(2.0f, sub(mul(x, z), mul(w, y)));
  r[7] = mul(2.0f, add(mul(y, z), mul(w, x)));
  r[8] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
}

// Rotate v by q (lie.quat_rotate); conj: by q's conjugate.
__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* o,
                                            bool conj = false) {
  float c[4], r[9];
  if (conj) {
    quat_conj(q, c);
    quat_to_rot(c, r);
  } else {
    quat_to_rot(q, r);
  }
  matvec(r, v, o);
}

// Rotation matrix -> unit quaternion with w >= 0, the branch the plain
// version's max-pivot select keeps.
__device__ __forceinline__ void rot_to_quat(const float* m, float* o) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = add(add(m00, m11), m22);
  float q[4];
  if (tr > 0.0f) {
    const float s = mul(sqrtf(fmaxf(add(1.0f, tr), 1e-30f)), 2.0f);
    q[0] = mul(0.25f, s);
    q[1] = dv(sub(m21, m12), s);
    q[2] = dv(sub(m02, m20), s);
    q[3] = dv(sub(m10, m01), s);
  } else if (m00 >= m11 && m00 >= m22) {
    const float s = mul(sqrtf(fmaxf(sub(sub(add(1.0f, m00), m11), m22), 1e-30f)), 2.0f);
    q[0] = dv(sub(m21, m12), s);
    q[1] = mul(0.25f, s);
    q[2] = dv(add(m01, m10), s);
    q[3] = dv(add(m02, m20), s);
  } else if (m11 >= m22) {
    const float s = mul(sqrtf(fmaxf(sub(add(sub(1.0f, m00), m11), m22), 1e-30f)), 2.0f);
    q[0] = dv(sub(m02, m20), s);
    q[1] = dv(add(m01, m10), s);
    q[2] = mul(0.25f, s);
    q[3] = dv(add(m12, m21), s);
  } else {
    const float s = mul(sqrtf(fmaxf(add(sub(sub(1.0f, m00), m11), m22), 1e-30f)), 2.0f);
    q[0] = dv(sub(m10, m01), s);
    q[1] = dv(add(m02, m20), s);
    q[2] = dv(add(m12, m21), s);
    q[3] = mul(0.25f, s);
  }
  quat_normalize(q, o);
  if (o[0] < 0.0f)
    for (int i = 0; i < 4; ++i) o[i] = -o[i];
}

__device__ __forceinline__ void skew(const float* u, float* k) {
  k[0] = 0.0f;
  k[1] = -u[2];
  k[2] = u[1];
  k[3] = u[2];
  k[4] = 0.0f;
  k[5] = -u[0];
  k[6] = -u[1];
  k[7] = u[0];
  k[8] = 0.0f;
}

// omega -> (theta, k = skew(omega / theta) with theta -> 1 below the 1e-5
// guard, small).
__device__ __forceinline__ bool axis_of(const float* omega, float& theta, float* k) {
  theta = norm3(omega);
  const bool small = theta < 1e-5f;
  const float safe = small ? 1.0f : theta;
  const float u[3] = {dv(omega[0], safe), dv(omega[1], safe), dv(omega[2], safe)};
  skew(u, k);
  return small;
}

// Rodrigues (lie.so3_exp).
__device__ __forceinline__ void so3_exp(const float* omega, float* r) {
  float theta, k[9], kk[9];
  const bool small = axis_of(omega, theta, k);
  matmul3(k, k, kk, false);
  const float s = sinf(theta), c1 = sub(1.0f, cosf(theta));
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.0f : 0.0f;
    r[i] = small ? e : add(add(e, mul(s, k[i])), mul(c1, kk[i]));
  }
}

// Quaternion increment from body rates over dt (lie.exp_gyro_to_quat).
__device__ __forceinline__ void exp_gyro_to_quat(const float* gyro, float dt, float* q) {
  const float omega[3] = {mul(gyro[0], dt), mul(gyro[1], dt), mul(gyro[2], dt)};
  float r[9];
  so3_exp(omega, r);
  rot_to_quat(r, q);
}

// d Exp(gyro dt) / d gyro (lie.right_jacobian_d_rot_d_gyro), its formula
// and order; zero below the guard.
__device__ __forceinline__ void right_jacobian_d_rot_d_gyro(const float* gyro, float dt,
                                                            float* jac) {
  const float omega[3] = {mul(gyro[0], dt), mul(gyro[1], dt), mul(gyro[2], dt)};
  float theta, k[9], kk[9];
  const bool small = axis_of(omega, theta, k);
  const float t = small ? 1.0f : theta;
  matmul3(k, k, kk, false);
  const float tt = mul(t, t);
  const float a = dv(sub(1.0f, cosf(t)), tt);
  const float b = dv(sub(t, sinf(t)), mul(tt, t));
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.0f : 0.0f;
    jac[i] = small ? 0.0f : mul(dt, add(add(e, mul(a, k[i])), mul(b, kk[i])));
  }
}

// Rotation vector -> quaternion, identity below 1e-12 (lie.quat_from_axis_angle).
__device__ __forceinline__ void quat_from_axis_angle(const float* v, float* q) {
  const float angle = norm3(v);
  if (angle < 1e-12f) {
    q[0] = 1.0f;
    q[1] = q[2] = q[3] = 0.0f;
    return;
  }
  const float half = mul(0.5f, angle), s = sinf(half);
  q[0] = cosf(half);
  for (int i = 0; i < 3; ++i) q[i + 1] = mul(s, dv(v[i], angle));
}

// C fmod renormalisation of lie.rot_to_euler.
__device__ __forceinline__ float wrap_fmod(float a) {
  return sub(fmodf(add(a, (float)kPi), (float)(2.0 * kPi)), (float)kPi);
}

// Wrap to (-pi, pi] (lie.norm_angle_rad; torch.remainder has the sign of
// the divisor).
__device__ __forceinline__ float norm_angle_rad(float a) {
  const float b = (float)(2.0 * kPi);
  float r = fmodf(add(a, (float)kPi), b);
  if (r != 0.0f && ((b < 0.0f) != (r < 0.0f))) r = add(r, b);
  const float w = sub(r, (float)kPi);
  return w == -(float)kPi ? (float)kPi : w;
}

// Rotation matrix -> (roll, pitch, yaw) with the gimbal-lock branch.
__device__ __forceinline__ void rot_to_euler(const float* r, float* rpy) {
  const float r20 = r[6];
  if (fabsf(r20) > 0.998f) {
    rpy[0] = 0.0f;
    rpy[1] = mul((float)(kPi / 2.0), r20 >= 0.0f ? 1.0f : -1.0f);
    rpy[2] = atan2f(-r[5], r[4]);
  } else {
    rpy[1] = asinf(-fminf(fmaxf(r20, -1.0f), 1.0f));
    float cp = cosf(rpy[1]);
    if (fabsf(cp) < 1e-12f) cp = 1.0f;
    rpy[0] = atan2f(dv(r[7], cp), dv(r[8], cp));
    rpy[2] = atan2f(dv(r[3], cp), dv(r[0], cp));
  }
  for (int i = 0; i < 3; ++i) rpy[i] = wrap_fmod(rpy[i]);
}

__device__ __forceinline__ void quat_to_euler(const float* q, float* rpy) {
  float r[9];
  quat_to_rot(q, r);
  rot_to_euler(r, rpy);
}

// Rz(yaw) Ry(pitch) Rx(roll) (lie.euler_to_rot).
__device__ __forceinline__ void euler_to_rot(const float* rpy, float* m) {
  const float cr = cosf(rpy[0]), sr = sinf(rpy[0]);
  const float cp = cosf(rpy[1]), sp = sinf(rpy[1]);
  const float cy = cosf(rpy[2]), sy = sinf(rpy[2]);
  m[0] = mul(cy, cp);
  m[1] = sub(mul(mul(cy, sp), sr), mul(sy, cr));
  m[2] = add(mul(mul(cy, sp), cr), mul(sy, sr));
  m[3] = mul(sy, cp);
  m[4] = add(mul(mul(sy, sp), sr), mul(cy, cr));
  m[5] = sub(mul(mul(sy, sp), cr), mul(cy, sr));
  m[6] = -sp;
  m[7] = mul(cp, sr);
  m[8] = mul(cp, cr);
}

// R(rpy)^T v (frames.global_to_local_velocity).
__device__ __forceinline__ void global_to_local(const float* v, const float* rpy, float* o) {
  float m[9], mt[9];
  euler_to_rot(rpy, m);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) mt[3 * i + j] = m[3 * j + i];
  matvec(mt, v, o);
}

// Per-axis wrapped Euler residual of two quaternions.
__device__ __forceinline__ void euler_residual_from_quats(const float* sq_, const float* mq,
                                                          float* res) {
  float s[3], m[3];
  quat_to_euler(sq_, s);
  quat_to_euler(mq, m);
  for (int i = 0; i < 3; ++i) res[i] = norm_angle_rad(sub(m[i], s[i]));
}

// Closed-form 3x3 inverse, adjugate / det (lie.inv3x3), exact rounding.
__device__ __forceinline__ void inv3x3(const float* m, float* o) {
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5];
  const float g = m[6], h = m[7], i = m[8];
  const float A = sub(mul(e, i), mul(f, h));
  const float B = -sub(mul(d, i), mul(f, g));
  const float C = sub(mul(d, h), mul(e, g));
  const float inv_det = dv(1.0f, add(add(mul(a, A), mul(b, B)), mul(c, C)));
  o[0] = mul(A, inv_det);
  o[1] = mul(-sub(mul(b, i), mul(c, h)), inv_det);
  o[2] = mul(sub(mul(b, f), mul(c, e)), inv_det);
  o[3] = mul(B, inv_det);
  o[4] = mul(sub(mul(a, i), mul(c, g)), inv_det);
  o[5] = mul(-sub(mul(a, f), mul(c, d)), inv_det);
  o[6] = mul(C, inv_det);
  o[7] = mul(-sub(mul(a, h), mul(b, g)), inv_det);
  o[8] = mul(sub(mul(a, e), mul(b, d)), inv_det);
}

// so(3) vector of a rotation matrix (lie.so3_log), zero below the 1e-5 guard.
__device__ __forceinline__ void so3_log(const float* r, float* v) {
  const float tr = add(add(r[0], r[4]), r[8]);
  const float c = fminf(fmaxf(mul(sub(tr, 1.0f), 0.5f), -1.0f), 1.0f);
  const float theta = acosf(c);
  const bool small = fabsf(theta) < 1e-5f;
  const float d = mul(2.0f, small ? 1.0f : sinf(theta));
  const float w[3] = {dv(sub(r[7], r[5]), d), dv(sub(r[2], r[6]), d), dv(sub(r[3], r[1]), d)};
  for (int i = 0; i < 3; ++i) v[i] = small ? 0.0f : mul(theta, w[i]);
}

// ---- SE(3), row-major 4x4 (lie.py) ------------------------------------------

// (3x3 rotation, translation) -> 4x4 (lie.make_transform).
__device__ __forceinline__ void make_transform(const float* r, const float* t, float* o) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) o[4 * i + j] = r[3 * i + j];
    o[4 * i + 3] = t[i];
  }
  o[12] = o[13] = o[14] = 0.0f;
  o[15] = 1.0f;
}

__device__ __forceinline__ void rot_of(const float* tf, float* r) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r[3 * i + j] = tf[4 * i + j];
}

// a b (lie.compose), each entry summed over k in order.
__device__ __forceinline__ void compose(const float* a, const float* b, float* o) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 4; ++k) acc = add(acc, mul(a[4 * i + k], b[4 * k + j]));
      o[4 * i + j] = acc;
    }
}

// Closed-form rigid inverse [R^T | -R^T t] (lie.transform_inverse).
__device__ __forceinline__ void transform_inverse(const float* tf, float* o) {
  float rt[9], t[3], u[3];
  for (int i = 0; i < 3; ++i) {
    t[i] = tf[4 * i + 3];
    for (int j = 0; j < 3; ++j) rt[3 * i + j] = tf[4 * j + i];
  }
  matvec(rt, t, u);
  for (int i = 0; i < 3; ++i) u[i] = -u[i];
  make_transform(rt, u, o);
}

// Fractional rigid transform: ratio * translation, slerp(I, R); identity
// when dt_trans == 0 (lie.interpolate_tf_with_time).
__device__ __forceinline__ void interpolate_tf_with_time(const float* between, float dt_scan,
                                                         float dt_trans, float* o) {
  const bool zero = dt_trans == 0.0f;
  const float ratio = zero ? 0.0f : dv(dt_scan, zero ? 1.0f : dt_trans);
  float r[9], w[3], rr[9];
  rot_of(between, r);
  so3_log(r, w);
  for (int i = 0; i < 3; ++i) w[i] = mul(w[i], ratio);
  so3_exp(w, rr);
  const float t[3] = {mul(between[3], ratio), mul(between[7], ratio), mul(between[11], ratio)};
  make_transform(rr, t, o);
  if (zero)
    for (int e = 0; e < 16; ++e) o[e] = (e % 5 == 0) ? 1.0f : 0.0f;
}

// Pose of an Euler angle + position ring entry (rings.get_interpolated_pose
// tf_of).
__device__ __forceinline__ void pose_of(const float* rpy, const float* pos, float* o) {
  float r[9];
  euler_to_rot(rpy, r);
  make_transform(r, pos, o);
}

// ---- LU with partial pivoting, row-major m x m (m <= 6) -----------------------

// In place: A = P L U, the pivot row of column c recorded in piv[c] (the
// first row of the largest |entry|, LAPACK's getrf choice).
__device__ __forceinline__ void lu_factor(float* A, int* piv, int m) {
  for (int c = 0; c < m; ++c) {
    int p = c;
    for (int r = c + 1; r < m; ++r)
      if (fabsf(A[r * m + c]) > fabsf(A[p * m + c])) p = r;
    piv[c] = p;
    if (p != c)
      for (int k = 0; k < m; ++k) {
        const float t = A[c * m + k];
        A[c * m + k] = A[p * m + k];
        A[p * m + k] = t;
      }
    for (int r = c + 1; r < m; ++r) {
      const float l = dv(A[r * m + c], A[c * m + c]);
      A[r * m + c] = l;
      for (int k = c + 1; k < m; ++k) A[r * m + k] = sub(A[r * m + k], mul(l, A[c * m + k]));
    }
  }
}

// x = A^-1 b with the factors of lu_factor; b is permuted in place.
__device__ __forceinline__ void lu_solve(const float* A, const int* piv, float* b, float* x,
                                         int m) {
  for (int c = 0; c < m; ++c) {
    const int p = piv[c];
    const float t = b[c];
    b[c] = b[p];
    b[p] = t;
  }
  for (int r = 0; r < m; ++r)
    for (int c = 0; c < r; ++c) b[r] = sub(b[r], mul(A[r * m + c], b[c]));
  for (int r = m - 1; r >= 0; --r) {
    float acc = b[r];
    for (int c = r + 1; c < m; ++c) acc = sub(acc, mul(A[r * m + c], x[c]));
    x[r] = dv(acc, A[r * m + r]);
  }
}

// ---- the filter -----------------------------------------------------------

__device__ __forceinline__ float std_of(const State& s, int i) {
  return sqrtf(fmaxf(s.P[i * kN + i], 0.0f));
}

// check_rotation_stabilized (filter.py, ekf_algorithm.hpp:148-209)
__device__ __forceinline__ bool rotation_stabilized(const State& s) {
  const float lim = (float)(0.2 * kD2R);
  return std_of(s, 3) < lim && std_of(s, 4) < lim && std_of(s, 5) < lim;
}

// The flag refresh of update_gnss (cpp:351-354), from P.
__device__ __forceinline__ void refresh_flags(State& s) {
  const float l5 = (float)(5.0 * kD2R), l02 = (float)(0.2 * kD2R);
  const float sx = std_of(s, 0), sy = std_of(s, 1);
  const float sr = std_of(s, 3), sp = std_of(s, 4), syaw = std_of(s, 5);
  s.yaw_init = syaw < l5;
  s.state_init = sr < l5 && sp < l5 && syaw < l5 && sx < 1.0f && sy < 1.0f;
  s.rot_stab = sr < l02 && sp < l02 && syaw < l02;
  s.state_stab = sr < l02 && sp < l02 && syaw < l02 && sx < 0.5f && sy < 0.5f;
}

// The whole CTA: the state record into shared memory, word by word
// (coalesced); the caller's barrier publishes it.
__device__ __forceinline__ void load_state(const int* __restrict__ rec, State& s) {
  int* w = reinterpret_cast<int*>(&s);
  for (int i = threadIdx.x; i < kRecordWords; i += blockDim.x) w[i] = rec[i];
}

// The whole CTA, after a barrier: the state out to a fresh record.
__device__ __forceinline__ void store_state(const State& s, int* __restrict__ rec) {
  const int* w = reinterpret_cast<const int*>(&s);
  for (int i = threadIdx.x; i < kRecordWords; i += blockDim.x) rec[i] = w[i];
}

__device__ __forceinline__ void load_params(const float* __restrict__ rec, Params& p) {
  for (int i = threadIdx.x; i < kParamWords; i += blockDim.x) p.v[i] = rec[i];
}

// Thread 0: S = H P H^T + R, then its inverse (m = 2 adjugate, m = 3
// inv3x3, both for the small f32 form) or its LU with partial pivoting
// (m = 4, 6: S^T in place, the factorization torch.linalg.solve_ex(S^T, .)
// makes; S is SPD, so no pivot is zero).
__device__ __forceinline__ void factor_s(Update& u) {
  const int m = u.m;
  for (int a = 0; a < m; ++a)
    for (int b = 0; b < m; ++b) u.S[a * m + b] = add(u.Pi[a * kN + u.idx[b]], u.R[a * m + b]);
  if (m == 2) {
    const float* S = u.S;
    const float det = sub(mul(S[0], S[3]), mul(S[1], S[2]));
    const float inv[4] = {dv(S[3], det), dv(-S[1], det), dv(-S[2], det), dv(S[0], det)};
    copy(inv, u.S, 4);
  } else if (m == 3) {
    float inv[9];
    inv3x3(u.S, inv);
    copy(inv, u.S, 9);
  } else {
    float A[36];
    for (int a = 0; a < m; ++a)
      for (int b = 0; b < m; ++b) A[a * m + b] = u.S[b * m + a];  // S^T
    lu_factor(A, u.piv, m);
    copy(A, u.S, m * m);
  }
}

// Row i of K = P H^T S^-1: the small forms multiply by S^-1; m = 4, 6
// solve S^T k = (P H^T)[i] with the LU of factor_s.
__device__ __forceinline__ void gain_row(const State& s, Update& u, int i) {
  const int m = u.m;
  float ph[6], k[6];
  for (int b = 0; b < m; ++b) ph[b] = s.P[i * kN + u.idx[b]];
  if (m <= 3) {
    for (int b = 0; b < m; ++b) {
      float acc = 0.0f;
      for (int a = 0; a < m; ++a) acc = add(acc, mul(ph[a], u.S[a * m + b]));
      k[b] = acc;
    }
  } else {
    lu_solve(u.S, u.piv, ph, k, m);
  }
  float su = 0.0f;
  for (int b = 0; b < m; ++b) {
    u.K[i * 6 + b] = k[b];
    su = add(su, mul(k[b], u.Y[b]));
  }
  u.su[i] = su;
}

// Thread 0: the nominal state += the error-state correction su.
__device__ __forceinline__ void inject(State& s, const float* su) {
  float dq[4], q[4];
  for (int i = 0; i < 3; ++i) {
    s.pos[i] = add(s.pos[i], su[i]);
    s.vel[i] = add(s.vel[i], su[6 + i]);
    s.gyro[i] = add(s.gyro[i], su[9 + i]);
    s.acc[i] = add(s.acc[i], su[12 + i]);
    s.bg[i] = add(s.bg[i], su[15 + i]);
    s.ba[i] = add(s.ba[i], su[18 + i]);
    s.grav[i] = add(s.grav[i], su[21 + i]);
  }
  quat_from_axis_angle(su + 3, dq);
  quat_mul(s.rot, dq, q);
  quat_normalize(q, s.rot);
  quat_from_axis_angle(su + 24, dq);
  quat_mul(s.imu_rot, dq, q);
  quat_normalize(q, s.imu_rot);
}

// One Kalman update with H the selector of u.idx[0..m): the reference's
// P -= K H P form, or with ``joseph`` (I - K H) P (I - K H)^T + K R K^T
// (filter.py:_ekf_measurement_update, joseph=True). With H a selector, K H
// scatters K's m columns into the observed columns, so the Joseph form is
// A = P - K H P (the reference form's result), then
// A - (A H^T) K^T + (K R) K^T: one more CTA-strided pass of 2m terms per
// entry, after the observed columns of A and K R are gathered. The Joseph
// form is symmetric in exact arithmetic, and what it is for is a P that
// stays symmetric in long float32 runs: the pass evaluates the upper
// triangle and mirrors it, so P leaves every Joseph update exactly
// symmetric (A itself, and the plain version's two 27x27 products, are
// symmetric only to rounding; the entries differ from the plain version's
// by that rounding). Thread 0 has written u.m, u.idx, u.Y, u.R; every
// thread of the CTA calls this after a barrier.
__device__ __forceinline__ void measurement_update(State& s, Update& u, bool joseph) {
  const int m = u.m;
  for (int e = threadIdx.x; e < m * kN; e += blockDim.x)
    u.Pi[e] = s.P[u.idx[e / kN] * kN + e % kN];
  __syncthreads();
  if (threadIdx.x == 0) factor_s(u);
  __syncthreads();
  for (int i = threadIdx.x; i < kN; i += blockDim.x) gain_row(s, u, i);
  __syncthreads();
  for (int e = threadIdx.x; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    float acc = 0.0f;
    for (int k = 0; k < m; ++k) acc = add(acc, mul(u.K[i * 6 + k], u.Pi[k * kN + j]));
    s.P[e] = sub(s.P[e], acc);
  }
  if (threadIdx.x == 0) inject(s, u.su);
  __syncthreads();
  if (!joseph) return;
  for (int e = threadIdx.x; e < kN * m; e += blockDim.x) {
    const int i = e / m, b = e % m;
    u.Pi[b * kN + i] = s.P[i * kN + u.idx[b]];  // (A H^T)[i, b]
    float acc = 0.0f;
    for (int a = 0; a < m; ++a) acc = add(acc, mul(u.K[i * 6 + a], u.R[a * m + b]));
    u.KR[i * 6 + b] = acc;
  }
  __syncthreads();
  // the upper triangle, mirrored: each thread reads only A's upper entry
  // (i <= j) it replaces, so the in-place writes race with no read
  for (int e = threadIdx.x; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    if (j < i) continue;
    float ak = 0.0f, krk = 0.0f;
    for (int b = 0; b < m; ++b) {
      ak = add(ak, mul(u.Pi[b * kN + i], u.K[j * 6 + b]));
      krk = add(krk, mul(u.KR[i * 6 + b], u.K[j * 6 + b]));
    }
    const float v = add(sub(s.P[e], ak), krk);
    s.P[e] = v;
    s.P[j * kN + i] = v;
  }
  __syncthreads();
}

}  // namespace ekf
}  // namespace elm
