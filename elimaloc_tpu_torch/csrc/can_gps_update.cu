// Kernel W: a frame's CAN and GPS updates, kernel I redesigned for Hopper.
//
// Replaces elimaloc_tpu/ekf/filter.py:_ekf_measurement_update (:221),
// update_gnss (:616, the regular path: flag refresh, GNSS minimum
// covariance, the 3-DOF position path with the antenna inflation while yaw
// is uninitialised, prev_gnss_timestamp) and update_can (:705, with
// ZuptCan) as elimaloc_tpu/pipeline/runtime.py:453-475 runs them (the CAN
// then the GPS sub-batch, each sample masked by validity, a GPS fix also by
// the variance gate of gps_step :205), and the event loop's CAN and GPS
// steps (runtime.py:205, :260). Kernel I (ekf_update.cu) computes the same
// and stays as W's bit-for-bit reference; it launches on no path.
//
// Bound: latency. Each update is an m x m solve (m = 4 for CAN, 3 or 6 for
// GPS) and a rank-m correction of the 27 x 27 P, a few thousand flops on
// a serial chain; the bytes (two 3 KB state records) take ~2 ns. Kernel I
// spent ~15k SM cycles a CAN update and ~35k a 6-DOF fix (clock64 stamps
// on the H100, PERF.md), most of it on thread 0 waiting on local memory:
// the measurement size m was a runtime value, so the LU, the pivots and the
// gain rows were runtime-indexed arrays. Design:
// - m is a template parameter (CAN 4; GPS 3 for NAVSATFIX / BESTPOS, 6 for
//   NOVATEL, picked at launch), so the set-up, the LU with partial
//   pivoting (row swaps as predicated register swaps), the gain rows and
//   their solves are unrolled in registers;
// - every CAN and GPS input is staged in shared memory by the whole CTA in
//   coalesced passes of kStage samples before the updates that read it;
//   validity and the CAN time gate are read there by every thread, so a
//   padded or refused slot costs no barrier;
// - three block barriers an update (five in the Joseph form) against
//   kernel I's six (eight): warp 0 sets the measurement up and factors S
//   while the other warps gather H P; then the 27 gain rows (K R too in
//   the Joseph form); then the P update, one entry a thread on 23 warps,
//   beside the injection split over three more warps (the two quaternions
//   and the vectors with the ZuptCan / prev_gnss_t finish), each in its own
//   warp so that no two run as divergent halves of one;
// - a 3-DOF fix skips the Euler residual, which only the 6-DOF path reads;
//   a 6-DOF fix takes the two Euler conversions on two lanes at once.
// Each element keeps kernel I's sequence of IEEE-rounded operations
// (elm::mul / add / sub, __fdiv_rn, the same libm calls), so W's state
// record equals I's bit for bit.
// Lanes: a fleet frame (replay_fused_fleet's vmap, elimaloc_tpu/parallel/
// sharding.py:256-281) launches one CTA a lane, as kernel S's lane form
// (pcm_stage.cu), each on its lane's record and its CAN and GPS rows at
// their lane strides (the fleet's padding rows are invalid and skipped as a
// stream's own invalid rows are); one lane is the single launch.
#include "ekf_update.cuh"

using namespace elm;
using namespace elm::ekf;

namespace {

constexpr int kWarps = 26;
constexpr int kThreadsW = kWarps * 32;
constexpr int kPWarps = 23;  // warps 0-22: the 729 entries of P, one a thread
constexpr int kRotWarp = 23, kImuRotWarp = 24, kVecWarp = 25;
constexpr int kStage = 256;  // samples of a sub-batch staged a pass
static_assert(kPWarps * 32 >= kN * kN, "one P entry a thread");

// One Kalman update's scratch (m <= 6): F holds S^-1 (m = 3) or the LU of
// S^T (m = 4, 6); Pi holds H P, then in the Joseph form (A H^T)^T.
struct Upd {
  float Y[6], R[36], F[36];
  int piv[6];
  float Pi[6 * kN], K[kN * 6], KR[kN * 6], su[kN];
};

// One staged sample: CAN (t, vx, yaw) or GPS (t, pos, the re-squared
// variances).
struct Meas {
  float t, vx, yaw, pos[3], var[3];
};

// The state index of measurement row b: CAN observes the global velocity
// and the yaw rate (filter.update_can: S_VX.., S_YAW_RATE), GPS the
// position and then the rotation.
template <int M>
__device__ __forceinline__ int obs(int b) {
  return M == 4 ? (b < 3 ? 6 + b : 11) : b;
}

// Warp 0, lane 0: can_setup's measurement (ekf_update.cuh), in registers.
__device__ __forceinline__ void can_meas(const State& s, const Params& prm, const Meas& z,
                                         Upd& u) {
  float rm[9], cvg[3], tmp[9], R3[9];
  quat_to_rot(s.rot, rm);
  const float uv[3] = {mul(z.vx, prm.v[CAN_VEL_SCALE]), 0.0f, 0.0f};
  matvec(rm, uv, cvg);
  const float unc = prm.v[CAN_UNC_VEL], unc2 = sq(mul(2.0f, unc));
  const float rl[9] = {sq(unc), 0.0f, 0.0f, 0.0f, unc2, 0.0f, 0.0f, 0.0f, unc2};
  matmul3(rm, rl, tmp, false);
  matmul3(tmp, rm, R3, true);
#pragma unroll
  for (int i = 0; i < 3; ++i) u.Y[i] = sub(cvg[i], s.vel[i]);
  u.Y[3] = sub(sub(z.yaw, s.can_bias), s.gyro[2]);
#pragma unroll
  for (int e = 0; e < 16; ++e) u.R[e] = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) u.R[4 * a + b] = R3[3 * a + b];
  u.R[15] = sq(prm.v[CAN_UNC_YAW]);
}

// Warp 0: gnss_setup's regular path for a GPS fix (ekf_update.cuh; the
// measurement as kernel I's gps leg builds it: identity rotation, zero
// rotation covariance, pos_cov = diag(var)). m = 6 takes the Euler angles
// of the state's and the measurement's rotation on lanes 0 and 1 at once.
template <int M>
__device__ __forceinline__ void gps_meas(State& s, const Params& prm, const Meas& z, Upd& u) {
  const int lane = threadIdx.x;
  float res[3];
  if (M == 6 && lane < 2) {
    const float id[4] = {1.0f, 0.0f, 0.0f, 0.0f};
    float mq[4], q[4], e[3];
    quat_normalize(id, mq);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = lane == 0 ? s.rot[i] : mq[i];
    quat_to_euler(q, e);
    float other[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) other[i] = __shfl_sync(0x3u, e[i], 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) res[i] = norm_angle_rad(sub(other[i], e[i]));
  }
  if (lane != 0) return;
  refresh_flags(s);
  float R6[36];
#pragma unroll
  for (int e = 0; e < 36; ++e) R6[e] = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) R6[7 * a] = z.var[a];
#pragma unroll
  for (int i = 0; i < 6; ++i) R6[7 * i] = add(R6[7 * i], prm.v[GNSS_MIN_COV + i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) u.Y[i] = sub(z.pos[i], s.pos[i]);
  if (M == 3) {
    const float inflate = s.yaw_init ? 0.0f : 3.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        u.R[3 * a + b] = add(R6[6 * a + b], a == b && a < 2 ? inflate : 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) u.Y[3 + i] = res[i];
#pragma unroll
    for (int e = 0; e < 36; ++e) u.R[e] = R6[e];
  }
}

// Warp 0, lane 0: S = H P H^T + R, then S^-1 (m = 3, inv3x3) or the LU of
// S^T with partial pivoting (m = 4, 6): factor_s and lu_factor (ekf.cuh)
// with every index known at compile time.
template <int M>
__device__ __forceinline__ void factor(const State& s, Upd& u) {
  float A[M * M];
  if (M == 3) {
    float S[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) S[3 * a + b] = add(s.P[a * kN + b], u.R[3 * a + b]);
    ekf::inv3x3(S, A);
  } else {
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int b = 0; b < M; ++b)
        A[b * M + a] = add(s.P[obs<M>(a) * kN + obs<M>(b)], u.R[a * M + b]);  // S^T
#pragma unroll
    for (int c = 0; c < M; ++c) {
      int p = c;
      float best = fabsf(A[c * M + c]);
#pragma unroll
      for (int r = c + 1; r < M; ++r) {
        const float v = fabsf(A[r * M + c]);
        if (v > best) {
          p = r;
          best = v;
        }
      }
      u.piv[c] = p;
#pragma unroll
      for (int r = c + 1; r < M; ++r)
        if (p == r)
#pragma unroll
          for (int k = 0; k < M; ++k) {
            const float t = A[c * M + k];
            A[c * M + k] = A[r * M + k];
            A[r * M + k] = t;
          }
#pragma unroll
      for (int r = c + 1; r < M; ++r) {
        const float l = dv(A[r * M + c], A[c * M + c]);
        A[r * M + c] = l;
#pragma unroll
        for (int k = c + 1; k < M; ++k) A[r * M + k] = sub(A[r * M + k], mul(l, A[c * M + k]));
      }
    }
  }
#pragma unroll
  for (int e = 0; e < M * M; ++e) u.F[e] = A[e];
}

// Thread i < 27: row i of K = P H^T S^-1 (gain_row, ekf.cuh: the small
// form multiplies by S^-1, m = 4, 6 run lu_solve on the LU of S^T), its
// share su[i] = K[i] Y, and in the Joseph form row i of K R.
template <int M>
__device__ __forceinline__ void gain(const State& s, Upd& u, int i, bool joseph) {
  float ph[M], k[M];
#pragma unroll
  for (int b = 0; b < M; ++b) ph[b] = s.P[i * kN + obs<M>(b)];
  if (M == 3) {
#pragma unroll
    for (int b = 0; b < M; ++b) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < M; ++a) acc = add(acc, mul(ph[a], u.F[a * M + b]));
      k[b] = acc;
    }
  } else {
    float A[M * M];
#pragma unroll
    for (int e = 0; e < M * M; ++e) A[e] = u.F[e];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const int p = u.piv[c];
#pragma unroll
      for (int r = c + 1; r < M; ++r)
        if (p == r) {
          const float t = ph[c];
          ph[c] = ph[r];
          ph[r] = t;
        }
    }
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < r; ++c) ph[r] = sub(ph[r], mul(A[r * M + c], ph[c]));
#pragma unroll
    for (int r = M - 1; r >= 0; --r) {
      float acc = ph[r];
#pragma unroll
      for (int c = r + 1; c < M; ++c) acc = sub(acc, mul(A[r * M + c], k[c]));
      k[r] = dv(acc, A[r * M + r]);
    }
  }
  float su = 0.0f;
#pragma unroll
  for (int b = 0; b < M; ++b) {
    u.K[i * 6 + b] = k[b];
    su = add(su, mul(k[b], u.Y[b]));
  }
  u.su[i] = su;
  if (joseph)
#pragma unroll
    for (int b = 0; b < M; ++b) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < M; ++a) acc = add(acc, mul(k[a], u.R[a * M + b]));
      u.KR[i * 6 + b] = acc;
    }
}

// The nominal state += su, one warp a part (inject, ekf.cuh), then the
// measurement's finish on the vectors' warp: ZuptCan for CAN
// (can_finish, ekf_update.cuh), prev_gnss_t for GPS.
template <int M>
__device__ __forceinline__ void inject_split(State& s, const Upd& u, const Meas& z, int warp) {
  float dq[4], q[4];
  if (warp == kRotWarp) {
    quat_from_axis_angle(u.su + 3, dq);
    quat_mul(s.rot, dq, q);
    quat_normalize(q, s.rot);
  } else if (warp == kImuRotWarp) {
    quat_from_axis_angle(u.su + 24, dq);
    quat_mul(s.imu_rot, dq, q);
    quat_normalize(q, s.imu_rot);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.pos[i] = add(s.pos[i], u.su[i]);
      s.vel[i] = add(s.vel[i], u.su[6 + i]);
      s.gyro[i] = add(s.gyro[i], u.su[9 + i]);
      s.acc[i] = add(s.acc[i], u.su[12 + i]);
      s.bg[i] = add(s.bg[i], u.su[15 + i]);
      s.ba[i] = add(s.ba[i], u.su[18 + i]);
      s.grav[i] = add(s.grav[i], u.su[21 + i]);
    }
    if (M == 4)
      can_finish(s, z.t, z.vx, z.yaw);
    else
      s.prev_gnss_t = z.t;
  }
}

// One Kalman update of measurement size M (the reference's P -= K H P, or
// with ``joseph`` the Joseph form of ekf.cuh's measurement_update). Every
// thread calls it; the state is published by the caller's last barrier.
template <int M>
__device__ void kalman(State& s, const Params& prm, Upd& u, const Meas& z, bool joseph) {
  const int tid = threadIdx.x, warp = tid >> 5;
  if (warp == 0) {
    if (M == 4) {
      if (tid == 0) can_meas(s, prm, z, u);
    } else {
      gps_meas<M>(s, prm, z, u);
    }
    __syncwarp();
    if (tid == 0) factor<M>(s, u);
  } else {
    for (int e = tid - 32; e < M * kN; e += blockDim.x - 32)
      u.Pi[e] = s.P[obs<M>(e / kN) * kN + e % kN];
  }
  __syncthreads();
  if (tid < kN) gain<M>(s, u, tid, joseph);
  __syncthreads();
  if (tid < kN * kN) {
    const int i = tid / kN, j = tid % kN;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < M; ++k) acc = add(acc, mul(u.K[i * 6 + k], u.Pi[k * kN + j]));
    s.P[tid] = sub(s.P[tid], acc);
  } else if (warp >= kRotWarp && (tid & 31) == 0) {
    inject_split<M>(s, u, z, warp);
  }
  __syncthreads();
  if (!joseph) return;
  for (int e = tid; e < kN * M; e += blockDim.x) {
    const int i = e / M, b = e % M;
    u.Pi[b * kN + i] = s.P[i * kN + obs<M>(b)];  // (A H^T)[i, b]
  }
  __syncthreads();
  // the upper triangle, mirrored (ekf.cuh): each thread reads only the
  // upper entry it replaces
  if (tid < kN * kN) {
    const int i = tid / kN, j = tid % kN;
    if (j >= i) {
      float ak = 0.0f, krk = 0.0f;
#pragma unroll
      for (int b = 0; b < M; ++b) {
        ak = add(ak, mul(u.Pi[b * kN + i], u.K[j * 6 + b]));
        krk = add(krk, mul(u.KR[i * 6 + b], u.K[j * 6 + b]));
      }
      const float v = add(sub(s.P[tid], ak), krk);
      s.P[tid] = v;
      s.P[j * kN + i] = v;
    }
  }
  __syncthreads();
}

struct Stage {
  float t[kStage], a[kStage], b[kStage], pos[3 * kStage], cov[3 * kStage];
  bool valid[kStage];
};

template <int GM>
__global__ void __launch_bounds__(kThreadsW) can_gps_update_kernel(
    const int* __restrict__ rec_in, int* __restrict__ rec_out,
    const float* __restrict__ prm_rec, int n_can, const float* __restrict__ can_t,
    const float* __restrict__ can_vel, const float* __restrict__ can_yaw,
    const bool* __restrict__ can_valid, int n_gps, const float* __restrict__ gnss_max,
    const float* __restrict__ gps_t, const float* __restrict__ gps_pos,
    const float* __restrict__ gps_cov, const bool* __restrict__ gps_valid, bool joseph) {
  // this CTA's lane: its record and its CAN / GPS rows at their lane strides
  const int l = blockIdx.x;
  rec_in += l * kRecordWords;
  rec_out += l * kRecordWords;
  can_t += (size_t)l * n_can;
  can_vel += (size_t)l * n_can;
  can_yaw += (size_t)l * n_can;
  if (can_valid != nullptr) can_valid += (size_t)l * n_can;
  gps_t += (size_t)l * n_gps;
  gps_pos += (size_t)3 * l * n_gps;
  gps_cov += (size_t)3 * l * n_gps;
  if (gps_valid != nullptr) gps_valid += (size_t)l * n_gps;
  __shared__ State s;
  __shared__ Params prm;
  __shared__ Upd u;
  __shared__ Stage g;
  load_state(rec_in, s);
  load_params(prm_rec, prm);
  for (int base = 0; base < n_can; base += kStage) {
    const int nb = min(kStage, n_can - base);
    __syncthreads();  // the state is published and the stage free
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      g.t[k] = can_t[base + k];
      g.a[k] = can_vel[base + k];
      g.b[k] = can_yaw[base + k];
      g.valid[k] = can_valid == nullptr || can_valid[base + k];
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      // can_setup's gate: a sample within 0.01 s of the last CAN update is refused
      if (!g.valid[k] || !(fabsf(sub(g.t[k], s.prev_can_t)) >= 0.01f)) continue;
      Meas z;
      z.t = g.t[k];
      z.vx = g.a[k];
      z.yaw = g.b[k];
      kalman<4>(s, prm, u, z, joseph);
    }
  }
  for (int base = 0; base < n_gps; base += kStage) {
    const int nb = min(kStage, n_gps - base);
    __syncthreads();
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      g.t[k] = gps_t[base + k];
      g.valid[k] = gps_valid == nullptr || gps_valid[base + k];
    }
    for (int k = threadIdx.x; k < 3 * nb; k += blockDim.x) {
      g.pos[k] = gps_pos[3 * base + k];
      g.cov[k] = gps_cov[3 * base + k];
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      // gps_step: the re-squared NavSatFix variance and its gate
      Meas z;
      z.t = g.t[k];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        z.var[i] = sq(g.cov[3 * k + i]);
        z.pos[i] = g.pos[3 * k + i];
      }
      if (!g.valid[k] || !(z.var[0] <= *gnss_max && z.var[1] <= *gnss_max)) continue;
      kalman<GM>(s, prm, u, z, joseph);
    }
  }
  __syncthreads();
  store_state(s, rec_out);
}

}  // namespace

// ``lanes`` frames, one CTA each: the records, can_* [lanes, n_can] and
// gps_t / gps_valid [lanes, n_gps], gps_pos / gps_cov [lanes, n_gps, 3] at
// their lane strides; the GNSS source and gnss_max are the fleet's.
extern "C" int elm_can_gps_update(const void* rec_in, void* rec_out, const float* params,
                                  int n_can, const float* can_t, const float* can_vel,
                                  const float* can_yaw, const bool* can_valid, int n_gps,
                                  int gps_src, const float* gnss_max, const float* gps_t,
                                  const float* gps_pos, const float* gps_cov,
                                  const bool* gps_valid, int joseph, int lanes,
                                  cudaStream_t stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  const auto kernel =
      n_gps > 0 && gps_src == NOVATEL ? can_gps_update_kernel<6> : can_gps_update_kernel<3>;
  kernel<<<lanes, kThreadsW, 0, stream>>>((const int*)rec_in, (int*)rec_out, params, n_can, can_t,
                                      can_vel, can_yaw, can_valid, n_gps, gnss_max, gps_t,
                                      gps_pos, gps_cov, gps_valid, joseph != 0);
  return (int)cudaGetLastError();
}
