// Every query of the rings at a scan's start and end time (K6's per-scan
// half and K8's pose sync), shared by kernel K (scan_ring.cu: the queries
// alone, at times read from device memory) and kernel T (scan_front.cu:
// the range gate and the scan times first, then these queries on the last
// CTA of the same launch).
//
// Replaces elimaloc_tpu/deskew.py:make_deskew_info (:157) with
// imu_deskew_info (:82) and odom_deskew_info (:109), and
// elimaloc_tpu/pipeline/rings.py:get_interpolated_pose (:204) followed by
// lie.compose(sync_pose, tf_ego_to_lidar) (runtime.py:338): the IMU window
// of the scan and its gyro integration (the cumsum, compacted to the
// W-wide window the deskew reads), the odometry increment from scan start
// to scan end, the ego pose at the scan's end (interpolated between the
// bracketing ring entries or extrapolated past the last one), ``found``,
// ``usable`` and the ICP initial guess.
//
// One CTA of kQueryThreads. The nine index searches (first / last true of
// a mask, and a count) run across the block with shared-memory atomics;
// thread 0 then integrates the gyro over the window (sequentially, in
// double like the CPU cumsum), builds the odometry increment and the synced
// pose with ekf.cuh's SE(3) helpers, and the block writes the window rows.
// The search semantics are the plain version's: the first index of a true
// ``>``/``>=`` mask, the last of a ``<=`` one, 0 (first) and n - 1 (last)
// when nothing is found.
#pragma once

#include <limits.h>

#include "ekf.cuh"

namespace elm {
namespace scan {

using namespace ekf;

constexpr int kQueryThreads = 256;

enum Search { IMU_FIRST, IMU_LAST, IMU_N, FRESH_FIRST, FRESH_LAST, GE_CUR, GE_END, LE_LAST,
              GT_FIRST, kSearches };

// The output layout: floats imu_time [w], imu_rot [w, 3], odom_incre [3],
// init_guess [4, 4]; int64 first_idx, last_idx; bools imu_included [w],
// imu_available, odom_available, imu_covers_start, found, usable.
__host__ __device__ constexpr int query_floats(int w) { return 4 * w + 19; }
constexpr int kQueryFlags = 5;

struct Ego {
  const float *t, *pos, *rpy, *vel, *gyro;
  const int* count;
  int cap;
};

struct QueryShared {
  int s[kSearches];
  int start;
};

// Extrapolated pose at time ``at`` from ring entry i: position by the
// global velocity, Euler angles by the body rates (rings.py:164-172,
// deskew.py:90-96).
__device__ __forceinline__ void extrapolate(const Ego& e, int i, float at, float* o) {
  float r[9], v[3], pos[3], rpy[3];
  const float dt = sub(at, e.t[i]);
  euler_to_rot(e.rpy + 3 * i, r);
  matvec(r, e.vel + 3 * i, v);
  for (int c = 0; c < 3; ++c) {
    pos[c] = add(e.pos[3 * i + c], mul(v[c], dt));
    rpy[c] = add(e.rpy[3 * i + c], mul(e.gyro[3 * i + c], dt));
  }
  pose_of(rpy, pos, o);
}

// The whole CTA: the queries at the scan's start ``cur`` and end ``end``
// into fout / iout / bout (the layout above). Ends without a barrier.
__device__ __forceinline__ void ring_query(const float* __restrict__ imu_t,
                                           const float* __restrict__ imu_gyro,
                                           const int* __restrict__ imu_count, int imu_cap,
                                           const Ego& e, float cur, float end,
                                           const float* __restrict__ tf_ego_to_lidar, int w,
                                           int run_deskew, float* __restrict__ fout,
                                           long long* __restrict__ iout,
                                           bool* __restrict__ bout, QueryShared& sh) {
  int* s = sh.s;
  const float lo = sub(cur, 0.01f), hi = add(end, 0.01f), fresh_lo = sub(cur, 0.1f);
  const int n_imu = *imu_count, n_ego = *e.count;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kSearches; ++k) s[k] = INT_MAX;
    s[IMU_LAST] = s[FRESH_LAST] = s[LE_LAST] = -1;
    s[IMU_N] = 0;
  }
  __syncthreads();
  int v[kSearches];
  for (int k = 0; k < kSearches; ++k) v[k] = INT_MAX;
  v[IMU_LAST] = v[FRESH_LAST] = v[LE_LAST] = -1;
  v[IMU_N] = 0;
  for (int i = threadIdx.x; i < imu_cap; i += blockDim.x) {
    const float t = imu_t[i];
    if (i < n_imu && t >= lo && t <= hi) {
      v[IMU_FIRST] = min(v[IMU_FIRST], i);
      v[IMU_LAST] = max(v[IMU_LAST], i);
      v[IMU_N] += 1;
    }
  }
  for (int i = threadIdx.x; i < e.cap; i += blockDim.x) {
    const float t = e.t[i];
    if (i >= n_ego) continue;
    if (t >= fresh_lo) {
      v[FRESH_FIRST] = min(v[FRESH_FIRST], i);
      v[FRESH_LAST] = max(v[FRESH_LAST], i);
      if (t >= cur) v[GE_CUR] = min(v[GE_CUR], i);
      if (t >= end) v[GE_END] = min(v[GE_END], i);
    }
    if (t <= end) v[LE_LAST] = max(v[LE_LAST], i);
    if (t > end) v[GT_FIRST] = min(v[GT_FIRST], i);
  }
  for (int k = 0; k < kSearches; ++k) {
    if (k == IMU_N)
      atomicAdd(&s[k], v[k]);
    else if (k == IMU_LAST || k == FRESH_LAST || k == LE_LAST)
      atomicMax(&s[k], v[k]);
    else
      atomicMin(&s[k], v[k]);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // ---- the IMU window (deskew.py:82-105, 157-193) ----
    const bool any_inc = s[IMU_FIRST] != INT_MAX;
    const int first = any_inc ? s[IMU_FIRST] : 0;
    const int last = any_inc ? s[IMU_LAST] : imu_cap - 1;
    const bool imu_ok = s[IMU_N] >= 2;
    const int start = min(max(first, 0), imu_cap - w);
    const bool truncated = (last - start) > (w - 1);
    sh.start = start;
    // the cumsum of gyro * dt: its terms vanish up to ``first`` (dt is 0
    // unless a sample and the one before it are both in the window), so
    // rot[first] is 0 and the window's rows need the sum from first + 1 on
    double acc[3] = {0.0, 0.0, 0.0};
    float* rot = fout + w;
    for (int i = start; i < start + w; ++i) {
      const bool inc_i = i < n_imu && imu_t[i] >= lo && imu_t[i] <= hi;
      const bool inc_p = i > 0 && i - 1 < n_imu && imu_t[i - 1] >= lo && imu_t[i - 1] <= hi;
      if (i > first && inc_i && inc_p) {
        const float dt = sub(imu_t[i], imu_t[i - 1]);
        for (int c = 0; c < 3; ++c) acc[c] += (double)mul(imu_gyro[3 * i + c], dt);
      }
      for (int c = 0; c < 3; ++c) rot[3 * (i - start) + c] = inc_i ? (float)acc[c] : 0.0f;
    }
    iout[0] = first - start;
    iout[1] = min(max(last - start, 0), w - 1);

    // ---- the odometry increment (deskew.py:109-154) ----
    const bool any_fresh = s[FRESH_FIRST] != INT_MAX;
    const int first_fresh = any_fresh ? s[FRESH_FIRST] : 0;
    const int last_fresh = any_fresh ? s[FRESH_LAST] : e.cap - 1;
    const bool front_ok = any_fresh && e.t[first_fresh] <= cur;
    const int start_idx = s[GE_CUR] != INT_MAX ? s[GE_CUR] : last_fresh;
    const bool has_end = s[GE_END] != INT_MAX;
    float tf_start[16], tf_end[16], inv[16], between[16];
    pose_of(e.rpy + 3 * start_idx, e.pos + 3 * start_idx, tf_start);
    if (has_end)
      pose_of(e.rpy + 3 * s[GE_END], e.pos + 3 * s[GE_END], tf_end);
    else
      extrapolate(e, last_fresh, end, tf_end);
    const float t_end = has_end ? e.t[s[GE_END]] : end;
    transform_inverse(tf_start, inv);
    compose(inv, tf_end, between);
    const float dt_trans = sub(t_end, e.t[start_idx]);
    const bool zero = dt_trans == 0.0f;
    const float ratio = zero ? 0.0f : dv(sub(end, cur), dt_trans);
    float* incre = fout + 4 * w;
    for (int c = 0; c < 3; ++c)
      incre[c] = (front_ok && !zero) ? mul(between[4 * c + 3], ratio) : 0.0f;

    // ---- the pose at the scan's end (rings.py:204-243) and the guess ----
    const bool found_before = s[LE_LAST] >= 0;
    const bool found_after = s[GT_FIRST] != INT_MAX;
    const int before = found_before ? s[LE_LAST] : 0;
    const int after = found_after ? s[GT_FIRST] : before;
    float tf_before[16], tf_after[16], interp[16], sync[16];
    pose_of(e.rpy + 3 * before, e.pos + 3 * before, tf_before);
    if (found_after)
      pose_of(e.rpy + 3 * after, e.pos + 3 * after, tf_after);
    else
      extrapolate(e, n_ego > 0 ? n_ego - 1 : 0, end, tf_after);
    const float t_after = found_after ? e.t[after] : end;
    transform_inverse(tf_before, inv);
    compose(inv, tf_after, between);
    interpolate_tf_with_time(between, sub(end, e.t[before]), sub(t_after, e.t[before]), interp);
    compose(tf_before, interp, sync);
    compose(sync, tf_ego_to_lidar, fout + 4 * w + 3);

    bool* flags = bout + w;
    flags[0] = imu_ok;
    flags[1] = front_ok;
    flags[2] = imu_ok && imu_t[first] <= add(cur, 0.01f) && !truncated;
    flags[3] = found_before;
    flags[4] = (!run_deskew || (imu_ok && front_ok)) && found_before && n_ego > 0;
  }
  __syncthreads();
  const int start = sh.start;
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const int i = start + j;
    const float t = imu_t[i];
    fout[j] = t;
    bout[j] = i < n_imu && t >= lo && t <= hi;
  }
}

}  // namespace scan
}  // namespace elm
