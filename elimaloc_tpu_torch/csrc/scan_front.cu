// Kernel T: the scan's front in one host call — the range gate, the scan
// times, every query of the rings at them (kernel K's body) and the
// per-point deskew (kernel D's body).
//
// Replaces elimaloc_tpu/pipeline/runtime.py:299-338, the front of
// scan_step: ``stamp - lidar_time_delay``, the range gate ``valid &
// (norm(points) <= input_max_dist)`` (:305-309), deskew.normalize_scan_times
// (deskew.py:60) in both scan_time_end forms, make_deskew_info (deskew.py:
// 157, with :82 and :109), deskew_points (:196, :229, with bug_compat_z),
// rings.get_interpolated_pose (rings.py:204), ``usable`` and the initial
// guess compose(sync_pose, tf_ego_to_lidar) (runtime.py:338). Before it the
// port ran some 16 eager launches for the gate and the scan times (the
// norm, two casts, two argmaxes, a flip, two index_selects, the time
// arithmetic), then kernel K and kernel D, each a wrapper call of its own:
// about 0.47 ms of host time a frame for ~0.03 ms of device work.
//
// Bound: latency. Per point 17 bytes in (xyz, time, valid) and 13 out
// (valid', xyz'), ~0.8 MB at 26k points, and the rings (~10 KB): a few
// microseconds of HBM time, below the two launches' own latency. The four
// stages are one dependency chain on the device (the gate gives valid',
// valid' the first and last valid point and so the scan's times, the times
// the ring queries, the queries the deskew's window table), so one host
// call runs the chain as two launches from the C entry:
//  1. scan_gate_query_kernel, CTAs of kQueryThreads over the points (a
//     grid-stride loop): each thread gates its points and writes valid',
//     the distance as lie.norm forms it (x*x + y*y, + z*z, sqrt, each
//     IEEE-rounded); each CTA reduces its first and last valid index (warp
//     reductions, then warp 0's lanes) into a per-device workspace with one
//     atomicMin and one atomicMax, then counts itself done after a
//     __threadfence; the last CTA to arrive reads the two indices (__ldcg:
//     the other CTAs' atomics, not a stale L1 line), resets the workspace
//     (counter 0, first INT_MAX, last -1) for the next call, takes front_t
//     and back_t with the plain version's none-found values (first 0, last
//     n - 1), forms the scan's times in the scan_time_end form (one
//     IEEE-rounded add each) and runs kernel K's body (scan_ring.cuh) on its
//     kQueryThreads threads, then writes deskew_ok.
//  2. scan_deskew_points_kernel, only with run_deskew: kernel D's bodies
//     (deskew.cuh) in D's blocks, the window table and every scalar read
//     from launch 1's outputs (no host sync), each point's time from the
//     scan start formed in a register (times - front_t, IEEE-rounded, as the
//     plain version's subtraction) and never stored.
// The shared bodies give T the same bits as the gate and scan times in
// torch, then kernel K, then kernel D.
// Lanes: a fleet frame (replay_fused_fleet's vmap, elimaloc_tpu/parallel/
// sharding.py:256-281) runs both launches with the lane as blockIdx.y, each
// lane's points, rings and outputs at their lane strides and its own three
// workspace ints (the last-CTA hand-off is per lane). One lane is the single
// call.
#include "deskew.cuh"
#include "scan_ring.cuh"

using namespace elm;
using namespace elm::scan;
using namespace elm::desk;

namespace {

constexpr int kWarps = kQueryThreads / 32;
// launch 1's CTAs at most (more points take the grid-stride loop)
constexpr int kMaxGateCtas = 1024;
// the flags argument's bits
constexpr int kScanTimeEnd = 1, kRunDeskew = 2, kBugCompatZ = 4;
// the float outputs after kernel K's: the delayed stamp, scan_cur,
// scan_end, front_t; the bool outputs after K's: deskew_ok, then valid' [n]
constexpr int kFrontScalars = 4;
constexpr int kFrontFlags = kQueryFlags + 1;
// the workspace: the done counter, the first and the last valid index
enum Work { DONE, FIRST, LAST };

struct FrontArgs {
  const float *points, *times;
  const bool* valid;
  int n;
  const float *stamp, *delay, *max_dist;
  const float *imu_t, *imu_gyro;
  const int* imu_count;
  int imu_cap;
  Ego ego;
  const float* tf_ego_to_lidar;
  int w, flags;
  int* work;
  long long* iout;
  float* fout;
  bool *bout, *valid_out;
  float* pts_out;
};

// Lane l's arguments: the points, times, valid, stamp, rings, workspace and
// outputs at their lane strides (the delay, max_dist and tf are shared).
__device__ __forceinline__ FrontArgs lane_args(FrontArgs a, int l) {
  const size_t n = a.n;
  a.points += 3 * n * l;
  a.times += n * l;
  a.valid += n * l;
  a.stamp += l;
  a.imu_t += (size_t)a.imu_cap * l;
  a.imu_gyro += (size_t)3 * a.imu_cap * l;
  a.imu_count += l;
  const size_t e = (size_t)a.ego.cap * l;
  a.ego = Ego{a.ego.t + e, a.ego.pos + 3 * e, a.ego.rpy + 3 * e, a.ego.vel + 3 * e,
              a.ego.gyro + 3 * e, a.ego.count + l, a.ego.cap};
  a.work += 3 * l;
  a.iout += 2 * l;
  a.fout += (size_t)(query_floats(a.w) + kFrontScalars) * l;
  a.bout += (size_t)(a.w + kFrontFlags) * l;
  a.valid_out += n * l;
  if (a.pts_out != nullptr) a.pts_out += 3 * n * l;
  return a;
}

__global__ void __launch_bounds__(kQueryThreads) scan_gate_query_kernel(FrontArgs in) {
  const FrontArgs a = lane_args(in, blockIdx.y);
  __shared__ QueryShared sh;
  __shared__ int s_lo[kWarps], s_hi[kWarps];
  __shared__ bool s_last;
  __shared__ float s_cur, s_end;
  const float max_dist = *a.max_dist;
  int lo = INT_MAX, hi = -1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += gridDim.x * blockDim.x) {
    const float x = a.points[3 * i], y = a.points[3 * i + 1], z = a.points[3 * i + 2];
    const float d = __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z)));
    const bool v = a.valid[i] && d <= max_dist;
    a.valid_out[i] = v;
    if (v) {
      lo = min(lo, i);
      hi = max(hi, i);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[wid] = lo;
    s_hi[wid] = hi;
  }
  __syncthreads();
  if (wid == 0) {
    lo = __reduce_min_sync(0xffffffffu, lane < kWarps ? s_lo[lane] : INT_MAX);
    hi = __reduce_max_sync(0xffffffffu, lane < kWarps ? s_hi[lane] : -1);
    if (lane == 0) {
      if (lo != INT_MAX) atomicMin(&a.work[FIRST], lo);
      if (hi >= 0) atomicMax(&a.work[LAST], hi);
      __threadfence();
      s_last = atomicAdd(&a.work[DONE], 1) == (int)gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!s_last) return;

  // the last CTA: every CTA's indices are in; the scan's times
  // (deskew.normalize_scan_times), then kernel K's queries at them
  if (threadIdx.x == 0) {
    __threadfence();
    const int first = __ldcg(&a.work[FIRST]), last = __ldcg(&a.work[LAST]);
    a.work[DONE] = 0;
    a.work[FIRST] = INT_MAX;
    a.work[LAST] = -1;
    const float front_t = a.times[first != INT_MAX ? first : 0];
    const float back_t = a.times[last >= 0 ? last : a.n - 1];
    const float stamp = sub(*a.stamp, *a.delay);
    float cur, end;
    if (a.flags & kScanTimeEnd) {
      end = stamp;
      cur = add(end, front_t);
    } else {
      cur = stamp;
      end = add(stamp, back_t);
    }
    float* sc = a.fout + query_floats(a.w);
    sc[0] = stamp;
    sc[1] = cur;
    sc[2] = end;
    sc[3] = front_t;
    s_cur = cur;
    s_end = end;
  }
  __syncthreads();
  ring_query(a.imu_t, a.imu_gyro, a.imu_count, a.imu_cap, a.ego, s_cur, s_end,
             a.tf_ego_to_lidar, a.w, (a.flags & kRunDeskew) != 0, a.fout, a.iout, a.bout, sh);
  // deskew_ok = imu_available & odom_available (thread 0 wrote both)
  if (threadIdx.x == 0) a.bout[a.w + kQueryFlags] = a.bout[a.w] && a.bout[a.w + 1];
}

__global__ void __launch_bounds__(kDeskewThreads) scan_deskew_points_kernel(FrontArgs in) {
  const FrontArgs a = lane_args(in, blockIdx.y);
  extern __shared__ float table[];  // [w] t_prev, [w] dt, [3w] d_rot
  const int w = a.w;
  stage_table(table, a.fout, a.fout + w, a.bout, w);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float* sc = a.fout + query_floats(w);
  const float rel = (a.flags & kScanTimeEnd) ? sub(a.times[i], sc[3]) : a.times[i];
  deskew_point(i, a.points, rel, a.valid_out[i], table, w, a.fout + w, a.iout + 1,
               a.fout + 4 * w, sc + 1, sc + 2, a.bout + w, a.bout + w + 1,
               (a.flags & kBugCompatZ) != 0, a.pts_out);
}

}  // namespace

// imu: the IMU ring's t, gyro, acc, count; ego: the ego ring's t, pos, rpy,
// vel_local, gyro, count (as the wrappers pass a ring); work: 3 ints, 0,
// INT_MAX, -1 between calls; out: int64 first_idx, last_idx at byte 0, then
// at byte 16 the floats of kernel K's layout (imu_time [w], imu_rot [w, 3],
// odom_incre [3], init_guess [4, 4]) and the delayed stamp, scan_cur,
// scan_end, front_t, then the bools imu_included [w], imu_available,
// odom_available, imu_covers_start, found, usable, deskew_ok, valid' [n];
// pts_out: the deskewed points [n, 3] (run_deskew only). n >= 1.
// ``lanes`` scans of n points each (1 <= lanes <= 65535): the points
// [lanes, n, 3], times and valid [lanes, n], stamp [lanes] and the rings
// ([lanes, cap], [lanes, cap, 3], [lanes]) at their lane strides, work
// 3 ints a lane; out holds the int64 pairs [lanes, 2], then the floats
// [lanes, 4w + 23], the bools [lanes, w + 6] and valid' [lanes, n] (one
// lane: the layout above), pts_out [lanes, n, 3].
extern "C" int elm_scan_front(const float* points, const float* times, const bool* valid, int n,
                              const float* stamp, const float* delay, const float* max_dist,
                              void* const* imu, int imu_cap, void* const* ego, int ego_cap,
                              const float* tf_ego_to_lidar, int w, int flags, int lanes,
                              int* work, void* out, float* pts_out, cudaStream_t stream) {
  FrontArgs a;
  a.points = points;
  a.times = times;
  a.valid = valid;
  a.n = n;
  a.stamp = stamp;
  a.delay = delay;
  a.max_dist = max_dist;
  a.imu_t = (const float*)imu[0];
  a.imu_gyro = (const float*)imu[1];
  a.imu_count = (const int*)imu[3];
  a.imu_cap = imu_cap;
  a.ego = Ego{(const float*)ego[0], (const float*)ego[1], (const float*)ego[2],
              (const float*)ego[3], (const float*)ego[4], (const int*)ego[5], ego_cap};
  a.tf_ego_to_lidar = tf_ego_to_lidar;
  a.w = w;
  a.flags = flags;
  a.work = work;
  char* o = (char*)out;
  a.iout = (long long*)o;
  a.fout = (float*)(o + 16 * (size_t)lanes);
  a.bout = (bool*)(a.fout + (size_t)lanes * (query_floats(w) + kFrontScalars));
  a.valid_out = a.bout + (size_t)lanes * (w + kFrontFlags);
  a.pts_out = pts_out;
  int blocks = (n + kQueryThreads - 1) / kQueryThreads;
  if (blocks > kMaxGateCtas) blocks = kMaxGateCtas;
  scan_gate_query_kernel<<<dim3(blocks, lanes), kQueryThreads, 0, stream>>>(a);
  if (flags & kRunDeskew) {
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    scan_deskew_points_kernel<<<dim3((n + kDeskewThreads - 1) / kDeskewThreads, lanes),
                                kDeskewThreads, sizeof(float) * 5 * (size_t)w, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
