// Kernel K: every query of the rings at a scan's start and end time (K6's
// per-scan half and K8's pose sync), at times read from device memory.
//
// Replaces elimaloc_tpu/deskew.py:make_deskew_info (:157) with
// imu_deskew_info (:82) and odom_deskew_info (:109), and
// elimaloc_tpu/pipeline/rings.py:get_interpolated_pose (:204) followed by
// lie.compose(sync_pose, tf_ego_to_lidar) (runtime.py:338); see
// scan_ring.cuh, which holds its body. On the TPU these are XLA-fused
// masked reductions; the plain PyTorch version is ~150 small launches. The
// pipeline runs the same body inside kernel T (scan_front.cu), after the
// range gate and the scan times of the same launch; this entry is the
// reference T is held to (the gate and scan times in torch, then K, then
// kernel D, bit for bit).
//
// Bound: latency. The inputs are the rings (256 IMU rows, 512 ego rows,
// ~10 KB); the outputs ~1 KB. Design: one CTA, the body of scan_ring.cuh.
#include "scan_ring.cuh"

using namespace elm;
using namespace elm::scan;

namespace {

__global__ void __launch_bounds__(kQueryThreads) scan_ring_query_kernel(
    const float* __restrict__ imu_t, const float* __restrict__ imu_gyro,
    const int* __restrict__ imu_count, int imu_cap, Ego e, const float* __restrict__ scan_cur,
    const float* __restrict__ scan_end, const float* __restrict__ tf_ego_to_lidar, int w,
    int run_deskew, float* __restrict__ fout, long long* __restrict__ iout,
    bool* __restrict__ bout) {
  __shared__ QueryShared sh;
  ring_query(imu_t, imu_gyro, imu_count, imu_cap, e, *scan_cur, *scan_end, tf_ego_to_lidar, w,
             run_deskew, fout, iout, bout, sh);
}

}  // namespace

// fout: imu_time [w], imu_rot [w, 3], odom_incre [3], init_guess [4, 4];
// iout: first_idx, last_idx; bout: imu_included [w], imu_available,
// odom_available, imu_covers_start, found, usable.
extern "C" int elm_scan_ring_query(const float* imu_t, const float* imu_gyro,
                                   const int* imu_count, int imu_cap, const float* ego_t,
                                   const float* ego_pos, const float* ego_rpy,
                                   const float* ego_vel, const float* ego_gyro,
                                   const int* ego_count, int ego_cap, const float* scan_cur,
                                   const float* scan_end, const float* tf_ego_to_lidar, int w,
                                   int run_deskew, float* fout, long long* iout, bool* bout,
                                   cudaStream_t stream) {
  const Ego e{ego_t, ego_pos, ego_rpy, ego_vel, ego_gyro, ego_count, ego_cap};
  scan_ring_query_kernel<<<1, kQueryThreads, 0, stream>>>(
      imu_t, imu_gyro, imu_count, imu_cap, e, scan_cur, scan_end, tf_ego_to_lidar, w, run_deskew,
      fout, iout, bout);
  return (int)cudaGetLastError();
}
