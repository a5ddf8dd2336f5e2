"""Reference-faithful single-core CPU pipeline (NumPy, float64, no JAX).

Two jobs:

1. **Measured baseline** for the TPU speedup claim: the reference publishes no
   numbers (BASELINE.md), so bench.py times this implementation — the same
   per-scan math (deskew, voxel downsample, 27-voxel correspondence over the
   packed hash grid, robust Gauss-Newton/LM ICP, EKF fusion) as
   well-vectorized single-threaded NumPy over the same packed map arrays.

2. **End-to-end oracle** for trajectory parity: :class:`CpuPipeline` replays a
   full log — 27-state EKF with every gate/aux filter, all four ICP methods,
   deskew, covariance shaping, latency compensation — in float64 with real
   Python control flow (the reference's early returns, not masks).
   bench.py / tests measure ATE(TPU pipeline vs this oracle) on the same log.

Reference mapping (transliteration of the cited formulas, like
tests/ref_numpy.py — the reference ships no tests, so an oracle must restate
the math):
  * CpuEkf            <- src/app/localization/ekf_localization/src/
                         ekf_algorithm.cpp:22-833 + ekf_algorithm.hpp:116-209
  * CpuVoxelGrid      <- src/app/localization/pcm_matching/src/
                         voxel_hash_map.cpp:31-206
  * icp_np            <- src/app/localization/pcm_matching/src/
                         registration.cpp:15-418
  * deskew/pose sync  <- src/app/localization/pcm_matching/src/
                         pcm_matching.cpp:467-824, 933-1045
  * cov shaping       <- pcm_matching.cpp:1047-1101 + pcm_matching.hpp:222-290
  * latency comp      <- ekf_localization.cpp:323-394
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import ElimalocConfig, GnssSource, GpsType, IcpMethod
from .map.builder import BuiltMap, hash_coords, fingerprint_coords

INIT_STATE_COV = 100.0  # ekf_algorithm.hpp:73
_D2R = np.pi / 180.0


# --------------------------------------------------------------------------- #
# f64 rotation helpers (localization_functions.hpp:312-483)
# --------------------------------------------------------------------------- #

def _skew(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def _skew_batch(v):
    out = np.zeros((len(v), 3, 3))
    out[:, 0, 1] = -v[:, 2]
    out[:, 0, 2] = v[:, 1]
    out[:, 1, 0] = v[:, 2]
    out[:, 1, 2] = -v[:, 0]
    out[:, 2, 0] = -v[:, 1]
    out[:, 2, 1] = v[:, 0]
    return out


def _exp_so3(v):
    """Exp (hpp:409-419) — identity below the reference's 1e-5 threshold."""
    th = np.linalg.norm(v)
    if th < 1e-5:
        return np.eye(3)
    k = _skew(np.asarray(v) / th)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)


def _log_so3(R):
    """Log (hpp:393-403) — zero below the reference's 1e-5 threshold."""
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos_t)
    if abs(th) < 1e-5:
        return np.zeros(3)
    m = (R - R.T) / (2.0 * np.sin(th))
    return th * np.array([m[2, 1], m[0, 2], m[1, 0]])


def _right_jacobian(gyro, dt):
    """PartialDerivativeRotWrtGyro (hpp:466-483): the reference's exact
    formula (normalized K, theta powers) and its ZERO below 1e-5."""
    v = np.asarray(gyro) * dt
    th = np.linalg.norm(v)
    if th < 1e-5:
        return np.zeros((3, 3))
    k = _skew(v / th)
    return dt * (
        np.eye(3)
        + (1 - np.cos(th)) / th**2 * k
        + (th - np.sin(th)) / th**3 * (k @ k)
    )


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_normalize(q):
    return q / np.linalg.norm(q)


def quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_to_rot(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rot_to_quat(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return quat_normalize(np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]))
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-30)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return quat_normalize(q)


def quat_from_axis_angle(v):
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = np.asarray(v) / th
    s = np.sin(th / 2.0)
    return np.array([np.cos(th / 2.0), axis[0] * s, axis[1] * s, axis[2] * s])


def euler_to_rot(rpy):
    """VecToRot (hpp:336-345): R = Rz Ry Rx."""
    cr, sr = np.cos(rpy[0]), np.sin(rpy[0])
    cp, sp = np.cos(rpy[1]), np.sin(rpy[1])
    cy, sy = np.cos(rpy[2]), np.sin(rpy[2])
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def rot_to_euler(R):
    """RotToVec (hpp:312-334) incl. the gimbal-lock branch."""
    sy = -R[2, 0]
    if abs(sy) > 1.0 - 1e-6:
        # gimbal lock: pitch = +-pi/2, roll set to 0
        pitch = np.pi / 2.0 * np.sign(sy)
        roll = 0.0
        yaw = np.arctan2(-R[0, 1], R[1, 1])
        return np.array([roll, pitch, yaw])
    pitch = np.arcsin(np.clip(sy, -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])


def norm_angle(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def global_to_local_velocity(v, rpy):
    return euler_to_rot(rpy).T @ np.asarray(v)


def _interpolate_tf_with_time(tf_between, dt_scan, dt_trans):
    """InterpolateTfWithTime (hpp:219-241)."""
    if dt_trans == 0.0:
        return np.eye(4)
    ratio = dt_scan / dt_trans
    out = np.eye(4)
    out[:3, 3] = tf_between[:3, 3] * ratio
    out[:3, :3] = _exp_so3(_log_so3(tf_between[:3, :3]) * ratio)
    return out


# --------------------------------------------------------------------------- #
# 27-state EKF (ekf_algorithm.cpp) — float64, real early returns
# --------------------------------------------------------------------------- #

# state indices (ekf_algorithm.hpp:41-69)
S_X, S_ROLL, S_VX, S_ROLL_RATE, S_AX, S_B_ROLL_RATE, S_B_AX, S_G_X, S_IMU_ROLL = (
    0, 3, 6, 9, 12, 15, 18, 21, 24)
S_Z, S_VZ, S_AZ, S_G_Z, S_YAW, S_PITCH, S_YAW_RATE = 2, 8, 14, 23, 5, 4, 11
STATE_ORDER = 27


class CpuEkf:
    """EkfAlgorithm transliteration (ekf_algorithm.cpp:22-833)."""

    def __init__(self, cfg: ElimalocConfig):
        self.cfg = cfg.ekf
        self.reset()

    def reset(self):
        c = self.cfg
        self.pos = np.array([c.ekf_init_x_m, c.ekf_init_y_m, c.ekf_init_z_m])
        self.rot = rot_to_quat(euler_to_rot(np.array(
            [c.ekf_init_roll_deg, c.ekf_init_pitch_deg, c.ekf_init_yaw_deg]
        ) * _D2R))
        self.vel = np.zeros(3)
        self.gyro = np.zeros(3)
        self.acc = np.zeros(3)
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.grav = np.array([0.0, 0.0, c.imu_gravity])
        self.imu_rot = np.array([1.0, 0.0, 0.0, 0.0])
        P = np.eye(STATE_ORDER) * INIT_STATE_COV
        for i in range(3):
            P[S_B_ROLL_RATE + i, S_B_ROLL_RATE + i] = c.imu_bias_cov_gyro
            P[S_B_AX + i, S_B_AX + i] = c.imu_bias_cov_acc
            P[S_G_X + i, S_G_X + i] = c.imu_bias_cov_acc
            P[S_IMU_ROLL + i, S_IMU_ROLL + i] = c.imu_bias_cov_gyro
        self.P = P
        self.reset_for_init_prediction = True
        self.yaw_initialized = False
        self.state_initialized = False
        self.rotation_stabilized = False
        self.state_stabilized = False
        self.pcm_init_on_going = False
        self.vehicle_imu_calib_started = False
        self.pcm_update_count = 0
        self.prev_timestamp = 0.0
        self.prev_gnss_timestamp = 0.0
        self.prev_can_timestamp = 0.0
        self.can_yaw_rate_bias = 0.0
        self._cf_started = False
        self._cf_prev_vx = 0.0
        self._cf_prev_t = 0.0

    # ---- gates (hpp:148-209) ----
    def _std(self, i):
        return np.sqrt(max(self.P[i, i], 0.0))

    def check_state_initialized(self):
        lim = 5.0 * _D2R
        self.state_initialized = (
            self._std(S_ROLL) < lim and self._std(S_PITCH) < lim
            and self._std(S_YAW) < lim and self._std(S_X) < 1.0
            and self._std(S_X + 1) < 1.0)

    def check_yaw_initialized(self):
        self.yaw_initialized = self._std(S_YAW) < 5.0 * _D2R

    def check_rotation_stabilized(self):
        lim = 0.2 * _D2R
        self.rotation_stabilized = (
            self._std(S_ROLL) < lim and self._std(S_PITCH) < lim
            and self._std(S_YAW) < lim)

    def check_state_stabilized(self):
        lim = 0.2 * _D2R
        self.state_stabilized = (
            self._std(S_ROLL) < lim and self._std(S_PITCH) < lim
            and self._std(S_YAW) < lim and self._std(S_X) < 0.5
            and self._std(S_X + 1) < 0.5)

    # ---- UpdateEkfState (hpp:116-145), H = selector of idx ----
    def _update(self, idx, Y, R):
        idx = np.asarray(idx)
        P = self.P
        S = P[np.ix_(idx, idx)] + R
        K = P[:, idx] @ np.linalg.inv(S)
        su = K @ np.asarray(Y)
        self.pos += su[0:3]
        self.vel += su[6:9]
        self.gyro += su[9:12]
        self.acc += su[12:15]
        self.bg += su[15:18]
        self.ba += su[18:21]
        self.grav += su[21:24]
        self.rot = quat_normalize(quat_mul(self.rot, quat_from_axis_angle(su[3:6])))
        self.imu_rot = quat_normalize(
            quat_mul(self.imu_rot, quat_from_axis_angle(su[24:27])))
        self.P = P - K @ P[idx, :]

    # ---- RunPredictionImu (cpp:167-316) ----
    def run_prediction_imu(self, t, acc, gyro):
        c = self.cfg
        if self.reset_for_init_prediction:
            self.prev_timestamp = t
            self.reset_for_init_prediction = False
            return False
        if self.pcm_init_on_going:
            self.prev_timestamp = t
            return False
        self.check_rotation_stabilized()
        if not self.state_initialized:
            self.prev_timestamp = t
            if self.yaw_initialized and (
                int(c.gps_type) == int(GpsType.BESTPOS)
                or c.use_complementary_filter
            ):
                self._complementary_filter(t, acc)
            return False
        if abs(t - self.prev_timestamp) < 1e-6:
            return False
        dt = t - self.prev_timestamp

        G_R_I = quat_to_rot(self.rot)
        corrected_gyro = gyro - self.bg
        self.rot = quat_normalize(quat_mul(
            self.rot, rot_to_quat(_exp_so3(corrected_gyro * dt))))
        corrected_accel = acc - self.ba
        accel_global = G_R_I @ corrected_accel - self.grav
        self.pos = self.pos + self.vel * dt + 0.5 * accel_global * dt * dt
        self.vel = self.vel + accel_global * dt
        self.gyro = corrected_gyro
        self.acc = accel_global

        dt2 = dt * dt
        qd = np.zeros(STATE_ORDER)
        qd[S_X:S_X + 3] = c.state_std_pos_m ** 2 * dt2
        qd[S_ROLL:S_ROLL + 3] = (c.state_std_rot_deg * _D2R) ** 2 * dt2
        qd[S_VX:S_VX + 3] = c.state_std_vel_mps ** 2 * dt2
        qd[S_ROLL_RATE:S_ROLL_RATE + 3] = (c.imu_std_gyro_dps * _D2R) ** 2 * dt2
        qd[S_AX:S_AX + 3] = c.imu_std_acc_mps ** 2 * dt2
        qd[S_B_ROLL_RATE:S_B_ROLL_RATE + 3] = c.imu_bias_cov_gyro ** 2 * dt2
        qd[S_B_AX:S_B_AX + 3] = c.imu_bias_cov_acc ** 2 * dt2
        qd[S_G_X:S_G_X + 3] = c.imu_bias_cov_acc ** 2 * dt2
        qd[S_IMU_ROLL:S_IMU_ROLL + 3] = (c.state_std_rot_deg * _D2R) ** 2 * dt2
        Q = np.diag(qd)

        F = np.eye(STATE_ORDER)
        F[S_X:S_X + 3, S_VX:S_VX + 3] = np.eye(3) * dt
        F[S_X:S_X + 3, S_B_AX:S_B_AX + 3] = -0.5 * G_R_I * dt2
        F[S_ROLL:S_ROLL + 3, S_B_ROLL_RATE:S_B_ROLL_RATE + 3] = (
            -_right_jacobian(corrected_gyro, dt))
        F[S_VX:S_VX + 3, S_B_AX:S_B_AX + 3] = -G_R_I * dt
        F[S_ROLL_RATE:S_ROLL_RATE + 3, S_B_ROLL_RATE:S_B_ROLL_RATE + 3] = -np.eye(3)
        F[S_AX:S_AX + 3, S_B_AX:S_B_AX + 3] = -G_R_I
        if c.imu_estimate_gravity:
            F[S_Z, S_G_Z] = -0.5 * dt2
            F[S_VZ, S_G_Z] = -dt
            F[S_AZ, S_G_Z] = -1.0
        self.P = F @ self.P @ F.T + Q
        self.prev_timestamp = t

        if c.use_zupt:
            self._zupt_imu(acc, gyro)
        if int(c.gps_type) == int(GpsType.BESTPOS) or c.use_complementary_filter:
            self._complementary_filter(t, acc)
        if c.imu_estimate_calibration:
            self._calibrate_vehicle_to_imu()
        return True

    # ---- RunPrediction: the CA-model no-IMU fallback (cpp:81-165) ----
    def run_prediction(self, t):
        c = self.cfg
        if self.reset_for_init_prediction:
            self.prev_timestamp = t
            self.reset_for_init_prediction = False
            return False
        if self.pcm_init_on_going:
            self.prev_timestamp = t
            return False
        if abs(t - self.prev_timestamp) < 1e-6:
            return False
        dt = t - self.prev_timestamp
        self.pos = self.pos + self.vel * dt + 0.5 * self.acc * dt * dt
        self.rot = quat_normalize(quat_mul(
            self.rot, rot_to_quat(_exp_so3(self.gyro * dt))))
        self.vel = self.vel + self.acc * dt

        dt2 = dt * dt
        qd = np.zeros(STATE_ORDER)
        qd[S_X:S_X + 3] = c.state_std_pos_m ** 2 * dt2
        qd[S_ROLL:S_ROLL + 3] = (c.state_std_rot_deg * _D2R) ** 2 * dt2
        qd[S_VX:S_VX + 3] = c.state_std_vel_mps ** 2 * dt2
        # quirk preserved: gyro std in deg/s, unscaled (cpp:138-139)
        qd[S_ROLL_RATE:S_ROLL_RATE + 3] = c.state_std_gyro_dps ** 2 * dt2
        qd[S_AX:S_AX + 3] = c.state_std_acc_mps ** 2 * dt2
        Q = np.diag(qd)

        F = np.eye(STATE_ORDER)
        F[S_X:S_X + 3, S_VX:S_VX + 3] = np.eye(3) * dt
        F[S_ROLL:S_ROLL + 3, S_ROLL_RATE:S_ROLL_RATE + 3] = np.eye(3) * dt
        F[S_X:S_X + 3, S_AX:S_AX + 3] = np.eye(3) * 0.5 * dt2
        F[S_VX:S_VX + 3, S_AX:S_AX + 3] = np.eye(3) * dt
        self.P = F @ self.P @ F.T + Q
        self.prev_timestamp = t
        return True

    # ---- ZuptImu (cpp:508-565) ----
    def _zupt_imu(self, acc, gyro):
        alpha, gamma = 0.01, 0.01
        vel_thre, gyro_thre, acc_thre = 0.1, 0.1, 0.1
        vel_local = quat_to_rot(self.rot).T @ self.vel
        if abs(vel_local[0]) > vel_thre:
            return
        vel_coeff = (vel_thre - abs(vel_local[0])) / vel_thre * 0.1
        self.vel = self.vel + vel_coeff * (-self.vel)
        if np.linalg.norm(self.gyro) > gyro_thre or np.linalg.norm(self.acc[:2]) > acc_thre:
            return
        self.bg = self.bg + gamma * (gyro - self.bg)
        grav_local = quat_to_rot(self.rot).T @ self.grav
        # both error terms use the PRE-update ba (cpp:545-549: errors are
        # computed before S_.ba +=)
        acc_err_loc = acc - (grav_local + self.ba)
        acc_err_g = quat_to_rot(self.rot) @ (acc - self.ba) - self.grav
        self.ba = self.ba + alpha * acc_err_loc
        if self.cfg.imu_estimate_gravity:
            self.grav[2] += alpha * acc_err_g[2]

    # ---- ComplementaryKalmanFilter (cpp:597-701) ----
    def _complementary_filter(self, t, acc):
        acc_meas = acc - self.ba
        vel_local = quat_to_rot(self.rot).T @ self.vel
        centripetal_acc = vel_local[0] * self.gyro[2]
        if not self._cf_started:
            self._cf_started = True
            self._cf_prev_vx = vel_local[0]
            self._cf_prev_t = t
        dt = t - self._cf_prev_t
        if dt < 1e-6:
            return
        est_acc_x = (vel_local[0] - self._cf_prev_vx) / dt
        self._cf_prev_vx = vel_local[0]
        self._cf_prev_t = t
        compensated = acc_meas - np.array([0.0, centripetal_acc, 0.0])
        if self.rotation_stabilized:
            compensated = compensated - np.array([est_acc_x, 0.0, 0.0])
        acc_diff = np.linalg.norm(acc_meas) - np.linalg.norm(self.grav)
        n = np.linalg.norm(compensated)
        if n < 1e-12:
            return
        gdir = compensated / n
        z = np.array([np.arctan2(gdir[1], gdir[2]),
                      -np.arcsin(np.clip(gdir[0], -1.0, 1.0))])
        rpy = rot_to_euler(quat_to_rot(self.rot))
        innovation = norm_angle(z - rpy[:2])
        base = 1.0 * _D2R if self.state_initialized else 10.0 * _D2R
        centr = abs(centripetal_acc) / 9.81 * 10.0
        longi = abs(est_acc_x) / 9.81 * 10.0
        accd = abs(acc_diff) / 9.81 * 10.0
        lat_s = 1.0 + accd + centr
        lon_s = 1.0 + accd + longi
        min_r = (1.0 * _D2R) ** 2
        R = np.diag([max((base * lat_s) ** 2, min_r),
                     max((base * lon_s) ** 2, min_r)])
        self._update((S_ROLL, S_PITCH), innovation, R)

    # ---- CalibrateVehicleToImu (cpp:703-776) ----
    def _calibrate_vehicle_to_imu(self):
        if np.linalg.norm(self.vel) < 3.0 or not self.rotation_stabilized:
            return
        self.vehicle_imu_calib_started = True
        q = quat_mul(self.rot, quat_conj(self.imu_rot))
        v_local = quat_to_rot(q).T @ self.vel
        v_dir = v_local / np.linalg.norm(v_local)
        yaw = np.arctan2(v_dir[1], v_dir[0])
        pitch = -np.arcsin(np.clip(v_dir[2], -1.0, 1.0))
        innovation = np.array([0.0, -pitch, -yaw])
        R = np.eye(3) * (1.0 * _D2R) ** 2  # fixed R (cpp:761-763)
        self._update((S_IMU_ROLL, S_IMU_ROLL + 1, S_IMU_ROLL + 2), innovation, R)

    # ---- RunGnssUpdate (cpp:318-432) ----
    def run_gnss_update(self, t, source, pos, rot_quat, pos_cov, rot_cov):
        c = self.cfg
        if source == GnssSource.PCM_INIT:
            self.pos = np.asarray(pos, np.float64).copy()
            self.rot = quat_normalize(np.asarray(rot_quat, np.float64))
            self.vel = np.zeros(3)
            self.gyro = np.zeros(3)
            self.acc = np.zeros(3)
            self.bg = np.zeros(3)
            self.ba = np.zeros(3)
            self.grav = np.array([0.0, 0.0, c.imu_gravity])
            self.P[:S_AZ + 1, :S_AZ + 1] = np.eye(S_AZ + 1) * INIT_STATE_COV
            self.state_initialized = True
            self.yaw_initialized = True
            self.pcm_init_on_going = True
            return True
        self.check_yaw_initialized()
        self.check_state_initialized()
        self.check_rotation_stabilized()
        self.check_state_stabilized()
        if self.pcm_init_on_going and source == GnssSource.PCM:
            if self.pcm_update_count > 10:
                self.pcm_init_on_going = False
            self.pcm_update_count += 1

        R6 = np.zeros((6, 6))
        R6[:3, :3] = pos_cov
        R6[3:, 3:] = rot_cov
        if source in (GnssSource.NOVATEL, GnssSource.BESTPOS, GnssSource.NAVSATFIX):
            R6[0, 0] += c.gnss_min_cov_x_m
            R6[1, 1] += c.gnss_min_cov_y_m
            R6[2, 2] += c.gnss_min_cov_z_m
            # quirk preserved: deg * pi/180, NOT squared (cpp:394-396)
            R6[3, 3] += c.gnss_min_cov_roll_deg * _D2R
            R6[4, 4] += c.gnss_min_cov_pitch_deg * _D2R
            R6[5, 5] += c.gnss_min_cov_yaw_deg * _D2R

        # CalEulerResidualFromQuat (hpp:355-370)
        rpy_state = rot_to_euler(quat_to_rot(self.rot))
        rpy_meas = rot_to_euler(quat_to_rot(quat_normalize(np.asarray(rot_quat))))
        res_euler = norm_angle(rpy_meas - rpy_state)
        Y6 = np.concatenate([np.asarray(pos) - self.pos, res_euler])

        if source in (GnssSource.NAVSATFIX, GnssSource.BESTPOS):
            if not self.yaw_initialized:
                R6[0, 0] += 3.0
                R6[1, 1] += 3.0
            self._update((0, 1, 2), Y6[:3], R6[:3, :3])
        else:
            self._update(tuple(range(6)), Y6, R6)
        self.prev_gnss_timestamp = t
        return True

    # ---- RunCanUpdate (cpp:434-506) ----
    def run_can_update(self, t, vel_x, yaw_rate):
        c = self.cfg
        if abs(t - self.prev_can_timestamp) < 0.01:
            return False
        unbiased_gyro_z = yaw_rate - self.can_yaw_rate_bias
        unbiased_vel = np.array([vel_x * c.can_vel_scale_factor, 0.0, 0.0])
        rot_m = quat_to_rot(self.rot)
        can_vel_global = rot_m @ unbiased_vel
        Y = np.concatenate([can_vel_global - self.vel,
                            [unbiased_gyro_z - self.gyro[2]]])
        unc = c.can_meas_uncertainty_vel_mps
        R_local = np.diag([unc ** 2, (2 * unc) ** 2, (2 * unc) ** 2])
        R = np.zeros((4, 4))
        R[:3, :3] = rot_m @ R_local @ rot_m.T
        R[3, 3] = (c.can_meas_uncertainty_yaw_rate_deg * _D2R) ** 2
        self._update((S_VX, S_VX + 1, S_VZ, S_YAW_RATE), Y, R)
        self.prev_can_timestamp = t
        # ZuptCan (cpp:567-587) on the raw input
        if np.linalg.norm([vel_x, 0.0, 0.0]) <= 0.05:
            a = 0.05
            self.can_yaw_rate_bias = a * yaw_rate + (1 - a) * self.can_yaw_rate_bias
            self.vel = (1 - a) * self.vel
        return True

    # ---- GetCurrentState (cpp:778-833) ----
    def get_state(self):
        rpy = rot_to_euler(quat_to_rot(self.rot))
        return {
            "timestamp": self.prev_timestamp,
            "pos": self.pos.copy(),
            "rpy": rpy,
            "vel_local": global_to_local_velocity(self.vel, rpy),
            "gyro": self.gyro.copy(),
        }


# --------------------------------------------------------------------------- #
# Packed-grid queries (voxel_hash_map.cpp:31-206)
# --------------------------------------------------------------------------- #

class CpuVoxelGrid:
    """NumPy view of the packed voxel map with the same windowed-probe hash.

    Provides all three reference correspondence kernels: nearest point
    (cpp:31-88, + per-point GICP covariance payloads), nearest voxel
    covariance (cpp:90-151), and all 7 face-adjacent voxel covariances
    (cpp:153-206)."""

    def __init__(self, built: BuiltMap):
        self.voxel_size = built.voxel_size
        p = built.max_probe
        self.max_probe = p
        self.table_size = built.table_size
        self.table = np.concatenate([built.table, built.table[:p]])
        self.table_fp = np.concatenate([built.table_fp, built.table_fp[:p]])
        m = built.max_points_per_voxel
        self.points = np.concatenate(
            [built.points, np.full((1, m, 3), np.inf, np.float32)], axis=0
        )
        self.counts = np.concatenate([built.counts, [0]])
        self.vox_mean = np.concatenate(
            [built.vox_mean, np.full((1, 3), np.inf, np.float32)], axis=0
        )
        self.vox_cov = np.concatenate(
            [built.vox_cov, np.eye(3, dtype=np.float32)[None]], axis=0
        )
        self.point_cov = self.point_cov_mean = None
        if built.point_cov is not None:
            self.point_cov = np.concatenate(
                [built.point_cov,
                 np.tile(np.eye(3, dtype=np.float32), (1, m, 1, 1))], axis=0)
            self.point_cov_mean = np.concatenate(
                [built.point_cov_mean, np.full((1, m, 3), np.inf, np.float32)],
                axis=0)
        self.sentinel = built.num_voxels
        self._offsets = np.array(
            [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
            dtype=np.int64,
        )
        self._offsets7 = np.array(
            [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
             [0, 0, 1], [0, 0, -1]], dtype=np.int64)

    def lookup(self, coords):
        h = hash_coords(coords, self.table_size)
        fp = fingerprint_coords(coords)
        idx = h[..., None] + np.arange(self.max_probe)
        rows = self.table[idx]
        fps = self.table_fp[idx]
        empty = rows < 0
        empty_before = np.cumsum(empty, axis=-1) - empty > 0
        hit = (fps == fp[..., None]) & ~empty & ~empty_before
        any_hit = hit.any(axis=-1)
        first = hit.argmax(axis=-1)
        row = np.take_along_axis(rows, first[..., None], axis=-1)[..., 0]
        return np.where(any_hit, row, self.sentinel)

    def _nearest_rows(self, queries, max_dist):
        c = np.floor(queries / self.voxel_size).astype(np.int64)
        nb = c[:, None, :] + self._offsets[None, :, :]
        rows = self.lookup(nb)                              # [N,27]
        cand = self.points[rows]                            # [N,27,M,3]
        d2 = np.einsum(
            "nkmi,nkmi->nkm",
            cand - queries[:, None, None, :],
            cand - queries[:, None, None, :],
        )
        d2f = d2.reshape(len(queries), -1)
        best = np.argmin(d2f, axis=1)
        best_d2 = d2f[np.arange(len(queries)), best]
        m = cand.shape[2]
        valid = best_d2 < max_dist * max_dist
        best_row = np.take_along_axis(
            rows, (best // m)[:, None], axis=1)[:, 0]
        return best_row, best % m, valid

    def nearest_point(self, queries, max_dist):
        """Nearest map point in the 27-voxel cube; (target [N,3], valid [N])."""
        row, slot, valid = self._nearest_rows(queries, max_dist)
        tgt = self.points[row, slot].astype(np.float64)
        return np.where(valid[:, None], tgt, queries), valid

    def nearest_point_cov(self, queries, max_dist):
        """GICP: nearest point + its precomputed neighborhood cov/mean."""
        row, slot, valid = self._nearest_rows(queries, max_dist)
        tgt = self.points[row, slot].astype(np.float64)
        cov = self.point_cov[row, slot].astype(np.float64)
        mean = self.point_cov_mean[row, slot].astype(np.float64)
        return (np.where(valid[:, None], tgt, queries), cov,
                np.where(valid[:, None], mean, queries), valid)

    def nearest_voxel_cov(self, queries, max_dist):
        """VGICP (cpp:90-151): cov of the 27-neighborhood voxel whose mean is
        closest."""
        c = np.floor(queries / self.voxel_size).astype(np.int64)
        nb = c[:, None, :] + self._offsets[None, :, :]
        rows = self.lookup(nb)
        means = self.vox_mean[rows].astype(np.float64)       # [N,27,3]
        occ = self.counts[rows] > 0
        diff = means - queries[:, None, :]
        d2 = np.where(occ, np.einsum("nki,nki->nk", diff, diff), np.inf)
        best = np.argmin(d2, axis=1)
        ar = np.arange(len(queries))
        valid = d2[ar, best] < max_dist * max_dist
        row = rows[ar, best]
        cov = self.vox_cov[row].astype(np.float64)
        mean = self.vox_mean[row].astype(np.float64)
        return cov, np.where(valid[:, None], mean, queries), valid

    def all_voxel_cov(self, queries, max_dist):
        """AVGICP (cpp:153-206): all 7 face-adjacent occupied voxels within
        max_dist. Returns (cov [N,7,3,3], mean [N,7,3], valid [N,7])."""
        c = np.floor(queries / self.voxel_size).astype(np.int64)
        nb = c[:, None, :] + self._offsets7[None, :, :]
        rows = self.lookup(nb)
        means = self.vox_mean[rows].astype(np.float64)
        occ = self.counts[rows] > 0
        diff = means - queries[:, None, :]
        d2 = np.einsum("nki,nki->nk", diff, diff)
        valid = occ & (d2 < max_dist * max_dist)
        cov = self.vox_cov[rows].astype(np.float64)
        mean = np.where(valid[:, :, None], means, queries[:, None, :])
        return cov, mean, valid


def voxel_downsample_np(points, voxel_size):
    keys = np.floor(points / voxel_size).astype(np.int64) + (1 << 20)
    packed = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
    _, first = np.unique(packed, return_index=True)
    return points[np.sort(first)]


# --------------------------------------------------------------------------- #
# Registration (registration.cpp:15-418) — all four methods, vectorized f64
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class IcpNpParams:
    method: int = int(IcpMethod.P2P)
    max_iter: int = 10
    max_search: float = 5.0
    lm_lambda: float = 0.5
    term: float = 0.02
    min_overlap: float = 0.4
    max_fitness: float = 0.5
    use_radar_cov: bool = False
    range_variance_m: float = 0.1
    azimuth_variance_deg: float = 0.5
    elevation_variance_deg: float = 1.0


def radar_point_cov_np(points, range_var, azi_var_deg, ele_var_deg):
    """Per-point range/azimuth/elevation covariance (CalPointCov,
    registration.hpp:186-208). Quirk preserved: returns R @ S (no R^T)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dist = np.sqrt(x * x + y * y)
    s_x = np.full_like(dist, range_var)
    s_y = np.maximum(0.1, dist * np.sin(azi_var_deg * _D2R))
    s_z = np.maximum(0.1, dist * np.sin(ele_var_deg * _D2R))
    ele = np.arctan2(z, dist)
    azi = np.arctan2(y, x)
    cy, sy = np.cos(azi), np.sin(azi)
    cp, sp = np.cos(ele), np.sin(ele)
    zero = np.zeros_like(azi)
    R = np.stack(
        [np.stack([cy * cp, -sy, cy * sp], -1),
         np.stack([sy * cp, cy, sy * sp], -1),
         np.stack([-sp, zero, cp], -1)], axis=-2)
    S = np.zeros(points.shape[:-1] + (3, 3))
    S[..., 0, 0] = s_x
    S[..., 1, 1] = s_y
    S[..., 2, 2] = s_z
    return np.einsum("kij,kjl->kil", R, S)


def _gn_solve(src_local, tgt_local_mean, maha, w, lm_lambda):
    """Masked batched J^T M J / J^T M r accumulation + LM solve
    (the AlignClouds* shared core)."""
    r = tgt_local_mean - src_local
    S = _skew_batch(src_local)
    A = w[:, None, None] * maha
    AS = np.einsum("kij,kjl->kil", A, S)
    tl = A.sum(0)
    tr = -AS.sum(0)
    bl = np.einsum("kij,kjl->il", S, A)
    br = -np.einsum("kij,kjl->il", S, AS)
    Ar = np.einsum("kij,kj->ki", A, r)
    JTJ = np.block([[tl, tr], [bl, br]])
    JTr = np.concatenate([Ar.sum(0), np.einsum("kij,kj->i", S, Ar)])
    reg = JTJ + lm_lambda * np.diag(np.diag(JTJ))
    x = np.linalg.solve(reg, JTr)
    return x, reg, r


def _smallest_eigvec_batch(covs):
    _, vecs = np.linalg.eigh(covs)
    return vecs[:, :, 0]


def icp_np(grid: CpuVoxelGrid, src_local, init_pose, p: IcpNpParams):
    """RunRegister (registration.cpp:273-418) for all four methods.

    Returns (pose, is_success, fitness, local_cov)."""
    pose = np.asarray(init_pose, np.float64).copy()
    n = len(src_local)
    fitness = 0.0
    local_cov = np.eye(6)
    method = p.method
    radar_all = None
    if p.use_radar_cov:
        # computed once from the initially-transformed cloud (cpp:302-305)
        init_global = src_local @ pose[:3, :3].T + pose[:3, 3]
        radar_all = radar_point_cov_np(
            init_global, p.range_variance_m, p.azimuth_variance_deg,
            p.elevation_variance_deg)
    for _ in range(p.max_iter):
        src_global = src_local @ pose[:3, :3].T + pose[:3, 3]
        inv = np.linalg.inv(pose)
        rot_inv = pose[:3, :3].T

        if method in (int(IcpMethod.P2P), int(IcpMethod.GICP)):
            if method == int(IcpMethod.P2P):
                tgt, valid = grid.nearest_point(src_global, p.max_search)
            else:
                tgt, cov, cov_mean, valid = grid.nearest_point_cov(
                    src_global, p.max_search)
            matched = int(valid.sum())
            if matched / n < p.min_overlap:
                return pose, False, fitness, local_cov
            sl = src_local[valid]
            if method == int(IcpMethod.P2P):
                tl = tgt[valid] @ inv[:3, :3].T + inv[:3, 3]
                r2 = np.einsum("ki,ki->k", tl - sl, tl - sl)
                w = p.max_search ** 2 / (p.max_search + r2) ** 2
                maha = np.broadcast_to(np.eye(3), (matched, 3, 3))
                x, reg, r = _gn_solve(sl, tl, maha, w, p.lm_lambda)
                fitness = float(np.sqrt(r2).sum() / max(matched, 1))
            else:
                # GICP: residual vs neighborhood mean; Mahalanobis weighting;
                # point-to-plane fitness (cpp:68-152)
                cm = cov_mean[valid] @ inv[:3, :3].T + inv[:3, 3]
                r2 = np.einsum("ki,ki->k", cm - sl, cm - sl)
                w = p.max_search ** 2 / (p.max_search + r2) ** 2 * 0.8 + 0.2
                RCR = np.einsum("ij,kjl,ml->kim", rot_inv, cov[valid], rot_inv)
                if radar_all is not None:
                    RCR = RCR + radar_all[valid]
                maha = np.linalg.inv(RCR)
                x, reg, r = _gn_solve(sl, cm, maha, w, p.lm_lambda)
                nrm = _smallest_eigvec_batch(cov[valid]) @ rot_inv.T
                nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
                fitness = float(
                    np.abs(np.einsum("ki,ki->k", r, nrm)).sum() / max(matched, 1))
                local_cov = np.linalg.inv(reg)
        else:
            if method == int(IcpMethod.VGICP):
                cov, mean, valid = grid.nearest_voxel_cov(src_global, p.max_search)
                sl_rep, cov_f, mean_f, val_f = src_local, cov, mean, valid
            else:  # AVGICP: up to 7 (point, voxel) pairs per point
                cov, mean, valid = grid.all_voxel_cov(src_global, p.max_search)
                k = valid.shape[1]
                sl_rep = np.repeat(src_local, k, axis=0)
                cov_f = cov.reshape(-1, 3, 3)
                mean_f = mean.reshape(-1, 3)
                val_f = valid.reshape(-1)
            matched = int(val_f.sum())
            # AVGICP quirk: PAIR count vs point count, can exceed 1 (cpp:349)
            if matched / n < p.min_overlap:
                return pose, False, fitness, local_cov
            sl = sl_rep[val_f]
            ml = mean_f[val_f] @ inv[:3, :3].T + inv[:3, 3]
            r2 = np.einsum("ki,ki->k", ml - sl, ml - sl)
            w = p.max_search ** 2 / (p.max_search + r2) ** 2
            keep = w >= 0.01  # cutoff (cpp:199-201)
            RCR = np.einsum("ij,kjl,ml->kim", rot_inv, cov_f[val_f], rot_inv)
            if radar_all is not None:
                rf = (radar_all if method == int(IcpMethod.VGICP)
                      else np.repeat(radar_all, valid.shape[1], axis=0))
                RCR = RCR + rf[val_f]
            maha = np.linalg.inv(RCR)
            x, reg, r = _gn_solve(sl[keep], ml[keep], maha[keep], w[keep],
                                  p.lm_lambda)
            # fitness numerator over kept, denominator full match (cpp:199-207)
            fitness = float(np.sqrt(r2[keep]).sum() / max(matched, 1))

        step = np.eye(4)
        step[:3, :3] = _exp_so3(x[3:])
        step[:3, 3] = x[:3]
        pose = pose @ step
        rot_norm = np.arccos(np.clip((np.trace(step[:3, :3]) - 1) / 2, -1, 1))
        if rot_norm + np.linalg.norm(x[:3]) < p.term:
            break
    if fitness > p.max_fitness:
        return pose, False, fitness, local_cov
    return pose, True, fitness, local_cov


# --------------------------------------------------------------------------- #
# Deskew (pcm_matching.cpp:467-824) — deque-driven, like the node
# --------------------------------------------------------------------------- #

def deskew_np(points, rel_times, imu_t, imu_gyro, scan_cur, scan_end,
              odom_incre):
    """Vectorized LIO-SAM deskew to scan end (same model as deskew.py)."""
    inc = (imu_t >= scan_cur - 0.01) & (imu_t <= scan_end + 0.01)
    t_inc = imu_t[inc]
    if len(t_inc) < 2:
        return points
    g = imu_gyro[inc]
    dt = np.diff(t_inc, prepend=t_inc[0])
    rot = np.cumsum(g * dt[:, None], axis=0)
    rot -= rot[0]
    pt_t = scan_cur + rel_times
    rot_cur = np.stack(
        [np.interp(pt_t, t_inc, rot[:, k]) for k in range(3)], axis=1
    )
    rot_from_end = rot_cur - rot[-1]
    span = max(scan_end - scan_cur, 1e-9)
    ratio = rel_times / span
    pos_from_end = (ratio[:, None] - 1.0) * odom_incre[None, :]
    cr, sr = np.cos(rot_from_end[:, 0]), np.sin(rot_from_end[:, 0])
    cp, sp = np.cos(rot_from_end[:, 1]), np.sin(rot_from_end[:, 1])
    cy, sy = np.cos(rot_from_end[:, 2]), np.sin(rot_from_end[:, 2])
    # Rz Ry Rx rows applied per point
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    nx = (cy * cp) * x + (cy * sp * sr - sy * cr) * y + (cy * sp * cr + sy * sr) * z
    ny = (sy * cp) * x + (sy * sp * sr + cy * cr) * y + (sy * sp * cr - cy * sr) * z
    nz = (-sp) * x + (cp * sr) * y + (cp * cr) * z
    return np.stack([nx, ny, nz], axis=1) + pos_from_end


def _odom_incre_from_deque(odom, scan_cur, scan_end):
    """OdomDeskewInfo (cpp:587-729): scan-start -> scan-end translation from
    the ego deque; extrapolates past the last sample. odom = list of dicts."""
    fresh = [o for o in odom if o["timestamp"] >= scan_cur - 0.1]
    if not fresh or fresh[0]["timestamp"] > scan_cur:
        return None
    start = next((o for o in fresh if o["timestamp"] >= scan_cur), fresh[-1])
    end = next((o for o in fresh if o["timestamp"] >= scan_end), None)
    def tf_of(o):
        t = np.eye(4)
        t[:3, :3] = euler_to_rot(o["rpy"])
        t[:3, 3] = o["pos"]
        return t
    tf_start = tf_of(start)
    if end is None:
        last = fresh[-1]
        dt_ex = scan_end - last["timestamp"]
        v_glob = euler_to_rot(last["rpy"]) @ last["vel_local"]
        pos_ex = last["pos"] + v_glob * dt_ex
        rpy_ex = last["rpy"] + last["gyro"] * dt_ex
        tf_end = np.eye(4)
        tf_end[:3, :3] = euler_to_rot(rpy_ex)
        tf_end[:3, 3] = pos_ex
        t_end = scan_end
    else:
        tf_end = tf_of(end)
        t_end = end["timestamp"]
    between = np.linalg.inv(tf_start) @ tf_end
    interp = _interpolate_tf_with_time(
        between, scan_end - scan_cur, t_end - start["timestamp"])
    return interp[:3, 3]


def _interpolated_pose(odom, t):
    """GetInterpolatedPose (cpp:933-1045): bracketing interpolation or
    velocity extrapolation. Returns 4x4 pose or None."""
    if not odom:
        return None
    before = None
    after = None
    for o in odom:
        if o["timestamp"] <= t:
            before = o
        elif after is None:
            after = o
            break
    if before is None:
        return None
    def tf_of(o):
        m = np.eye(4)
        m[:3, :3] = euler_to_rot(o["rpy"])
        m[:3, 3] = o["pos"]
        return m
    tf_before = tf_of(before)
    if after is None:
        last = odom[-1]
        dt_ex = t - last["timestamp"]
        v_glob = euler_to_rot(last["rpy"]) @ last["vel_local"]
        pos_ex = last["pos"] + v_glob * dt_ex
        rpy_ex = last["rpy"] + last["gyro"] * dt_ex
        tf_after = np.eye(4)
        tf_after[:3, :3] = euler_to_rot(rpy_ex)
        tf_after[:3, 3] = pos_ex
        t_after = t
    else:
        tf_after = tf_of(after)
        t_after = after["timestamp"]
    between = np.linalg.inv(tf_before) @ tf_after
    interp = _interpolate_tf_with_time(
        between, t - before["timestamp"], t_after - before["timestamp"])
    return tf_before @ interp


def shape_icp_covariance_np(rot_ego, local_cov, fitness):
    """PublishPcmOdom cov shaping (cpp:1073-1098 + NormalizeCovariance
    hpp:251-275)."""
    std = max(fitness, 0.25)
    angle_std = std * _D2R

    def normalize(cov):
        diag = np.diag(cov)
        if diag.min() <= 1e-9:
            cov = cov * 1e9
        mind = max(np.diag(cov).min(), 1e-9)
        return np.minimum(cov / mind, 5.0)

    t_cov = normalize(rot_ego @ local_cov[:3, :3] @ rot_ego.T) * std * std
    r_cov = normalize(local_cov[3:, 3:]) * angle_std * angle_std
    return t_cov, r_cov


def gnss_time_compensation_np(odom, meas_t, meas_pos, meas_rpy):
    """GnssTimeCompensation (ekf_localization.cpp:323-394)."""
    if not odom or odom[0]["timestamp"] > meas_t:
        return None
    cur = odom[-1]
    closest = next((o for o in odom if o["timestamp"] > meas_t), cur)
    dt = cur["timestamp"] - meas_t
    if dt <= 0.0:
        return meas_t, np.asarray(meas_pos), np.asarray(meas_rpy)
    span = cur["timestamp"] - closest["timestamp"]
    if abs(span) <= 1e-5:
        return cur["timestamp"], np.asarray(meas_pos), np.asarray(meas_rpy)
    ratio = dt / span
    dpos = (cur["pos"] - closest["pos"]) * ratio
    drpy = norm_angle(cur["rpy"] - closest["rpy"]) * ratio
    out_rpy = rot_to_euler(euler_to_rot(meas_rpy) @ euler_to_rot(drpy))
    return cur["timestamp"], np.asarray(meas_pos) + dpos, out_rpy


# --------------------------------------------------------------------------- #
# Full oracle pipeline (both reference nodes, one thread, f64)
# --------------------------------------------------------------------------- #

class CpuPipeline:
    """Single-threaded float64 replay of the full two-node system.

    Mirrors LocalizationPipeline.run's deterministic event order with the
    reference's deque/early-return semantics. Used as the trajectory-parity
    oracle and the honest CPU baseline."""

    def __init__(self, cfg: ElimalocConfig, built: BuiltMap, *,
                 ego_ring_size: int = 1024, imu_ring_size: int = 512):
        self.cfg = cfg
        self.grid = CpuVoxelGrid(built)
        self.ekf = CpuEkf(cfg)
        self.ego_ring_size = ego_ring_size
        self.imu_ring_size = imu_ring_size
        self.odom = []       # ego-state deque (PCM's deq_odom_)
        self.imu_deque = []  # (t, gyro) deque for deskew
        d2r = _D2R
        r_l = euler_to_rot(np.asarray(cfg.calib.ego_to_lidar_rot_deg) * d2r)
        self.tf_ego_to_lidar = np.eye(4)
        self.tf_ego_to_lidar[:3, :3] = r_l
        self.tf_ego_to_lidar[:3, 3] = cfg.calib.ego_to_lidar_trans
        self.tf_lidar_to_ego = np.linalg.inv(self.tf_ego_to_lidar)
        self.r_imu = euler_to_rot(np.asarray(cfg.calib.ego_to_imu_rot_deg) * d2r)
        self.t_imu = np.asarray(cfg.calib.ego_to_imu_trans, np.float64)
        self.icp_params = IcpNpParams(
            method=int(cfg.pcm.icp_method),
            max_iter=cfg.pcm.max_iteration,
            max_search=cfg.pcm.max_search_dist,
            lm_lambda=cfg.pcm.lm_lambda,
            term=cfg.pcm.icp_termination_threshold_m,
            min_overlap=cfg.pcm.min_overlap_ratio,
            max_fitness=cfg.pcm.max_fitness_score,
        )
        self._prev_imu_gyro = np.zeros(3)

    # -- event handlers --
    def imu_event(self, t, acc_raw, gyro_raw):
        # ImuStructConverter (hpp:149-181): rotate + centrifugal lever arm
        gyro = self.r_imu @ np.asarray(gyro_raw, np.float64)
        acc = self.r_imu @ np.asarray(acc_raw, np.float64) + np.cross(
            gyro, np.cross(gyro, -self.t_imu))
        self.ekf.run_prediction_imu(t, acc, gyro)
        es = self.ekf.get_state()
        es["timestamp"] = t if es["timestamp"] == 0.0 else es["timestamp"]
        if not self.odom or self.odom[-1]["timestamp"] + 1e-5 < es["timestamp"]:
            self.odom.append(es)
            if len(self.odom) > self.ego_ring_size:
                self.odom.pop(0)
        # PCM IMU intake: rotation only, no lever arm (pcm_matching.cpp:328)
        self.imu_deque.append((t, self.r_imu @ np.asarray(gyro_raw, np.float64)))
        if len(self.imu_deque) > self.imu_ring_size:
            self.imu_deque.pop(0)

    def gps_event(self, t, pos, cov_diag):
        c = self.cfg.ekf
        if not c.use_gps:
            return
        var = np.asarray(cov_diag, np.float64) ** 2  # quirk: squared again
        if var[0] > c.gnss_uncertainty_max_m or var[1] > c.gnss_uncertainty_max_m:
            return
        src = {int(GpsType.NAVSATFIX): GnssSource.NAVSATFIX,
               int(GpsType.BESTPOS): GnssSource.BESTPOS,
               int(GpsType.ODOMETRY): GnssSource.NOVATEL}[int(c.gps_type)]
        self.ekf.run_gnss_update(
            t, src, np.asarray(pos, np.float64),
            np.array([1.0, 0.0, 0.0, 0.0]), np.diag(var), np.zeros((3, 3)))

    def can_event(self, t, vel_x, yaw_rate):
        if self.cfg.ekf.use_can:
            self.ekf.run_can_update(t, float(vel_x), float(yaw_rate))

    def scan_event(self, stamp, points, rel_raw, valid):
        """CallbackPointCloud (pcm_matching.cpp:198-324)."""
        cfg = self.cfg
        stamp = stamp - cfg.pcm.lidar_time_delay
        pts = np.asarray(points, np.float64)[valid]
        rel = np.asarray(rel_raw, np.float64)[valid]
        dist = np.linalg.norm(pts, axis=1)
        keep = dist <= cfg.pcm.input_max_dist
        pts, rel = pts[keep], rel[keep]
        if len(pts) == 0:
            return None
        if cfg.pcm.lidar_scan_time_end:
            scan_end = stamp
            scan_cur = scan_end + rel[0]
            rel = rel - rel[0]
        else:
            scan_cur = stamp
            scan_end = stamp + rel[-1]

        if cfg.pcm.run_deskew:
            if len(self.imu_deque) < 2:
                return None
            imu_t = np.array([x[0] for x in self.imu_deque])
            imu_g = np.stack([x[1] for x in self.imu_deque])
            incre = _odom_incre_from_deque(self.odom, scan_cur, scan_end)
            if incre is None:
                return None
            pts = deskew_np(pts, rel, imu_t, imu_g, scan_cur, scan_end, incre)

        sync_pose = _interpolated_pose(self.odom, scan_end)
        if sync_pose is None:
            return None
        ds = voxel_downsample_np(pts, cfg.pcm.input_voxel_ds_m)
        init = sync_pose @ self.tf_ego_to_lidar
        pose, ok, fitness, local_cov = icp_np(self.grid, ds, init,
                                              self.icp_params)
        if not ok:
            return {"applied": False, "icp_pose": pose}
        icp_ego = pose @ self.tf_lidar_to_ego
        rot_ego = icp_ego[:3, :3]
        pos_cov, rot_cov = shape_icp_covariance_np(rot_ego, local_cov, fitness)
        rpy = rot_to_euler(rot_ego)
        comp = gnss_time_compensation_np(self.odom, scan_end, icp_ego[:3, 3], rpy)
        if comp is None:
            return {"applied": False, "icp_pose": icp_ego}
        ct, cpos, crpy = comp
        if cfg.ekf.use_pcm_matching:
            self.ekf.run_gnss_update(
                ct, GnssSource.PCM, cpos, rot_to_quat(euler_to_rot(crpy)),
                pos_cov, rot_cov)
        return {"applied": True, "icp_pose": icp_ego, "fitness": fitness}

    def run(self, log, time_base=None, frame_ordered: bool = False):
        """Replay a ReplayLog; returns a trajectory dict sampled at scan
        events (matching LocalizationPipeline.run).

        ``frame_ordered=False`` (default) replays in strict event-time order
        — the reference's callback order. ``frame_ordered=True`` replays
        with the fused pipeline's deterministic per-frame ordering
        (imu -> can -> gps -> scan within each inter-scan window,
        replay_fused docstring) so parity comparisons against run_fused
        isolate NUMERICS from the documented ordering skew."""
        tb = float(time_base if time_base is not None
                   else np.floor(min(log.imu_t[0], log.scan_t[0])))
        events = [("imu", i, float(t) - tb) for i, t in enumerate(log.imu_t)]
        # scans are delivered when the sweep completes (see
        # pipeline.runtime.scan_arrival_times)
        rel_last = np.where(log.scan_valid, log.scan_times, -np.inf).max(axis=1)
        arrival = log.scan_t + np.maximum(rel_last.astype(np.float64), 0.0)
        events += [("scan", i, float(t) - tb) for i, t in enumerate(arrival)]
        if log.gps_t is not None and self.cfg.ekf.use_gps:
            events += [("gps", i, float(t) - tb) for i, t in enumerate(log.gps_t)]
        if log.can_t is not None and self.cfg.ekf.use_can:
            events += [("can", i, float(t) - tb) for i, t in enumerate(log.can_t)]
        if frame_ordered:
            arr_rel = np.sort(arrival) - tb
            prio = {"imu": 0, "can": 1, "gps": 2, "scan": 3}

            def key(e):
                kind, _, t = e
                # scans bound their own frame; others attach to the frame of
                # the next scan arrival (searchsorted 'left': an event AT the
                # arrival instant precedes that scan, like build_fused_batches)
                frame = int(np.searchsorted(arr_rel, t,
                                            side="left" if kind != "scan"
                                            else "right"))
                if kind == "scan":
                    frame -= 1
                return (frame, prio[kind], t)

            events.sort(key=key)
        else:
            events.sort(key=lambda e: e[2])
        traj_t, traj_pos, traj_rpy, scans = [], [], [], []
        for kind, i, t in events:
            if kind == "imu":
                self.imu_event(t, log.imu_acc[i], log.imu_gyro[i])
            elif kind == "scan":
                out = self.scan_event(
                    float(log.scan_t[i]) - tb, log.scan_points[i],
                    log.scan_times[i], log.scan_valid[i])
                es = self.ekf.get_state()
                traj_t.append(es["timestamp"] + tb)
                traj_pos.append(es["pos"])
                traj_rpy.append(es["rpy"])
                scans.append(out)
            elif kind == "gps":
                self.gps_event(t, log.gps_pos[i], log.gps_cov[i])
            elif kind == "can":
                self.can_event(t, log.can_vel[i], log.can_yaw_rate[i])
        return {
            "t": np.asarray(traj_t),
            "pos": np.stack(traj_pos) if traj_pos else np.zeros((0, 3)),
            "rpy": np.stack(traj_rpy) if traj_rpy else np.zeros((0, 3)),
            "scans": scans,
        }


# --------------------------------------------------------------------------- #
# Single-scan step (bench baseline), kept API-compatible
# --------------------------------------------------------------------------- #

def icp_p2p_np(grid: CpuVoxelGrid, src_local, init_pose, *, max_iter=10,
               max_search=5.0, lm_lambda=0.5, term=0.02, min_overlap=0.4):
    """Vectorized single-core P2P RunRegister (registration.cpp:273-418)."""
    pose, ok, fitness, _ = icp_np(
        grid, src_local, init_pose,
        IcpNpParams(method=int(IcpMethod.P2P), max_iter=max_iter,
                    max_search=max_search, lm_lambda=lm_lambda, term=term,
                    min_overlap=min_overlap, max_fitness=np.inf))
    return pose, ok, fitness


def cpu_scan_step(grid: CpuVoxelGrid, points, rel_times, imu_t, imu_gyro,
                  scan_cur, scan_end, odom_incre, init_pose, *,
                  ds_voxel=1.5, max_dist=100.0, method=int(IcpMethod.P2P),
                  **icp_kw):
    """Full per-scan CPU step: range gate -> deskew -> downsample -> ICP.
    Mirrors CallbackPointCloud's hot path (pcm_matching.cpp:198-299)."""
    dist = np.linalg.norm(points, axis=1)
    pts = points[dist <= max_dist]
    rel = rel_times[: len(pts)] if len(rel_times) != len(pts) else rel_times[dist <= max_dist]
    pts = deskew_np(pts, rel, imu_t, imu_gyro, scan_cur, scan_end, odom_incre)
    ds = voxel_downsample_np(pts, ds_voxel)
    if method == int(IcpMethod.P2P):
        return icp_p2p_np(grid, ds, init_pose, **icp_kw)
    pose, ok, fit, _ = icp_np(grid, ds, init_pose,
                              IcpNpParams(method=method, **icp_kw))
    return pose, ok, fit
