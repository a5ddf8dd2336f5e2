"""EKF state records — port of ``elimaloc_tpu/ekf/state.py:39-173``.

Plain dataclasses of tensors (see ``struct.Struct``) with the reference's
27-state layout (ekf_algorithm.hpp:41-67):
  0:3 position   3:6 rotation (rpy)   6:9 velocity   9:12 body rates
  12:15 accel    15:18 gyro bias      18:21 acc bias 21:24 gravity
  24:27 imu mount rotation
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..struct import Struct

S_X, S_Y, S_Z = 0, 1, 2
S_ROLL, S_PITCH, S_YAW = 3, 4, 5
S_VX, S_VY, S_VZ = 6, 7, 8
S_ROLL_RATE, S_PITCH_RATE, S_YAW_RATE = 9, 10, 11
S_AX, S_AY, S_AZ = 12, 13, 14
S_B_ROLL_RATE, S_B_PITCH_RATE, S_B_YAW_RATE = 15, 16, 17
S_B_AX, S_B_AY, S_B_AZ = 18, 19, 20
S_G_X, S_G_Y, S_G_Z = 21, 22, 23
S_IMU_ROLL, S_IMU_PITCH, S_IMU_YAW = 24, 25, 26

STATE_ORDER = 27
GNSS_MEAS_ORDER = 6
INIT_STATE_COV = 100.0  # reference: ekf_algorithm.hpp:73


@dataclasses.dataclass
class EkfState(Struct):
    """Nominal state + covariance + filter bookkeeping
    (EkfAlgorithm members, ekf_algorithm.hpp:262-289)."""

    pos: torch.Tensor        # [3]
    rot: torch.Tensor        # [4] quaternion (w,x,y,z)
    vel: torch.Tensor        # [3]
    gyro: torch.Tensor       # [3]
    acc: torch.Tensor        # [3]
    bg: torch.Tensor         # [3]
    ba: torch.Tensor         # [3]
    grav: torch.Tensor       # [3]
    imu_rot: torch.Tensor    # [4]
    P: torch.Tensor          # [27, 27]

    reset_for_init_prediction: torch.Tensor  # bool
    state_initialized: torch.Tensor
    yaw_initialized: torch.Tensor
    rotation_stabilized: torch.Tensor
    state_stabilized: torch.Tensor
    pcm_init_on_going: torch.Tensor
    vehicle_imu_calib_started: torch.Tensor
    can_yaw_rate_bias: torch.Tensor          # scalar
    pcm_update_count: torch.Tensor           # int32
    prev_timestamp: torch.Tensor
    prev_gnss_timestamp: torch.Tensor
    prev_can_timestamp: torch.Tensor

    cf_initialized: torch.Tensor             # bool
    cf_prev_vel_local_x: torch.Tensor
    cf_prev_time: torch.Tensor


@dataclasses.dataclass
class ImuMeas(Struct):
    """Ego-frame IMU sample (ImuStruct, localization_struct.hpp:126)."""

    timestamp: torch.Tensor
    acc: torch.Tensor   # [3]
    gyro: torch.Tensor  # [3]


@dataclasses.dataclass
class GnssMeas(Struct):
    """6-DOF pose measurement (EkfGnssMeasurement, hpp:146-153)."""

    timestamp: torch.Tensor
    source: int           # GnssSource value (host constant on the slice)
    pos: torch.Tensor     # [3]
    rot: torch.Tensor     # [4]
    pos_cov: torch.Tensor  # [3,3]
    rot_cov: torch.Tensor  # [3,3]


@dataclasses.dataclass
class EkfParams(Struct):
    """Continuous EKF parameters (tensors), built by :func:`make_params`."""

    init_pos: torch.Tensor
    init_rpy: torch.Tensor
    imu_gravity: torch.Tensor
    state_std_pos_m: torch.Tensor
    state_std_rot_rad: torch.Tensor
    state_std_vel_mps: torch.Tensor
    state_std_gyro_dps: torch.Tensor
    state_std_acc_mps: torch.Tensor
    imu_std_gyro_rad: torch.Tensor
    imu_std_acc_mps: torch.Tensor
    imu_bias_cov_gyro: torch.Tensor
    imu_bias_cov_acc: torch.Tensor
    gnss_min_cov: torch.Tensor        # [6]
    can_vel_scale: torch.Tensor
    can_meas_uncertainty_vel: torch.Tensor
    can_meas_uncertainty_yaw_rate_rad: torch.Tensor


def make_params(cfg, dtype=torch.float32, device=None) -> EkfParams:
    """EkfConfig -> EkfParams (unit conversions as in ekf_algorithm.cpp)."""
    def r(deg):  # same rounding as the reference's deg * pi / 180
        return deg * math.pi / 180.0

    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return EkfParams(
        init_pos=f([cfg.ekf_init_x_m, cfg.ekf_init_y_m, cfg.ekf_init_z_m]),
        init_rpy=f([r(cfg.ekf_init_roll_deg), r(cfg.ekf_init_pitch_deg),
                    r(cfg.ekf_init_yaw_deg)]),
        imu_gravity=f(cfg.imu_gravity),
        state_std_pos_m=f(cfg.state_std_pos_m),
        state_std_rot_rad=f(r(cfg.state_std_rot_deg)),
        state_std_vel_mps=f(cfg.state_std_vel_mps),
        state_std_gyro_dps=f(cfg.state_std_gyro_dps),
        state_std_acc_mps=f(cfg.state_std_acc_mps),
        imu_std_gyro_rad=f(r(cfg.imu_std_gyro_dps)),
        imu_std_acc_mps=f(cfg.imu_std_acc_mps),
        imu_bias_cov_gyro=f(cfg.imu_bias_cov_gyro),
        imu_bias_cov_acc=f(cfg.imu_bias_cov_acc),
        gnss_min_cov=f([
            cfg.gnss_min_cov_x_m, cfg.gnss_min_cov_y_m, cfg.gnss_min_cov_z_m,
            r(cfg.gnss_min_cov_roll_deg), r(cfg.gnss_min_cov_pitch_deg),
            r(cfg.gnss_min_cov_yaw_deg),
        ]),
        can_vel_scale=f(cfg.can_vel_scale_factor),
        can_meas_uncertainty_vel=f(cfg.can_meas_uncertainty_vel_mps),
        can_meas_uncertainty_yaw_rate_rad=f(
            r(cfg.can_meas_uncertainty_yaw_rate_deg)),
    )
