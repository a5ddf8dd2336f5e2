"""Frame conversions — port of ``elimaloc_tpu/ops/frames.py:16,27,75``
(reference: localization_functions.hpp:125-181, 491-513)."""

from __future__ import annotations

import torch

from .lie import euler_to_rot, matvec


def global_to_local_velocity(v_global, rpy):
    """R(rpy)^T v (ConvertGlobalToLocalVelocity, hpp:491-513)."""
    return matvec(euler_to_rot(rpy).transpose(-1, -2), v_global)


def local_to_global_velocity(v_local, rpy):
    """R(rpy) v."""
    return matvec(euler_to_rot(rpy), v_local)


def imu_to_ego(acc_imu, gyro_imu, rot_calib, trans_calib=None):
    """IMU sample(s) -> ego frame, with the centrifugal term w x (w x (-r))
    when the lever arm ``trans_calib`` is given (hpp:125-181)."""
    acc = matvec(rot_calib, acc_imu)
    gyro = matvec(rot_calib, gyro_imu)
    if trans_calib is not None:
        r = trans_calib.expand(gyro.shape)
        acc = acc + torch.linalg.cross(gyro, torch.linalg.cross(gyro, -r))
    return acc, gyro
