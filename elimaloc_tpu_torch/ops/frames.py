"""Frame conversions — port of ``elimaloc_tpu/ops/frames.py`` (reference:
localization_functions.hpp:125-181, 491-581)."""

from __future__ import annotations

import torch

from .lie import euler_to_rot, matvec


def global_to_local_velocity(v_global, rpy):
    """R(rpy)^T v (ConvertGlobalToLocalVelocity, hpp:491-513)."""
    return matvec(euler_to_rot(rpy).transpose(-1, -2), v_global)


def local_to_global_velocity(v_local, rpy):
    """R(rpy) v."""
    return matvec(euler_to_rot(rpy), v_local)


def local_to_global_angular_rate(rate_local, rpy):
    """Body angular rates -> Euler-angle rates with the reference's matrix
    kept verbatim (ConvertLocalToGlobalAngularRate, hpp:521-543)."""
    r, p = rpy[..., 0], rpy[..., 1]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    lr, lp, ly = rate_local[..., 0], rate_local[..., 1], rate_local[..., 2]
    return torch.stack([lr - ly * sp, lp * cr + ly * sr * cp, -lp * sr + ly * cr * cp],
                       dim=-1)


def global_to_local_angular_rate(rate_global, rpy):
    """Euler-angle rates -> body angular rates, the reference's sign
    conventions and its cos(pitch) guard kept (ConvertGlobalToLocalAngularRate,
    hpp:551-581)."""
    r, p = rpy[..., 0], rpy[..., 1]
    cr, sr = torch.cos(r), torch.sin(r)
    cp = torch.cos(p)
    safe_cp = torch.where(torch.abs(cp * cr) < 1e-6, torch.ones_like(cp), cp)
    gr, gp, gy = rate_global[..., 0], rate_global[..., 1], rate_global[..., 2]
    return torch.stack([gr + gp * (sr / safe_cp) + gy * (-cr / safe_cp),
                        gp * cr + gy * sr,
                        gp * (-sr / safe_cp) + gy * (cr / safe_cp)], dim=-1)


def imu_to_ego(acc_imu, gyro_imu, rot_calib, trans_calib=None):
    """IMU sample(s) -> ego frame, with the centrifugal term w x (w x (-r))
    when the lever arm ``trans_calib`` is given (hpp:125-181)."""
    acc = matvec(rot_calib, acc_imu)
    gyro = matvec(rot_calib, gyro_imu)
    if trans_calib is not None:
        r = trans_calib.expand(gyro.shape)
        acc = acc + torch.linalg.cross(gyro, torch.linalg.cross(gyro, -r))
    return acc, gyro
