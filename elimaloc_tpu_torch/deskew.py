"""LiDAR motion compensation (deskew) — port of ``elimaloc_tpu/deskew.py``
(reference: pcm_matching.cpp:467-824).

``normalize_scan_times``, ``imu_deskew_info``, ``odom_deskew_info`` and
``make_deskew_info`` are small per-scan tensor ops. ``deskew_points`` is the
per-point hot op (JAX ``_find_rotation_batch`` + ``deskew_points``,
deskew.py:196-264): on a CUDA tensor it launches kernel D
(csrc/deskew.cu); on a CPU tensor it runs :func:`deskew_points_plain`, its
plain PyTorch version. The ``bug_compat_z`` flag keeps the reference's
z-translation typo (cpp:804) reproducible.
"""

from __future__ import annotations

import dataclasses

import torch

from . import kernels
from .ops import lie
from .ops.frames import local_to_global_velocity
from .pipeline.rings import _first_true, _last_true, take
from .struct import Struct


@dataclasses.dataclass
class DeskewInfo(Struct):
    """Per-scan deskew state (deskew.py:38-57)."""

    imu_time: torch.Tensor      # [W]
    imu_rot: torch.Tensor       # [W,3] integrated rotation at each sample
    imu_included: torch.Tensor  # [W] bool
    first_idx: torch.Tensor
    last_idx: torch.Tensor
    odom_incre: torch.Tensor    # [3]
    scan_cur: torch.Tensor
    scan_end: torch.Tensor
    imu_available: torch.Tensor
    odom_available: torch.Tensor
    imu_covers_start: torch.Tensor


def normalize_scan_times(times, valid, header_stamp, scan_time_end: bool):
    """(rel_times from scan start, scan_cur, scan_end) (cpp:473-486)."""
    front_t = take(times, _first_true(valid))
    back_t = take(times, _last_true(valid))
    if scan_time_end:
        scan_end = header_stamp
        return times - front_t, scan_end + front_t, scan_end
    return times, header_stamp, header_stamp + back_t


def imu_deskew_info(imu_time, imu_gyro, imu_valid, scan_cur, scan_end):
    """Integrate gyro over the scan window (ImuDeskewInfo, cpp:533-585)."""
    inc = imu_valid & (imu_time >= scan_cur - 0.01) & (imu_time <= scan_end + 0.01)
    first = _first_true(inc)
    last = _last_true(inc)
    prev_inc = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    dt = torch.where(inc & prev_inc,
                     imu_time - torch.cat([imu_time[:1], imu_time[:-1]]),
                     torch.zeros_like(imu_time))
    rot = torch.cumsum(imu_gyro * dt[:, None], dim=0)
    rot = rot - take(rot, first)
    rot = torch.where(inc[:, None], rot, torch.zeros_like(rot))
    available = torch.sum(inc) >= 2
    return rot, inc, first, last, available


def odom_deskew_info(ring_time, ring_pos, ring_rpy, ring_vel_local,
                     ring_gyro, ring_valid, scan_cur, scan_end):
    """Scan-start -> scan-end translation increment from the odometry ring
    (OdomDeskewInfo, cpp:587-729). Returns (incre [3], available)."""
    fresh = ring_valid & (ring_time >= scan_cur - 0.1)
    first_fresh = _first_true(fresh)
    front_ok = torch.any(fresh) & (take(ring_time, first_fresh) <= scan_cur)

    ge_cur = fresh & (ring_time >= scan_cur)
    last_fresh = _last_true(fresh)
    start_idx = torch.where(torch.any(ge_cur), _first_true(ge_cur), last_fresh)

    ge_end = fresh & (ring_time >= scan_end)
    has_end = torch.any(ge_end)
    end_idx = torch.where(has_end, _first_true(ge_end), last_fresh)

    def tf_of(i):
        return lie.make_transform(lie.euler_to_rot(take(ring_rpy, i)), take(ring_pos, i))

    tf_start = tf_of(start_idx)

    # extrapolated end pose (cpp:648-708)
    dt_ex = scan_end - take(ring_time, last_fresh)
    rpy_l = take(ring_rpy, last_fresh)
    v_glob = local_to_global_velocity(take(ring_vel_local, last_fresh), rpy_l)
    pos_ex = take(ring_pos, last_fresh) + v_glob * dt_ex
    rpy_ex = rpy_l + take(ring_gyro, last_fresh) * dt_ex
    tf_end_ex = lie.make_transform(lie.euler_to_rot(rpy_ex), pos_ex)
    tf_end = torch.where(has_end, tf_of(end_idx), tf_end_ex)
    t_end = torch.where(has_end, take(ring_time, end_idx), scan_end)

    between = lie.compose(lie.transform_inverse(tf_start), tf_end)
    interp = lie.interpolate_tf_with_time(
        between, scan_end - scan_cur, t_end - take(ring_time, start_idx))
    incre = interp[:3, 3]
    return torch.where(front_ok, incre, torch.zeros_like(incre)), front_ok


def make_deskew_info(imu_time, imu_gyro, imu_valid, ring_time, ring_pos,
                     ring_rpy, ring_vel_local, ring_gyro, ring_valid,
                     scan_cur, scan_end, window_budget: int = 64) -> DeskewInfo:
    """Deskew info with the IMU window compacted to a contiguous W-slice
    (deskew.py:157-193); an overflowing window clamps its tail and clears
    ``imu_covers_start``."""
    rot, inc, first, last, imu_ok = imu_deskew_info(
        imu_time, imu_gyro, imu_valid, scan_cur, scan_end)
    incre, odom_ok = odom_deskew_info(
        ring_time, ring_pos, ring_rpy, ring_vel_local, ring_gyro, ring_valid,
        scan_cur, scan_end)
    m = imu_time.shape[0]
    w = min(int(window_budget), m)
    start = torch.clamp(first, 0, m - w)
    truncated = (last - start) > (w - 1)
    covers = imu_ok & (take(imu_time, first) <= scan_cur + 0.01) & ~truncated
    sl = start + torch.arange(w, device=imu_time.device)
    return DeskewInfo(
        imu_time=imu_time[sl],
        imu_rot=rot[sl],
        imu_included=inc[sl],
        first_idx=first - start,
        last_idx=torch.clamp(last - start, 0, w - 1),
        odom_incre=incre,
        scan_cur=scan_cur,
        scan_end=scan_end,
        imu_available=imu_ok,
        odom_available=odom_ok,
        imu_covers_start=covers,
    )


def find_rotation_plain(info: DeskewInfo, point_times):
    """FindRotation (cpp:731-762) for all points: the piecewise-linear
    rotation table as a sum over intervals,
        rot(t) = sum_k d_rot_k * clip((t - t_{k-1}) / dt_k, 0, 1)."""
    t = info.imu_time
    rot = info.imu_rot
    inc = info.imu_included
    t_prev = torch.cat([t[:1], t[:-1]])
    rot_prev = torch.cat([torch.zeros_like(rot[:1]), rot[:-1]])
    pair_ok = inc & torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    dt = torch.where(pair_ok, t - t_prev, torch.ones_like(t))
    dt = torch.where(dt == 0.0, torch.ones_like(dt), dt)
    d_rot = torch.where(pair_ok[:, None], rot - rot_prev, torch.zeros_like(rot))
    w = torch.clamp((point_times[:, None] - t_prev[None, :]) / dt[None, :],
                    0.0, 1.0)                                   # [N,W]
    return w @ d_rot


def deskew_points_plain(points, rel_times, valid, info: DeskewInfo,
                        bug_compat_z: bool = False):
    """Plain PyTorch version of kernel D (deskew.py:229-264)."""
    rot_end = take(info.imu_rot, info.last_idx)
    rot_cur = find_rotation_plain(info, info.scan_cur + rel_times)
    span = info.scan_end - info.scan_cur
    ratio = rel_times / torch.where(span == 0, torch.ones_like(span), span)
    pos_cur = ratio[:, None] * info.odom_incre[None, :]
    rot_from_end = rot_cur - rot_end[None, :]
    pos_from_end = pos_cur - info.odom_incre[None, :]
    if bug_compat_z:
        # cpp:804: z uses the interpolated z ROTATION minus the z increment
        pos_from_end = torch.cat(
            [pos_from_end[:, :2], (rot_cur[:, 2] - info.odom_incre[2])[:, None]],
            dim=1)
    moved = lie.matvec(lie.euler_to_rot(rot_from_end), points) + pos_from_end
    ok = info.imu_available & info.odom_available
    return torch.where((valid & ok)[:, None], moved, points)


def deskew_points(points, rel_times, valid, info: DeskewInfo, *,
                  run_deskew: bool = True, bug_compat_z: bool = False):
    """Every point to the scan-END frame (DeskewPoint, cpp:780-824). Returns
    (points' [N,3], ok); with deskew off or its info unavailable the points
    pass through and ``ok`` says so."""
    ok = info.imu_available & info.odom_available
    if not run_deskew:
        return points, ok
    if points.device.type == "cpu":
        return deskew_points_plain(points, rel_times, valid, info, bug_compat_z), ok
    return kernels.deskew(points, rel_times, valid, info, bug_compat_z), ok
