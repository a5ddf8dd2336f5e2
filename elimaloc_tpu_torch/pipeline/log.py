"""Replay log schema + synthetic log generation — a NumPy copy of
``elimaloc_tpu.pipeline.log`` (copied because importing the JAX package
imports jax, which the GPU host lacks; outputs are held bit-identical by
tests/test_torch_guards.py).

The reference is validated by ROS bag replay (SURVEY.md §4); this framework
replaces bags with a simple array log (.npz) holding time-stamped IMU / LiDAR
/ GPS / CAN streams plus optional ground truth, and ships a synthetic
generator (a vehicle driving through a procedurally built world with a
motion-distorting spinning LiDAR) so every pipeline test and benchmark is
self-contained.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ReplayLog:
    """Event streams, each chronologically sorted."""

    imu_t: np.ndarray          # [Ni]
    imu_acc: np.ndarray        # [Ni,3] raw sensor frame
    imu_gyro: np.ndarray       # [Ni,3]
    scan_t: np.ndarray         # [Ns] header stamps
    scan_points: np.ndarray    # [Ns,N,3] sensor frame
    scan_times: np.ndarray     # [Ns,N] per-point rel times (raw convention)
    scan_valid: np.ndarray     # [Ns,N] bool
    gps_t: Optional[np.ndarray] = None      # [Ng]
    gps_pos: Optional[np.ndarray] = None    # [Ng,3] local ENU
    gps_cov: Optional[np.ndarray] = None    # [Ng,3] diagonal "covariance"
    can_t: Optional[np.ndarray] = None      # [Nc]
    can_vel: Optional[np.ndarray] = None    # [Nc]
    can_yaw_rate: Optional[np.ndarray] = None
    truth_t: Optional[np.ndarray] = None    # [Nt]
    truth_pos: Optional[np.ndarray] = None  # [Nt,3]
    truth_rpy: Optional[np.ndarray] = None  # [Nt,3]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            **{
                k: v
                for k, v in dataclasses.asdict(self).items()
                if v is not None
            },
        )

    @classmethod
    def load(cls, path: str) -> "ReplayLog":
        data = np.load(path)
        kwargs = {f.name: data[f.name] if f.name in data else None
                  for f in dataclasses.fields(cls)}
        return cls(**kwargs)


def make_world(seed=0, extent=120.0, n_ground=400_000, n_wall=200_000,
               wall_spacing=25.0):
    """Procedural urban-ish world: noisy ground plane + wall grid."""
    rng = np.random.default_rng(seed)
    ground = np.c_[
        rng.uniform(-extent, extent, (n_ground, 2)),
        rng.normal(0.0, 0.03, n_ground),
    ]
    wy = np.c_[
        rng.uniform(-extent, extent, n_wall // 2),
        np.round(rng.uniform(-extent, extent, n_wall // 2) / wall_spacing)
        * wall_spacing
        + rng.normal(0, 0.03, n_wall // 2),
        rng.uniform(0.0, 5.0, n_wall // 2),
    ]
    wx = np.c_[
        np.round(rng.uniform(-extent, extent, n_wall // 2) / wall_spacing)
        * wall_spacing
        + rng.normal(0, 0.03, n_wall // 2),
        rng.uniform(-extent, extent, n_wall // 2),
        rng.uniform(0.0, 5.0, n_wall // 2),
    ]
    return np.r_[ground, wy, wx]


def _traj(t, radius=60.0, speed=8.0, ramp=3.0):
    """Circle trajectory with a linear speed ramp from standstill.

    Returns (pos, yaw, global vel, yaw_rate, body accel_x) at time(s) t.
    A vehicle that starts already at full speed makes the cold-started EKF
    marginally stable; real logs start from rest, so the generator does too.
    """
    t = np.asarray(t, np.float64)
    ramp = max(ramp, 1e-6)
    v = speed * np.clip(t / ramp, 0.0, 1.0)
    ax = np.where(t < ramp, speed / ramp, 0.0)
    # arc length s(t), theta = s / R
    s_arc = np.where(
        t < ramp,
        0.5 * speed * t * t / ramp,
        0.5 * speed * ramp + speed * (t - ramp),
    )
    th = s_arc / radius
    pos = np.stack(
        [radius * np.cos(th), radius * np.sin(th), np.zeros_like(th)], axis=-1
    )
    yaw = th + np.pi / 2.0
    vel = np.stack(
        [-v * np.sin(th), v * np.cos(th), np.zeros_like(th)], axis=-1
    )
    yaw_rate = v / radius
    return pos, yaw, vel, yaw_rate, ax


def _yaw_rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    z = np.zeros_like(yaw)
    o = np.ones_like(yaw)
    return np.stack(
        [np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
         np.stack([z, z, o], -1)],
        axis=-2,
    )


def synthesize_log(
    world: np.ndarray,
    duration: float = 20.0,
    scan_hz: float = 10.0,
    imu_hz: float = 100.0,
    gps_hz: float = 1.0,
    can_hz: float = 50.0,
    points_per_scan: int = 8192,
    max_range: float = 80.0,
    seed: int = 1,
    gravity: float = 9.81,
    gyro_bias=(0.002, -0.001, 0.003),
    acc_bias=(0.02, -0.01, 0.015),
    imu_noise_gyro: float = 0.002,
    imu_noise_acc: float = 0.02,
    point_noise: float = 0.02,
    scan_time_end: bool = True,
    t0: float = 1_000_000.0,
    radius: float = 60.0,
    speed: float = 8.0,
    ramp: float = 3.0,
) -> ReplayLog:
    """Drive a circle through the world and record all sensor streams.

    The LiDAR spins over each 1/scan_hz interval: point i of a scan is the
    world point seen from the vehicle pose at that point's own acquisition
    time (real motion distortion, to be undone by the deskewer)."""
    rng = np.random.default_rng(seed)
    gyro_bias = np.asarray(gyro_bias)
    acc_bias = np.asarray(acc_bias)

    # City-scale worlds (10-100M points): a brute-force per-scan distance
    # pass over the whole world is O(scans x world). Bin the world into
    # coarse 2D cells once and only distance-test the cells within range of
    # each scan pose. Same range-gate semantics; the candidate ORDER differs
    # from the brute-force path, so sampled logs differ per seed (fine — any
    # generated log is self-consistent with its ground truth).
    cell_index = None
    if len(world) > 2_000_000:
        cell = max(64.0, max_range / 2)
        cx = np.floor(world[:, 0] / cell).astype(np.int64)
        cy = np.floor(world[:, 1] / cell).astype(np.int64)
        ckey = (cx - cx.min()) * (cy.max() - cy.min() + 2) + (cy - cy.min())
        order = np.argsort(ckey, kind="stable")
        skey = ckey[order]
        ukeys, starts = np.unique(skey, return_index=True)
        starts = np.append(starts, len(skey))
        world_sorted = world[order]

        def near_points(center_xy):
            bx0 = int(np.floor((center_xy[0] - max_range) / cell)) - cx.min()
            bx1 = int(np.floor((center_xy[0] + max_range) / cell)) - cx.min()
            by0 = int(np.floor((center_xy[1] - max_range) / cell)) - cy.min()
            by1 = int(np.floor((center_xy[1] + max_range) / cell)) - cy.min()
            span_y = cy.max() - cy.min() + 2
            chunks = []
            for bx in range(bx0, bx1 + 1):
                for by in range(by0, by1 + 1):
                    k = bx * span_y + by
                    i = np.searchsorted(ukeys, k)
                    if i < len(ukeys) and ukeys[i] == k:
                        chunks.append(world_sorted[starts[i]:starts[i + 1]])
            if not chunks:
                return np.empty((0, 3), world.dtype)
            cand = np.concatenate(chunks)
            d2 = np.sum((cand[:, :2] - center_xy) ** 2, axis=1)
            return cand[d2 < max_range * max_range]

        cell_index = near_points

    # IMU: body rates + specific force (tangential + centripetal + gravity)
    imu_t = t0 + np.arange(0.0, duration, 1.0 / imu_hz)
    _, yaw_i, vel_i, yr_i, ax_i = _traj(imu_t - t0, radius, speed, ramp)
    v_i = np.linalg.norm(vel_i, axis=1)
    gyro_true = np.c_[np.zeros((len(imu_t), 2)), yr_i]
    acc_body = np.c_[ax_i, v_i * yr_i, np.full(len(imu_t), gravity)]
    imu_gyro = gyro_true + gyro_bias + rng.normal(0, imu_noise_gyro, (len(imu_t), 3))
    imu_acc = acc_body + acc_bias + rng.normal(0, imu_noise_acc, (len(imu_t), 3))

    # Scans with per-point acquisition times across the sweep
    span = 1.0 / scan_hz
    scan_t = t0 + np.arange(span, duration - span, span)
    ns = len(scan_t)
    pts = np.full((ns, points_per_scan, 3), 1e9, np.float32)
    ptimes = np.zeros((ns, points_per_scan), np.float32)
    pvalid = np.zeros((ns, points_per_scan), bool)
    for si, st in enumerate(scan_t):
        rel = np.sort(rng.uniform(0.0, span, points_per_scan))
        t_abs = (st - t0) + (rel - span if scan_time_end else rel)
        # pose of each point's instant
        pos_p, yaw_p, _, _, _ = _traj(t_abs, radius, speed, ramp)
        if cell_index is not None:
            near = cell_index(pos_p.mean(0)[:2])
        else:
            d2 = np.sum((world[:, :2] - pos_p.mean(0)[:2]) ** 2, axis=1)
            near = world[d2 < max_range * max_range]
        if len(near) < points_per_scan:
            continue
        sel = near[rng.integers(0, len(near), points_per_scan)]
        rot = _yaw_rot(yaw_p)                      # [N,3,3]
        local = np.einsum("nji,nj->ni", rot, sel - pos_p)
        local += rng.normal(0, point_noise, local.shape)
        pts[si] = local.astype(np.float32)
        ptimes[si] = (rel - span if scan_time_end else rel).astype(np.float32)
        pvalid[si] = True
    # header stamp convention: scan_time_end=True -> the stamp is the LAST
    # point time (points acquired over [st - span, st)); False -> the FIRST
    # (points over [st, st + span), per-point times positive from the stamp).
    # Either way the generator's t_abs grid makes scan_t the stamp.
    header = scan_t

    # GPS (local ENU directly; the pipeline can also take lat/lon)
    gps_t = t0 + np.arange(0.5, duration, 1.0 / gps_hz)
    gpos, _, _, _, _ = _traj(gps_t - t0, radius, speed, ramp)
    gps_pos = gpos + rng.normal(0, 0.3, gpos.shape)
    gps_cov = np.full((len(gps_t), 3), 0.3)

    # CAN wheel speed
    can_t = t0 + np.arange(0.0, duration, 1.0 / can_hz)
    _, _, cvel, cyr, _ = _traj(can_t - t0, radius, speed, ramp)
    can_vel = np.linalg.norm(cvel, axis=1) + rng.normal(0, 0.05, len(can_t))
    can_yaw = cyr + rng.normal(0, 0.002, len(can_t))

    # Ground truth at scan ends
    tt = header
    tpos, tyaw, _, _, _ = _traj(tt - t0, radius, speed, ramp)
    trpy = np.c_[np.zeros((ns, 2)), tyaw]

    return ReplayLog(
        imu_t=imu_t, imu_acc=imu_acc, imu_gyro=imu_gyro,
        scan_t=header, scan_points=pts, scan_times=ptimes, scan_valid=pvalid,
        gps_t=gps_t, gps_pos=gps_pos, gps_cov=gps_cov,
        can_t=can_t, can_vel=can_vel, can_yaw_rate=can_yaw,
        truth_t=tt, truth_pos=tpos, truth_rpy=trpy,
    )


def ate_rmse(est_t, est_pos, truth_t, truth_pos) -> float:
    """Absolute trajectory error (RMSE) with nearest-time association."""
    est_t = np.asarray(est_t)
    if len(est_t) == 0:
        return float("inf")
    errs = []
    for tt, tp in zip(truth_t, truth_pos):
        i = np.argmin(np.abs(est_t - tt))
        if abs(est_t[i] - tt) < 0.05:
            errs.append(np.linalg.norm(est_pos[i] - tp))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf")
