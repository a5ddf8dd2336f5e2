"""The fused localization runtime, P2P main path — port of
``elimaloc_tpu/pipeline/runtime.py``.

One :class:`PipelineState` (EKF state + ego/IMU rings) runs through
:func:`fused_frame` once per LiDAR scan: :func:`imu_subbatch` (the frame's
IMU samples through the EKF prediction, then one batch push into each
ring), then :func:`scan_step` (range gate -> deskew -> pose sync -> voxel
downsample -> P2P registration -> covariance shaping -> latency
compensation -> EKF PCM update). :func:`replay_fused` is the Python loop
that replaces the JAX ``lax.scan`` over frames; batches come from the NumPy
:func:`build_fused_batches` and move to the device once per log.

Refused with NotImplementedError (ROADMAP Queue 1): GPS / CAN fusion in
the fused frame (#12), the hash backend (#13), active-window maps (#14) and
every ICP method but P2P (#11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import deskew as deskew_mod
from ..config import ElimalocConfig, GnssSource, IcpMethod
from ..ekf import (
    EkfFlags,
    EkfParams,
    EkfState,
    GnssMeas,
    ImuMeas,
    ego_state,
    init_state,
    make_params,
    predict_imu,
    update_gnss,
)
from ..map import builder as map_builder
from ..map import tiles as map_tiles
from ..map.grid import voxel_downsample
from ..ops import lie
from ..ops.frames import global_to_local_velocity, imu_to_ego
from ..register.icp import (
    IcpParams,
    IcpStatic,
    make_icp_params,
    make_icp_static,
    run_register,
)
from ..struct import Struct, select
from . import rings
from .log import ReplayLog


@dataclasses.dataclass
class PipelineState(Struct):
    ekf: EkfState
    ego_ring: rings.EgoRing
    imu_ring: rings.ImuRing


@dataclasses.dataclass
class PipelineParams(Struct):
    """Continuous parameters shared by all steps (tensors)."""

    ekf: EkfParams
    icp: IcpParams
    tf_ego_to_lidar: torch.Tensor      # [4,4]
    tf_lidar_to_ego: torch.Tensor      # [4,4]
    ego_to_imu_rot: torch.Tensor       # [3,3]
    ego_to_imu_trans: torch.Tensor     # [3]
    lidar_time_delay: torch.Tensor
    input_max_dist: torch.Tensor
    input_voxel_ds: torch.Tensor
    gnss_uncertainty_max: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PipelineStatic:
    """Static switches shared by all steps (runtime.py:89-114 without the
    TPU-only ``sub_unroll`` and the event-loop fields ``use_imu`` and
    ``tick_hz``, which the fused path never reads)."""

    ekf_flags: EkfFlags
    icp_static: IcpStatic
    run_deskew: bool = True
    scan_time_end: bool = True
    bug_compat_deskew_z: bool = False
    ds_points: int = 8192
    use_gps: bool = False
    use_can: bool = False
    use_pcm: bool = True


def make_pipeline_params(cfg: ElimalocConfig, dtype=torch.float32,
                         device=None) -> PipelineParams:
    d2r = np.pi / 180.0
    r_lidar = lie.euler_to_rot(
        torch.tensor(cfg.calib.ego_to_lidar_rot_deg, dtype=torch.float64) * d2r)
    tf = np.eye(4)
    tf[:3, :3] = r_lidar.numpy()
    tf[:3, 3] = cfg.calib.ego_to_lidar_trans
    r_imu = lie.euler_to_rot(
        torch.tensor(cfg.calib.ego_to_imu_rot_deg, dtype=torch.float64) * d2r)

    def f(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    return PipelineParams(
        ekf=make_params(cfg.ekf, dtype=dtype, device=device),
        icp=make_icp_params(cfg.pcm, dtype=dtype, device=device),
        tf_ego_to_lidar=f(tf),
        tf_lidar_to_ego=f(np.linalg.inv(tf)),
        ego_to_imu_rot=f(r_imu.numpy()),
        ego_to_imu_trans=f(cfg.calib.ego_to_imu_trans),
        lidar_time_delay=f(cfg.pcm.lidar_time_delay),
        input_max_dist=f(cfg.pcm.input_max_dist),
        input_voxel_ds=f(cfg.pcm.input_voxel_ds_m),
        gnss_uncertainty_max=f(cfg.ekf.gnss_uncertainty_max_m),
    )


def make_pipeline_static(cfg: ElimalocConfig, backend: str = "tile",
                         tile_budget=None, ds_points: int = 8192,
                         bug_compat_deskew_z: bool = False,
                         reassign_each_iter: bool | None = None) -> PipelineStatic:
    return PipelineStatic(
        ekf_flags=EkfFlags.from_config(cfg.ekf),
        icp_static=make_icp_static(cfg.pcm, backend=backend,
                                   tile_budget=tile_budget,
                                   reassign_each_iter=reassign_each_iter),
        run_deskew=cfg.pcm.run_deskew,
        scan_time_end=cfg.pcm.lidar_scan_time_end,
        bug_compat_deskew_z=bug_compat_deskew_z,
        ds_points=ds_points,
        use_gps=cfg.ekf.use_gps,
        use_can=cfg.ekf.use_can,
        use_pcm=cfg.ekf.use_pcm_matching,
    )


def shape_icp_covariance(rot_ego, local_cov, fitness):
    """ICP (JTJ + lambda I)^-1 -> measurement covariance (PublishPcmOdom,
    pcm_matching.cpp:1073-1098 + NormalizeCovariance hpp:251-275)."""
    std = torch.clamp(fitness, min=0.25)
    angle_std = std * math.pi / 180.0

    def normalize(cov):
        min_diag = torch.min(torch.diagonal(cov))
        cov2 = torch.where(min_diag <= 1e-9, cov * 1e9, cov)
        min2 = torch.clamp(torch.min(torch.diagonal(cov2)), min=1e-9)
        return torch.clamp(cov2 / min2, max=5.0)

    t_cov = rot_ego @ local_cov[:3, :3] @ rot_ego.T
    r_cov = local_cov[3:, 3:]
    return (normalize(t_cov) * std * std,
            normalize(r_cov) * angle_std * angle_std)


def _no_mark(name):
    return None


def scan_step(state: PipelineState, stamp, points, rel_raw, valid, tmap,
              pp: PipelineParams, ps: PipelineStatic, mark=_no_mark):
    """One LiDAR frame through the matching pipeline (runtime.py:299-382).
    Returns (state', out dict). ``mark(name)`` is called at the stage
    boundaries "deskew", "downsample", "assign", "gn" (for timing)."""
    stamp = stamp - pp.lidar_time_delay

    # range gate (FilterPointsByDistance, cpp:451-465)
    valid = valid & (lie.norm(points) <= pp.input_max_dist)
    rel, scan_cur, scan_end = deskew_mod.normalize_scan_times(
        rel_raw, valid, stamp, ps.scan_time_end)

    imu_r = state.imu_ring
    ego_r = state.ego_ring
    info = deskew_mod.make_deskew_info(
        imu_r.t, imu_r.gyro, imu_r.valid_mask(),
        ego_r.t, ego_r.pos, ego_r.rpy, ego_r.vel_local, ego_r.gyro,
        ego_r.valid_mask(), scan_cur, scan_end)
    pts_d, desk_ok = deskew_mod.deskew_points(
        points, rel, valid, info, run_deskew=ps.run_deskew,
        bug_compat_z=ps.bug_compat_deskew_z)
    usable = desk_ok if ps.run_deskew else torch.ones_like(desk_ok)
    mark("deskew")

    sync_pose, found = rings.get_interpolated_pose(ego_r, scan_end)
    usable = usable & found & (ego_r.count > 0)
    ds_pts, ds_valid, ds_kept = voxel_downsample(
        pts_d, valid, pp.input_voxel_ds, ps.ds_points)
    mark("downsample")

    init_guess = lie.compose(sync_pose, pp.tf_ego_to_lidar)
    res = run_register(ds_pts, ds_valid, tmap, init_guess, pp.icp,
                       ps.icp_static, mark=mark)

    icp_ego_pose = lie.compose(res.pose, pp.tf_lidar_to_ego)
    rot_ego = icp_ego_pose[:3, :3]
    pos = icp_ego_pose[:3, 3]
    quat = lie.rot_to_quat(rot_ego)
    pos_cov, rot_cov = shape_icp_covariance(rot_ego, res.local_cov, res.fitness)

    ct, cpos, cquat, comp_ok = rings.gnss_time_compensation(
        ego_r, scan_end, pos, quat)
    meas = GnssMeas(timestamp=ct, source=int(GnssSource.PCM), pos=cpos,
                    rot=cquat, pos_cov=pos_cov, rot_cov=rot_cov)
    apply = usable & res.success & comp_ok
    if not ps.use_pcm:
        apply = torch.zeros_like(apply)
    ekf2 = update_gnss(state.ekf, meas, pp.ekf, ps.ekf_flags)
    new_state = select(apply, state.replace(ekf=ekf2), state)

    out = {
        "scan_end": scan_end,
        "icp_pose": icp_ego_pose,
        "applied": apply,
        "icp_success": res.success,
        "deskew_ok": desk_ok,
        "pose_sync_ok": found,
        "deskew_full_cover": info.imu_covers_start,
        "fitness": res.fitness,
        "overlap": res.overlap,
        "iterations": res.iterations,
        "slots_dropped": res.dropped,
        "ds_kept": ds_kept,
    }
    return new_state, out


def imu_subbatch(st: PipelineState, b, pp: PipelineParams,
                 ps: PipelineStatic) -> PipelineState:
    """The frame's IMU samples through ``predict_imu`` one at a time (masked
    by validity), the ego-state conversions batched after the loop, then one
    batch push into each ring (runtime.py:405-441)."""
    ts, accs, gyros, valids = b["imu_t"], b["imu_acc"], b["imu_gyro"], b["imu_valid"]
    acc_e, gyro_e = imu_to_ego(accs, gyros, pp.ego_to_imu_rot, pp.ego_to_imu_trans)
    # PCM's IMU intake rotates but does not lever-arm compensate (cpp:328)
    gyro_pcm = gyros @ pp.ego_to_imu_rot.T
    acc_pcm = accs @ pp.ego_to_imu_rot.T

    ekf = st.ekf
    hist = []
    for i in range(ts.shape[0]):
        ekf2 = predict_imu(ekf, ImuMeas(timestamp=ts[i], acc=acc_e[i],
                                        gyro=gyro_e[i]), pp.ekf, ps.ekf_flags)
        ekf = select(valids[i], ekf2, ekf)
        hist.append((ekf.prev_timestamp, ekf.pos, ekf.rot, ekf.vel, ekf.gyro))
    t_s, pos_s, rot_s, vel_s, gyro_s = (torch.stack(x) for x in zip(*hist))
    rpy_s = lie.rot_to_euler(lie.quat_to_rot(rot_s))
    vloc_s = global_to_local_velocity(vel_s, rpy_s)
    ego_ring = rings.push_ego_batch(st.ego_ring, t_s, pos_s, rpy_s, vloc_s,
                                    gyro_s, valids)
    imu_ring = rings.push_imu_batch(st.imu_ring, ts, gyro_pcm, acc_pcm, valids)
    return st.replace(ekf=ekf, ego_ring=ego_ring, imu_ring=imu_ring)


def fused_frame(st: PipelineState, b, tmap, pp: PipelineParams,
                ps: PipelineStatic, mark=_no_mark):
    """One scan frame: the IMU sub-batch then the scan (runtime.py:444-491).
    ``mark(name)`` gets "imu" after the IMU chain, the scan_step marks, and
    "ekf_update" at the end of the frame."""
    if ps.use_gps or ps.use_can:
        raise NotImplementedError(
            "GPS / CAN fusion in the fused frame is ROADMAP Queue 1 #12")
    st = imu_subbatch(st, b, pp, ps)
    mark("imu")
    st, out = scan_step(st, b["scan_t"], b["scan_points"], b["scan_times"],
                        b["scan_valid"], tmap, pp, ps, mark=mark)
    es = ego_state(st.ekf)
    out["ego_pos"] = es["pos"]
    out["ego_rpy"] = es["rpy"]
    out["ego_t"] = es["timestamp"]
    P = st.ekf.P
    out["p_asym"] = torch.max(torch.abs(P - P.T))
    out["p_min_diag"] = torch.min(torch.diagonal(P))
    mark("ekf_update")
    return st, out


def replay_fused(state: PipelineState, batches, tmap, pp: PipelineParams,
                 ps: PipelineStatic, mark=_no_mark):
    """:func:`fused_frame` over every frame of a device batch dict; the
    per-frame outputs are stacked on the device."""
    outs = []
    for k in range(batches["scan_t"].shape[0]):
        state, out = fused_frame(state, {key: v[k] for key, v in batches.items()},
                                 tmap, pp, ps, mark=mark)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# --------------------------------------------------------------------------- #
# Host-side batch preparation (NumPy)
# --------------------------------------------------------------------------- #

def scan_arrival_times(log: ReplayLog) -> np.ndarray:
    """Delivery time of each scan = time of its last point (runtime.py:556)."""
    rel_last = np.where(log.scan_valid, log.scan_times, -np.inf).max(axis=1)
    return log.scan_t + np.maximum(rel_last.astype(np.float64), 0.0)


def build_fused_batches(log: ReplayLog, dtype=np.float32, time_base: float = 0.0):
    """Group a ReplayLog into per-scan-frame sub-batches with fixed budgets
    (NumPy copy of runtime.py:564-637). Timestamps are rebased by
    ``time_base`` in float64 before the ``dtype`` store."""
    ns = len(log.scan_t)
    arrival = scan_arrival_times(log)
    order = np.argsort(arrival, kind="stable")
    if not np.array_equal(order, np.arange(ns)):
        arrival = arrival[order]
        log = dataclasses.replace(
            log,
            scan_t=log.scan_t[order],
            scan_points=log.scan_points[order],
            scan_times=log.scan_times[order],
            scan_valid=log.scan_valid[order],
        )

    def bucket(ts, *arrays):
        idx = np.searchsorted(arrival, ts, side="left")
        keep = idx < ns
        fi = idx[keep]
        counts = np.bincount(fi, minlength=ns)
        cap = max(int(counts.max()), 1)
        starts = np.zeros(ns + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        k = np.arange(len(fi)) - starts[fi]
        t_b = np.zeros((ns, cap), dtype)
        v_b = np.zeros((ns, cap), bool)
        t_b[fi, k] = np.asarray(ts, np.float64)[keep] - time_base
        v_b[fi, k] = True
        arr_bs = []
        for a in arrays:
            a = np.asarray(a)
            ab = np.zeros((ns, cap) + a.shape[1:], dtype)
            ab[fi, k] = a[keep]
            arr_bs.append(ab)
        return [t_b, v_b] + arr_bs

    imu = bucket(log.imu_t, log.imu_acc, log.imu_gyro)
    batches = {
        "scan_t": np.asarray(log.scan_t - time_base, dtype),
        "scan_points": np.asarray(log.scan_points, dtype),
        "scan_times": np.asarray(log.scan_times, dtype),
        "scan_valid": np.asarray(log.scan_valid),
        "imu_t": imu[0],
        "imu_valid": imu[1],
        "imu_acc": imu[2],
        "imu_gyro": imu[3],
    }
    if log.can_t is not None:
        can = bucket(log.can_t, log.can_vel, log.can_yaw_rate)
        batches.update(can_t=can[0], can_valid=can[1], can_vel=can[2],
                       can_yaw=can[3])
    if log.gps_t is not None:
        gps = bucket(log.gps_t, log.gps_pos, log.gps_cov)
        batches.update(gps_t=gps[0], gps_valid=gps[1], gps_pos=gps[2],
                       gps_cov=gps[3])
    return batches


def batches_to_device(batches, device=None, dtype=torch.float32):
    """One host->device copy of a batch dict; float arrays take ``dtype``."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=dtype if np.issubdtype(v.dtype, np.floating)
                               else None)
            for k, v in batches.items()}


def autosize_budgets(log: ReplayLog, voxel_ds, tile_size, qb=32, headroom=0.15):
    """(ds_points, max_slots) sized from the log by a host pre-pass (a copy
    of bench.py:113-137): the densest scan's occupied downsample voxels, and
    its occupied query tiles plus the per-tile QB chunking, each with
    ``headroom``."""
    max_kept = 0
    max_slots = 0
    for k in range(len(log.scan_t)):
        p = log.scan_points[k][log.scan_valid[k]]
        vox = np.unique(np.floor(p / voxel_ds).astype(np.int64), axis=0)
        _, cnt = np.unique(
            np.floor(vox[:, :2] * voxel_ds / tile_size).astype(np.int64),
            axis=0, return_counts=True)
        max_kept = max(max_kept, len(vox))
        max_slots = max(max_slots, int(np.ceil(cnt / qb).sum()))

    def rup(x, m):
        return int(np.ceil(x / m) * m)

    return rup(max_kept * (1 + headroom), 512), rup(max_slots * (1 + headroom), 8)


# --------------------------------------------------------------------------- #
# Host-facing pipeline
# --------------------------------------------------------------------------- #

class LocalizationPipeline:
    """End-to-end localization over a prebuilt map on one device
    (runtime.py:644-1588, the full-map fused P2P path).

    Timestamps are rebased to ``time_base`` (set on the first event) in
    float64 on the host before any float32 store; returned trajectories are
    absolute again (``ego_t_abs``)."""

    def __init__(self, cfg: ElimalocConfig, map_points, *,
                 dtype=torch.float32, device=None, backend: str = "tile",
                 tile_budget=None, ds_points: int = 8192,
                 ego_ring_size: int = 1024, imu_ring_size: int = 512,
                 tile_voxels: int = 4, use_native: bool = True,
                 map_window_radius: Optional[float] = None,
                 halo_margin: Optional[int] = None):
        method = cfg.pcm.icp_method
        if method != IcpMethod.P2P:
            raise NotImplementedError(
                f"ICP method {IcpMethod(method).name}: only P2P is ported "
                "(ROADMAP Queue 1 #11)")
        if backend != "tile":
            raise NotImplementedError(
                f"backend={backend!r}: the hash backend is ROADMAP Queue 1 #13")
        if map_window_radius is not None:
            raise NotImplementedError(
                "map_window_radius: active-window maps are ROADMAP Queue 1 #14")
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        if isinstance(map_points, map_tiles.HostTileMap):
            host_tmap = map_points
        else:
            if isinstance(map_points, map_builder.BuiltMap):
                built = map_points
            else:
                built = map_builder.build_voxel_map(
                    map_points, cfg.pcm.pcm_voxel_size,
                    cfg.pcm.pcm_voxel_max_point, use_native=use_native)
            host_tmap = map_tiles.build_tile_map(
                built, tile_voxels=tile_voxels,
                halo_margin=1 if halo_margin is None else halo_margin)
        self.host_map = host_tmap
        self.map = host_tmap.to_device(self.device, dtype)
        reassign = False if host_tmap.halo_margin >= 2 else None
        self.params = make_pipeline_params(cfg, dtype=dtype, device=self.device)
        self.static = make_pipeline_static(
            cfg, backend=backend, tile_budget=tile_budget, ds_points=ds_points,
            reassign_each_iter=reassign)
        self._ego_ring_size = ego_ring_size
        self._imu_ring_size = imu_ring_size
        self.time_base = None

    def _rebase(self, t):
        if self.time_base is None:
            self.time_base = float(np.floor(np.min(np.asarray(t))))
        return np.asarray(t, np.float64) - self.time_base

    def reset(self) -> PipelineState:
        self.time_base = None
        return PipelineState(
            ekf=init_state(self.params.ekf, dtype=self.dtype),
            ego_ring=rings.make_ego_ring(self._ego_ring_size, self.dtype, self.device),
            imu_ring=rings.make_imu_ring(self._imu_ring_size, self.dtype, self.device),
        )

    def frame(self, state: PipelineState, b, mark=_no_mark):
        """:func:`fused_frame` for one frame's device batch dict."""
        return fused_frame(state, b, self.map, self.params, self.static, mark=mark)

    def run_fused(self, log: ReplayLog, state: Optional[PipelineState] = None,
                  mark=_no_mark):
        """Whole-log fused replay: batches built on the host, moved to the
        device once, frames run in order. Returns (state, outs) with outs as
        NumPy arrays stacked over frames plus ``ego_t_abs``."""
        state = state if state is not None else self.reset()
        self._rebase(min(log.imu_t[0], log.scan_t[0]))
        batches = batches_to_device(
            build_fused_batches(log, time_base=self.time_base), self.device,
            self.dtype)
        state, outs = replay_fused(state, batches, self.map, self.params,
                                   self.static, mark=mark)
        outs = {k: v.cpu().numpy() for k, v in outs.items()}
        outs["ego_t_abs"] = outs["ego_t"].astype(np.float64) + self.time_base
        return state, outs

