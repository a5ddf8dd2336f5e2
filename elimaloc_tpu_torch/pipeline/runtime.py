"""The localization runtime — port of ``elimaloc_tpu/pipeline/runtime.py``
(P2P, GICP, VGICP and AVGICP on the tile or the hash backend, with GPS and
CAN fusion).

One :class:`PipelineState` (EKF state + ego/IMU rings) runs through the
event steps: :func:`imu_step` (one IMU sample), :func:`gps_step`,
:func:`can_step`, :func:`scan_step` (the scan's front, kernel T: the
range gate, the scan times, the ring queries and the deskew -> voxel
downsample, kernel C -> ICP registration, kernels B, A/E/F/G and M (the
hash backend: Q and M) -> the scan's end, kernel S: the PCM measurement,
the EKF PCM update and the frame's published outputs) and
:func:`pcm_init_step` (a relocalization result). :func:`fused_frame` is
one LiDAR frame: :func:`imu_subbatch` (the frame's IMU samples into the
ego frame, through the EKF prediction, then one push into each ring: one
launch of kernel H), the frame's CAN and GPS samples when the
configuration fuses them (kernel W), then :func:`scan_step`. The EKF
state lives on the card as one packed record (``ekf.state``), which
kernels H, W, U and S take and give.

:class:`LocalizationPipeline` drives them three ways, as the JAX package
does: ``run`` (the per-event loop over a log in time order), ``run_frames``
(the online mode, one fused frame per scan, or ``chunk`` frames per consult
of the window ladder) and ``run_fused`` (the same frame loop, without the
per-frame config poll); batches come from the NumPy
:func:`build_fused_batches` and move to the device once per log. With
``map_window_radius`` only a window of the map is resident on the device
(active-window serving, runtime.py:839-1123): a prefetch worker crops the
next window from the host map on a side CUDA stream and moves it in place
with kernel N (``tiles.shift_window``) while frames run on the old one.

The functional replay runs the same frames on a batch dict with no
pipeline object (JAX runtime.py:494-543): :func:`replay_fused` (every
frame, the outputs stacked on the device), :func:`replay_fused_chunk`
(frames [k0, k0 + chunk), the frames past the log's end on its last
frame, their states dropped) and :func:`fused_frame_at` (one frame).

With ``use_imu=False`` the event loop runs the reference's tick mode: a
constant-acceleration prediction and its ego push per system-clock tick
(:func:`tick_step`, one launch of kernel U) while raw IMU only feeds the IMU
ring (:func:`imu_ring_step`, one launch of kernel V).

:meth:`LocalizationPipeline.run_fused_fleet` localizes B logs against the
one map in one frame loop (JAX runtime.py:1590-1649, the single-chip fleet
mode): the logs' batches padded to the fleet's capacities and stacked on a
lane axis (:func:`fleet_batches`, ``parallel.stack_streams``), then
``parallel.replay_fused_fleet``: :func:`replay_fused` over the lanes'
frames, :func:`fused_frame` with a lane axis, one call of each stage
serving every lane (on the card one launch each of the
lane forms of kernels H, C, B (tile backend), X (radar covariances), S, W
with CAN or GPS fusion, and the loop kernel (a launch per 128 lanes), T's
two launches once each). It runs every configuration JAX's fleet runs:
P2P, GICP, VGICP and AVGICP on the tile or the hash backend, with or
without radar covariances and CAN and GPS fusion, with ``use_imu`` True or
False (the fused frame runs the IMU chain either way, as JAX's vmapped
``fused_frame`` does), for any number of lanes; a windowed pipeline is
refused with JAX's ValueError.
"""

from __future__ import annotations

import dataclasses
import math
import operator
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import deskew as deskew_mod
from .. import kernels
from ..config import ConfigWatcher, ElimalocConfig, GnssSource, IcpMethod
from ..ekf import (
    EkfFlags,
    EkfParams,
    EkfState,
    GnssMeas,
    init_state,
    make_params,
    update_chain,
    update_gnss,
)
from ..ekf.filter import ego_history, imu_chain_plain, tick_stage_plain, update_chain_plain
from ..ekf.state import pack_state
from ..map import builder as map_builder
from ..map import grid as map_grid
from ..map import tiles as map_tiles
from ..map.grid import voxel_downsample
from ..ops import geo, lie
from ..ops.frames import imu_to_ego
from ..register.icp import (
    IcpParams,
    IcpStatic,
    check_supported,
    make_icp_params,
    make_icp_static,
    run_register,
)
from ..parallel import stack_streams
from ..struct import Struct, lane
from ..utils.observability import state_dashboard
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
    TPU-only ``sub_unroll``). ``use_imu`` and ``tick_hz`` are read by the
    event loop only: the frame loops run the IMU chain either way, as JAX's
    ``fused_frame`` does."""

    ekf_flags: EkfFlags
    icp_static: IcpStatic
    run_deskew: bool = True
    scan_time_end: bool = True
    bug_compat_deskew_z: bool = False
    ds_points: int = 8192
    use_gps: bool = False
    use_can: bool = False
    use_pcm: bool = True
    use_imu: bool = True
    tick_hz: float = 100.0  # CA-prediction rate when use_imu is off


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
        use_imu=cfg.ekf.use_imu,
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

    # row-major first: CPU matmul rounds a column-major block (a CPU
    # inverse's) differently, and a fleet lane's block (a view of the
    # stacked [B, 6, 6]) must round as its single stream's does
    local_cov = local_cov.contiguous()
    t_cov = rot_ego @ local_cov[:3, :3] @ rot_ego.T
    r_cov = local_cov[3:, 3:]
    # row-major, as kernel I reads them (an inverse on the card may come
    # back column-major, and elementwise results keep its strides)
    return ((normalize(t_cov) * std * std).contiguous(),
            (normalize(r_cov) * angle_std * angle_std).contiguous())


def pcm_measurement_plain(res, tf_lidar_to_ego, ego_ring, scan_end, usable,
                          use_pcm: bool):
    """Plain PyTorch version of kernel L (JAX runtime.py:341-358): the ICP
    pose in the ego frame, its covariance shaped by
    :func:`shape_icp_covariance`, latency-compensated against the ego ring
    (``rings.gnss_time_compensation``) into the PCM GnssMeas, and ``apply``
    = usable & ICP success & compensation ok & use_pcm. Returns (icp ego
    pose [4,4], meas, apply)."""
    icp_ego_pose = lie.compose(res.pose, tf_lidar_to_ego)
    rot_ego = icp_ego_pose[:3, :3]
    quat = lie.rot_to_quat(rot_ego)
    pos_cov, rot_cov = shape_icp_covariance(rot_ego, res.local_cov, res.fitness)
    ct, cpos, cquat, comp_ok = rings.gnss_time_compensation(
        ego_ring, scan_end, icp_ego_pose[:3, 3], quat)
    meas = GnssMeas(timestamp=ct, source=int(GnssSource.PCM), pos=cpos, rot=cquat,
                    pos_cov=pos_cov, rot_cov=rot_cov)
    apply = usable & res.success & comp_ok
    if not use_pcm:
        apply = torch.zeros_like(apply)
    return icp_ego_pose, meas, apply


def pcm_measurement(res, tf_lidar_to_ego, ego_ring, scan_end, usable, use_pcm: bool):
    """:func:`pcm_measurement_plain` for CPU tensors, kernel L for CUDA
    ones."""
    if scan_end.device.type == "cpu":
        return pcm_measurement_plain(res, tf_lidar_to_ego, ego_ring, scan_end, usable,
                                     use_pcm)
    pose, t, pos, quat, pos_cov, rot_cov, apply = kernels.pcm_measurement(
        res.pose, tf_lidar_to_ego, res.local_cov, res.fitness, res.success, usable,
        ego_ring, scan_end, use_pcm)
    return pose, GnssMeas(timestamp=t, source=int(GnssSource.PCM), pos=pos, rot=quat,
                          pos_cov=pos_cov, rot_cov=rot_cov), apply


def pcm_stage_plain(ekf: EkfState, res, tf_lidar_to_ego, ego_ring, scan_end, usable,
                    params: EkfParams, flags: EkfFlags, use_pcm: bool):
    """Plain PyTorch version of kernel S, the scan's end (JAX runtime.py:
    341-362 and fused_frame's epilogue :481-490): :func:`pcm_measurement_plain`,
    the PCM update (``ekf.filter.update_chain_plain``, masked by ``apply``),
    then the frame's published outputs from the updated filter. Returns
    (ekf', meas, published): ``published`` holds ``icp_pose`` and
    ``applied`` (scan_step's outputs) and ``ego_pos``, ``ego_rpy``,
    ``ego_t`` (:func:`ego_pose`), ``p_asym`` = max |P - P^T| and
    ``p_min_diag`` (fused_frame's)."""
    icp_ego_pose, meas, apply = pcm_measurement_plain(res, tf_lidar_to_ego, ego_ring,
                                                      scan_end, usable, use_pcm)
    ekf = update_chain_plain(ekf, params, flags, pcm=(meas, apply))
    es = ego_pose(ekf)
    P = ekf.P
    return ekf, meas, {"icp_pose": icp_ego_pose, "applied": apply, "ego_pos": es["pos"],
                       "ego_rpy": es["rpy"], "ego_t": es["timestamp"],
                       "p_asym": torch.max(torch.abs(P - P.T)),
                       "p_min_diag": torch.min(torch.diagonal(P))}


def pcm_stage_lanes_plain(ekf: EkfState, res, tf_lidar_to_ego, ego_ring, scan_end, usable,
                          params: EkfParams, flags: EkfFlags, use_pcm: bool):
    """Plain lane form of kernel S: :func:`pcm_stage_plain` on each lane of a
    fleet frame (``scan_end`` [B]; the state, the registration's result
    and the ego ring with a lane axis), stacked."""
    outs = [pcm_stage_plain(lane(ekf, i), lane(res, i), tf_lidar_to_ego, lane(ego_ring, i),
                            scan_end[i], usable[i], params, flags, use_pcm)
            for i in range(scan_end.shape[0])]
    return tuple(stack_streams(list(x)) for x in zip(*outs))


def _on_card(t) -> bool:
    """Whether the scan's front and end launch kernels T and S for ``t`` (any
    device but the CPU, where they run their plain versions)."""
    return t.device.type != "cpu"


def pcm_stage(ekf: EkfState, res, tf_lidar_to_ego, ego_ring, scan_end, usable,
              params: EkfParams, flags: EkfFlags, use_pcm: bool):
    """The scan's end: :func:`pcm_stage_plain` for CPU tensors, one launch of
    kernel S (``kernels.pcm_stage``) for CUDA ones; for a fleet frame
    (``scan_end`` [B]) :func:`pcm_stage_lanes_plain` or S's lane form."""
    if not _on_card(scan_end):
        plain = pcm_stage_lanes_plain if scan_end.dim() == 1 else pcm_stage_plain
        return plain(ekf, res, tf_lidar_to_ego, ego_ring, scan_end, usable, params, flags,
                     use_pcm)
    ekf, (pose, t, pos, quat, pos_cov, rot_cov, apply, ego_pos, ego_rpy, ego_t, p_asym,
          p_min_diag) = kernels.pcm_stage(
        ekf, params, flags, res.pose, tf_lidar_to_ego, res.local_cov, res.fitness,
        res.success, usable, ego_ring, scan_end, use_pcm)
    meas = GnssMeas(timestamp=t, source=int(GnssSource.PCM), pos=pos, rot=quat,
                    pos_cov=pos_cov, rot_cov=rot_cov)
    return ekf, meas, {"icp_pose": pose, "applied": apply, "ego_pos": ego_pos,
                       "ego_rpy": ego_rpy, "ego_t": ego_t, "p_asym": p_asym,
                       "p_min_diag": p_min_diag}


@dataclasses.dataclass
class ScanFront(Struct):
    """The scan's front (JAX runtime.py:299-338): the gated point mask, the
    points in the scan-end frame, the scan's times, the ICP initial guess,
    ``found`` (the pose sync), ``usable``, ``deskew_ok`` (the deskew info's
    availability) and the deskew info itself."""

    valid: torch.Tensor       # [N] bool, after the range gate
    points: torch.Tensor      # [N,3] deskewed (the input without run_deskew)
    scan_cur: torch.Tensor
    scan_end: torch.Tensor
    init_guess: torch.Tensor  # [4,4]
    found: torch.Tensor
    usable: torch.Tensor
    deskew_ok: torch.Tensor
    info: deskew_mod.DeskewInfo


def scan_front_plain(state: PipelineState, stamp, points, rel_raw, valid,
                     pp: PipelineParams, ps: PipelineStatic) -> ScanFront:
    """Plain PyTorch version of kernel T, the scan's front (JAX runtime.py:
    299-338): ``stamp - lidar_time_delay``, the range gate
    (FilterPointsByDistance, cpp:451-465), ``deskew.normalize_scan_times``,
    ``deskew.scan_ring_query_plain`` (kernel K's plain version) and, with
    ``run_deskew``, ``deskew.deskew_points_plain`` (kernel D's)."""
    stamp = stamp - pp.lidar_time_delay
    valid = valid & (lie.norm(points) <= pp.input_max_dist)
    rel, scan_cur, scan_end = deskew_mod.normalize_scan_times(
        rel_raw, valid, stamp, ps.scan_time_end)
    info, init_guess, found, usable = deskew_mod.scan_ring_query_plain(
        state.imu_ring, state.ego_ring, scan_cur, scan_end, pp.tf_ego_to_lidar,
        run_deskew=ps.run_deskew)
    ok = info.imu_available & info.odom_available
    if ps.run_deskew:
        points = deskew_mod.deskew_points_plain(points, rel, valid, info,
                                                ps.bug_compat_deskew_z)
    return ScanFront(valid=valid, points=points, scan_cur=scan_cur, scan_end=scan_end,
                     init_guess=init_guess, found=found, usable=usable, deskew_ok=ok,
                     info=info)


def scan_front_lanes_plain(state: PipelineState, stamp, points, rel_raw, valid,
                           pp: PipelineParams, ps: PipelineStatic) -> ScanFront:
    """Plain lane form of kernel T: :func:`scan_front_plain` on each lane of
    a fleet frame (``stamp`` [B], points [B, N, 3], the state with a lane
    axis), stacked."""
    return stack_streams([scan_front_plain(lane(state, i), stamp[i], points[i], rel_raw[i],
                                           valid[i], pp, ps) for i in range(points.shape[0])])


def scan_front(state: PipelineState, stamp, points, rel_raw, valid, pp: PipelineParams,
               ps: PipelineStatic) -> ScanFront:
    """The scan's front: :func:`scan_front_plain` for CPU tensors, one call of
    kernel T (``kernels.scan_front``: two launches) for CUDA ones; for a
    fleet frame (points [B, N, 3]) :func:`scan_front_lanes_plain` or T's
    lane form."""
    if not _on_card(points):
        plain = scan_front_lanes_plain if points.dim() == 3 else scan_front_plain
        return plain(state, stamp, points, rel_raw, valid, pp, ps)
    (valid, pts, cur, end, guess, found, usable, ok, imu_time, imu_rot, included, first_idx,
     last_idx, incre, imu_ok, odom_ok, covers) = kernels.scan_front(
        points, rel_raw, valid, stamp, pp.lidar_time_delay, pp.input_max_dist,
        state.imu_ring, state.ego_ring, pp.tf_ego_to_lidar, ps.scan_time_end,
        ps.run_deskew, ps.bug_compat_deskew_z)
    info = deskew_mod.DeskewInfo(
        imu_time=imu_time, imu_rot=imu_rot, imu_included=included, first_idx=first_idx,
        last_idx=last_idx, odom_incre=incre, scan_cur=cur, scan_end=end,
        imu_available=imu_ok, odom_available=odom_ok, imu_covers_start=covers)
    return ScanFront(valid=valid, points=pts, scan_cur=cur, scan_end=end, init_guess=guess,
                     found=found, usable=usable, deskew_ok=ok, info=info)


#: the frame's outputs that fused_frame adds to scan_step's (JAX
#: runtime.py:481-490), in its order
PUBLISHED = ("ego_pos", "ego_rpy", "ego_t", "p_asym", "p_min_diag")


def _no_mark(name):
    return None


def scan_step(state: PipelineState, stamp, points, rel_raw, valid, tmap,
              pp: PipelineParams, ps: PipelineStatic, mark=_no_mark, published=None):
    """One LiDAR frame through the matching pipeline (runtime.py:299-382).
    Returns (state', out dict), ``out`` with JAX's keys. ``mark(name)`` is
    called at the stage boundaries "front", "downsample", "assign", "gn" and
    "pcm_stage" (for timing). The scan's front (the delayed stamp, the range
    gate, the scan times, the ring queries and the deskew) is
    :func:`scan_front`, kernel T on the card; the scan's end (the PCM
    measurement, the PCM update and the frame's published outputs) is
    :func:`pcm_stage`, kernel S; a ``published`` dict receives the outputs
    of it that ``out`` does not hold (:data:`PUBLISHED`: the filter's pose
    after the update, P's asymmetry and smallest diagonal)."""
    front = scan_front(state, stamp, points, rel_raw, valid, pp, ps)
    mark("front")

    ds_pts, ds_valid, ds_kept = voxel_downsample(
        front.points, front.valid, pp.input_voxel_ds, ps.ds_points)
    mark("downsample")

    res = run_register(ds_pts, ds_valid, tmap, front.init_guess, pp.icp,
                       ps.icp_static, mark=mark)

    ekf, _, pub = pcm_stage(state.ekf, res, pp.tf_lidar_to_ego, state.ego_ring,
                            front.scan_end, front.usable, pp.ekf, ps.ekf_flags, ps.use_pcm)
    mark("pcm_stage")
    new_state = state.replace(ekf=ekf)
    if published is not None:
        published.update((k, pub[k]) for k in PUBLISHED)

    out = {
        "scan_end": front.scan_end,
        "icp_pose": pub["icp_pose"],
        "applied": pub["applied"],
        "icp_success": res.success,
        "deskew_ok": front.deskew_ok,
        "pose_sync_ok": front.found,
        "deskew_full_cover": front.info.imu_covers_start,
        "fitness": res.fitness,
        "overlap": res.overlap,
        "iterations": res.iterations,
        "slots_dropped": res.dropped,
        "ds_kept": ds_kept,
    }
    return new_state, out


def pcm_init_step(state: PipelineState, t, pose, pp: PipelineParams,
                  ps: PipelineStatic) -> PipelineState:
    """Feed a relocalization result into the EKF (runtime.py:385-398;
    CallbackPcmInitOdom, ekf_localization.cpp:181-204: covariance 1e-9,
    source PCM_INIT). The PCM_INIT branch of ``update_gnss`` is a hard reset
    of the state, no Kalman update, once per relocalization: it runs as
    plain torch on either device (kernel I takes only the PCM source), and
    the reset state is packed into a fresh record for the EKF kernels."""
    dtype, dev = pose.dtype, pose.device
    eye = torch.eye(3, dtype=dtype, device=dev) * 1e-9
    meas = GnssMeas(timestamp=t, source=int(GnssSource.PCM_INIT), pos=pose[:3, 3],
                    rot=lie.rot_to_quat(pose[:3, :3]), pos_cov=eye, rot_cov=eye)
    return state.replace(ekf=pack_state(update_gnss(state.ekf, meas, pp.ekf, ps.ekf_flags)))


def _one(*xs):
    """One sample as a sub-batch of one, valid (a ``valid`` of None)."""
    return tuple(x[None] for x in xs) + (None,)


def gps_step(state: PipelineState, t, pos, cov_diag, pp: PipelineParams,
             ps: PipelineStatic) -> PipelineState:
    """GPS fix update (runtime.py:205-234): the configured gps_type picks the
    source, NAVSATFIX / BESTPOS 3-DOF and ODOMETRY the NOVATEL 6-DOF path;
    see ``ekf.filter.update_gps``. A GPS sub-batch of one through
    ``update_chain`` (kernel W on the card)."""
    if not ps.use_gps:
        return state
    return state.replace(ekf=update_chain(state.ekf, pp.ekf, ps.ekf_flags,
                                          gps=_one(t, pos, cov_diag),
                                          gnss_uncertainty_max=pp.gnss_uncertainty_max))


def can_step(state: PipelineState, t, vel_x, yaw_rate, pp: PipelineParams,
             ps: PipelineStatic) -> PipelineState:
    """CAN wheel-speed update (runtime.py:260-272): a CAN sub-batch of one
    through ``update_chain`` (kernel W on the card)."""
    if not ps.use_can:
        return state
    return state.replace(ekf=update_chain(state.ekf, pp.ekf, ps.ekf_flags,
                                          can=_one(t, vel_x, yaw_rate)))


def imu_subbatch_plain(st: PipelineState, b, pp: PipelineParams,
                       ps: PipelineStatic) -> PipelineState:
    """Plain PyTorch version of kernel H (runtime.py:405-441): the frame's
    IMU samples into the ego frame (``frames.imu_to_ego``; PCM's intake
    rotated only), through ``ekf.filter.imu_chain_plain`` + ``ego_history``,
    then one batch push into each ring (``rings.push_rings_plain``).
    ``b["imu_valid"]`` None: every sample valid."""
    ts, accs, gyros, valids = b["imu_t"], b["imu_acc"], b["imu_gyro"], b["imu_valid"]
    if valids is None:
        valids = torch.ones(ts.shape[0], dtype=torch.bool, device=ts.device)
    acc_e, gyro_e = imu_to_ego(accs, gyros, pp.ego_to_imu_rot, pp.ego_to_imu_trans)
    # PCM's IMU intake rotates but does not lever-arm compensate (cpp:328)
    gyro_pcm = gyros @ pp.ego_to_imu_rot.T
    acc_pcm = accs @ pp.ego_to_imu_rot.T
    ekf, hist = imu_chain_plain(st.ekf, ts, acc_e, gyro_e, valids, pp.ekf, ps.ekf_flags)
    ego_ring, imu_ring = rings.push_rings_plain(st.ego_ring, st.imu_ring, ego_history(*hist),
                                                (ts, gyro_pcm, acc_pcm), valids)
    return st.replace(ekf=ekf, ego_ring=ego_ring, imu_ring=imu_ring)


_IMU_KEYS = ("imu_t", "imu_acc", "imu_gyro", "imu_valid")


def imu_subbatch_lanes_plain(st: PipelineState, b, pp: PipelineParams,
                             ps: PipelineStatic) -> PipelineState:
    """Plain lane form of kernel H: :func:`imu_subbatch_plain` on each lane of
    a fleet frame (``b["imu_t"]`` [B, n], the state with a lane axis),
    stacked."""
    return stack_streams([imu_subbatch_plain(lane(st, i), {k: None if b[k] is None else b[k][i]
                                                           for k in _IMU_KEYS}, pp, ps)
                          for i in range(b["imu_t"].shape[0])])


def _imu_stage(st: PipelineState, b, pp: PipelineParams, ps: PipelineStatic) -> PipelineState:
    """:func:`imu_subbatch_plain` for CPU tensors, one launch of kernel H
    (``kernels.imu_stage``) for CUDA ones; for a fleet frame (``imu_t``
    [B, n]) :func:`imu_subbatch_lanes_plain` or H's lane form."""
    if b["imu_t"].device.type == "cpu":
        plain = imu_subbatch_lanes_plain if b["imu_t"].dim() == 2 else imu_subbatch_plain
        return plain(st, b, pp, ps)
    ekf, ego_ring, imu_ring = kernels.imu_stage(
        st.ekf, st.ego_ring, st.imu_ring, b["imu_t"], b["imu_acc"], b["imu_gyro"],
        b["imu_valid"], pp.ego_to_imu_rot, pp.ego_to_imu_trans, pp.ekf, ps.ekf_flags)
    return st.replace(ekf=ekf, ego_ring=ego_ring, imu_ring=imu_ring)


def imu_chunks(n: int, caps=()) -> list:
    """The [start, end) ranges a frame of ``n`` IMU samples runs in, in
    order: cut from the end at most ``kernels.IMU_STAGE_MAX_SAMPLES`` apart,
    and at n - C for each ring capacity C in ``caps`` between that and n.
    A batch push of n rows into a ring of C < n keeps only rows n - C..n-1
    (rings._push_arrays_batch, as JAX's): so the last range, and any range
    past n - C, brings the ring exactly those rows."""
    cut = kernels.IMU_STAGE_MAX_SAMPLES
    bounds = sorted({0, n} | {n - c for c in caps if cut < c < n})
    chunks = []
    for s, e in zip(bounds, bounds[1:]):
        chunks += [(max(s, k - cut), k) for k in range(e, s, -cut)]
    return sorted(chunks)


def imu_subbatch(st: PipelineState, b, pp: PipelineParams,
                 ps: PipelineStatic) -> PipelineState:
    """The frame's IMU stage (runtime.py:405-441): :func:`imu_subbatch_plain`
    for CPU tensors, kernel H (``kernels.imu_stage``) for CUDA ones, one call
    a range of :func:`imu_chunks` (one launch for a frame of at most
    ``kernels.IMU_STAGE_MAX_SAMPLES`` samples). Each range takes the EKF
    state the one before gave; a ring takes a range's output only from the
    ranges its batch push would keep, so the split frame's rings are the
    unsplit push's (``build_fused_batches`` pads every frame to the largest
    frame's count, which a long IMU lead before the first scan makes
    large). A fleet frame (``imu_t`` [B, n], padded to the fleet's count)
    splits every lane at the same ranges."""
    n = b["imu_t"].shape[-1]
    chunks = imu_chunks(n, [r.capacity for r in (st.ego_ring, st.imu_ring) if r is not None])
    if len(chunks) <= 1:
        return _imu_stage(st, b, pp, ps)
    axis = b["imu_t"].dim() - 1  # the sample axis: 1 for a fleet frame
    for s, e in chunks:
        part = {k: None if b[k] is None else b[k].narrow(axis, s, e - s).contiguous()
                for k in _IMU_KEYS}
        out = _imu_stage(st, part, pp, ps)
        ego, imu = (new if old is None or e > n - old.capacity else old
                    for old, new in zip((st.ego_ring, st.imu_ring), (out.ego_ring, out.imu_ring)))
        st = st.replace(ekf=out.ekf, ego_ring=ego, imu_ring=imu)
    return st


def imu_step(state: PipelineState, t, acc_raw, gyro_raw, pp: PipelineParams,
             ps: PipelineStatic) -> PipelineState:
    """IMU sample -> EKF prediction -> published state into the rings
    (runtime.py:187-202): :func:`imu_subbatch` on a budget of one valid
    sample (one launch of kernel H on the card). The one-sample push of the
    JAX step (rings.py:75, with its clear on a time regression, dedupe and
    roll when full) is the batch push of one row."""
    return imu_subbatch(state, {"imu_t": t.reshape(1), "imu_acc": acc_raw[None],
                                "imu_gyro": gyro_raw[None], "imu_valid": None}, pp, ps)


def imu_ring_step(state: PipelineState, t, acc_raw, gyro_raw, pp: PipelineParams,
                  ps: PipelineStatic) -> PipelineState:
    """PCM-side IMU intake only, no EKF prediction (runtime.py:237-246): with
    use_imu off the matching node still consumes IMU for deskewing
    (pcm_matching.cpp:39, 326-336). The sample rotated into the ego frame
    without lever-arm compensation, as :func:`imu_subbatch` does, then a
    push of one row into the IMU ring alone: ``rings.imu_intake_plain`` for
    CPU tensors, one launch of kernel V (``kernels.imu_intake``) for CUDA
    ones."""
    if t.device.type == "cpu":
        imu_ring = rings.imu_intake_plain(state.imu_ring, t, acc_raw, gyro_raw,
                                          pp.ego_to_imu_rot)
    else:
        imu_ring = kernels.imu_intake(state.imu_ring, t, acc_raw, gyro_raw, pp.ego_to_imu_rot)
    return state.replace(imu_ring=imu_ring)


def tick_step(state: PipelineState, t, pp: PipelineParams,
              ps: PipelineStatic) -> PipelineState:
    """System-clock CA prediction tick of use_imu=False (runtime.py:249-257;
    the reference's 100 Hz MainLoop -> RunPrediction, ekf_localization.cpp:
    206-216, 660-676): the CA ``predict``, then its ego state pushed into
    the ego ring alone (``_push_ego``, runtime.py:172-179):
    ``ekf.filter.tick_stage_plain`` for CPU tensors, one launch of kernel U
    (``kernels.tick_stage``) for CUDA ones."""
    if t.device.type == "cpu":
        ekf, ego_ring = tick_stage_plain(state.ekf, state.ego_ring, t, pp.ekf)
    else:
        ekf, ego_ring = kernels.tick_stage(state.ekf, t, pp.ekf, state.ego_ring)
    return state.replace(ekf=ekf, ego_ring=ego_ring)


def ego_pose(ekf: EkfState):
    """The published pose of the filter: (timestamp, pos, rpy), the part of
    ``ekf.ego_state`` the run loops output (the rest of ego_state, eight more
    conversions, would run eagerly here for nothing)."""
    return {"timestamp": ekf.prev_timestamp, "pos": ekf.pos,
            "rpy": lie.rot_to_euler(lie.quat_to_rot(ekf.rot))}


def fused_frame(st: PipelineState, b, tmap, pp: PipelineParams,
                ps: PipelineStatic, mark=_no_mark):
    """One scan frame: the IMU sub-batch, the CAN then the GPS sub-batch
    (each sample masked by validity), then the scan (runtime.py:444-491),
    whose end (kernel S on the card) also gives the frame's published
    outputs. ``mark(name)`` gets "imu" after the IMU chain and the ring
    pushes, "can_gps" after the CAN / GPS updates, the scan_step marks, and
    "outputs" at the end of the frame. A fleet frame (``parallel.
    replay_fused_fleet``) is the same call with a leading lane axis on the
    state and every batch entry: each stage then runs its lane form once
    for all lanes."""
    st = imu_subbatch(st, b, pp, ps)
    mark("imu")
    if ps.use_can or ps.use_gps:
        can = gps = None
        if ps.use_can:
            can = (b["can_t"], b["can_vel"], b["can_yaw"], b["can_valid"])
        if ps.use_gps:
            gps = (b["gps_t"], b["gps_pos"], b["gps_cov"], b["gps_valid"])
        st = st.replace(ekf=update_chain(
            st.ekf, pp.ekf, ps.ekf_flags, can=can, gps=gps,
            gnss_uncertainty_max=pp.gnss_uncertainty_max))
    mark("can_gps")
    pub = {}
    st, out = scan_step(st, b["scan_t"], b["scan_points"], b["scan_times"],
                        b["scan_valid"], tmap, pp, ps, mark=mark, published=pub)
    out.update(pub)
    mark("outputs")
    return st, out


# --------------------------------------------------------------------------- #
# The functional whole-log replay (JAX runtime.py:494-543)
# --------------------------------------------------------------------------- #

def _device_batches(batches, pp: PipelineParams):
    """``batches`` on ``pp``'s device: NumPy arrays moved once
    (:func:`batches_to_device`, float arrays in ``pp``'s dtype), tensors
    used as they are."""
    host = {k: v for k, v in batches.items() if not isinstance(v, torch.Tensor)}
    if not host:
        return batches
    moved = batches_to_device(host, pp.tf_ego_to_lidar.device, pp.tf_ego_to_lidar.dtype)
    return {k: moved.get(k, v) for k, v in batches.items()}


def fused_frame_at(state: PipelineState, batches, k, tmap, pp: PipelineParams,
                   ps: PipelineStatic, mark=_no_mark):
    """:func:`fused_frame` on frame ``k`` of a whole-log batch dict (JAX
    runtime.py:494-501), each entry's row ``k`` a view. ``batches``: a
    :func:`build_fused_batches` dict of NumPy arrays (moved to ``pp``'s
    device and dtype first) or of tensors (used as they are). A ``k``
    outside [0, n) raises IndexError, where JAX's traced index is clamped."""
    k = operator.index(k)
    batches = _device_batches(batches, pp)
    n = batches["scan_t"].shape[0]
    if not 0 <= k < n:
        raise IndexError(f"frame {k} is outside the log's {n} frames")
    return fused_frame(state, {key: v[k] for key, v in batches.items()}, tmap, pp, ps,
                       mark=mark)


def replay_fused(state: PipelineState, batches, tmap, pp: PipelineParams,
                 ps: PipelineStatic, mark=_no_mark):
    """One :func:`fused_frame` per frame of a whole-log batch dict, in order
    (JAX runtime.py:504-512, its ``lax.scan``). ``batches`` as in
    :func:`fused_frame_at`. Returns ``(state, outs)``, ``outs`` a dict of
    ``fused_frame``'s keys, each stacked on the device to [F, ...]: no
    readback and no ``ego_t_abs`` (``LocalizationPipeline.run_fused`` adds
    them). It is :func:`replay_fused_chunk` over all n frames."""
    return replay_fused_chunk(state, batches, 0, tmap, pp, ps, batches["scan_t"].shape[0],
                              mark=mark)


def replay_fused_chunk(state: PipelineState, batches, k0, tmap, pp: PipelineParams,
                       ps: PipelineStatic, chunk, mark=_no_mark):
    """One :func:`fused_frame` per frame of [k0, k0 + chunk) of a whole-log
    batch dict, in order, the outputs stacked on the device to [chunk, ...]
    (JAX runtime.py:515-543, the dispatch unit of JAX's chunked windowed
    ``run_frames``). ``k0`` and ``chunk`` are host ints; ``chunk``
    < 1 raises ValueError. ``batches`` as in :func:`fused_frame_at`: a
    caller that runs many chunks moves them to the device once first.

    The ragged tail, as JAX's: a frame ``k`` >= n runs on frame n - 1's
    inputs from the carried state, and its output row is kept ([chunk, ...]
    rows always), but its state is dropped (the choice is made on the host,
    as k and n are host ints). Every stage returns fresh tensors, so a
    dropped frame leaves the carried state as it was. ``mark`` as in
    :func:`fused_frame`."""
    k0, chunk = operator.index(k0), operator.index(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    batches = _device_batches(batches, pp)
    n = batches["scan_t"].shape[0]
    outs = []
    for k in range(k0, k0 + chunk):
        st, out = fused_frame(state, {key: v[min(k, n - 1)] for key, v in batches.items()},
                              tmap, pp, ps, mark=mark)
        if k < n:
            state = st
        outs.append(out)
    return state, {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


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


def fleet_batches(logs):
    """The fleet's batches (JAX runtime.py:1614-1640): each log's
    :func:`build_fused_batches` on its own time base floor(min(imu_t[0],
    scan_t[0])), every per-frame capacity axis padded to the fleet's largest
    with zero rows (``valid`` False, which every consumer masks), stacked
    on a leading lane axis (``parallel.stack_streams``). Returns (the bases
    [B] in float64, the batch dict of [B, F, ...] arrays). ValueError, as
    JAX's, for logs of different scan counts or sensor streams."""
    ns = {len(log.scan_t) for log in logs}
    if len(ns) != 1:
        raise ValueError(f"fleet logs must share a scan count, got {sorted(ns)}")
    bases, batch_list = [], []
    for log in logs:
        tb = float(np.floor(min(log.imu_t[0], log.scan_t[0])))
        bases.append(tb)
        batch_list.append(build_fused_batches(log, time_base=tb))
    keys = set(batch_list[0])
    if any(set(b) != keys for b in batch_list[1:]):
        raise ValueError("fleet logs must share sensor streams (can/gps)")
    for k in keys:
        shapes = [b[k].shape for b in batch_list]
        mx = tuple(max(sh[d] for sh in shapes) for d in range(len(shapes[0])))
        for b in batch_list:
            if b[k].shape != mx:
                b[k] = np.pad(b[k], [(0, m - n) for n, m in zip(b[k].shape, mx)])
    return np.asarray(bases, np.float64), stack_streams(batch_list)


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
# Active-window serving: host helpers
# --------------------------------------------------------------------------- #

# Active-window incremental shifts (tiles.shift_window, runtime.py:537-543):
# the largest per-axis tile shift served incrementally (bigger jumps, a
# relocalization, take a full crop), and the window-local coordinate drift
# at which a full crop re-centres the origin (f32 ulp at 2 km is ~1e-4 m,
# two orders below the voxel scale).
_MAX_INCR_SHIFT = 3
_INCR_DRIFT_LIMIT_M = 2048.0


class _HostFetch:
    """A device->host copy in flight (runtime.py:546-553, the stale-by-one
    window poses): ``non_blocking`` into pinned memory with an event after
    it, so queuing it does not wait; ``landed()`` queries the event,
    ``value()`` waits for it. A CPU tensor is copied at once."""

    def __init__(self, t):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.clone()

    def landed(self) -> bool:
        return self.event is None or self.event.query()

    def value(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class _Window:
    """A window ready to adopt: the device map, its centre (m), its tile
    anchor and its coordinate origin's anchor, the seconds its host crop
    took, and on the card the event after its upload (and shift) on the
    stream that made it, with the pinned staging buffers the upload reads."""

    map: map_tiles.TileMap
    center: np.ndarray
    anchor: tuple
    origin_anchor: tuple
    host_s: float
    event: Optional[torch.cuda.Event] = None
    staging: list = dataclasses.field(default_factory=list)


def _fit_motion(ppos, f0):
    """(frame of the last observed pose, its xy, per-frame velocity,
    per-frame acceleration) from a chunk's poses starting at frame ``f0``
    (runtime.py:1457-1466)."""
    xy = np.asarray(ppos, np.float64)[:, :2]
    f_last = f0 + len(xy) - 1
    if len(xy) >= 3:
        d = xy[1:] - xy[:-1]
        return f_last, xy[-1], d[-1], (d[-1] - d[0]) / max(len(d) - 1, 1)
    if len(xy) == 2:
        return f_last, xy[-1], xy[-1] - xy[0], np.zeros(2)
    return f_last, xy[-1], np.zeros(2), np.zeros(2)


def _predict(motion, f):
    """The motion model's xy at frame ``f`` (runtime.py:1468-1471)."""
    f_last, xy, d, a = motion
    k = max(f - f_last, 0)
    return xy + k * d + a * (k * (k + 1)) / 2.0


# --------------------------------------------------------------------------- #
# Host-facing pipeline
# --------------------------------------------------------------------------- #

class LocalizationPipeline:
    """End-to-end localization over a prebuilt map on one device
    (runtime.py:644-1588, every ICP method): the event loop :meth:`run`, the
    online frame loop :meth:`run_frames`, the whole-log :meth:`run_fused`,
    relocalization (:meth:`initialize_at`), config hot reload
    (:meth:`reload_config`, :meth:`watch_config`) and the geodetic
    projection (:meth:`project_gps`, :meth:`unproject`).

    ``map_points`` is a raw [N,3] cloud (built here with the covariances the
    method needs: per-voxel for VGICP/AVGICP, per-point for GICP,
    runtime.py:696-704), a ``BuiltMap`` or a packed ``HostTileMap``, used as
    they are. ``halo_margin`` defaults to 2 for AVGICP and 1 otherwise
    (runtime.py:728-731): the wider halo keeps the hoisted slot assignment
    exact for AVGICP's 7-voxel sums.

    ``backend="hash"`` (runtime.py:751-753) registers on the hash grid
    (``map.grid.MapGrid``, built from the BuiltMap; kernel Q on the card)
    instead of the packed tile map; it takes a raw cloud or a BuiltMap
    and no window (ValueError otherwise, as in JAX).

    ``map_window_radius`` (m) turns on active-window serving for maps too
    large for the device, typically a disk-backed ``HostTileMap`` from
    ``map.tiles.load_tile_map(dir, mmap=True)``: only the
    (2r+1) x (2r+1)-tile window around the vehicle is resident, re-cropped
    with hysteresis as the pose nears its edge. With ``map_window_prefetch``
    (default) the next window is cropped and uploaded by a worker thread on
    a side CUDA stream while frames run on the current one; small moves go
    through kernel N (``tiles.shift_window``). ``window_stats`` counts the
    swaps, how each was served and the seconds of crop, upload and stall.

    ``device`` is the card unless the caller asks for another: CUDA tensors
    run the hand-written kernels, ``device="cpu"`` their plain versions.

    Timestamps are rebased to ``time_base`` (set on the first event) in
    float64 on the host before any float32 store; returned trajectories are
    absolute again (``ego_t_abs``)."""

    def __init__(self, cfg: ElimalocConfig, map_points, *,
                 dtype=torch.float32, device="cuda", backend: str = "tile",
                 tile_budget=None, ds_points: int = 8192,
                 ego_ring_size: int = 1024, imu_ring_size: int = 512,
                 tile_voxels: int = 4, use_native: bool = True,
                 map_window_radius: Optional[float] = None,
                 map_window_prefetch: bool = True,
                 halo_margin: Optional[int] = None):
        method = cfg.pcm.icp_method
        prebuilt = isinstance(map_points, map_tiles.HostTileMap)
        hashed = backend == "hash"
        if hashed and prebuilt:
            raise ValueError("a HostTileMap input requires the tile backend")
        if hashed and map_window_radius is not None:
            raise ValueError("map_window_radius requires the tile backend")
        if halo_margin is None:
            halo_margin = 2 if method == IcpMethod.AVGICP else 1
        if prebuilt:
            halo_margin = map_points.halo_margin
        # a property of the MAP, kept across hot reloads: with a margin >= 2
        # halo the hoisted assignment is exact for every method
        # (runtime.py:735-736); the hash backend keeps make_icp_static's
        # default, which it does not read
        self._reassign_override = False if halo_margin >= 2 and not hashed else None
        self.static = make_pipeline_static(
            cfg, backend=backend, tile_budget=tile_budget, ds_points=ds_points,
            reassign_each_iter=self._reassign_override)
        check_supported(self.static.icp_static)
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        # kept for relocalization's ground-height probe (runtime.py:691-700);
        # a packed HostTileMap has no BuiltMap and probes its own halo rows
        self.built = None
        self._config_watcher = None
        self._last_dashboard_t = None
        host_tmap = None
        if prebuilt:
            host_tmap = map_points
        else:
            if isinstance(map_points, map_builder.BuiltMap):
                built = map_points
            else:
                built = map_builder.build_voxel_map(
                    map_points, cfg.pcm.pcm_voxel_size,
                    cfg.pcm.pcm_voxel_max_point,
                    compute_voxel_cov=method in (IcpMethod.VGICP, IcpMethod.AVGICP),
                    compute_point_cov=method == IcpMethod.GICP,
                    gicp_cov_search_dist=cfg.pcm.gicp_cov_search_dist,
                    use_native=use_native)
            if not hashed:
                host_tmap = map_tiles.build_tile_map(
                    built, tile_voxels=tile_voxels, halo_margin=halo_margin)
            self.built = built
        point_cov = self.built.point_cov if hashed else host_tmap.halo_point_cov
        vox_cov = self.built.vox_cov if hashed else host_tmap.halo_vox_cov
        if method == IcpMethod.GICP and point_cov is None:
            raise ValueError(
                "GICP needs per-point covariances: build the map with "
                "build_voxel_map(..., compute_point_cov=True)")
        if method in (IcpMethod.VGICP, IcpMethod.AVGICP) and np.all(
                vox_cov == np.eye(3, dtype=np.float32)):
            raise ValueError(
                f"{IcpMethod(method).name} needs per-voxel covariances and every "
                "voxel covariance of this map is the identity: build it with "
                "build_voxel_map(..., compute_voxel_cov=True)")
        self.host_map = host_tmap
        self.params = make_pipeline_params(cfg, dtype=dtype, device=self.device)
        self._ego_ring_size = ego_ring_size
        self._imu_ring_size = imu_ring_size
        self.time_base = None

        # active-window state (runtime.py:705-746)
        self.map_window_radius = map_window_radius
        self._window_prefetch = map_window_prefetch
        self._window_center = None
        self._window_offset_tiles = None
        self._window_origin_anchor = None
        self._prefetch = None    # the prefetch the ladder may adopt
        self.window_stats = {
            "swaps": 0, "prefetch_hits": 0, "prefetch_joins": 0,
            "sync_swaps": 0, "incr_crops": 0,
            # host crop seconds and upload seconds (wherever they run, the
            # worker included), and the seconds the FRAME LOOP stalled on a
            # swap (joins + sync swaps): the only part on the critical path
            "crop_s": 0.0, "h2d_s": 0.0, "swap_wait_s": 0.0,
        }
        if map_window_radius is not None:
            self._workers = []   # every prefetch whose worker may still fail
            # the frame loop and the prefetch workers (two may overlap) add
            # to the same counters
            self._stats_lock = threading.Lock()
            # the prefetch worker's stream: its uploads and kernel N overlap
            # the frames on the main stream
            self._side = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                          else None)
            self._window_tiles = max(int(np.ceil(map_window_radius / host_tmap.tile_size)), 2)
            # the first window around the configured initial pose
            self._set_window(np.array([cfg.ekf.ekf_init_x_m, cfg.ekf.ekf_init_y_m]))
        elif hashed:
            self.map = map_grid.to_device(self.built, self.device, dtype)
        else:
            self.map = host_tmap.to_device(self.device, dtype)

    @property
    def windowed(self) -> bool:
        return self.map_window_radius is not None

    def _rebase(self, t):
        if self.time_base is None:
            self.time_base = float(np.floor(np.min(np.asarray(t))))
        return np.asarray(t, np.float64) - self.time_base

    def _tensor(self, a):
        """Host array -> device tensor; float arrays take the pipeline's dtype."""
        a = np.asarray(a)
        return torch.as_tensor(a, device=self.device,
                               dtype=self.dtype if a.dtype.kind == "f" else None)

    def reset(self) -> PipelineState:
        self.time_base = None
        return PipelineState(
            ekf=init_state(self.params.ekf, dtype=self.dtype),
            ego_ring=rings.make_ego_ring(self._ego_ring_size, self.dtype, self.device),
            imu_ring=rings.make_imu_ring(self._imu_ring_size, self.dtype, self.device),
        )

    def imu_step(self, state: PipelineState, t, acc_raw, gyro_raw) -> PipelineState:
        """:func:`imu_step` with this pipeline's parameters (device tensors)."""
        return imu_step(state, t, acc_raw, gyro_raw, self.params, self.static)

    def pcm_init_step(self, state: PipelineState, t, pose) -> PipelineState:
        """:func:`pcm_init_step` with this pipeline's parameters."""
        return pcm_init_step(state, t, pose, self.params, self.static)

    # ---- active-window management (runtime.py:839-1123) ----
    def _stat(self, key, value):
        with self._stats_lock:
            self.window_stats[key] += value

    def _window_dims(self):
        h = self.host_map
        n = 2 * self._window_tiles + 1
        return (min(n, h.tx_dim), min(n, h.ty_dim))

    def _adopt_window(self, win: _Window):
        if win.event is not None:
            # The upload racing its consumer: the window was made on another
            # stream. The main stream waits for its event (the host does
            # not), and every tensor records the main stream, so the
            # allocator keeps its memory until the frames queued there that
            # read it are done.
            main = torch.cuda.current_stream(self.device)
            main.wait_event(win.event)
            for f in map_tiles.HALO_FIELDS + ("origin",):
                t = getattr(win.map, f)
                if t is not None:
                    t.record_stream(main)
        self.map = win.map
        self._window_center = win.center
        self._window_offset_tiles = win.anchor
        self._window_origin_anchor = win.origin_anchor

    def _window_enqueue(self, center_xy, base_map=None, base_anchor=None,
                        origin_anchor=None) -> _Window:
        """Build the window at ``center_xy`` and ENQUEUE its upload on the
        current stream without waiting for it (runtime.py:850-907); the
        caller follows up with :meth:`_window_finalize`, maybe from another
        thread. Given a resident window whose move is a small shift, the
        window moves INCREMENTALLY (kernel N on the card): only the entering
        rows go up, and retained rows keep their bits because the coordinate
        origin stays. A full crop, which re-centres the origin, is taken for
        the first window, big jumps (relocalization) and once the drift from
        the origin nears f32's limits. Full crops and entering rows go up
        from pinned buffers, ``non_blocking``; the buffers ride in the
        returned window until :meth:`_window_finalize` has waited out the
        upload."""
        h = self.host_map
        dims = self._window_dims()
        center_xy = np.asarray(center_xy, float)
        anchor = h.window_anchor(center_xy, dims)
        offset_dtype = torch.empty(0, dtype=self.dtype).numpy().dtype
        incr = None
        if base_map is not None and origin_anchor is not None:
            dx = anchor[0] - base_anchor[0]
            dy = anchor[1] - base_anchor[1]
            k = max(abs(dx), abs(dy))
            drift = max(abs(anchor[0] - origin_anchor[0]) + dims[0],
                        abs(anchor[1] - origin_anchor[1]) + dims[1])
            if 0 < k <= _MAX_INCR_SHIFT and drift * h.tile_size <= _INCR_DRIFT_LIMIT_M:
                incr = (dx, dy, k)
        staging = []
        t0 = time.time()
        if incr is None:
            host_win = h.crop_window(center_xy, self._window_tiles, dims=dims,
                                     offset_dtype=offset_dtype)
            t1 = time.time()
            dev = host_win.to_device(self.device, self.dtype, staging=staging)
            center = np.array(host_win.world_offset) + 0.5 * np.array(
                [host_win.tx_dim, host_win.ty_dim]) * h.tile_size
            oa = anchor
        else:
            dx, dy, k = incr
            r_pad = k * (dims[0] + dims[1])
            dst, payload = h.crop_entering_rows(base_anchor, anchor, dims, origin_anchor,
                                                r_pad, offset_dtype=offset_dtype)
            t1 = time.time()

            def up(a):
                return map_tiles._h2d(a, self.device, self.dtype, staging)

            if self.device.type == "cuda":
                # Freed memory under the worker: kernel N reads the resident
                # window on this stream while the main thread may adopt a new
                # window and drop this one; recording this stream on each
                # tensor N reads keeps the allocator from reusing its memory
                # before N has run.
                cur = torch.cuda.current_stream(self.device)
                for f in map_tiles.HALO_FIELDS:
                    t = getattr(base_map, f)
                    if t is not None:
                        t.record_stream(cur)
            dev = map_tiles.shift_window(base_map, dx, dy, up(dst),
                                         {f: up(v) for f, v in payload.items()})
            self._stat("incr_crops", 1)
            off, _ = h._origin_offsets(anchor, offset_dtype)
            center = off + 0.5 * np.array(dims) * h.tile_size
            oa = origin_anchor
        event = None
        if self.device.type == "cuda":
            # "built": the upload and kernel N are enqueued; the event marks
            # their end on this stream
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return _Window(dev, center, anchor, oa, t1 - t0, event, staging)

    def _window_finalize(self, win: _Window):
        """Wait out an enqueued window's upload (the pinned staging buffers
        are released only then), account for it and release the crop's file
        pages, in the JAX order (runtime.py:909-922: evicting any later
        overlapped the next crop, which re-faulted the pages)."""
        t1 = time.time()
        if win.event is not None:
            win.event.synchronize()
        t2 = time.time()
        win.staging.clear()
        self.host_map.drop_page_cache()
        self._stat("crop_s", win.host_s)
        self._stat("h2d_s", t2 - t1)

    def _build_window(self, center_xy, base_map=None, base_anchor=None,
                      origin_anchor=None) -> _Window:
        """Synchronous enqueue + finalize (see :meth:`_window_enqueue`)."""
        win = self._window_enqueue(center_xy, base_map=base_map, base_anchor=base_anchor,
                                   origin_anchor=origin_anchor)
        self._window_finalize(win)
        return win

    def _set_window(self, center_xy):
        self._adopt_window(self._build_window(
            center_xy, base_map=getattr(self, "map", None),
            base_anchor=self._window_offset_tiles,
            origin_anchor=self._window_origin_anchor))

    def _window_margin(self):
        ts = self.host_map.tile_size
        half = self._window_tiles * ts
        sensor = float(self.cfg.pcm.input_max_dist)
        return max(half - sensor - 2.0 * ts, ts)

    def _check_worker(self):
        """No hidden fallback: a prefetch worker that failed (kernel N
        included, adopted or not) fails the run here, on the main thread,
        at the consult or join after it (JAX turns it into a synchronous
        crop, runtime.py:1090-1106)."""
        for pf in [w for w in self._workers if w["done"].is_set()]:
            self._workers.remove(pf)
            if "error" in pf:
                if self._prefetch is pf:
                    self._prefetch = None
                raise RuntimeError("the window prefetch worker failed") from pf["error"]

    def _join_prefetch(self):
        """Wait for every prefetch worker still running and re-raise a
        failure."""
        for pf in list(self._workers):
            pf["done"].wait()
        self._check_worker()

    def _start_prefetch(self, pos_xy):
        """Crop + upload the window centred at ``pos_xy`` in a worker thread
        (runtime.py:949-1003; double buffering: the old window keeps serving
        frames until the new one is adopted). Two stages: ``built`` once the
        upload is ENQUEUED (the window is adoptable: the main stream waits
        for its event), ``done`` once it has landed and the crop's file
        pages are released."""
        self._check_worker()
        anchor = self.host_map.window_anchor(np.asarray(pos_xy, float), self._window_dims())
        pf = self._prefetch
        if anchor == self._window_offset_tiles:
            return
        if pf is not None:
            if not pf["done"].is_set():
                return  # let the crop in flight finish
            if pf["anchor"] == anchor:
                return  # the finished one is already ideal
        holder = {"anchor": anchor, "built": threading.Event(), "done": threading.Event()}
        center_xy = np.asarray(pos_xy, float).copy()
        # snapshot the resident window on the MAIN thread: adoption may
        # replace self.map while the worker runs
        base = (self.map, self._window_offset_tiles, self._window_origin_anchor)
        ready = None
        if self._side is not None:
            # kernel N on the side stream reads the base window only after
            # the main stream's work up to here (which made it)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))

        def work():
            try:
                # The worker's current stream: kernels launch on the current
                # stream, so the uploads and kernel N go to the side stream
                # only inside this block (None on the CPU: no stream).
                with torch.cuda.stream(self._side):
                    if ready is not None:
                        self._side.wait_event(ready)
                    win = self._window_enqueue(center_xy, *base)
                holder["window"] = win
                holder["built"].set()
                self._window_finalize(win)
            except BaseException as e:  # kept, re-raised on the main thread
                holder["error"] = e
            finally:
                holder["built"].set()
                holder["done"].set()

        self._prefetch = holder
        self._workers.append(holder)
        # non-daemon (runtime.py:1000-1003): a clean exit waits out the crop
        # and upload in flight instead of tearing the process down under it
        threading.Thread(target=work, daemon=False).start()

    def _maybe_rewindow(self, pos_xy, lookahead_xy=None):
        """Re-window before sensor-range correspondences can truncate at the
        window edge, never re-uploading an identical window
        (runtime.py:1005-1123). With prefetch, the anchor-divergence ladder
        warms the window at one tile of divergence and swaps at two (when
        the pose is also past the margin), adopting the warmed window when
        it is within the sensor slack of ideal: a hit if it was built, a
        join (waiting for ``built`` only) if not. Otherwise, and without
        prefetch, the swap is a synchronous crop. ``lookahead_xy``: the
        displacement (m) expected before the next consult; the prefetch
        stage looks there, the swap decision stays at ``pos_xy``."""
        if not self.windowed:
            return
        self._check_worker()
        pos = np.asarray(pos_xy, float)
        ts = self.host_map.tile_size
        margin = self._window_margin()
        dist = np.max(np.abs(pos - self._window_center))
        anchor = self.host_map.window_anchor(pos, self._window_dims())
        div = max(abs(anchor[0] - self._window_offset_tiles[0]),
                  abs(anchor[1] - self._window_offset_tiles[1]))
        if not (dist > margin and div >= 2):
            ahead, dist_a, div_a = pos, dist, div
            if lookahead_xy is not None:
                ahead = pos + np.asarray(lookahead_xy, float)
                dist_a = np.max(np.abs(ahead - self._window_center))
                anchor_a = self.host_map.window_anchor(ahead, self._window_dims())
                div_a = max(abs(anchor_a[0] - self._window_offset_tiles[0]),
                            abs(anchor_a[1] - self._window_offset_tiles[1]))
            if self._window_prefetch and div_a >= 1 and dist_a > max(margin - 6.0 * ts, 0.0):
                self._start_prefetch(ahead)
            return
        pf = self._prefetch
        # adopt when the warmed window is within the sensor's slack of the
        # anchor a synchronous swap would pick (one tile for windows smaller
        # than the sensor range)
        sensor = float(self.cfg.pcm.input_max_dist)
        slack_tiles = max(int((self._window_tiles * ts - sensor) / ts) - 1, 1)
        adopted = False
        if pf is not None and max(abs(pf["anchor"][0] - anchor[0]),
                                  abs(pf["anchor"][1] - anchor[1])) <= slack_tiles:
            if pf["built"].is_set():
                key = "prefetch_hits"
            else:
                # the crop is in flight: join it (its host crop and enqueue,
                # not the upload, which the main stream's wait orders)
                key = "prefetch_joins"
                t0 = time.time()
                pf["built"].wait()
                self._stat("swap_wait_s", time.time() - t0)
            if "window" not in pf:  # the worker failed before its window was built
                pf["done"].wait()
                self._check_worker()
            self._adopt_window(pf["window"])
            self._stat(key, 1)
            adopted = True
        if not adopted:
            t0 = time.time()
            if pf is not None and not pf["done"].is_set():
                # a stale crop in flight must not run beside the synchronous
                # one (they would compete for the core and the page cache)
                pf["done"].wait()
                self._check_worker()
            self._set_window(pos)
            self._stat("sync_swaps", 1)
            self._stat("swap_wait_s", time.time() - t0)
        self._prefetch = None
        self._stat("swaps", 1)
        if self._window_prefetch and lookahead_xy is not None:
            # warm the NEXT window at once: at speed the time between swaps
            # is all the worker gets
            self._start_prefetch(pos + np.asarray(lookahead_xy, float))

    # ---- config hot reload (runtime.py:1159-1183, 1358-1376) ----
    def reload_config(self, cfg: ElimalocConfig) -> None:
        """Hot reload (the reference's ProcessINI + UpdateDynamicConfig,
        ekf_localization.cpp:218-320 / ekf_algorithm.cpp:68-79): the
        continuous parameters swap in; changed feature flags make a new
        :class:`PipelineStatic`. The map and the filter state are kept."""
        old = self.static
        static = make_pipeline_static(
            cfg, backend=old.icp_static.backend, tile_budget=old.icp_static.tile_budget,
            ds_points=old.ds_points, bug_compat_deskew_z=old.bug_compat_deskew_z,
            reassign_each_iter=self._reassign_override)
        if static != old:
            check_supported(static.icp_static)
            self.static = static
        self.cfg = cfg
        self.params = make_pipeline_params(cfg, dtype=self.dtype, device=self.device)

    def watch_config(self, localization_ini: str,
                     calibration_ini: Optional[str] = None) -> None:
        """Arm the per-frame (per-IMU-event in :meth:`run`) ini hot reload of
        :meth:`run` and :meth:`run_frames`: a host mtime check each time, and
        :meth:`reload_config` on a change, the filter state untouched."""
        self._config_watcher = ConfigWatcher(localization_ini, calibration_ini)
        # the files as they are now are the configuration already applied
        self._config_watcher.cfg = self.cfg

    def _poll_config(self) -> None:
        w = self._config_watcher
        if w is not None and w.poll():
            self.reload_config(w.cfg)

    def _maybe_dashboard(self, state: PipelineState) -> None:
        """While ``debug_print`` is on, the state dashboard once a simulated
        second (runtime.py:1378-1390; the reference prints PrintState from a
        1 s timer, ekf_algorithm.cpp:176-180): one host read of the filter's
        time a call, and the dashboard's fields when it prints."""
        if not self.cfg.ekf.debug_print:
            return
        t = float(state.ekf.prev_timestamp)
        if self._last_dashboard_t is None or t - self._last_dashboard_t >= 1.0:
            self._last_dashboard_t = t
            print(state_dashboard(state.ekf, self.cfg.ekf), flush=True)

    # ---- geodetic projection (runtime.py:1185-1210, float64 on the host) ----
    def project_gps(self, lat, lon, height):
        """lat/lon/h -> local xyz about the configured geodetic origin
        (ProjectGpsPoint, ekf_localization.cpp:643-648): ENU, or the UTM
        plane when ``projection_mode`` is "UTM"."""
        e = self.cfg.ekf
        fwd = (geo.project_gps_point_utm if self.cfg.pcm.projection_mode.upper() == "UTM"
               else geo.project_gps_point)
        return np.asarray(fwd(lat, lon, height, e.ref_latitude, e.ref_longitude,
                              e.ref_height))

    def unproject(self, xyz):
        """Local xyz -> (lat, lon, h) (LocalCartesian::Reverse,
        ekf_localization.cpp:412-418), honouring ``projection_mode``."""
        e = self.cfg.ekf
        rev = (geo.unproject_local_point_utm if self.cfg.pcm.projection_mode.upper() == "UTM"
               else geo.unproject_local_point)
        lat, lon, h = rev(xyz, e.ref_latitude, e.ref_longitude, e.ref_height)
        return np.asarray(lat), np.asarray(lon), np.asarray(h)

    # ---- relocalization (CallbackInitialPose, pcm_matching.cpp:356-447) ----
    def _ground_from_tiles(self, position_xy, search_range: float = 5.0):
        """FindGroundHeight from the packed tile map (runtime.py:1125-1144),
        for a pipeline built from a HostTileMap: mean z of the 5 lowest halo
        points of the query tile within range. It reads the full host map,
        also when a window is active."""
        h = self.host_map
        ts = h.tile_size
        tx = int(np.floor(position_xy[0] / ts)) - h.tx0
        ty = int(np.floor(position_xy[1] / ts)) - h.ty0
        if not (0 <= tx < h.tx_dim and 0 <= ty < h.ty_dim):
            return False, 0.0
        pts = np.asarray(h.halo_points[tx * h.ty_dim + ty])
        pts = pts[np.isfinite(pts[:, 0])]
        d2 = np.sum((pts[:, :2] - np.asarray(position_xy)) ** 2, axis=1)
        within = pts[d2 <= search_range * search_range]
        if within.shape[0] <= 3:
            return False, 0.0
        low = within[np.argsort(within[:, 2])[:5]]
        return True, float(low[:, 2].mean())

    def initialize_at(self, state: PipelineState, x, y, yaw, scan_points, scan_valid,
                      timestamp):
        """The rviz-click flow (runtime.py:1213-1246): ground height at the
        click, the scan downsampled (kernel C) and registered from the
        clicked pose (kernels B, A/E/F/G and M), then the PCM_INIT hard reset
        of the filter. Returns (state, ok)."""
        timestamp = float(self._rebase(timestamp))
        if self.built is not None:
            found, ground_z = map_builder.find_ground_height(self.built, [x, y])
        else:
            found, ground_z = self._ground_from_tiles([x, y])
        if not found:
            return state, False
        if self.windowed:
            # a relocalization usually lands outside the resident window:
            # re-window around the click before registering
            self._maybe_rewindow(np.asarray([x, y], float))
        pose = np.eye(4)
        pose[:3, :3] = lie.euler_to_rot(
            torch.tensor([0.0, 0.0, yaw], dtype=torch.float64)).numpy()
        pose[:3, 3] = [x, y, ground_z]
        init_lidar = lie.compose(self._tensor(pose), self.params.tf_ego_to_lidar)
        ds_pts, ds_valid, _ = voxel_downsample(
            self._tensor(scan_points), self._tensor(scan_valid), self.params.input_voxel_ds,
            self.static.ds_points)
        res = run_register(ds_pts, ds_valid, self.map, init_lidar, self.params.icp,
                           self.static.icp_static)
        if not bool(res.success):
            return state, False
        final = lie.compose(res.pose, self.params.tf_lidar_to_ego)
        return self.pcm_init_step(state, self._tensor(timestamp), final), True

    # ---- the host event loop (runtime.py:1249-1355) ----
    def run(self, log: ReplayLog, state: Optional[PipelineState] = None,
            collect_every_imu: bool = False, on_scan=None):
        """Replay a log in event-time order: IMU samples, scans (delivered
        at :func:`scan_arrival_times`), GPS fixes and CAN samples, each
        through its event step; the config is polled before every IMU
        event. With ``use_imu`` off (runtime.py:1260-1273) the IMU samples
        only feed the IMU ring (:func:`imu_ring_step`) and CA ticks at
        ``tick_hz`` over the rebased float64 IMU span drive the filter
        (:func:`tick_step`); the config is polled before each of both. The
        log's per-sample arrays go to the device once, each scan when it is
        delivered. Returns (state, trajectory dict: ``t`` (absolute),
        ``pos`` and ``rpy`` after every scan, and every IMU sample with
        ``collect_every_imu`` (none in the tick mode); ``scans``, each
        scan's outputs). ``on_scan(out)`` sees a scan's outputs as NumPy
        plus ``ego_pos`` and ``ego_t``, one readback per scan. A windowed
        pipeline consults its window ladder before each scan at the
        filter's position, with ~1 s of motion at its velocity as the
        prefetch's lookahead (runtime.py:1315-1320). With ``debug_print`` a
        dashboard a simulated second, checked after each scan."""
        state = state if state is not None else self.reset()
        self._rebase(min(log.imu_t[0], log.scan_t[0]))
        use_imu = self.static.use_imu
        streams = {"imu" if use_imu else "pcm_imu": (log.imu_t, log.imu_acc, log.imu_gyro)}
        if not use_imu:
            # the reference's MainLoop drives the CA predictions (runtime.py:
            # 1266-1273)
            t0r = float(self._rebase(log.imu_t[0]))
            t1r = float(self._rebase(log.imu_t[-1]))
            ticks = np.arange(t0r, t1r, 1.0 / self.static.tick_hz)
        if log.gps_t is not None and self.static.use_gps:
            streams["gps"] = (log.gps_t, log.gps_pos, log.gps_cov)
        if log.can_t is not None and self.static.use_can:
            streams["can"] = (log.can_t, log.can_vel, log.can_yaw_rate)
        events = [("scan", i, t) for i, t in enumerate(self._rebase(scan_arrival_times(log)))]
        dev = {}
        for kind, (t, *vals) in streams.items():
            t = self._rebase(t)
            events += [(kind, i, ti) for i, ti in enumerate(t)]
            dev[kind] = [self._tensor(t)] + [self._tensor(v) for v in vals]
        if not use_imu:
            events += [("tick", i, ti) for i, ti in enumerate(ticks)]
            dev["tick"] = self._tensor(ticks)
        # equal times run in JAX's list order under its stable sort
        # (runtime.py:1259-1287): imu (or pcm_imu, tick), scan, gps, can
        rank = {"imu": 0, "pcm_imu": 0, "tick": 1, "scan": 2, "gps": 3, "can": 4}
        events.sort(key=lambda e: (e[2], rank[e[0]]))
        stamps = self._tensor(self._rebase(log.scan_t))

        ego, outs = [], []
        for kind, i, _ in events:
            if kind in ("imu", "pcm_imu", "tick"):
                # the reference polls ProcessINI in every IMU callback
                # (ekf_localization.cpp:141)
                self._poll_config()
            if kind == "imu":
                state = imu_step(state, *(x[i] for x in dev["imu"]), self.params, self.static)
                if collect_every_imu:
                    ego.append(ego_pose(state.ekf))
            elif kind == "pcm_imu":
                state = imu_ring_step(state, *(x[i] for x in dev["pcm_imu"]), self.params,
                                      self.static)
            elif kind == "tick":
                state = tick_step(state, dev["tick"][i], self.params, self.static)
            elif kind == "scan":
                if self.windowed:
                    pv = torch.cat([state.ekf.pos[:2], state.ekf.vel[:2]]).cpu().numpy()
                    self._maybe_rewindow(pv[:2], pv[2:] * 1.0)
                pub = {}
                state, out = scan_step(
                    state, stamps[i], self._tensor(log.scan_points[i]),
                    self._tensor(log.scan_times[i]), self._tensor(log.scan_valid[i]),
                    self.map, self.params, self.static, published=pub)
                ego.append({"timestamp": pub["ego_t"], "pos": pub["ego_pos"],
                            "rpy": pub["ego_rpy"]})
                outs.append(out)
                if on_scan is not None:
                    on_scan({**{k: v.cpu().numpy() for k, v in out.items()},
                             "ego_pos": ego[-1]["pos"].cpu().numpy(),
                             "ego_t": float(ego[-1]["timestamp"]) + self.time_base})
                self._maybe_dashboard(state)
            elif kind == "gps":
                state = gps_step(state, *(x[i] for x in dev["gps"]), self.params, self.static)
            else:
                state = can_step(state, *(x[i] for x in dev["can"]), self.params, self.static)
        if self.windowed:
            self._join_prefetch()
        traj = {"t": np.zeros(0), "pos": np.zeros((0, 3)), "rpy": np.zeros((0, 3)),
                "scans": []}
        if ego:
            traj["t"] = torch.stack([e["timestamp"] for e in ego]).cpu().numpy().astype(
                np.float64) + self.time_base
            traj["pos"] = torch.stack([e["pos"] for e in ego]).cpu().numpy()
            traj["rpy"] = torch.stack([e["rpy"] for e in ego]).cpu().numpy()
        if outs:
            stacked = {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
            traj["scans"] = [{k: np.asarray(v[j]) for k, v in stacked.items()}
                             for j in range(len(outs))]
        return state, traj

    # ---- the frame loop: online (run_frames) and whole-log (run_fused) ----
    def _frames(self, log: ReplayLog, state, batches, on_scan, mark, poll: bool,
                chunk: Optional[int] = None):
        """One :func:`fused_frame` per scan over the log's batches (moved to
        the device once), the outputs stacked on the device and read back
        once. With ``poll`` the config is polled before each frame, or each
        chunk, and with ``debug_print`` a dashboard a simulated second is
        checked after it; ``run_fused`` on a full map (no poll) prints none,
        as in the JAX package.

        Per frame (runtime.py:1533-1564): a windowed pipeline consults its
        window ladder before each frame at the previous frame's pose, whose
        read waits for that frame to finish; ``on_scan(out)`` gets each frame's device
        outputs. With ``chunk`` > 1 (runtime.py:1422-1532): the ladder is
        consulted once per ``chunk`` frames, at the end of the chunk that a
        motion model (fitted to the newest chunk of poses that has landed)
        predicts, with one further chunk as the prefetch's lookahead; one
        pose fetch per chunk; ``on_scan(out)`` gets the chunk's outputs
        stacked, ``n - k0`` rows for the final ragged chunk."""
        state = state if state is not None else self.reset()
        self._rebase(min(log.imu_t[0], log.scan_t[0]))
        if batches is None:
            batches = build_fused_batches(log, time_base=self.time_base)
        batches = batches_to_device(batches, self.device, self.dtype)
        n = batches["scan_t"].shape[0]
        step = chunk if chunk is not None and chunk > 1 else 1
        windowed = self.windowed
        pend = []       # (first frame, the fetch of its chunk's poses)
        motion = None   # _fit_motion's model, once a chunk has landed
        if windowed and step > 1 and self._window_prefetch:
            # warm the FORWARD window before the first frame, along the
            # configured initial heading (the ladder sees no motion before
            # the first chunk lands)
            yaw = np.deg2rad(self.cfg.ekf.ekf_init_yaw_deg)
            fwd = 2.0 * self.host_map.tile_size * np.array([np.cos(yaw), np.sin(yaw)])
            self._start_prefetch(np.asarray(self._window_center) + fwd)
        outs = []
        for ci, k0 in enumerate(range(0, n, step)):
            if poll:
                self._poll_config()
            if windowed and step == 1:
                # the previous frame's pose, one frame stale (JAX reads it
                # with np.asarray, runtime.py:1543): the read waits for the
                # frame queued last, so the host waits for the device once
                # per frame before it queues the next one
                self._maybe_rewindow(pend[-1][1].value()[:2] if pend
                                     else state.ekf.pos[:2].cpu().numpy())
            elif windowed:
                if motion is None and ci == 1:
                    # seed the motion model: one blocking read, once
                    motion = _fit_motion(pend[0][1].value(), pend[0][0])
                    pend = pend[1:]
                else:
                    # re-anchor from the newest chunk whose fetch has landed,
                    # never blocking the dispatch loop
                    for i in range(len(pend) - 1, -1, -1):
                        if pend[i][1].landed():
                            motion = _fit_motion(pend[i][1].value(), pend[i][0])
                            pend = pend[i + 1:]
                            break
                if motion is not None:
                    pred = _predict(motion, k0 + step - 1)
                    self._maybe_rewindow(pred, _predict(motion, k0 + 2 * step - 1) - pred)
            frame_outs = []
            for k in range(k0, min(k0 + step, n)):
                # self.params / self.static / self.map are read per frame: a
                # hot reload or a window swap takes effect at the next one
                state, out = fused_frame(state, {key: v[k] for key, v in batches.items()},
                                         self.map, self.params, self.static, mark=mark)
                frame_outs.append(out)
            if step > 1:
                out = {key: torch.stack([o[key] for o in frame_outs]) for key in frame_outs[0]}
            if windowed:
                pend.append((k0, _HostFetch(out["ego_pos"])))
                del pend[:-8]  # the model needs only the newest few
            outs.append(out)
            if on_scan is not None:
                on_scan(out)
            if poll:
                self._maybe_dashboard(state)
        if windowed:
            self._join_prefetch()
        cat = torch.cat if step > 1 else torch.stack
        stacked = {k: cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
        stacked["ego_t_abs"] = stacked["ego_t"].astype(np.float64) + self.time_base
        return state, stacked

    def run_frames(self, log: ReplayLog, state: Optional[PipelineState] = None, *,
                   batches=None, on_scan=None, chunk: Optional[int] = None,
                   mark=_no_mark):
        """The online mode (runtime.py:1393-1570): one fused frame per scan,
        the ini polled before each (see :meth:`watch_config`), ``on_scan(out)``
        after each with the frame's device outputs; with ``chunk`` > 1 the
        window ladder, the poll and ``on_scan`` go per ``chunk`` frames (see
        :meth:`_frames`), on a full map too. ``batches``: a
        :func:`build_fused_batches` dict, else built from the log. Returns
        (state, outs) as :meth:`run_fused`."""
        return self._frames(log, state, batches, on_scan, mark, poll=True, chunk=chunk)

    def run_fused(self, log: ReplayLog, state: Optional[PipelineState] = None,
                  window_chunk: int = 8, mark=_no_mark):
        """Whole-log fused replay (runtime.py:1573-1588): on a full map the
        frame loop of :meth:`run_frames` without the config poll; a windowed
        pipeline runs ``run_frames(chunk=window_chunk)``, with window
        management between chunks. Returns (state, outs) with outs as NumPy
        arrays stacked over frames plus ``ego_t_abs``."""
        if self.windowed:
            return self.run_frames(log, state, chunk=max(int(window_chunk), 1), mark=mark)
        return self._frames(log, state, None, None, mark, poll=False)

    def run_fused_fleet(self, logs, states=None, mark=_no_mark):
        """Multi-stream fused replay (runtime.py:1590-1649): ``B`` independent
        logs localized against the shared map in one frame loop
        (``parallel.replay_fused_fleet``: :func:`replay_fused` over the
        lanes' frames, each frame one call of every stage for all lanes, on
        the card one launch of each kernel's lane form).
        The logs must share a scan count and sensor streams; per-frame
        capacities are padded to the fleet's largest (:func:`fleet_batches`).
        ``states``: a list of B single states (default: ``reset()`` each),
        stacked on a lane axis (``parallel.stack_streams``). Returns
        ``(states, outs)`` with a leading lane axis on every field, ``outs``
        as NumPy arrays [B, F, ...] plus ``ego_t_abs`` on each lane's own
        time base; each lane's trajectory is its log's :meth:`run_fused`.
        ``time_base`` is None afterwards (the bases are per lane). Every
        method on either backend, with or without radar covariances and CAN
        and GPS fusion, with ``use_imu`` True or False; a windowed pipeline
        raises ValueError, as JAX's does."""
        from ..parallel import replay_fused_fleet

        if self.windowed:
            raise ValueError(
                "fleet replay compiles the whole log batch into one program "
                "and cannot swap map windows; use run()/run_frames() per "
                "stream with map_window_radius")
        bases, batches = fleet_batches(logs)
        if states is None:
            states = [self.reset() for _ in logs]
        states, outs = replay_fused_fleet(stack_streams(states), batches, self.map,
                                          self.params, self.static, mark=mark)
        outs = {k: v.cpu().numpy() for k, v in outs.items()}
        outs["ego_t_abs"] = outs["ego_t"].astype(np.float64) + bases[:, None]
        self.time_base = None  # per-lane bases; the host clock is lane-local
        return states, outs
