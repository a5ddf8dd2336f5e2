"""Scan-to-map registration, P2P / GICP / VGICP / AVGICP on the tile and
hash backends — port of ``elimaloc_tpu/register/icp.py`` (reference:
registration.cpp).

``run_register`` assigns the scan to tile slots once from the initial guess
(the hoisted assignment, icp.py:660-675) and runs the GN/LM loop: one
search + GN reduction per iteration, the LM-damped 6x6 solve, the SE(3)
step, and the overlap and termination gates. That is the
``lax.while_loop`` exactly: same trip count, same carry. The window-origin
conjugation (icp.py:630-632, 824-825) is kept on the host around the loop;
it is a zero shift for full maps. Only GICP exports
``local_cov = inv(JTJ + lambda diag)`` (icp.py:791-795).

Every registration runs the whole loop in one call: on a CUDA tensor one
cooperative launch of a loop kernel (csrc/``gn_loop.cuh`` around the
method's search: on the tile backend ``kernels.p2p_register``,
``p2p_register.cu``, kernel A's slot code; ``kernels.gicp_register``,
``gicp.cu``, kernel E's; ``kernels.vgicp_register``, ``vgicp.cu``, kernel
F's; ``kernels.avgicp_register``, ``avgicp.cu``, kernel G's; on the hash
backend ``kernels.hash_register``, ``hash_correspond.cu``, kernel Q's),
the reduction and kernel M's step every iteration, the termination test on
the card; the host reads nothing back. On a CPU tensor
:func:`p2p_register_plain`, :func:`gicp_register_plain`,
:func:`vgicp_register_plain`, :func:`avgicp_register_plain` and
:func:`hash_register_plain`: :func:`host_loop` of the plain versions (the
search composed with the method's tail, ``*_search_reduce_plain``,
icp.py:495-555 on tiles, then :func:`gn_update_plain`) with one readback
per iteration.

:func:`gn_iteration` (on a CUDA tensor kernel A, E, F or G through
:func:`search_sums`, then kernel M ``gn_step.cu``) and
:func:`gn_iteration_hash` (kernel Q, then M) keep one GN iteration: they
launch on no path, and are the reference each loop kernel is held to, bit
for bit, through the same host loop.

With ``use_radar_cov`` every GICP / VGICP / AVGICP row adds its point's
range / azimuth / elevation covariance (:func:`radar_point_cov`) to
R^T C R before the inverse. It is computed once per registration from the
WORLD initial pose, before the window-origin shift, and packed into the
slot layout (icp.py:619-632, 652-655), or in query order on the hash
backend: :func:`radar_slots`, kernel X ``radar_rows.cu`` on the card (kernel
P ``radar_cov.cu`` is its reference). AVGICP then takes the flattened per-pair tail
(icp.py:551-562) instead of the world-frame reduction.

The hash backend (``backend="hash"``, icp.py:612-675, the JAX package's
semantic reference for the tile engine) registers against a
``map.grid.MapGrid`` in world coordinates: no slot assignment (``dropped``
is 0), no window origin, and every GN iteration looks the voxels up again
from the current pose (:func:`hash_register`: kernel Q's body
``hash_correspond.cuh`` inside the loop kernel on the card; on a CPU tensor
:func:`hash_search_reduce_plain`, the grid queries composed with the same
tails, icp.py:429-467, and :func:`gn_update_plain`). The radar covariances
come in query order, from kernel X on the rows 0..N-1. As in JAX,
``corr_reuse`` and ``reassign_each_iter`` do nothing there.

A fleet frame's registrations (:func:`run_register_lanes`, a scan with a
leading lane axis) run every method on either backend, with or without
the radar covariances: the batched set-up (on tiles kernel B's lane form
and the gather; with radar kernel X's lane form), one launch of the loop
kernel's lane form for every ``kernels.MAX_LANES`` lanes
(:func:`p2p_register`, :func:`gicp_register`, :func:`vgicp_register`,
:func:`avgicp_register`, :func:`hash_register`; their ``*_lanes_plain``
forms on CPU tensors) and the batched tail.

Not ported, refused with NotImplementedError: the tile backend's
correspondence-reuse and per-iteration reassignment loops (ROADMAP "Not
ported") and the sharded modes (ROADMAP Queue 1, ``parallel/sharding.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import kernels
from ..config import IcpMethod, PcmConfig
from ..map import grid as mapgrid
from ..map import tiles as maptiles
from ..map.grid import div
from ..ops import lie
from ..struct import Struct


@dataclasses.dataclass
class IcpParams(Struct):
    """Continuous registration parameters (RegistrationConfig,
    registration.hpp:62-85)."""

    max_search_dist: torch.Tensor
    lm_lambda: torch.Tensor
    termination_threshold: torch.Tensor
    min_overlap_ratio: torch.Tensor
    max_fitness_score: torch.Tensor
    range_variance_m: torch.Tensor
    azimuth_variance_deg: torch.Tensor
    elevation_variance_deg: torch.Tensor
    corr_refresh_dist: torch.Tensor


@dataclasses.dataclass(frozen=True)
class IcpStatic:
    """Static registration switches (icp.py:67-110): ``backend`` "tile"
    (the hoisted slot assignment) or "hash" (the grid, looked up from the
    current pose every iteration)."""

    method: int = int(IcpMethod.GICP)
    max_iteration: int = 10
    use_radar_cov: bool = False
    backend: str = "tile"
    corr_reuse: bool = False
    reassign_each_iter: bool = False
    tile_budget: maptiles.TileQueryBudget = maptiles.TileQueryBudget()
    psum_axis: str | None = None
    slot_shard_axis: str | None = None


def make_icp_params(cfg: PcmConfig, dtype=torch.float32, device=None) -> IcpParams:
    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return IcpParams(
        max_search_dist=f(cfg.max_search_dist),
        lm_lambda=f(cfg.lm_lambda),
        termination_threshold=f(cfg.icp_termination_threshold_m),
        min_overlap_ratio=f(cfg.min_overlap_ratio),
        max_fitness_score=f(cfg.max_fitness_score),
        range_variance_m=f(cfg.range_variance_m),
        azimuth_variance_deg=f(cfg.azimuth_variance_deg),
        elevation_variance_deg=f(cfg.elevation_variance_deg),
        corr_refresh_dist=f(cfg.corr_refresh_dist_m),
    )


def make_icp_static(cfg: PcmConfig, backend: str = "tile",
                    tile_budget: maptiles.TileQueryBudget | None = None,
                    reassign_each_iter: bool | None = None) -> IcpStatic:
    """Same defaults as icp.py:128-151 (AVGICP reassigns unless reuse is on)."""
    if reassign_each_iter is None:
        reassign_each_iter = (
            int(cfg.icp_method) == int(IcpMethod.AVGICP)
            and not float(cfg.corr_refresh_dist_m) > 0.0
        )
    return IcpStatic(
        method=int(cfg.icp_method),
        max_iteration=int(cfg.max_iteration),
        use_radar_cov=bool(cfg.use_radar_cov),
        backend=backend,
        corr_reuse=float(cfg.corr_refresh_dist_m) > 0.0,
        reassign_each_iter=bool(reassign_each_iter),
        tile_budget=tile_budget or maptiles.TileQueryBudget(),
    )


@dataclasses.dataclass
class IcpResult(Struct):
    pose: torch.Tensor        # [4,4] refined sensor pose (global)
    success: torch.Tensor     # bool
    fitness: torch.Tensor
    local_cov: torch.Tensor   # [6,6] (JTJ + lambda diag)^-1, GICP only (cpp:140-142)
    iterations: torch.Tensor  # int32
    overlap: torch.Tensor     # last correspondence ratio
    dropped: torch.Tensor     # queries dropped on tile-slot overflow


def check_supported(static: IcpStatic) -> None:
    """Refuse what the port does not run yet, naming the ROADMAP item."""
    if static.backend not in ("tile", "hash"):
        raise ValueError(f"backend={static.backend!r}: 'tile' or 'hash'")
    if static.backend == "tile" and (static.corr_reuse or static.reassign_each_iter):
        raise NotImplementedError(
            "corr_reuse / reassign_each_iter are not ported (ROADMAP "
            "'Not ported'): the port searches every iteration on the hoisted "
            "assignment; AVGICP needs a halo_margin=2 tile map")
    if static.psum_axis is not None or static.slot_shard_axis is not None:
        raise NotImplementedError(
            "psum_axis / slot_shard_axis: multi-device registration is in "
            "ROADMAP Queue 1, parallel/sharding.py")


def _on_card(t) -> bool:
    """Whether the GN loop's callers launch kernels for ``t`` (any device but
    the CPU, where they run the plain versions)."""
    return t.device.type != "cpu"


# --------------------------------------------------------------------------- #
# One GN iteration: search + reduction (P2P: kernel A)
# --------------------------------------------------------------------------- #

def transform_slots(pose, sbuf):
    """q = R s + t on the slot layout, in the fixed order kernel A uses:
    ((R_i0 s0 + R_i1 s1) + R_i2 s2) + t_i."""
    s0, s1, s2 = sbuf[..., 0], sbuf[..., 1], sbuf[..., 2]
    return torch.stack(
        [pose[i, 0] * s0 + pose[i, 1] * s1 + pose[i, 2] * s2 + pose[i, 3]
         for i in range(3)], dim=-1)


def _p2p_tail(pose, src, target, valid, params: IcpParams):
    """P2P GN partials given correspondences (AlignCloudsLocal,
    registration.cpp:15-66; icp.py:283-321): J = [I | -skew(p)], M = w I with
    the reference's robust weight th^2 / (th + r^2)^2.
    Returns (matched, JTJ [6,6], JTr [6], fit_num)."""
    matched = torch.sum(valid)
    inv_pose = lie.transform_inverse(pose)
    tgt_local = target @ inv_pose[:3, :3].T + inv_pose[:3, 3]
    r = tgt_local - src
    r2 = torch.sum(r * r, dim=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2
    wv = w * valid.to(src.dtype)
    wp = wv[:, None] * src
    sw = torch.sum(wv)
    swp = torch.sum(wp, dim=0)
    ppT = wp.T @ src                                   # sum w p p^T
    wp2 = torch.trace(ppT)
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    S_swp = lie.skew(swp)
    JTJ = torch.cat([
        torch.cat([sw * eye, -S_swp], dim=1),
        torch.cat([S_swp, wp2 * eye - ppT], dim=1),
    ], dim=0)
    JTr = torch.cat([
        torch.sum(wv[:, None] * r, dim=0),
        torch.sum(torch.linalg.cross(wp, r), dim=0),
    ])
    fit_num = torch.sum(torch.where(valid, torch.sqrt(r2), torch.zeros_like(r2)))
    return matched, JTJ, JTr, fit_num


def p2p_search_reduce_plain(tmap, slot_tile, sbuf, qmask, pose, params: IcpParams,
                            budget: maptiles.TileQueryBudget):
    """Plain PyTorch version of kernel A: the search at ``pose``
    (icp.py:479-500) then :func:`_p2p_tail`. Returns
    (matched, JTJ, JTr, fit_num, tgt [S,QB,3], ok [S,QB])."""
    qbuf = transform_slots(pose, sbuf)
    qvox = torch.floor(div(qbuf, tmap.voxel_size)).to(torch.int32)
    tgt, ok = maptiles.nearest_point_slots(
        tmap, slot_tile, qbuf, qvox, qmask, params.max_search_dist, budget)
    matched, JTJ, JTr, fit_num = _p2p_tail(
        pose, sbuf.reshape(-1, 3), tgt.reshape(-1, 3), ok.reshape(-1), params)
    return matched, JTJ, JTr, fit_num, tgt, ok


def assemble_p2p(sums):
    """Kernel A's 18 sums -> (matched, JTJ, JTr, fit_num), the block layout
    of ``_p2p_tail`` (icp.py:312-319)."""
    sw, swp, pp, swr, spxr = sums[0], sums[1:4], sums[4:10], sums[10:13], sums[13:16]
    ppT = torch.stack([
        torch.stack([pp[0], pp[1], pp[2]]),
        torch.stack([pp[1], pp[3], pp[4]]),
        torch.stack([pp[2], pp[4], pp[5]]),
    ])
    eye = torch.eye(3, dtype=sums.dtype, device=sums.device)
    S_swp = lie.skew(swp)
    JTJ = torch.cat([
        torch.cat([sw * eye, -S_swp], dim=1),
        torch.cat([S_swp, (pp[0] + pp[3] + pp[5]) * eye - ppT], dim=1),
    ], dim=0)
    return sums[17].round().to(torch.int64), JTJ, torch.cat([swr, spxr]), sums[16]


# --------------------------------------------------------------------------- #
# GICP / VGICP / AVGICP tails (icp.py:175-227, 324-426)
# --------------------------------------------------------------------------- #

def _gn_blocks(A, Ar, src):
    """Sum over rows of J^T M J and J^T M r for J = [I | -skew(p)], given
    A = w M [K,3,3] and A r [K,3] in the sensor frame. A need not be
    symmetric (the SVD-regularised covariances are U diag V^T), so all four
    blocks are summed: tl = sum A, tr = -sum A S, bl = sum S A,
    br = -sum S A S (icp.py:186-198)."""
    S = lie.skew(src)
    AS = A @ S
    JTJ = torch.cat([
        torch.cat([torch.sum(A, dim=0), -torch.sum(AS, dim=0)], dim=1),
        torch.cat([torch.einsum("kij,kjl->il", S, A),
                   -torch.einsum("kij,kjl->il", S, AS)], dim=1),
    ], dim=0)
    JTr = torch.cat([torch.sum(Ar, dim=0), torch.einsum("kij,kj->i", S, Ar)])
    return JTJ, JTr


def _accumulate_gn(src_local, tgt_global, maha, w, mask, pose):
    """Masked J^T M J and J^T M r over flat [K,...] rows (cpp:36-48 /
    115-125 / 193-205; icp.py:175-199). Returns (JTJ, JTr, r)."""
    inv_pose = lie.transform_inverse(pose)
    tgt_local = tgt_global @ inv_pose[:3, :3].T + inv_pose[:3, 3]
    r = tgt_local - src_local
    A = (w * mask)[:, None, None] * maha
    JTJ, JTr = _gn_blocks(A, torch.einsum("kij,kj->ki", A, r), src_local)
    return JTJ, JTr, r


def _smallest_eigvec(covs):
    """Unit eigenvector of the smallest eigenvalue of [..., 3, 3] symmetric
    matrices in closed form (icp.py:214-248): trigonometric eigenvalues, then
    the longest cross product of two rows of C - lambda I; (0, 0, 1) when all
    are ~0. Its sign is arbitrary; the consumer takes |r . n|."""
    a = covs
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = a - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(b * b, dim=(-2, -1)) / 6.0, min=1e-30))
    bn = b / p[..., None, None]
    det = (
        bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 1])
        - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 0])
        + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1] - bn[..., 1, 1] * bn[..., 2, 0])
    )
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    c = a - lam_min[..., None, None] * eye
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    best = torch.argmax(lie.norm(cands), dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    n = lie.norm(v, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(n > 1e-20, v / torch.clamp(n, min=1e-30), fallback)


def radar_point_cov(points, params: IcpParams):
    """Per-point range / azimuth / elevation covariance (CalPointCov,
    registration.hpp:186-208; icp.py:251-276) with d the horizontal range:
    S = diag(range var, max(0.1, d sin(azimuth var)), max(0.1, d sin(elevation
    var))), R = Rz(azi) Ry(ele). Quirk preserved: returns R S (no R^T), which
    is not symmetric. [N, 3] -> [N, 3, 3]."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dist = torch.sqrt(x * x + y * y)
    d2r = math.pi / 180.0
    s_x = params.range_variance_m.expand(dist.shape)
    s_y = torch.clamp(dist * torch.sin(params.azimuth_variance_deg * d2r), min=0.1)
    s_z = torch.clamp(dist * torch.sin(params.elevation_variance_deg * d2r), min=0.1)
    ele = torch.atan2(z, dist)
    azi = torch.atan2(y, x)
    cy, sy = torch.cos(azi), torch.sin(azi)
    cp, sp = torch.cos(ele), torch.sin(ele)
    R = torch.stack([
        torch.stack([cy * cp, -sy, cy * sp], -1),
        torch.stack([sy * cp, cy, sy * sp], -1),
        torch.stack([-sp, torch.zeros_like(azi), cp], -1),
    ], dim=-2)
    # R @ diag(s): each column scaled by its variance
    return R * torch.stack([s_x, s_y, s_z], -1)[..., None, :]


def radar_slots_plain(src_local, qidx, qmask, pose, params: IcpParams):
    """Plain PyTorch version of kernels P and X: :func:`radar_point_cov` of
    the scan at the world pose ``pose``, gathered into the slot layout of
    the assignment (``qidx``, ``qmask`` [S, QB]) and zero where ``qmask`` is
    false (icp.py:619-623, 652-655). Returns [S, QB, 3, 3]; with ``qidx``
    and ``qmask`` None, the rows 0..N-1 in order, [N, 3, 3]."""
    radar = radar_point_cov(lie.transform_points(pose, src_local), params)
    if qidx is None:
        return radar
    safe_idx = torch.clamp(qidx.to(torch.int64), max=src_local.shape[0] - 1)
    return torch.where(qmask[..., None, None], radar[safe_idx],
                       torch.zeros((), dtype=radar.dtype, device=radar.device))


def radar_slots_lanes_plain(src_local, qidx, qmask, pose, params: IcpParams):
    """Plain lane form of kernel X: :func:`radar_slots_plain` on each lane
    of a fleet frame (scans [B, N, 3], ``qidx`` / ``qmask`` [B, S, QB] or
    None, world poses [B, 4, 4]), the rows stacked: [B, S, QB, 3, 3] or
    [B, N, 3, 3]."""
    return torch.stack([
        radar_slots_plain(src_local[i], None if qidx is None else qidx[i],
                          None if qmask is None else qmask[i], pose[i], params)
        for i in range(src_local.shape[0])])


def radar_slots(src_local, qidx, qmask, pose, params: IcpParams):
    """:func:`radar_slots_plain` for CPU tensors, kernel X
    (``kernels.radar_rows``) for CUDA ones; with a lane axis on the scans
    (a fleet frame) :func:`radar_slots_lanes_plain` or X's lane form."""
    if src_local.device.type == "cpu":
        plain = radar_slots_lanes_plain if src_local.dim() == 3 else radar_slots_plain
        return plain(src_local, qidx, qmask, pose, params)
    return kernels.radar_rows(src_local, qidx, qmask, pose, params)


def _gicp_tail(pose, src, cov, cov_mean, valid, params: IcpParams, radar=None):
    """GICP GN partials (AlignCloudsLocalPointCov, cpp:68-152; icp.py:324-351):
    M = (R^T C R + radar)^-1 (``radar`` [K, 3, 3] or None), residuals
    against the neighbourhood MEAN, weight 0.8 th^2 / (th + r^2)^2 + 0.2,
    fitness |r . n| with n the sensor-frame normal of C. Returns (matched,
    JTJ, JTr, fit_num)."""
    rot_inv = pose[:3, :3].T
    matched = torch.sum(valid)
    rcr = rot_inv @ cov @ rot_inv.T
    maha = lie.inv3x3(rcr if radar is None else rcr + radar)
    inv_pose = lie.transform_inverse(pose)
    r = cov_mean @ inv_pose[:3, :3].T + inv_pose[:3, 3] - src
    r2 = torch.sum(r * r, dim=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2 * 0.8 + 0.2
    JTJ, JTr, _ = _accumulate_gn(src, cov_mean, maha, w, valid.to(src.dtype), pose)
    normal = _smallest_eigvec(cov) @ rot_inv.T
    normal = normal / torch.clamp(lie.norm(normal, keepdim=True), min=1e-30)
    dot = torch.abs(torch.sum(r * normal, dim=-1))
    fit_num = torch.sum(torch.where(valid, dot, torch.zeros_like(dot)))
    return matched, JTJ, JTr, fit_num


def _voxcov_tail(pose, src, cov, mean, valid, params: IcpParams, radar=None):
    """VGICP GN partials (AlignCloudsLocalVoxelCov, cpp:154-225;
    icp.py:354-378), M = (R^T C R + radar)^-1: rows with weight < 0.01 leave
    both the sums and the fitness numerator, but every valid match counts.
    With radar, AVGICP's (point, voxel) pairs come here flattened."""
    rot_inv = pose[:3, :3].T
    matched = torch.sum(valid)
    rcr = rot_inv @ cov @ rot_inv.T
    maha = lie.inv3x3(rcr if radar is None else rcr + radar)
    inv_pose = lie.transform_inverse(pose)
    r = mean @ inv_pose[:3, :3].T + inv_pose[:3, 3] - src
    r2 = torch.sum(r * r, dim=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2
    keep = valid & (w >= 0.01)
    JTJ, JTr, _ = _accumulate_gn(src, mean, maha, w, keep.to(src.dtype), pose)
    fit_num = torch.sum(torch.where(keep, torch.sqrt(r2), torch.zeros_like(r2)))
    return matched, JTJ, JTr, fit_num


def _avg_voxcov_tail(pose, src, q_world, cov, mean, ok, params: IcpParams):
    """AVGICP GN partials with the 7-voxel axis reduced in the world frame
    first (icp.py:381-426): P = sum w C^-1, bw = sum w C^-1 (mu - q), then
    A = R^T P R and b = R^T bw once per point. ``matched`` counts (point,
    voxel) PAIRS, so the overlap ratio can exceed 1 (a reference quirk)."""
    matched = torch.sum(ok)
    d = mean - q_world[:, None, :]                       # [K,7,3] world frame
    r2 = torch.sum(d * d, dim=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2
    keep = ok & (w >= 0.01)
    wk = torch.where(keep, w, torch.zeros_like(w))
    cinv = lie.inv3x3(cov)
    P = torch.einsum("ko,koij->kij", wk, cinv)
    bw = torch.einsum("ko,koij,koj->ki", wk, cinv, d)
    rot = pose[:3, :3]
    JTJ, JTr = _gn_blocks(rot.T @ P @ rot, bw @ rot, src)
    fit_num = torch.sum(torch.where(keep, torch.sqrt(r2), torch.zeros_like(r2)))
    return matched, JTJ, JTr, fit_num


def _slot_queries(tmap, pose, sbuf):
    """The queries at ``pose`` on the slot layout and their voxels."""
    qbuf = transform_slots(pose, sbuf)
    return qbuf, torch.floor(div(qbuf, tmap.voxel_size)).to(torch.int32)


def _flat_radar(radar):
    return None if radar is None else radar.reshape(-1, 3, 3)


def gicp_search_reduce_plain(tmap, slot_tile, sbuf, qmask, pose, params: IcpParams,
                             budget: maptiles.TileQueryBudget, radar=None):
    """Plain PyTorch version of kernel E: the GICP search (icp.py:502-507)
    then :func:`_gicp_tail`, with the slot-packed ``radar`` [S,QB,3,3] when
    given. Returns (matched, JTJ, JTr, fit_num, cov [S,QB,3,3],
    mean [S,QB,3], ok [S,QB])."""
    qbuf, qvox = _slot_queries(tmap, pose, sbuf)
    _, ok, cov, mean = maptiles.nearest_point_slots(
        tmap, slot_tile, qbuf, qvox, qmask, params.max_search_dist, budget,
        with_point_cov=True)
    sums = _gicp_tail(pose, sbuf.reshape(-1, 3), cov.reshape(-1, 3, 3),
                      mean.reshape(-1, 3), ok.reshape(-1), params, _flat_radar(radar))
    return (*sums, cov, mean, ok)


def vgicp_search_reduce_plain(tmap, slot_tile, sbuf, qmask, pose, params: IcpParams,
                              budget: maptiles.TileQueryBudget, radar=None):
    """Plain PyTorch version of kernel F: the VGICP search (icp.py:509-514)
    then :func:`_voxcov_tail`, with the slot-packed ``radar`` when given.
    Returns (matched, JTJ, JTr, fit_num, cov [S,QB,3,3], mean [S,QB,3],
    ok [S,QB])."""
    qbuf, qvox = _slot_queries(tmap, pose, sbuf)
    cov, mean, ok = maptiles.nearest_voxel_cov_slots(
        tmap, slot_tile, qbuf, qvox, qmask, params.max_search_dist, budget)
    sums = _voxcov_tail(pose, sbuf.reshape(-1, 3), cov.reshape(-1, 3, 3),
                        mean.reshape(-1, 3), ok.reshape(-1), params, _flat_radar(radar))
    return (*sums, cov, mean, ok)


def avgicp_search_reduce_plain(tmap, slot_tile, sbuf, qmask, pose, params: IcpParams,
                               budget: maptiles.TileQueryBudget, radar=None):
    """Plain PyTorch version of kernel G: the AVGICP search (icp.py:516-521)
    then :func:`_avg_voxcov_tail`; with the slot-packed ``radar`` the
    flattened per-pair :func:`_voxcov_tail` instead (icp.py:551-562: the
    radar term inside the inverse breaks the world-frame reduction), each
    row's point and radar covariance repeated over its 7 pairs. Returns
    (matched, JTJ, JTr, fit_num, cov [S,QB,7,3,3], mean [S,QB,7,3],
    ok [S,QB,7])."""
    qbuf, qvox = _slot_queries(tmap, pose, sbuf)
    cov, mean, ok = maptiles.all_voxel_cov_slots(
        tmap, slot_tile, qbuf, qvox, qmask, params.max_search_dist, budget)
    src = sbuf.reshape(-1, 3)
    if radar is None:
        sums = _avg_voxcov_tail(pose, src, qbuf.reshape(-1, 3),
                                cov.reshape(-1, 7, 3, 3), mean.reshape(-1, 7, 3),
                                ok.reshape(-1, 7), params)
    else:
        sums = _voxcov_tail(pose, torch.repeat_interleave(src, 7, dim=0),
                            cov.reshape(-1, 3, 3), mean.reshape(-1, 3), ok.reshape(-1),
                            params, torch.repeat_interleave(_flat_radar(radar), 7, dim=0))
    return (*sums, cov, mean, ok)


def assemble_gn(sums):
    """Kernels E/F/G's 44 sums -> (matched, JTJ, JTr, fit_num): the JTJ blocks
    tl, tr, bl, br (each 3x3 row-major), JTr top and bottom, the fitness
    numerator, the matched count (icp.py:197-198)."""
    b = sums[:36].reshape(4, 3, 3)
    JTJ = torch.cat([torch.cat([b[0], b[1]], dim=1),
                     torch.cat([b[2], b[3]], dim=1)], dim=0)
    return sums[43].round().to(torch.int64), JTJ, sums[36:42], sums[42]


_PLAIN = {
    int(IcpMethod.P2P): p2p_search_reduce_plain,
    int(IcpMethod.GICP): gicp_search_reduce_plain,
    int(IcpMethod.VGICP): vgicp_search_reduce_plain,
    int(IcpMethod.AVGICP): avgicp_search_reduce_plain,
}


def search_sums(method: int, tmap, slot_tile, sbuf, qmask, pose, params: IcpParams,
                radar=None):
    """One GN iteration's search + reduction on the card: the method's
    kernel (A, E, F or G; E, F, G in their radar form when ``radar`` is
    given) -> the reduced sums, [18] for P2P (:func:`assemble_p2p`'s
    layout) or [44] (:func:`assemble_gn`'s)."""
    args = (slot_tile, sbuf, qmask, pose, params.max_search_dist)
    geo = tmap.search_geometry
    if method == int(IcpMethod.P2P):
        return kernels.p2p_correspond(tmap.halo_points, *args, **geo)[0]
    if method == int(IcpMethod.GICP):
        return kernels.gicp_correspond(
            tmap.halo_points, tmap.halo_point_cov, tmap.halo_point_cov_mean, *args,
            radar=radar, **geo)[0]
    if method == int(IcpMethod.VGICP):
        return kernels.vgicp_correspond(
            tmap.halo_vox_mean, tmap.halo_vox_cov, tmap.halo_vox_coord, *args,
            radar=radar, **geo)[0]
    return kernels.avgicp_correspond(
        tmap.halo_vox_mean, tmap.halo_vox_cov, tmap.halo_vox_coord, *args,
        voxel_size=tmap.voxel_size, radar=radar)[0]


def search_reduce(method: int, tmap, slot_tile, sbuf, qmask, pose,
                  params: IcpParams, budget: maptiles.TileQueryBudget, radar=None):
    """One GN iteration's search + reduction of ``method`` on CPU tensors ->
    (matched, JTJ, JTr, fit_num), the plain version of kernel A, E, F or G
    (with the slot-packed ``radar`` for E, F, G when given). On the card
    :func:`gn_iteration` takes :func:`search_sums` and kernel M instead."""
    if sbuf.device.type != "cpu":
        raise ValueError("search_reduce is the plain route for CPU tensors; on the card "
                         "use search_sums (kernel A, E, F or G)")
    extra = () if radar is None else (radar,)
    return _PLAIN[method](tmap, slot_tile, sbuf, qmask, pose, params, budget, *extra)[:4]


def _solve_step(JTJ, JTr, lm_lambda):
    """LM-damped solve (cpp:55-56) -> (x, regularized JTJ). ``solve_ex``
    leaves singular systems unchecked, like the JAX solve, and never syncs."""
    reg = JTJ + lm_lambda * torch.diag(torch.diagonal(JTJ))
    x = torch.linalg.solve_ex(reg, JTr)[0]
    return x, reg


def _step_transform(x):
    """6-vector -> small SE(3) transform (cpp:58-62)."""
    return lie.make_transform(lie.so3_exp(x[3:6]), x[0:3])


def gn_update_plain(matched, JTJ, JTr, fit_num, pose, fitness, local_cov, total,
                    params: IcpParams, gicp: bool):
    """Plain PyTorch version of kernel M: the GN loop body after the
    reduction (icp.py:761-795): fitness and overlap ratio, the overlap
    gate, the LM-damped solve, the SE(3) step and compose, the termination
    norm, and for GICP ``local_cov = (JTJ + lambda diag)^-1``. Returns
    (pose, local_cov, fitness, overlap, stop, failed), stop = done | failed."""
    dtype = pose.dtype
    fit = fit_num / torch.clamp(matched, min=1).to(dtype)
    ratio = matched.to(dtype) / total
    overlap_ok = ratio >= params.min_overlap_ratio

    x, reg = _solve_step(JTJ, JTr, params.lm_lambda)
    x = torch.where(overlap_ok, x, torch.zeros_like(x))
    step_tf = _step_transform(x)
    pose = torch.where(overlap_ok, lie.compose(pose, step_tf), pose)

    rot_norm = lie.norm(lie.so3_log(step_tf[:3, :3]))
    transform_norm = rot_norm + lie.norm(x[0:3])
    done = overlap_ok & (transform_norm < params.termination_threshold)
    fitness = torch.where(overlap_ok, fit, fitness)
    if gicp:
        # only the GICP solver exports (JTJ + lambda diag)^-1 (cpp:140-142)
        local_cov = torch.where(overlap_ok, torch.linalg.inv_ex(reg)[0], local_cov)
    return pose, local_cov, fitness, ratio, done | ~overlap_ok, ~overlap_ok


def gn_iteration(method: int, tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov,
                 total, params: IcpParams, budget: maptiles.TileQueryBudget, radar=None):
    """One GN iteration: on a CPU tensor the plain search + reduction and
    :func:`gn_update_plain`; on a CUDA one kernel A, E, F or G, then kernel M
    on the same stream. ``radar``: the slot-packed radar covariances of
    :func:`radar_slots`, or None. Returns (pose, local_cov, fitness,
    overlap, stop, failed)."""
    gicp = method == int(IcpMethod.GICP)
    carry = (pose, fitness, local_cov, total, params)
    if not _on_card(sbuf):
        return gn_update_plain(
            *search_reduce(method, tmap, slot_tile, sbuf, qmask, pose, params, budget,
                           radar), *carry, gicp)
    return kernels.gn_step(search_sums(method, tmap, slot_tile, sbuf, qmask, pose, params,
                                      radar), *carry, gicp)


def host_loop(step, pose, fitness, local_cov, max_iteration: int):
    """The GN/LM loop on the host (the ``lax.while_loop``'s trip count and
    carry, icp.py:728-821): ``step(pose, fitness, local_cov)`` -> (pose,
    local_cov, fitness, overlap, stop, failed) at most ``max_iteration``
    times, ONE readback of ``stop`` per iteration. Returns (pose,
    local_cov, fitness, overlap, failed, iterations int32)."""
    overlap = torch.zeros_like(fitness)
    failed = torch.zeros((), dtype=torch.bool, device=pose.device)
    it = 0
    while it < max_iteration:
        pose, local_cov, fitness, overlap, stop, failed = step(pose, fitness, local_cov)
        it += 1
        if bool(stop):      # the one readback per iteration
            break
    return (pose, local_cov, fitness, overlap, failed,
            torch.full((), it, dtype=torch.int32, device=pose.device))


def p2p_register_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                       params: IcpParams, budget: maptiles.TileQueryBudget,
                       max_iteration: int):
    """Plain PyTorch version of the P2P loop kernel (``kernels.p2p_register``):
    :func:`host_loop` of :func:`p2p_search_reduce_plain` then
    :func:`gn_update_plain` from the carry (``pose``, ``fitness``,
    ``local_cov``). Returns (pose, local_cov, fitness, overlap, failed,
    iterations int32)."""
    return _tile_register_plain(p2p_search_reduce_plain, False, tmap, slot_tile, sbuf, qmask,
                                pose, fitness, local_cov, total, params, budget,
                                max_iteration, None)


def _register_lanes_plain(single, tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov,
                          total, params, budget, max_iteration, radar=None):
    """A loop kernel's plain lane form: its plain version ``single`` on each
    lane (every input with a leading lane axis but the map and the params;
    ``radar`` [B, S, QB, 3, 3] or None), the outputs stacked. Each lane
    iterates until its own gates release and keeps its carry and its
    count: JAX's vmapped while_loop (masked per lane) gives every lane the
    result of its own run."""
    per_lane = (slot_tile, sbuf, qmask, pose, fitness, local_cov, total)
    extra = [()] * sbuf.shape[0] if radar is None else [(r,) for r in radar]
    outs = [single(tmap, *(x[i] for x in per_lane), params, budget, max_iteration, *extra[i])
            for i in range(sbuf.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def p2p_register_lanes_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                             params: IcpParams, budget: maptiles.TileQueryBudget,
                             max_iteration: int):
    """Plain lane form of the P2P loop kernel: :func:`p2p_register_plain` on
    each lane, the outputs stacked (:func:`_register_lanes_plain`)."""
    return _register_lanes_plain(p2p_register_plain, tmap, slot_tile, sbuf, qmask, pose,
                                 fitness, local_cov, total, params, budget, max_iteration)


def p2p_register(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                 params: IcpParams, budget: maptiles.TileQueryBudget, max_iteration: int):
    """The P2P registration loop on the tile backend: :func:`p2p_register_plain`
    for CPU tensors, one launch of the loop kernel for CUDA ones. With a
    leading lane axis on the slots and the carry (a fleet frame): the loop
    kernel's lane form, or :func:`p2p_register_lanes_plain`."""
    if not _on_card(sbuf):
        plain = p2p_register_lanes_plain if sbuf.dim() == 4 else p2p_register_plain
        return plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params,
                     budget, max_iteration)
    return kernels.p2p_register(
        tmap.halo_points, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params,
        max_iteration, **tmap.search_geometry)


def _tile_register_plain(search, gicp, tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov,
                         total, params, budget, max_iteration, radar):
    """:func:`host_loop` of the plain search + reduction ``search`` (with the
    slot-packed ``radar`` when given) then :func:`gn_update_plain` from the
    carry (``gicp``: export local_cov)."""
    extra = () if radar is None else (radar,)

    def step(pose, fitness, local_cov):
        eq = search(tmap, slot_tile, sbuf, qmask, pose, params, budget, *extra)[:4]
        return gn_update_plain(*eq, pose, fitness, local_cov, total, params, gicp)

    return host_loop(step, pose, fitness, local_cov, max_iteration)


def gicp_register_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                        params: IcpParams, budget: maptiles.TileQueryBudget,
                        max_iteration: int, radar=None):
    """Plain PyTorch version of the GICP loop kernel
    (``kernels.gicp_register``): :func:`host_loop` of
    :func:`gicp_search_reduce_plain` (with the slot-packed ``radar`` when
    given) then :func:`gn_update_plain` with GICP's local_cov, from the
    carry. Returns (pose, local_cov, fitness, overlap, failed, iterations
    int32)."""
    return _tile_register_plain(gicp_search_reduce_plain, True, tmap, slot_tile, sbuf, qmask,
                                pose, fitness, local_cov, total, params, budget,
                                max_iteration, radar)


def vgicp_register_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                         params: IcpParams, budget: maptiles.TileQueryBudget,
                         max_iteration: int, radar=None):
    """Plain PyTorch version of the VGICP loop kernel
    (``kernels.vgicp_register``): :func:`host_loop` of
    :func:`vgicp_search_reduce_plain` then :func:`gn_update_plain`, as
    :func:`gicp_register_plain` (local_cov stays as given)."""
    return _tile_register_plain(vgicp_search_reduce_plain, False, tmap, slot_tile, sbuf,
                                qmask, pose, fitness, local_cov, total, params, budget,
                                max_iteration, radar)


def gicp_register_lanes_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                              params: IcpParams, budget: maptiles.TileQueryBudget,
                              max_iteration: int, radar=None):
    """Plain lane form of the GICP loop kernel: :func:`gicp_register_plain`
    on each lane (each with its lane of ``radar`` [B, S, QB, 3, 3] when
    given), the outputs stacked, local_cov per lane."""
    return _register_lanes_plain(gicp_register_plain, tmap, slot_tile, sbuf, qmask, pose,
                                 fitness, local_cov, total, params, budget, max_iteration,
                                 radar)


def vgicp_register_lanes_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                               params: IcpParams, budget: maptiles.TileQueryBudget,
                               max_iteration: int, radar=None):
    """Plain lane form of the VGICP loop kernel: :func:`vgicp_register_plain`
    on each lane (with its radar lane when given), the outputs stacked."""
    return _register_lanes_plain(vgicp_register_plain, tmap, slot_tile, sbuf, qmask, pose,
                                 fitness, local_cov, total, params, budget, max_iteration,
                                 radar)


def _cov_register_plain(single, lanes_plain, tmap, slot_tile, sbuf, qmask, pose, fitness,
                        local_cov, total, params, budget, max_iteration, radar):
    """A covariance method's loop on CPU tensors: its plain version, or with
    a lane axis on the slots (a fleet frame: ``sbuf`` [B, S, QB, 3]) its
    plain lane form."""
    plain = lanes_plain if sbuf.dim() == 4 else single
    return plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params,
                 budget, max_iteration, radar)


def gicp_register(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                  params: IcpParams, budget: maptiles.TileQueryBudget, max_iteration: int,
                  radar=None):
    """The GICP registration loop on the tile backend:
    :func:`gicp_register_plain` for CPU tensors, one launch of the loop
    kernel for CUDA ones. With a leading lane axis on the slots and the
    carry (a fleet frame): the loop kernel's lane form, or
    :func:`gicp_register_lanes_plain`."""
    if not _on_card(sbuf):
        return _cov_register_plain(gicp_register_plain, gicp_register_lanes_plain, tmap,
                                   slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                                   params, budget, max_iteration, radar)
    return kernels.gicp_register(
        tmap.halo_points, tmap.halo_point_cov, tmap.halo_point_cov_mean, slot_tile, sbuf,
        qmask, pose, fitness, local_cov, total, params, max_iteration, radar=radar,
        **tmap.search_geometry)


def vgicp_register(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                   params: IcpParams, budget: maptiles.TileQueryBudget, max_iteration: int,
                   radar=None):
    """The VGICP registration loop on the tile backend:
    :func:`vgicp_register_plain` for CPU tensors, one launch of the loop
    kernel for CUDA ones; a fleet frame's as :func:`gicp_register`."""
    if not _on_card(sbuf):
        return _cov_register_plain(vgicp_register_plain, vgicp_register_lanes_plain, tmap,
                                   slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                                   params, budget, max_iteration, radar)
    return kernels.vgicp_register(
        tmap.halo_vox_mean, tmap.halo_vox_cov, tmap.halo_vox_coord, slot_tile, sbuf, qmask,
        pose, fitness, local_cov, total, params, max_iteration, radar=radar,
        **tmap.search_geometry)


def avgicp_register_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                          params: IcpParams, budget: maptiles.TileQueryBudget,
                          max_iteration: int, radar=None):
    """Plain PyTorch version of the AVGICP loop kernel
    (``kernels.avgicp_register``): :func:`host_loop` of
    :func:`avgicp_search_reduce_plain` (with the slot-packed ``radar`` when
    given) then :func:`gn_update_plain` from the carry. Returns (pose,
    local_cov, fitness, overlap, failed, iterations int32)."""
    return _tile_register_plain(avgicp_search_reduce_plain, False, tmap, slot_tile, sbuf,
                                qmask, pose, fitness, local_cov, total, params, budget,
                                max_iteration, radar)


def avgicp_register_lanes_plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov,
                                total, params: IcpParams, budget: maptiles.TileQueryBudget,
                                max_iteration: int, radar=None):
    """Plain lane form of the AVGICP loop kernel: :func:`avgicp_register_plain`
    on each lane (with its radar lane when given), the outputs stacked."""
    return _register_lanes_plain(avgicp_register_plain, tmap, slot_tile, sbuf, qmask, pose,
                                 fitness, local_cov, total, params, budget, max_iteration,
                                 radar)


def avgicp_register(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                    params: IcpParams, budget: maptiles.TileQueryBudget, max_iteration: int,
                    radar=None):
    """The AVGICP registration loop on the tile backend:
    :func:`avgicp_register_plain` for CPU tensors, one launch of the loop
    kernel for CUDA ones (its gate runs in world coordinates: no window
    anchor); a fleet frame's as :func:`gicp_register`."""
    if not _on_card(sbuf):
        return _cov_register_plain(avgicp_register_plain, avgicp_register_lanes_plain, tmap,
                                   slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                                   params, budget, max_iteration, radar)
    return kernels.avgicp_register(
        tmap.halo_vox_mean, tmap.halo_vox_cov, tmap.halo_vox_coord, slot_tile, sbuf, qmask,
        pose, fitness, local_cov, total, params, max_iteration, voxel_size=tmap.voxel_size,
        radar=radar)


# --------------------------------------------------------------------------- #
# The hash backend's GN iteration (kernel Q)
# --------------------------------------------------------------------------- #

def hash_search_reduce_plain(grid, src, valid, pose, params: IcpParams, method: int,
                             radar=None):
    """Plain PyTorch version of kernel Q's fused entry: one RunRegister loop
    body on the hash grid (icp.py:429-467). The queries q = R s + t (in
    :func:`transform_slots`' order) go through the method's grid query, the
    matches are masked by ``valid``, then the method's tail; AVGICP's radar
    form takes the flattened per-pair :func:`_voxcov_tail`. ``radar``
    [N, 3, 3] in query order or None. Returns (matched, JTJ, JTr, fit_num)."""
    q = transform_slots(pose, src)
    md = params.max_search_dist
    if method == int(IcpMethod.P2P):
        target, ok, _, _ = mapgrid.query_nearest_point_plain(grid, q, md)
        return _p2p_tail(pose, src, target, ok & valid, params)
    if method == int(IcpMethod.GICP):
        _, cov, mean, ok = mapgrid.query_nearest_point_cov_plain(grid, q, md)
        return _gicp_tail(pose, src, cov, mean, ok & valid, params, radar)
    if method == int(IcpMethod.VGICP):
        cov, mean, ok = mapgrid.query_nearest_voxel_cov_plain(grid, q, md)
        return _voxcov_tail(pose, src, cov, mean, ok & valid, params, radar)
    cov, mean, ok = mapgrid.query_all_voxel_cov_plain(grid, q, md)
    ok = ok & valid[:, None]
    if radar is None:
        return _avg_voxcov_tail(pose, src, q, cov, mean, ok, params)
    return _voxcov_tail(pose, torch.repeat_interleave(src, 7, dim=0), cov.reshape(-1, 3, 3),
                        mean.reshape(-1, 3), ok.reshape(-1), params,
                        torch.repeat_interleave(radar, 7, dim=0))


def gn_iteration_hash(method: int, grid, src, valid, pose, fitness, local_cov, total,
                      params: IcpParams, radar=None):
    """One GN iteration on the hash backend: on a CPU tensor
    :func:`hash_search_reduce_plain` and :func:`gn_update_plain`; on a CUDA
    one kernel Q (the search + reduction from the current pose), then kernel
    M, on the same stream. Returns (pose, local_cov, fitness, overlap, stop,
    failed)."""
    gicp = method == int(IcpMethod.GICP)
    carry = (pose, fitness, local_cov, total, params)
    if not _on_card(src):
        return gn_update_plain(
            *hash_search_reduce_plain(grid, src, valid, pose, params, method, radar),
            *carry, gicp)
    sums = kernels.hash_correspond(grid, src, valid, pose, params.max_search_dist,
                                   IcpMethod(method).name, radar)
    return kernels.gn_step(sums, *carry, gicp)


def hash_register_plain(method: int, grid, src, valid, pose, fitness, local_cov, total,
                        params: IcpParams, max_iteration: int, radar=None):
    """Plain PyTorch version of the hash loop kernel (``kernels.hash_register``):
    :func:`host_loop` of :func:`hash_search_reduce_plain` (``radar`` [N,3,3]
    in query order or None) then :func:`gn_update_plain` from the carry.
    Returns (pose, local_cov, fitness, overlap, failed, iterations int32)."""
    gicp = method == int(IcpMethod.GICP)

    def step(pose, fitness, local_cov):
        return gn_update_plain(
            *hash_search_reduce_plain(grid, src, valid, pose, params, method, radar), pose,
            fitness, local_cov, total, params, gicp)

    return host_loop(step, pose, fitness, local_cov, max_iteration)


def hash_register_lanes_plain(method: int, grid, src, valid, pose, fitness, local_cov, total,
                              params: IcpParams, max_iteration: int, radar=None):
    """Plain lane form of the hash loop kernel: :func:`hash_register_plain`
    on each lane of a fleet frame (``src`` [B, N, 3], ``valid`` [B, N], the
    carry, ``total`` and ``radar`` [B, N, 3, 3] with a lane axis), the
    outputs stacked; each lane iterates until its own gates release."""
    outs = [hash_register_plain(method, grid, src[i], valid[i], pose[i], fitness[i],
                                local_cov[i], total[i], params, max_iteration,
                                None if radar is None else radar[i])
            for i in range(src.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def hash_register(method: int, grid, src, valid, pose, fitness, local_cov, total,
                  params: IcpParams, max_iteration: int, radar=None):
    """The registration loop on the hash backend: :func:`hash_register_plain`
    for CPU tensors, one launch of the loop kernel for CUDA ones. With a
    leading lane axis on the scan and the carry (a fleet frame): the loop
    kernel's lane form, or :func:`hash_register_lanes_plain`."""
    if not _on_card(src):
        plain = hash_register_lanes_plain if src.dim() == 3 else hash_register_plain
        return plain(method, grid, src, valid, pose, fitness, local_cov, total, params,
                     max_iteration, radar)
    return kernels.hash_register(grid, src, valid, pose, fitness, local_cov, total, params,
                                 max_iteration, IcpMethod(method).name, radar)


def radar_points(src_local, pose, params: IcpParams):
    """:func:`radar_point_cov` of the scan at the world pose, in query order
    [N, 3, 3] (icp.py:619-623): :func:`radar_slots` on the rows 0..N-1, given
    as no index and no mask (kernel X on the card: no index or mask tensor
    is made)."""
    return radar_slots(src_local, None, None, pose, params)


def _tile_loop(method: int):
    """The tile backend's registration loop of ``method``, looked up in this
    module at each call (a wrapper set on the module is the one called)."""
    return {int(IcpMethod.P2P): p2p_register, int(IcpMethod.GICP): gicp_register,
            int(IcpMethod.VGICP): vgicp_register, int(IcpMethod.AVGICP): avgicp_register}[method]


# --------------------------------------------------------------------------- #
# RunRegister (cpp:273-418)
# --------------------------------------------------------------------------- #

def run_register(src_local, src_valid, tmap, initial_guess, params: IcpParams,
                 static: IcpStatic, mark=None) -> IcpResult:
    """Register a sensor-frame scan [N,3] (mask [N]) against the map (a
    ``TileMap`` on the tile backend, a ``MapGrid`` on the hash backend) from
    a global initial pose [4,4]. ``mark(name)``, when given, is called
    after the set-up (the slot assignment and the radar covariances,
    "assign") and after the GN loop ("gn"). A scan [B, N, 3] with a pose
    [B, 4, 4] is a fleet frame's B registrations (:func:`run_register_lanes`)."""
    check_supported(static)
    if src_local.dim() == 3:
        return run_register_lanes(src_local, src_valid, tmap, initial_guess, params, static,
                                  mark)
    dtype = src_local.dtype
    dev = src_local.device
    pose_world = initial_guess.to(dtype)
    total = torch.clamp(torch.sum(src_valid), min=1).to(dtype)
    use_radar = static.use_radar_cov and static.method != int(IcpMethod.P2P)

    if static.backend == "hash":
        # world coordinates, no window origin (icp.py:630: the grid has none)
        origin = None
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        radar = radar_points(src_local, pose_world, params) if use_radar else None
        pose = pose_world
    else:
        origin = tmap.origin.to(dtype)
        pose = pose_world.clone()
        pose[:2, 3] -= origin
        asg = maptiles.assign_slots(tmap, lie.transform_points(pose, src_local),
                                    src_valid, static.tile_budget)
        dropped = asg.dropped.to(torch.int32)
        n = src_local.shape[0]
        safe_idx = torch.clamp(asg.qidx.to(torch.int64), max=n - 1)
        sbuf = torch.where(asg.qmask[..., None], src_local[safe_idx],
                           torch.zeros((), dtype=dtype, device=dev))
        # once per registration, from the WORLD initial pose (before the
        # window-origin shift), packed into the slot layout
        radar = (radar_slots(src_local, asg.qidx, asg.qmask, pose_world, params)
                 if use_radar else None)
    if mark is not None:
        mark("assign")

    fitness = torch.zeros((), dtype=dtype, device=dev)
    local_cov = torch.eye(6, dtype=dtype, device=dev)
    carry = (pose, fitness, local_cov, total, params)
    if static.backend == "hash":
        # the whole loop in one call: no readback on the card
        loop = hash_register(static.method, tmap, src_local, src_valid, *carry,
                             static.max_iteration, radar)
    elif static.method == int(IcpMethod.P2P):
        loop = p2p_register(tmap, asg.slot_tile, sbuf, asg.qmask, *carry, static.tile_budget,
                            static.max_iteration)
    else:
        loop = _tile_loop(static.method)(tmap, asg.slot_tile, sbuf, asg.qmask, *carry,
                                          static.tile_budget, static.max_iteration, radar)
    pose, local_cov, fitness, overlap, failed, iterations = loop
    if mark is not None:
        mark("gn")

    if origin is not None:
        pose = pose.clone()
        pose[:2, 3] += origin
    return IcpResult(
        pose=pose,
        success=~failed & (fitness <= params.max_fitness_score),
        fitness=fitness,
        local_cov=local_cov,
        iterations=iterations,
        overlap=overlap,
        dropped=dropped,
    )


def _in_launches(loop, lanes: int, per_lane):
    """``loop(*per_lane)`` on a fleet frame's ``lanes`` registrations, in
    runs of at most ``kernels.MAX_LANES`` lanes (one launch of a loop
    kernel's lane form takes at most that many, csrc/gn_loop.cuh
    kMaxLanes), the outputs concatenated on the lane axis. The lanes are
    independent, so each lane's result is the same in any run."""
    step = kernels.MAX_LANES
    if lanes <= step:
        return loop(*per_lane)
    parts = [loop(*(None if x is None else x[k:k + step] for x in per_lane))
             for k in range(0, lanes, step)]
    return tuple(torch.cat(x) for x in zip(*parts))


def run_register_lanes(src_local, src_valid, tmap, initial_guess, params: IcpParams,
                       static: IcpStatic, mark=None) -> IcpResult:
    """A fleet frame's registrations (JAX's vmap of run_register inside
    replay_fused_fleet, parallel/sharding.py:256-281): B scans [B, N, 3]
    (masks [B, N]) from B global initial poses [B, 4, 4] against the one
    map, by P2P, GICP, VGICP or AVGICP, on the tile or the hash backend,
    with or without the radar covariances. The set-up (on tiles the origin
    shift, the query transform, kernel B's lane form, the clamp and the
    gather of the slot blocks; on the hash grid none: the world pose,
    ``dropped`` zeros; the radar rows from the world pose, kernel X's lane
    form) and the pose / success tail run batched over the lanes, the GN
    loops as one launch of the loop kernel's lane form
    (:func:`p2p_register`, :func:`gicp_register`, :func:`vgicp_register`,
    :func:`avgicp_register`, :func:`hash_register`) for every
    ``kernels.MAX_LANES`` lanes (:func:`_in_launches`); every field of the
    result has a leading lane axis (GICP's local_cov per lane)."""
    dtype = src_local.dtype
    dev = src_local.device
    lanes, n = src_local.shape[:2]
    total = torch.clamp(torch.sum(src_valid, dim=-1), min=1).to(dtype)
    use_radar = static.use_radar_cov and static.method != int(IcpMethod.P2P)
    pose_world = initial_guess.to(dtype).contiguous()
    fitness = torch.zeros(lanes, dtype=dtype, device=dev)
    local_cov = torch.eye(6, dtype=dtype, device=dev).repeat(lanes, 1, 1)

    if static.backend == "hash":
        # world coordinates, no window origin, no assignment (icp.py:630)
        origin = None
        dropped = torch.zeros(lanes, dtype=torch.int32, device=dev)
        radar = radar_points(src_local, pose_world, params) if use_radar else None

        def loop(src, valid, pose, fitness, local_cov, total, radar):
            return hash_register(static.method, tmap, src, valid, pose, fitness, local_cov,
                                 total, params, static.max_iteration, radar)

        per_lane = (src_local, src_valid, pose_world, fitness, local_cov, total, radar)
    else:
        origin = tmap.origin.to(dtype)
        pose = pose_world.clone()
        pose[:, :2, 3] -= origin
        asg = maptiles.assign_slots(tmap, lie.transform_points(pose, src_local), src_valid,
                                    static.tile_budget)
        dropped = asg.dropped.to(torch.int32)
        safe_idx = torch.clamp(asg.qidx.to(torch.int64), max=n - 1)
        rows = torch.arange(lanes, device=dev)[:, None, None]
        sbuf = torch.where(asg.qmask[..., None], src_local[rows, safe_idx],
                           torch.zeros((), dtype=dtype, device=dev))
        # from the WORLD initial poses, packed into each lane's slot layout
        radar = (radar_slots(src_local, asg.qidx, asg.qmask, pose_world, params)
                 if use_radar else None)

        def loop(slot_tile, sbuf, qmask, pose, fitness, local_cov, total, radar):
            extra = () if radar is None else (radar,)
            return _tile_loop(static.method)(tmap, slot_tile, sbuf, qmask, pose, fitness,
                                             local_cov, total, params, static.tile_budget,
                                             static.max_iteration, *extra)

        per_lane = (asg.slot_tile, sbuf, asg.qmask, pose, fitness, local_cov, total, radar)
    if mark is not None:
        mark("assign")

    pose, local_cov, fitness, overlap, failed, iterations = _in_launches(loop, lanes, per_lane)
    if mark is not None:
        mark("gn")

    if origin is not None:
        pose = pose.clone()
        pose[:, :2, 3] += origin
    return IcpResult(
        pose=pose,
        success=~failed & (fitness <= params.max_fitness_score),
        fitness=fitness,
        local_cov=local_cov,
        iterations=iterations,
        overlap=overlap,
        dropped=dropped,
    )


def calculate_velocity(transform, dt):
    """Rigid transform over dt -> (linear, angular) velocity (reference:
    CalculateVelocity, registration.hpp:167-184)."""
    return transform[:3, 3] / dt, lie.so3_log(transform[:3, :3]) / dt


def separate_points_z(points, valid, z):
    """Split a masked point set by z (reference: SeperatePointsZ,
    registration.hpp:150-165). Returns (up_mask, down_mask)."""
    above = points[:, 2] > z
    return valid & above, valid & ~above
