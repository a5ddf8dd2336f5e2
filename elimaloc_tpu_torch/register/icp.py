"""Scan-to-map registration, P2P on the tile backend — port of
``elimaloc_tpu/register/icp.py`` (reference: registration.cpp).

``run_register`` assigns the scan to tile slots once from the initial guess
(the hoisted assignment, icp.py:660-675) and runs the GN/LM loop on the host:
one search + P2P reduction per iteration, the LM-damped 6x6 solve, the SE(3)
step, the overlap and termination gates, and ONE scalar readback per
iteration (``done | failed``) to decide whether to go on. That is the
``lax.while_loop`` exactly: same trip count, same carry. The window-origin
conjugation (icp.py:630-632, 824-825) is kept; it is a zero shift for full
maps.

One GN iteration's search + reduction is :func:`p2p_search_reduce`: kernel A
(csrc/correspond.cu) on a CUDA tensor, :func:`p2p_search_reduce_plain` (the
composition of ``tiles.nearest_point_slots`` and :func:`_p2p_tail`) on a CPU
tensor.

Not ported, refused with NotImplementedError: GICP / VGICP / AVGICP and the
radar covariances (ROADMAP Queue 1 #11), the hash backend (#13), the
correspondence-reuse and per-iteration reassignment loops (ROADMAP "Not
ported") and the sharded modes (#19).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..config import IcpMethod, PcmConfig
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
    """Static registration switches (icp.py:67-110); the port runs
    ``method=P2P``, ``backend="tile"`` with the hoisted assignment."""

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
    local_cov: torch.Tensor   # [6,6], identity for P2P (cpp:280)
    iterations: torch.Tensor  # int32
    overlap: torch.Tensor     # last correspondence ratio
    dropped: torch.Tensor     # queries dropped on tile-slot overflow


def check_supported(static: IcpStatic) -> None:
    """Refuse what the port does not run yet, naming the ROADMAP item."""
    if static.method != int(IcpMethod.P2P):
        raise NotImplementedError(
            f"ICP method {IcpMethod(static.method).name}: only P2P is ported "
            "(GICP/VGICP/AVGICP are ROADMAP Queue 1 #11)")
    if static.backend != "tile":
        raise NotImplementedError(
            f"backend={static.backend!r}: only the tile backend is ported "
            "(the hash grid is ROADMAP Queue 1 #13)")
    if static.use_radar_cov:
        raise NotImplementedError("use_radar_cov is ROADMAP Queue 1 #11")
    if static.corr_reuse or static.reassign_each_iter:
        raise NotImplementedError(
            "corr_reuse / reassign_each_iter are not ported (ROADMAP "
            "'Not ported'): the port searches every iteration on the hoisted "
            "assignment")
    if static.psum_axis is not None or static.slot_shard_axis is not None:
        raise NotImplementedError(
            "psum_axis / slot_shard_axis: multi-device registration is "
            "ROADMAP Queue 1 #19")


# --------------------------------------------------------------------------- #
# One GN iteration: search + P2P reduction
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


def p2p_search_reduce(tmap, slot_tile, sbuf, qmask, pose, params: IcpParams,
                      budget: maptiles.TileQueryBudget):
    """One GN iteration's search + reduction -> (matched, JTJ, JTr, fit_num).
    Kernel A on CUDA, the plain version on CPU."""
    if sbuf.device.type == "cpu":
        return p2p_search_reduce_plain(tmap, slot_tile, sbuf, qmask, pose,
                                       params, budget)[:4]
    sums, _, _ = kernels.p2p_correspond(
        tmap.halo_points, slot_tile, sbuf, qmask, pose, params.max_search_dist,
        voxel_size=tmap.voxel_size, tile_size=tmap.tile_size, tx0=tmap.tx0,
        ty0=tmap.ty0, ty_dim=tmap.ty_dim)
    return assemble_p2p(sums)


def _solve_step(JTJ, JTr, lm_lambda):
    """LM-damped solve (cpp:55-56) -> (x, regularized JTJ). ``solve_ex``
    leaves singular systems unchecked, like the JAX solve, and never syncs."""
    reg = JTJ + lm_lambda * torch.diag(torch.diagonal(JTJ))
    x = torch.linalg.solve_ex(reg, JTr)[0]
    return x, reg


def _step_transform(x):
    """6-vector -> small SE(3) transform (cpp:58-62)."""
    return lie.make_transform(lie.so3_exp(x[3:6]), x[0:3])


# --------------------------------------------------------------------------- #
# RunRegister (cpp:273-418)
# --------------------------------------------------------------------------- #

def run_register(src_local, src_valid, tmap: maptiles.TileMap, initial_guess,
                 params: IcpParams, static: IcpStatic, mark=None) -> IcpResult:
    """Register a sensor-frame scan [N,3] (mask [N]) against the tile map
    from a global initial pose [4,4]. ``mark(name)``, when given, is called
    after the slot assignment ("assign") and after the GN loop ("gn")."""
    check_supported(static)
    dtype = src_local.dtype
    pose0 = initial_guess.to(dtype)
    total = torch.clamp(torch.sum(src_valid), min=1).to(dtype)

    origin = tmap.origin.to(dtype)
    pose0 = pose0.clone()
    pose0[:2, 3] -= origin

    asg = maptiles.assign_slots(tmap, lie.transform_points(pose0, src_local),
                                src_valid, static.tile_budget)
    n = src_local.shape[0]
    safe_idx = torch.clamp(asg.qidx.to(torch.int64), max=n - 1)
    sbuf = torch.where(asg.qmask[..., None], src_local[safe_idx],
                       torch.zeros((), dtype=dtype, device=src_local.device))
    if mark is not None:
        mark("assign")

    pose = pose0
    fitness = torch.zeros((), dtype=dtype, device=src_local.device)
    overlap = torch.zeros((), dtype=dtype, device=src_local.device)
    it = 0
    while it < static.max_iteration:
        matched, JTJ, JTr, fit_num = p2p_search_reduce(
            tmap, asg.slot_tile, sbuf, asg.qmask, pose, params,
            static.tile_budget)
        fit = fit_num / torch.clamp(matched, min=1).to(dtype)
        ratio = matched.to(dtype) / total
        overlap_ok = ratio >= params.min_overlap_ratio

        x, _ = _solve_step(JTJ, JTr, params.lm_lambda)
        x = torch.where(overlap_ok, x, torch.zeros_like(x))
        step_tf = _step_transform(x)
        pose = torch.where(overlap_ok, lie.compose(pose, step_tf), pose)

        rot_norm = lie.norm(lie.so3_log(step_tf[:3, :3]))
        transform_norm = rot_norm + lie.norm(x[0:3])
        done = overlap_ok & (transform_norm < params.termination_threshold)
        fitness = torch.where(overlap_ok, fit, fitness)
        overlap = ratio
        it += 1
        failed = ~overlap_ok
        if bool(done | failed):      # the one readback per iteration
            break
    if mark is not None:
        mark("gn")

    pose = pose.clone()
    pose[:2, 3] += origin
    failed = ~overlap_ok if it > 0 else torch.zeros((), dtype=torch.bool,
                                                    device=src_local.device)
    return IcpResult(
        pose=pose,
        success=~failed & (fitness <= params.max_fitness_score),
        fitness=fitness,
        local_cov=torch.eye(6, dtype=dtype, device=src_local.device),
        iterations=torch.full((), it, dtype=torch.int32, device=src_local.device),
        overlap=overlap,
        dropped=asg.dropped.to(torch.int32),
    )
