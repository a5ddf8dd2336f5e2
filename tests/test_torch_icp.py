"""Port parity: elimaloc_tpu_torch.register.run_register (P2P, tile backend)
vs elimaloc_tpu.register.run_register, on the perturbed-pose case of
tests/test_icp.py:183-211 (~0.5 m / ~3 deg initial error).

Bounds: float64 pose atol 1e-9 with equal iteration counts and success
flags (the host loop with one readback per iteration is the while_loop
exactly; only rounding-order ulps differ); float32 pose atol 1e-4 m (the
float32 GN sums round differently over ~1k rows and the loop re-linearizes
on them) with equal iteration counts. The plain version of kernel M
(``gn_update_plain``, the loop body after the reduction) is held to the JAX
loop body on the normal equations of a recorded P2P and GICP iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.config import IcpMethod, PcmConfig
from elimaloc_tpu.map import TileQueryBudget, build_tile_map, build_voxel_map
from elimaloc_tpu.ops import lie as jlie
from elimaloc_tpu.register import icp as jicp
from elimaloc_tpu.register import make_icp_params, make_icp_static, run_register
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.register import icp as ticp
from test_icp import make_scan, make_world, pose_xyzyaw
from torch_parity import flatten

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-9),
          "f32": (jnp.float32, torch.float32, 1e-4)}


@pytest.mark.parametrize("init", ["perturbed", "aligned"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_run_register_p2p(dt_name, init):
    jdt, tdt, atol = DTYPES[dt_name]
    map_pts = make_world()
    true_pose = pose_xyzyaw(3.0, 1.0, 0.0, 0.5)
    init_pose = (pose_xyzyaw(3.4, 0.7, 0.1, 0.55) if init == "perturbed"
                 else true_pose)
    cfg = PcmConfig(icp_method=IcpMethod.P2P)
    built = build_voxel_map(map_pts, cfg.pcm_voxel_size, cfg.pcm_voxel_max_point,
                            use_native=False)
    jmap = build_tile_map(built, tile_voxels=4).to_device(dtype=jdt)
    scan = make_scan(map_pts, true_pose, n=1024)
    jparams = make_icp_params(cfg, dtype=jdt)
    jstatic = make_icp_static(cfg, tile_budget=TileQueryBudget(qb=32, max_slots=1024))
    jres = jax.jit(run_register, static_argnums=5)(
        jnp.asarray(scan, jdt), jnp.ones(len(scan), bool), jmap,
        jnp.asarray(init_pose, jdt), jparams, jstatic)

    tstatic = ticp.make_icp_static(
        tconfig.PcmConfig(icp_method=tconfig.IcpMethod.P2P),
        tile_budget=ttiles.TileQueryBudget(qb=32, max_slots=1024))
    tres = ticp.run_register(
        torch.as_tensor(scan, dtype=tdt), torch.ones(len(scan), dtype=torch.bool),
        convert.tile_map(flatten(jmap), dtype=tdt), torch.as_tensor(init_pose, dtype=tdt),
        convert.icp_params(flatten(jparams), dtype=tdt), tstatic)

    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.success) == bool(jres.success)
    assert int(tres.dropped) == int(jres.dropped) == 0
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=atol)
    np.testing.assert_allclose(float(tres.fitness), float(jres.fitness), atol=atol)
    assert bool(tres.success)
    err = np.linalg.norm(tres.pose.numpy()[:3, 3] - true_pose[:3, 3])
    assert err < 0.08


@pytest.mark.parametrize("change", [
    # AVGICP's per-iteration reassignment (a halo margin 1 map) does not run
    dict(method=int(IcpMethod.AVGICP), reassign_each_iter=True),
    dict(corr_reuse=True), dict(reassign_each_iter=True),
    dict(psum_axis="sp"), dict(slot_shard_axis="sp"),
    # the hash backend runs (test_hash_backend_is_supported); its sharded
    # mode does not
    dict(backend="hash", psum_axis="sp"),
], ids=["avgicp", "corr_reuse", "reassign", "psum", "slot_shard", "hash"])
def test_unported_features_refuse(change):
    static = ticp.IcpStatic(**{"method": int(IcpMethod.P2P), **change})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ticp.check_supported(static)


@pytest.mark.parametrize("change", [
    dict(), dict(method=int(IcpMethod.AVGICP), reassign_each_iter=True),
    dict(corr_reuse=True),
], ids=["hash", "avgicp_reassign", "corr_reuse"])
def test_hash_backend_is_supported(change):
    """The hash backend runs (tests/test_torch_hash_register.py holds it to
    JAX's); as in JAX, corr_reuse and reassign_each_iter do nothing there.
    An unknown backend is an error."""
    ticp.check_supported(ticp.IcpStatic(**{"method": int(IcpMethod.P2P), "backend": "hash",
                                           **change}))
    with pytest.raises(ValueError, match="'tile' or 'hash'"):
        ticp.check_supported(ticp.IcpStatic(backend="octree"))


@pytest.mark.parametrize("method", [IcpMethod.GICP, IcpMethod.VGICP, IcpMethod.P2P],
                         ids=["gicp", "vgicp", "radar_cov"])
def test_radar_configurations_run(method, monkeypatch):
    """``use_radar_cov`` is supported: the radar forms of GICP and VGICP
    register with the slot-packed radar covariances computed once (the plain
    version of kernel P on CPU tensors); P2P has no radar term, as in JAX
    (``_p2p_tail`` takes none), and registers as without it."""
    map_pts = make_world()
    built = tbuilder.build_voxel_map(map_pts, 1.0, 30, use_native=False,
                                     compute_point_cov=method == IcpMethod.GICP,
                                     compute_voxel_cov=method == IcpMethod.VGICP)
    tmap = ttiles.build_tile_map(built, tile_voxels=4).to_device("cpu", torch.float64)
    true_pose = pose_xyzyaw(3.0, 1.0, 0.0, 0.5)
    scan = torch.as_tensor(make_scan(map_pts, true_pose, n=512))
    calls = []
    plain = ticp.radar_slots_plain
    monkeypatch.setattr(ticp, "radar_slots_plain",
                        lambda *a: calls.append(a[1].shape) or plain(*a))
    res = {}
    for radar in (True, False):
        cfg = tconfig.PcmConfig(icp_method=tconfig.IcpMethod(int(method)), use_radar_cov=radar,
                                max_fitness_score=2.0, max_iteration=3)
        static = ticp.make_icp_static(cfg, tile_budget=ttiles.TileQueryBudget(qb=32,
                                                                             max_slots=512))
        ticp.check_supported(static)
        res[radar] = ticp.run_register(scan, torch.ones(len(scan), dtype=torch.bool), tmap,
                                       torch.as_tensor(pose_xyzyaw(3.2, 0.8, 0.0, 0.52)),
                                       ticp.make_icp_params(cfg, torch.float64), static)
    same = torch.equal(res[True].pose, res[False].pose)
    if method == IcpMethod.P2P:
        assert same and calls == []
    else:
        assert not same and len(calls) == 1


def _jax_loop_body(matched, JTJ, JTr, fit_num, pose, fitness, local_cov, total, params,
                   gicp):
    """The JAX while-loop body after the reduction (icp.py:761-795), from the
    JAX package's own _solve_step, _step_transform, lie.compose and
    lie.so3_log."""
    dtype = pose.dtype
    fit = fit_num / jnp.maximum(matched, 1).astype(dtype)
    ratio = matched.astype(dtype) / total
    ok = ratio >= params.min_overlap_ratio
    x, reg = jicp._solve_step(JTJ, JTr, params.lm_lambda)
    x = jnp.where(ok, x, jnp.zeros_like(x))
    step_tf = jicp._step_transform(x)
    pose_new = jnp.where(ok, jlie.compose(pose, step_tf), pose)
    transform_norm = (jnp.linalg.norm(jlie.so3_log(step_tf[:3, :3]))
                      + jnp.linalg.norm(x[0:3]))
    done = ok & (transform_norm < params.termination_threshold)
    cov = jnp.where(ok, jnp.linalg.inv(reg), local_cov) if gicp else local_cov
    return pose_new, cov, jnp.where(ok, fit, fitness), ratio, done | ~ok, ~ok


@pytest.mark.parametrize("min_overlap", [0.5, 1.5], ids=["overlap_ok", "overlap_fails"])
@pytest.mark.parametrize("method", ["P2P", "GICP"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_gn_update_plain_matches_jax_loop_body(dt_name, method, min_overlap):
    """Kernel M's plain version against the JAX loop body on the normal
    equations of one recorded iteration (P2P and GICP on the perturbed case
    above): pose and fitness at this file's bounds, local_cov within rel
    1e-9 (f64) / 1e-4 (f32) of its largest entry, the flags equal."""
    jdt, tdt, atol = DTYPES[dt_name]
    map_pts = make_world()
    true_pose = pose_xyzyaw(3.0, 1.0, 0.0, 0.5)
    init_pose = pose_xyzyaw(3.4, 0.7, 0.1, 0.55)
    pcm = tconfig.PcmConfig(icp_method=tconfig.IcpMethod[method],
                            min_overlap_ratio=min_overlap)
    built = tbuilder.build_voxel_map(map_pts, pcm.pcm_voxel_size, pcm.pcm_voxel_max_point,
                                     use_native=False, compute_point_cov=method == "GICP",
                                     gicp_cov_search_dist=pcm.gicp_cov_search_dist)
    tmap = ttiles.build_tile_map(built, tile_voxels=4).to_device("cpu", tdt)
    scan = make_scan(map_pts, true_pose, n=1024)
    params = ticp.make_icp_params(pcm, dtype=tdt)
    budget = ttiles.TileQueryBudget(qb=32, max_slots=1024)
    src = torch.as_tensor(scan, dtype=tdt)
    pose = torch.as_tensor(init_pose, dtype=tdt)
    asg = ttiles.assign_slots(tmap, ticp.lie.transform_points(pose, src),
                              torch.ones(len(scan), dtype=torch.bool), budget)
    sbuf = torch.where(asg.qmask[..., None], src[asg.qidx.long().clamp(max=len(scan) - 1)],
                       torch.zeros((), dtype=tdt))
    m = int(tconfig.IcpMethod[method])
    sums = ticp.search_reduce(m, tmap, asg.slot_tile, sbuf, asg.qmask, pose, params, budget)
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 6))
    carry = (init_pose, 0.3, a @ a.T, float(len(scan)))
    gicp = method == "GICP"
    got = ticp.gn_update_plain(*sums, pose, torch.tensor(carry[1], dtype=tdt),
                               torch.as_tensor(carry[2], dtype=tdt),
                               torch.tensor(carry[3], dtype=tdt), params, gicp)
    jparams = make_icp_params(PcmConfig(icp_method=IcpMethod[method],
                                        min_overlap_ratio=min_overlap), dtype=jdt)
    want = _jax_loop_body(*(jnp.asarray(x.numpy()) for x in sums[:1]),
                          *(jnp.asarray(x.numpy(), jdt) for x in sums[1:]),
                          *(jnp.asarray(x, jdt) for x in carry), jparams, gicp)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=atol)
    cov_scale = float(np.abs(np.asarray(want[1])).max())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=cov_scale * (1e-9 if dt_name == "f64" else 1e-4))
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    for g, w in zip(got[4:], want[4:]):
        assert bool(g) == bool(w)
    assert bool(got[5]) == (min_overlap > 1.0)
    assert (not torch.equal(got[1], torch.as_tensor(carry[2], dtype=tdt))) == (
        gicp and min_overlap == 0.5)
