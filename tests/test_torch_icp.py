"""Port parity: elimaloc_tpu_torch.register.run_register (P2P, tile backend)
vs elimaloc_tpu.register.run_register, on the perturbed-pose case of
tests/test_icp.py:183-211 (~0.5 m / ~3 deg initial error).

Bounds: float64 pose atol 1e-9 with equal iteration counts and success
flags (the host loop with one readback per iteration is the while_loop
exactly; only rounding-order ulps differ); float32 pose atol 1e-4 m (the
float32 GN sums round differently over ~1k rows and the loop re-linearizes
on them) with equal iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.config import IcpMethod, PcmConfig
from elimaloc_tpu.map import TileQueryBudget, build_tile_map, build_voxel_map
from elimaloc_tpu.register import make_icp_params, make_icp_static, run_register
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch import config as tconfig
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
    # the methods run; their radar forms and AVGICP's per-iteration
    # reassignment (a halo margin 1 map) do not
    dict(method=int(IcpMethod.GICP), use_radar_cov=True),
    dict(method=int(IcpMethod.VGICP), use_radar_cov=True),
    dict(method=int(IcpMethod.AVGICP), reassign_each_iter=True), dict(backend="hash"),
    dict(corr_reuse=True), dict(reassign_each_iter=True),
    dict(use_radar_cov=True), dict(psum_axis="sp"), dict(slot_shard_axis="sp"),
], ids=["gicp", "vgicp", "avgicp", "hash", "corr_reuse", "reassign",
        "radar_cov", "psum", "slot_shard"])
def test_unported_features_refuse(change):
    static = ticp.IcpStatic(**{"method": int(IcpMethod.P2P), **change})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ticp.check_supported(static)
