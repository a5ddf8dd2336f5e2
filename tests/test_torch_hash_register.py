"""Port parity: ``run_register`` on the hash backend (elimaloc_tpu_torch) against
elimaloc_tpu's, and the port's tile backend against its hash backend.

* Per method (P2P, GICP, VGICP, AVGICP), from a perturbed pose (~0.5 m,
  ~3 deg) on the ``test_icp`` world: iterations and success equal, pose
  within 1e-6 and fitness within 1e-9 in float64; in float32 iterations
  equal and pose within 1e-4 m (the float32 GN sums round differently over
  ~1k rows).
* The radar forms (``use_radar_cov``) in a map frame 1 km off the origin,
  where the reference's world-frame radar model is well-posed
  (tests/test_torch_radar.py says why): float64, iterations and success
  equal, pose within 1e-6.
* The port's own tile backend against its hash backend, as
  tests/test_tiles.py:158-251 holds JAX's (at 30 points a voxel, the
pipeline's default, against their 60: the plain CPU search gathers every
voxel's M slots): a P2P long walk (1.3 m initial
  error, 30 iterations) where both converge within 0.15 m of the truth and
  within 2 cm of each other, and AVGICP on a halo margin 2 map (the hoisted
  assignment exact; the hash backend looks the voxels up from the current
  pose every iteration) within 1e-4 m of the hash backend from three
  initial offsets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.config import IcpMethod, PcmConfig
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import grid as jgrid
from elimaloc_tpu.register import icp as jicp
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.register import icp as ticp
from test_icp import make_scan, make_world, pose_xyzyaw
from torch_parity import flatten, one_torch_thread  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-6),
          "f32": (jnp.float32, torch.float32, 1e-4)}
METHODS = ("P2P", "GICP", "VGICP", "AVGICP")
FAR = np.array([1000.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def world():
    pts = make_world()
    jb = jbuilder.build_voxel_map(pts, 1.0, 30, compute_voxel_cov=True,
                                  compute_point_cov=True, use_native=False)
    return pts, jb


def _cfg(method, radar=False):
    kw = dict(icp_method=IcpMethod[method], use_radar_cov=radar)
    if method in ("VGICP", "AVGICP"):
        kw["max_fitness_score"] = 2.0
    return PcmConfig(**kw), tconfig.PcmConfig(
        **{**kw, "icp_method": tconfig.IcpMethod[method]})


def _register_both(jb, scan, init_pose, method, jdt, tdt, radar=False):
    jcfg, tcfg = _cfg(method, radar)
    jparams = jicp.make_icp_params(jcfg, dtype=jdt)
    jres = jax.jit(jicp.run_register, static_argnums=5)(
        jnp.asarray(scan, jdt), jnp.ones(len(scan), bool),
        jgrid.to_device(jb, dtype=jdt), jnp.asarray(init_pose, jdt), jparams,
        jicp.make_icp_static(jcfg, backend="hash"))
    tres = ticp.run_register(
        torch.as_tensor(scan, dtype=tdt), torch.ones(len(scan), dtype=torch.bool),
        convert.map_grid(flatten(jgrid.to_device(jb, dtype=jdt)), dtype=tdt),
        torch.as_tensor(init_pose, dtype=tdt), convert.icp_params(flatten(jparams), dtype=tdt),
        ticp.make_icp_static(tcfg, backend="hash"))
    return jres, tres


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("method", METHODS)
def test_run_register_hash_matches_jax(world, method, dt_name):
    jdt, tdt, atol = DTYPES[dt_name]
    pts, jb = world
    true_pose = pose_xyzyaw(3.0, 1.0, 0.0, 0.5)
    scan = make_scan(pts, true_pose, n=1024)
    jres, tres = _register_both(jb, scan, pose_xyzyaw(3.4, 0.7, 0.1, 0.55), method, jdt, tdt)
    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.success) == bool(jres.success)
    assert int(tres.dropped) == int(jres.dropped) == 0
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), rtol=0, atol=atol)
    if dt_name == "f64":
        np.testing.assert_allclose(float(tres.fitness), float(jres.fitness), rtol=0,
                                   atol=1e-9)
    assert bool(tres.success)
    # AVGICP does not converge within 10 iterations here: tests/test_icp.py's
    # AVGICP truth bound
    gate = 0.45 if method == "AVGICP" else 0.1
    assert np.linalg.norm(tres.pose.numpy()[:3, 3] - true_pose[:3, 3]) < gate


@pytest.mark.parametrize("method", METHODS[1:])
def test_run_register_hash_radar_far_from_origin(world, method):
    pts, _ = world
    far = pts + FAR
    jb = jbuilder.build_voxel_map(far, 1.0, 30, compute_voxel_cov=method != "GICP",
                                  compute_point_cov=method == "GICP", use_native=False)
    true_pose = pose_xyzyaw(*(FAR[:2] + [3.0, 1.0]), 0.0, 0.5)
    scan = make_scan(far, true_pose, n=1024)
    init = pose_xyzyaw(*(FAR[:2] + [3.4, 0.7]), 0.1, 0.55)
    jres, tres = _register_both(jb, scan, init, method, jnp.float64, torch.float64, radar=True)
    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.success) == bool(jres.success)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), rtol=0, atol=1e-6)
    assert np.isfinite(tres.pose.numpy()).all()


def _walk_world(rng):
    """tests/test_tiles.py:148-157's world: ground and two walls."""
    ground = np.c_[rng.uniform(-25, 25, (30_000, 2)), rng.normal(0, 0.05, 30_000)]
    wall_y = np.c_[rng.uniform(-25, 25, 6000), np.full(6000, 8.0) + rng.normal(0, 0.05, 6000),
                   rng.uniform(0, 4, 6000)]
    wall_x = np.c_[np.full(6000, -6.0) + rng.normal(0, 0.05, 6000),
                   rng.uniform(-25, 25, 6000), rng.uniform(0, 4, 6000)]
    return np.r_[ground, wall_y, wall_x]


def _tile_and_hash(built, src, init, method, halo_margin, **cfg_kw):
    cfg = tconfig.PcmConfig(icp_method=tconfig.IcpMethod[method], **cfg_kw)
    params = ticp.make_icp_params(cfg, dtype=torch.float64)
    tmap = ttiles.build_tile_map(built, tile_voxels=4, halo_margin=halo_margin).to_device(
        "cpu", torch.float64)
    st_tile = ticp.make_icp_static(cfg, tile_budget=ttiles.TileQueryBudget(qb=8, max_slots=1024),
                                   reassign_each_iter=False)
    st_hash = ticp.make_icp_static(cfg, backend="hash")
    args = (torch.as_tensor(src), torch.ones(len(src), dtype=torch.bool))
    res_t = ticp.run_register(*args, tmap, torch.as_tensor(init), params, st_tile)
    res_h = ticp.run_register(*args, tgrid.to_device(built, "cpu", torch.float64),
                              torch.as_tensor(init), params, st_hash)
    return res_t, res_h


def test_tile_backend_long_walk_matches_hash():
    rng = np.random.default_rng(21)
    world = _walk_world(rng)
    built = tbuilder.build_voxel_map(world, 1.0, 30, use_native=False)
    scan = world[rng.choice(len(world), 3000, replace=False)]
    true_pose = np.eye(4)
    true_pose[:3, 3] = [1.0, 2.0, 0.0]
    init = true_pose.copy()
    init[:3, 3] += [0.9, -0.9, 0.1]
    res_t, res_h = _tile_and_hash(built, scan - true_pose[:3, 3], init, "P2P", 1,
                                  max_iteration=30)
    assert int(res_t.dropped) == 0
    assert bool(res_t.success) and bool(res_h.success)
    err_t = np.linalg.norm(res_t.pose.numpy()[:3, 3] - true_pose[:3, 3])
    err_h = np.linalg.norm(res_h.pose.numpy()[:3, 3] - true_pose[:3, 3])
    assert err_h < 0.15 and err_t < 0.15, (err_t, err_h)
    np.testing.assert_allclose(res_t.pose.numpy()[:3, 3], res_h.pose.numpy()[:3, 3], rtol=0,
                               atol=0.02)


@pytest.fixture(scope="module")
def avgicp_walk():
    rng = np.random.default_rng(23)
    world = _walk_world(rng)
    built = tbuilder.build_voxel_map(world, 1.0, 30, use_native=False, compute_voxel_cov=True)
    return built, world[rng.choice(len(world), 3000, replace=False)]


@pytest.mark.parametrize("off", [(0.3, 0.0, 0.0), (0.0, -0.3, 0.05), (-0.25, 0.25, 0.0)],
                         ids=["x", "y", "xy"])
def test_tile_backend_avgicp_margin2_matches_hash(avgicp_walk, off):
    built, scan = avgicp_walk
    true_pose = np.eye(4)
    true_pose[:3, 3] = [1.0, 2.0, 0.0]
    init = true_pose.copy()
    init[:3, 3] += off
    res_t, res_h = _tile_and_hash(built, scan - true_pose[:3, 3], init, "AVGICP", 2,
                                  max_iteration=20, max_fitness_score=2.0)
    assert bool(res_t.success) and bool(res_h.success)
    gap = np.linalg.norm(res_t.pose.numpy()[:3, 3] - res_h.pose.numpy()[:3, 3])
    assert gap < 1e-4, f"tile vs hash {gap * 1e3:.3f} mm"
