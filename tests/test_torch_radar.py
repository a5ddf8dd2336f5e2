"""The radar covariances (``use_radar_cov``) of elimaloc_tpu_torch against the
JAX package: ``radar_point_cov`` (JAX ``register/icp.py:251``), the radar
forms of the GICP / VGICP / AVGICP tails (``:331-333``, ``:361-363``,
AVGICP's flattened pairs ``:551-562``), ``run_register`` and a whole f32
replay (test_torch_radar_replay.py).

The radar covariance is computed in the WORLD frame (a reference quirk:
d is the horizontal distance from the map origin, the rotation the world
azimuth and elevation) and returned as R S with no R^T, so it is not
symmetric. Near the map origin the points' azimuths span the circle and
R^T C R + R S is indefinite for many rows: the registration then diverges
on both sides alike (on the ``test_icp`` world, GICP leaves the map by
~95 m after 9 iterations in JAX and in the port) and a chaotic divergence
says nothing about parity. So the registrations here run where the radar
model is well-posed, in a map frame whose origin lies 1 km away (the same
drive, every position shifted by +1 km in x), and on the ``test_icp``
world itself for its first 3 iterations.

Bounds:

* ``radar_point_cov``: float64 atol 1e-9, float32 atol 1e-5.
* the tails with a radar term: matched equal, JTJ / JTr / fitness
  numerator rtol 1e-10 (float64) or 1e-3 (float32: the radar term leaves
  rows near-singular; the float32 forms lie up to ~1e-3 from float64 on
  both sides, tests/test_torch_kernels.py).
* ``run_register`` (float64): iterations and success equal, pose within
  1e-6, fitness within 1e-9 (on the near world VGICP stops on the overlap
  ratio at its third iteration, on both sides).
* a windowed radar GICP registration equals the full-map one to 1e-6 m:
  the radar term is computed from the world pose, before the window-origin
  shift (JAX icp.py:619-632).
(The whole f32 replay with radar is in test_torch_radar_replay.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.config import IcpMethod, PcmConfig
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.register import icp as jicp
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.register import icp as ticp
from test_icp import make_scan, make_world, pose_xyzyaw
from torch_parity import flatten, one_torch_thread  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
#: the map frame's origin, 1 km away from the drive
FAR = np.array([1000.0, 0.0, 0.0])


class _Radar:
    use_radar_cov = True


def _params(jdt, tdt):
    jp = jicp.make_icp_params(PcmConfig(), dtype=jdt)
    return jp, convert.icp_params(flatten(jp), dtype=tdt)


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_radar_point_cov_matches_jax(dt_name):
    jdt, tdt = DTYPES[dt_name]
    rng = np.random.default_rng(51)
    pts = np.concatenate([rng.normal(0, 30.0, (400, 3)), FAR + rng.normal(0, 30.0, (200, 3)),
                          [[0.0, 0.0, 1.0], [5.0, 0.0, 0.0], [0.0, -3.0, -2.0]]])
    jp, tp = _params(jdt, tdt)
    ref = np.asarray(jicp.radar_point_cov(jnp.asarray(pts, jdt), jp))
    got = ticp.radar_point_cov(torch.as_tensor(pts, dtype=tdt), tp).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 if dt_name == "f64" else 1e-5)
    # R S with no R^T: not symmetric
    assert np.abs(got - np.swapaxes(got, -1, -2)).max() > 1e-2


def _tail_inputs(rng, method, n=1200):
    pose = np.eye(4)
    pose[:3, :3] = np.asarray(jicp.lie.so3_exp(jnp.asarray([0.02, -0.01, 0.7])))
    pose[:3, 3] = [60.0, 5.0, 0.3]
    src = rng.normal(0, 15.0, (n, 3))
    q = src @ pose[:3, :3].T + pose[:3, 3]
    b = rng.normal(0, 0.4, (n, 3, 3))
    cov = np.einsum("kij,klj->kil", b, b) + 0.05 * np.eye(3)
    if method == "avgicp":
        cov7 = np.repeat(cov[:, None], 7, axis=1)
        mean = q[:, None, :] + rng.normal(0, 1.2, (n, 7, 3))
        return pose, src, q, cov7, mean, rng.uniform(size=(n, 7)) < 0.7
    return pose, src, q, cov, q + rng.normal(0, 1.2, (n, 3)), rng.uniform(size=n) < 0.8


@pytest.mark.parametrize("method", ["gicp", "vgicp", "avgicp"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_radar_tails_match_jax(dt_name, method):
    jdt, tdt = DTYPES[dt_name]
    rng = np.random.default_rng(53)
    pose, src, q, cov, mean, ok = _tail_inputs(rng, method)
    jp, tp = _params(jdt, tdt)
    radar = np.asarray(jicp.radar_point_cov(jnp.asarray(q, jnp.float64),
                                            jicp.make_icp_params(PcmConfig(),
                                                                 dtype=jnp.float64)))
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    T = lambda a: torch.as_tensor(a, dtype=tdt)  # noqa: E731
    if method == "gicp":
        ref = jicp._gicp_tail(J(pose), J(src), J(cov), J(mean), jnp.asarray(ok), jp, _Radar,
                              J(radar))
        got = ticp._gicp_tail(T(pose), T(src), T(cov), T(mean), torch.as_tensor(ok), tp,
                              T(radar))
    elif method == "vgicp":
        ref = jicp._voxcov_tail(J(pose), J(src), J(cov), J(mean), jnp.asarray(ok), jp, _Radar,
                                J(radar))
        got = ticp._voxcov_tail(T(pose), T(src), T(cov), T(mean), torch.as_tensor(ok), tp,
                                T(radar))
    else:
        # the flattened AVGICP radar path (JAX icp.py:556-562) through the
        # port's plain kernel-G version on its slot layout
        ref = jicp._voxcov_tail(J(pose), J(np.repeat(src, 7, axis=0)), J(cov.reshape(-1, 3, 3)),
                                J(mean.reshape(-1, 3)), jnp.asarray(ok.reshape(-1)), jp,
                                _Radar, J(np.repeat(radar, 7, axis=0)))
        got = ticp._voxcov_tail(T(pose), torch.repeat_interleave(T(src), 7, dim=0),
                                T(cov.reshape(-1, 3, 3)), T(mean.reshape(-1, 3)),
                                torch.as_tensor(ok.reshape(-1)), tp,
                                torch.repeat_interleave(T(radar), 7, dim=0))
    assert int(got[0]) == int(ref[0])
    rtol = 1e-10 if dt_name == "f64" else 1e-3
    for g, r in zip(got[1:], ref[1:]):
        r = np.asarray(r, np.float64)
        assert np.linalg.norm(g.numpy() - r) <= rtol * np.linalg.norm(r)


METHODS = {"gicp": IcpMethod.GICP, "vgicp": IcpMethod.VGICP, "avgicp": IcpMethod.AVGICP}


@pytest.fixture(scope="module")
def radar_maps():
    """The test_icp world as it is and shifted 1 km, both covariances."""
    out = {}
    for frame, off in (("near", np.zeros(3)), ("far", FAR)):
        pts = make_world() + off
        out[frame] = (pts, off, jbuilder.build_voxel_map(
            pts, 1.0, 30, compute_voxel_cov=True, compute_point_cov=True, use_native=False))
    return out


@pytest.mark.parametrize("frame", ["near", "far"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_run_register_radar_matches_jax(radar_maps, method, frame):
    pts, off, built = radar_maps[frame]
    m = METHODS[method]
    iters = 3 if frame == "near" else 10
    true_pose = pose_xyzyaw(3.0 + off[0], 1.0, 0.0, 0.5)
    init_pose = pose_xyzyaw(3.4 + off[0], 0.7, 0.1, 0.55)
    scan = make_scan(pts, true_pose, n=1024)
    kw = dict(max_fitness_score=2.0, use_radar_cov=True, max_iteration=iters)
    budget = dict(qb=32, max_slots=1024)
    jmap = jtiles.build_tile_map(built, tile_voxels=4, halo_margin=2 if m == IcpMethod.AVGICP
                                 else 1).to_device(dtype=jnp.float64)
    jparams = jicp.make_icp_params(PcmConfig(icp_method=m, **kw), dtype=jnp.float64)
    jstatic = jicp.make_icp_static(PcmConfig(icp_method=m, **kw),
                                   tile_budget=jtiles.TileQueryBudget(**budget),
                                   reassign_each_iter=False)
    assert jstatic.use_radar_cov
    jres = jax.jit(jicp.run_register, static_argnums=5)(
        jnp.asarray(scan), jnp.ones(len(scan), bool), jmap, jnp.asarray(init_pose), jparams,
        jstatic)
    tstatic = ticp.make_icp_static(
        tconfig.PcmConfig(icp_method=tconfig.IcpMethod(int(m)), **kw),
        tile_budget=ttiles.TileQueryBudget(**budget), reassign_each_iter=False)
    tres = ticp.run_register(
        torch.as_tensor(scan), torch.ones(len(scan), dtype=torch.bool),
        convert.tile_map(flatten(jmap), dtype=torch.float64), torch.as_tensor(init_pose),
        convert.icp_params(flatten(jparams), dtype=torch.float64), tstatic)
    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.success) == bool(jres.success)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tres.fitness), float(jres.fitness), rtol=0, atol=1e-9)
    if frame == "far":   # where the radar model is well-posed, every step is taken
        assert int(tres.iterations) == iters and bool(tres.success)


def test_windowed_radar_registration_equals_full_map():
    """A radar GICP registration on a shifted window (window-local
    coordinates, origin re-centred) against the same registration on the
    full map, both in the port in float64."""
    rng = np.random.default_rng(61)
    pts = FAR + rng.uniform(-40, 40, (15_000, 3)) * np.array([1, 1, 0.08])
    built = tbuilder.build_voxel_map(pts, 1.0, 20, use_native=False, compute_point_cov=True)
    host = ttiles.build_tile_map(built, tile_voxels=4)
    dims = (9, 9)
    c0 = FAR[:2] + np.array([-10.0, -10.0])
    origin = host.window_anchor(c0, dims)
    win = host.crop_window(c0, 4, dims=dims).to_device("cpu", torch.float64)
    anchor = origin
    for target in (FAR[:2] + [-2.0, -6.0], FAR[:2] + [6.0, 2.0]):
        new = host.window_anchor(np.array(target), dims)
        k = max(abs(new[0] - anchor[0]), abs(new[1] - anchor[1]))
        dst, payload = host.crop_entering_rows(anchor, new, dims, origin, k * sum(dims),
                                               offset_dtype=np.dtype(np.float64))
        win = ttiles.shift_window(win, new[0] - anchor[0], new[1] - anchor[1],
                                  torch.as_tensor(dst),
                                  {f: None if v is None else torch.as_tensor(v)
                                   for f, v in payload.items()})
        anchor = new
    assert win.tile_anchor != (0, 0) and float(win.origin.abs().max()) > 900.0
    full = host.to_device("cpu", torch.float64)
    true_pose = np.eye(4)
    true_pose[:3, 3] = FAR + [6.0, 2.0, 0.0]
    sel = pts[np.linalg.norm(pts[:, :2] - true_pose[:2, 3], axis=1) < 12]
    scan = sel[rng.choice(len(sel), 800, replace=False)] - true_pose[:3, 3]
    init = true_pose.copy()
    init[:3, 3] += [0.3, -0.2, 0.05]
    cfg = tconfig.PcmConfig(icp_method=tconfig.IcpMethod.GICP, use_radar_cov=True,
                            max_iteration=10)
    budget = ttiles.TileQueryBudget(qb=16, max_slots=256)
    res = [ticp.run_register(torch.as_tensor(scan), torch.ones(len(scan), dtype=torch.bool),
                             m, torch.as_tensor(init), ticp.make_icp_params(cfg, torch.float64),
                             ticp.make_icp_static(cfg, tile_budget=budget)) for m in (win, full)]
    assert int(res[0].iterations) == int(res[1].iterations)
    assert bool(res[0].success) and bool(res[1].success)
    np.testing.assert_allclose(res[0].pose.numpy(), res[1].pose.numpy(), rtol=0, atol=1e-6)
    assert np.linalg.norm(res[0].pose.numpy()[:3, 3] - true_pose[:3, 3]) < 0.1
