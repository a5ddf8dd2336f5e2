"""Port parity of the GICP, VGICP and AVGICP registration path: the three
slot searches of elimaloc_tpu_torch.map.tiles, the GN tails and
``run_register`` of elimaloc_tpu_torch.register.icp, against the JAX package
on the same seeded NumPy inputs.

Bounds:
  * searches (``nearest_point_slots(with_point_cov=True)``,
    ``nearest_voxel_cov_slots``, ``all_voxel_cov_slots``): ``ok`` and the
    selected covariances and means exactly equal (exact diff^2 sums and
    first-index ties on both sides; the selection is a copy on both sides);
  * ``_accumulate_gn`` with a hand-made asymmetric M and the three tails:
    float64 rtol 1e-10, float32 rtol 1e-5 on the norms of JTJ, JTr and the
    fitness numerator (the sums run in another order), matched equal;
  * ``_smallest_eigvec``: |v . x| equal to 1e-10 (f64) / 1e-5 (f32) up to
    the arbitrary sign, degenerate inputs (identity, zero) give the same
    (0, 0, 1) fallback;
  * ``run_register``: float64 pose atol 1e-9, float32 atol 1e-4 m, equal
    iterations and success; GICP's exported local_cov = inv(JTJ + lambda
    diag) float64 rtol 1e-8 (its ~1e4 condition number on top of the pose's
    1e-12), float32 rtol 1e-2 on the norm (inverting an f32 6x6 of that
    condition from sums that differ in the 6th digit), and the identity for
    VGICP and AVGICP.
(The fused frame per method is in test_torch_methods_frames.py, the whole
replay in test_torch_methods_replay.py.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.config import IcpMethod, PcmConfig
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.register import icp as jicp
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.register import icp as ticp
from test_icp import make_scan, make_world, pose_xyzyaw
from torch_parity import flatten, one_torch_thread, tiny_world_and_log  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
RTOL = {"f64": 1e-10, "f32": 1e-5}


@pytest.fixture(scope="module")
def tiny_built():
    """The tiny_pipe world with both covariances, built once."""
    world, _ = tiny_world_and_log(jlog, duration=1.0)
    built = jbuilder.build_voxel_map(world, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    return world, built


def _maps(built, margin, jdt, tdt):
    jt = jtiles.build_tile_map(built, tile_voxels=4, halo_margin=margin).to_device(dtype=jdt)
    return jt, convert.tile_map(flatten(jt), dtype=tdt)


def _slot_inputs(world, jt, jdt, tdt, qb=8, seed=37):
    """Map points + noise (a few off the map, every 11th invalid), assigned to
    slots by the JAX package; the same slot buffers go to both sides."""
    rng = np.random.default_rng(seed)
    n = 900
    q = world[rng.integers(0, len(world), n)] + rng.normal(0, 0.3, (n, 3))
    q[:20, :2] += 200.0
    valid = np.ones(n, bool)
    valid[::11] = False
    jb = jtiles.TileQueryBudget(qb=qb, max_slots=1024)
    ja = jtiles.assign_slots(jt, jnp.asarray(q, jdt), jnp.asarray(valid), jb)
    d = flatten(ja)
    targs = tuple(torch.tensor(d[k], dtype=tdt if k == "qbuf" else None)
                  for k in ("slot_tile", "qbuf", "qvox", "qmask"))
    return ja, jb, targs, ttiles.TileQueryBudget(qb=qb, max_slots=1024)


def _equal(port, ref):
    for g, r in zip(port, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_nearest_point_slots_with_cov_exact(tiny_built, dt_name):
    jdt, tdt = DTYPES[dt_name]
    world, built = tiny_built
    jt, tt = _maps(built, 1, jdt, tdt)
    ja, jb, targs, tb = _slot_inputs(world, jt, jdt, tdt)
    ref = jtiles.nearest_point_slots(jt, ja.slot_tile, ja.qbuf, ja.qvox, ja.qmask,
                                     jnp.asarray(5.0, jdt), jb, with_point_cov=True)
    got = ttiles.nearest_point_slots(tt, *targs, torch.tensor(5.0, dtype=tdt), tb,
                                     with_point_cov=True)
    _equal(got, ref)
    ok = got[1]
    assert ok.sum() > 700
    eye = torch.eye(3, dtype=tdt)
    assert torch.equal(got[2][~ok], eye.expand(int((~ok).sum()), 3, 3))
    assert not torch.equal(got[2][ok], eye.expand(int(ok.sum()), 3, 3))


@pytest.mark.parametrize("margin", [1, 2])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_nearest_voxel_cov_slots_exact(tiny_built, dt_name, margin):
    jdt, tdt = DTYPES[dt_name]
    world, built = tiny_built
    jt, tt = _maps(built, margin, jdt, tdt)
    ja, jb, targs, tb = _slot_inputs(world, jt, jdt, tdt)
    ref = jtiles.nearest_voxel_cov_slots(jt, ja.slot_tile, ja.qbuf, ja.qvox, ja.qmask,
                                         jnp.asarray(5.0, jdt), jb)
    got = ttiles.nearest_voxel_cov_slots(tt, *targs, torch.tensor(5.0, dtype=tdt), tb)
    _equal(got, ref)
    assert got[2].sum() > 700


@pytest.mark.parametrize("margin", [1, 2])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_all_voxel_cov_slots_exact(tiny_built, dt_name, margin):
    jdt, tdt = DTYPES[dt_name]
    world, built = tiny_built
    jt, tt = _maps(built, margin, jdt, tdt)
    ja, jb, targs, tb = _slot_inputs(world, jt, jdt, tdt)
    ref = jtiles.all_voxel_cov_slots(jt, ja.slot_tile, ja.qbuf, ja.qvox, ja.qmask,
                                     jnp.asarray(5.0, jdt), jb)
    got = ttiles.all_voxel_cov_slots(tt, *targs, torch.tensor(5.0, dtype=tdt), tb)
    _equal(got, ref)
    ok = got[2]
    assert ok.sum() > 1500 and bool(ok[..., 1:].any())  # face neighbours too


# --------------------------------------------------------------------------- #
# The GN tails on hand-made inputs
# --------------------------------------------------------------------------- #

def _pose():
    pose = np.eye(4)
    pose[:3, :3] = np.asarray(jicp.lie.so3_exp(jnp.asarray([0.02, -0.01, 0.7])))
    pose[:3, 3] = [60.0, 5.0, 0.3]
    return pose


def _asym_covs(rng, shape):
    """U diag(1, 1, 1e-3) V^T with U != V: the asymmetric covariances the
    builder's SVD regularisation gives at degenerate spectra, plus SPD ones."""
    u = np.linalg.qr(rng.normal(size=shape + (3, 3)))[0]
    v = np.linalg.qr(rng.normal(size=shape + (3, 3)))[0]
    asym = np.einsum("...ij,j,...kj->...ik", u, [1.0, 1.0, 1e-3], v)
    b = rng.normal(0, 0.4, shape + (3, 3))
    spd = np.einsum("...ij,...kj->...ik", b, b) + 0.05 * np.eye(3)
    return np.where(rng.uniform(size=shape)[..., None, None] < 0.3, asym, spd)


def _params(jdt, tdt):
    jp = jicp.make_icp_params(PcmConfig(), dtype=jdt)
    return jp, convert.icp_params(flatten(jp), dtype=tdt)


def _close(port, ref, rtol):
    r = np.asarray(ref, np.float64)
    g = port.numpy().astype(np.float64)
    assert np.linalg.norm(g - r) <= rtol * np.linalg.norm(r), (g, r)


class _NoRadar:
    use_radar_cov = False


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_accumulate_gn_asymmetric(dt_name):
    jdt, tdt = DTYPES[dt_name]
    rng = np.random.default_rng(41)
    n, pose = 1500, _pose()
    src = rng.normal(0, 15.0, (n, 3))
    tgt = src @ pose[:3, :3].T + pose[:3, 3] + rng.normal(0, 0.2, (n, 3))
    maha = rng.normal(size=(n, 3, 3))          # deliberately not symmetric
    w = rng.uniform(0.1, 1.0, n)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float64)
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    T = lambda a: torch.as_tensor(a, dtype=tdt)  # noqa: E731
    ref = jicp._accumulate_gn(J(src), J(tgt), J(maha), J(w), J(mask), J(pose))
    got = ticp._accumulate_gn(T(src), T(tgt), T(maha), T(w), T(mask), T(pose))
    JTJ = np.asarray(ref[0])
    assert np.linalg.norm(JTJ[3:, :3] - JTJ[:3, 3:].T) > 1e-3 * np.linalg.norm(JTJ)
    for g, r in zip(got, ref):
        _close(g, r, RTOL[dt_name])


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_smallest_eigvec(dt_name):
    jdt, tdt = DTYPES[dt_name]
    rng = np.random.default_rng(43)
    q = np.linalg.qr(rng.normal(size=(200, 3, 3)))[0]
    lam = np.sort(rng.uniform(0.05, 2.0, (200, 3)), axis=-1)
    lam[:50] = [1e-3, 1.0, 1.0]                 # the regularised plane spectrum
    covs = np.einsum("kij,kj,klj->kil", q, lam, q)
    covs = np.concatenate([covs, np.eye(3)[None], np.zeros((1, 3, 3))])
    ref = np.asarray(jicp._smallest_eigvec(jnp.asarray(covs, jdt)))
    got = ticp._smallest_eigvec(torch.as_tensor(covs, dtype=tdt)).numpy()
    x = rng.normal(size=(len(covs), 3))
    np.testing.assert_allclose(np.abs(np.sum(got * x, -1)), np.abs(np.sum(ref * x, -1)),
                               rtol=RTOL[dt_name], atol=RTOL[dt_name])
    np.testing.assert_array_equal(got[-2:], [[0, 0, 1], [0, 0, 1]])
    np.testing.assert_array_equal(ref[-2:], got[-2:])
    # and it is the smallest eigenvector where the spectrum separates
    np.testing.assert_allclose(np.abs(np.sum(got[:200] * q[:, :, 0], -1)), 1.0,
                               atol=1e-4 if dt_name == "f32" else 1e-9)


def _tail_inputs(rng, method, n=1200):
    pose = _pose()
    src = rng.normal(0, 15.0, (n, 3))
    q = src @ pose[:3, :3].T + pose[:3, 3]
    if method == "avgicp":
        mean = q[:, None, :] + rng.normal(0, 1.2, (n, 7, 3))
        return pose, src, q, _asym_covs(rng, (n, 7)), mean, rng.uniform(size=(n, 7)) < 0.7
    mean = q + rng.normal(0, 1.2, (n, 3))
    return pose, src, q, _asym_covs(rng, (n,)), mean, rng.uniform(size=n) < 0.8


@pytest.mark.parametrize("method", ["gicp", "vgicp", "avgicp"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_tail(dt_name, method):
    jdt, tdt = DTYPES[dt_name]
    pose, src, q, cov, mean, ok = _tail_inputs(np.random.default_rng(47), method)
    jp, tp = _params(jdt, tdt)
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    T = lambda a: torch.as_tensor(a, dtype=tdt)  # noqa: E731
    if method == "gicp":
        ref = jicp._gicp_tail(J(pose), J(src), J(cov), J(mean), jnp.asarray(ok), jp,
                              _NoRadar, None)
        got = ticp._gicp_tail(T(pose), T(src), T(cov), T(mean), torch.as_tensor(ok), tp)
    elif method == "vgicp":
        ref = jicp._voxcov_tail(J(pose), J(src), J(cov), J(mean), jnp.asarray(ok), jp,
                                _NoRadar, None)
        got = ticp._voxcov_tail(T(pose), T(src), T(cov), T(mean), torch.as_tensor(ok), tp)
    else:
        ref = jicp._avg_voxcov_tail(J(pose), J(src), J(q), J(cov), J(mean),
                                    jnp.asarray(ok), jp)
        got = ticp._avg_voxcov_tail(T(pose), T(src), T(q), T(cov), T(mean),
                                    torch.as_tensor(ok), tp)
    assert int(got[0]) == int(ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, RTOL[dt_name])


# --------------------------------------------------------------------------- #
# run_register per method (the perturbed-pose case of tests/test_icp.py)
# --------------------------------------------------------------------------- #

METHODS = {"gicp": IcpMethod.GICP, "vgicp": IcpMethod.VGICP, "avgicp": IcpMethod.AVGICP}


@pytest.fixture(scope="module")
def icp_built():
    map_pts = make_world()
    built = jbuilder.build_voxel_map(map_pts, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    return map_pts, built


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_run_register(icp_built, dt_name, method):
    jdt, tdt = DTYPES[dt_name]
    atol = 1e-9 if dt_name == "f64" else 1e-4
    map_pts, built = icp_built
    m = METHODS[method]
    margin = 2 if m == IcpMethod.AVGICP else 1
    true_pose = pose_xyzyaw(3.0, 1.0, 0.0, 0.5)
    init_pose = pose_xyzyaw(3.4, 0.7, 0.1, 0.55)
    cfg = PcmConfig(icp_method=m, max_fitness_score=2.0)
    jmap = jtiles.build_tile_map(built, tile_voxels=4, halo_margin=margin).to_device(dtype=jdt)
    scan = make_scan(map_pts, true_pose, n=1024)
    jparams = jicp.make_icp_params(cfg, dtype=jdt)
    budget = dict(qb=32, max_slots=1024)
    # AVGICP keeps the hoisted assignment on its halo margin 2 map
    # (runtime.py:735-736), the one configuration the port runs
    jstatic = jicp.make_icp_static(cfg, tile_budget=jtiles.TileQueryBudget(**budget),
                                   reassign_each_iter=False)
    jres = jax.jit(jicp.run_register, static_argnums=5)(
        jnp.asarray(scan, jdt), jnp.ones(len(scan), bool), jmap,
        jnp.asarray(init_pose, jdt), jparams, jstatic)

    tstatic = ticp.make_icp_static(
        tconfig.PcmConfig(icp_method=tconfig.IcpMethod(int(m)), max_fitness_score=2.0),
        tile_budget=ttiles.TileQueryBudget(**budget), reassign_each_iter=False)
    tres = ticp.run_register(
        torch.as_tensor(scan, dtype=tdt), torch.ones(len(scan), dtype=torch.bool),
        convert.tile_map(flatten(jmap), dtype=tdt), torch.as_tensor(init_pose, dtype=tdt),
        convert.icp_params(flatten(jparams), dtype=tdt), tstatic)

    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.success) == bool(jres.success)
    assert int(tres.dropped) == int(jres.dropped) == 0
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=atol)
    np.testing.assert_allclose(float(tres.fitness), float(jres.fitness), atol=atol)
    np.testing.assert_allclose(float(tres.overlap), float(jres.overlap), atol=atol)
    assert bool(tres.success)
    # the truth limits of tests/test_icp.py:204-209 (the voxel-mean
    # objectives' accuracy floor on this sparse world is the algorithm's)
    lim = {IcpMethod.GICP: 0.08, IcpMethod.VGICP: 0.25, IcpMethod.AVGICP: 0.45}[m]
    assert np.linalg.norm(tres.pose.numpy()[:3, 3] - true_pose[:3, 3]) < lim
    cov, jcov = tres.local_cov.numpy(), np.asarray(jres.local_cov)
    if m == IcpMethod.GICP:
        assert not np.array_equal(jcov, np.eye(6))
        rtol = 1e-8 if dt_name == "f64" else 1e-2
        assert np.linalg.norm(cov - jcov) <= rtol * np.linalg.norm(jcov)
    else:
        np.testing.assert_array_equal(cov, np.eye(6))
        np.testing.assert_array_equal(jcov, np.eye(6))


@pytest.mark.parametrize("method", sorted(METHODS))
def test_pipeline_refuses_a_map_without_its_covariances(tiny_built, method):
    _, built = tiny_built
    tbuilt = tbuilder.BuiltMap(**{k: getattr(built, k) for k in
                                  tbuilder.BuiltMap.__dataclass_fields__})
    host = ttiles.build_tile_map(tbuilt, halo_margin=2)
    cfg = tconfig.ElimalocConfig()
    cfg.pcm.icp_method = tconfig.IcpMethod(int(METHODS[method]))
    TPipeline(cfg, host, device="cpu", ds_points=256)  # the full map is accepted
    if method == "gicp":
        bare = dataclasses.replace(host, halo_point_cov=None, halo_point_cov_mean=None)
    else:
        bare = dataclasses.replace(
            host, halo_vox_cov=np.broadcast_to(np.eye(3, dtype=np.float32),
                                               host.halo_vox_cov.shape))
    with pytest.raises(ValueError, match="covariances"):
        TPipeline(cfg, bare, device="cpu", ds_points=256)


def test_to_device_uploads_every_covariance_field(tiny_built):
    _, built = tiny_built
    host = ttiles.build_tile_map(built, halo_margin=2)
    tmap = host.to_device("cpu", torch.float64)
    for f in ("halo_point_cov", "halo_point_cov_mean", "halo_vox_mean", "halo_vox_cov"):
        np.testing.assert_array_equal(getattr(tmap, f).numpy(), getattr(host, f))
        assert getattr(tmap, f).dtype == torch.float64, f
    assert tmap.halo_vox_coord.dtype == torch.int32
    np.testing.assert_array_equal(tmap.halo_vox_coord.numpy(), host.halo_vox_coord)
    bare = dataclasses.replace(host, halo_point_cov=None, halo_point_cov_mean=None)
    assert bare.to_device("cpu").halo_point_cov is None
