"""Port parity: elimaloc_tpu_torch.pipeline.rings and .deskew vs JAX.

Rings and scans are generated from a seeded NumPy generator and fed to both
sides. Tolerances: float64 atol 1e-12 (same formulas, rounding-order ulps);
float32 atol 1e-5 m (a few ulps at the ~60 m ranges used). Ring pushes copy
values, so they are compared at those same bounds (one-row pushes exactly).
The plain versions of kernels J (``push_rings_plain``), K
(``scan_ring_query_plain``) and L (``runtime.pcm_measurement_plain``) are
held to the JAX functions they stand for; L's covariances at those bounds
relative to their largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import deskew as jdeskew
from elimaloc_tpu.ops import lie as jlie
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import deskew as tdeskew
from elimaloc_tpu_torch.pipeline import rings as trings
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp
from torch_parity import assert_tree_close, flatten

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12),
          "f32": (jnp.float32, torch.float32, 1e-5)}


def _ego_ring(jdt, cap=16, count=10, t0=0.9, rng=None):
    rng = rng or np.random.default_rng(3)
    ring = jrings.make_ego_ring(cap, jdt)
    t = t0 + 0.01 * np.arange(cap)
    pos = np.c_[60 + 8.0 * (t - t0), 0.5 * (t - t0), np.zeros(cap)]
    rpy = np.c_[rng.normal(0, 0.01, cap), rng.normal(0, 0.01, cap), 1.5 + 0.1 * (t - t0)]
    vel = np.c_[np.full(cap, 8.0), rng.normal(0, 0.1, cap), np.zeros(cap)]
    gyro = np.c_[np.zeros((cap, 2)), np.full(cap, 0.1)]
    f = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    return ring.replace(t=f(t), pos=f(pos), rpy=f(rpy), vel_local=f(vel),
                        gyro=f(gyro), count=jnp.asarray(count, jnp.int32))


def _t(a, tdt):
    a = np.asarray(a)
    return torch.as_tensor(a, dtype=tdt) if a.dtype.kind == "f" else torch.as_tensor(a)


def _port_ring(jring, cls, tdt):
    d = flatten(jring)
    return cls(**{k: _t(v, tdt) for k, v in d.items()})


PUSHES = {
    # (ring count, new times, valid mask)
    "append": (4, 1.0 + 0.01 * np.arange(6), np.ones(6, bool)),
    "overflow": (12, 1.0 + 0.01 * np.arange(9), np.r_[np.ones(8, bool), False]),
    "regress_clears": (10, 0.5 + 0.01 * np.arange(5), np.ones(5, bool)),
    "longer_than_ring": (3, 1.0 + 0.01 * np.arange(20), np.ones(20, bool)),
    "eps_dedupe": (10, 1.0 + np.array([0.0, 4e-6, 2e-5, 2.5e-5, 0.01]),
                   np.ones(5, bool)),
    "masked": (6, 1.0 + 0.01 * np.arange(6), np.array([0, 1, 1, 0, 1, 0], bool)),
}


@pytest.mark.parametrize("ring_kind", ["ego", "imu"])
@pytest.mark.parametrize("case", sorted(PUSHES))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_push_batch(dt_name, case, ring_kind):
    jdt, tdt, atol = DTYPES[dt_name]
    count, new_t, valid = PUSHES[case]
    rng = np.random.default_rng(5)
    jring = _ego_ring(jdt, count=count)
    m = len(new_t)
    vals = {k: rng.normal(size=(m, 3)) for k in ("pos", "rpy", "vel_local", "gyro", "acc")}
    if ring_kind == "ego":
        jr = jring
        tr = _port_ring(jr, trings.EgoRing, tdt)
        jout = jrings.push_ego_batch(
            jr, jnp.asarray(new_t, jdt), *(jnp.asarray(vals[k], jdt)
                                           for k in ("pos", "rpy", "vel_local", "gyro")),
            jnp.asarray(valid))
        tout = trings.push_ego_batch(
            tr, _t(new_t, tdt), *(_t(vals[k], tdt)
                                  for k in ("pos", "rpy", "vel_local", "gyro")),
            _t(valid, tdt))
    else:
        jr = jrings.ImuRing(t=jring.t, gyro=jring.gyro, acc=jring.pos, count=jring.count)
        tr = _port_ring(jr, trings.ImuRing, tdt)
        jout = jrings.push_imu_batch(jr, jnp.asarray(new_t, jdt),
                                     jnp.asarray(vals["gyro"], jdt),
                                     jnp.asarray(vals["acc"], jdt), jnp.asarray(valid))
        tout = trings.push_imu_batch(tr, _t(new_t, tdt), _t(vals["gyro"], tdt),
                                     _t(vals["acc"], tdt), _t(valid, tdt))
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)


@pytest.mark.parametrize("t_query", [0.85, 0.9, 0.955, 0.99, 1.05],
                         ids=["before", "on_first", "between", "on_last", "extrapolate"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_interpolated_pose_and_compensation(dt_name, t_query):
    jdt, tdt, atol = DTYPES[dt_name]
    jr = _ego_ring(jdt)
    tr = _port_ring(jr, trings.EgoRing, tdt)
    jpose, jfound = jrings.get_interpolated_pose(jr, jnp.asarray(t_query, jdt))
    tpose, tfound = trings.get_interpolated_pose(tr, torch.tensor(t_query, dtype=tdt))
    assert bool(tfound) == bool(jfound)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=atol)

    pos = np.array([60.3, 0.2, 0.1])
    quat = np.array([0.9, 0.01, -0.02, 0.43])
    quat /= np.linalg.norm(quat)
    jout = jrings.gnss_time_compensation(jr, jnp.asarray(t_query, jdt),
                                         jnp.asarray(pos, jdt), jnp.asarray(quat, jdt))
    tout = trings.gnss_time_compensation(tr, torch.tensor(t_query, dtype=tdt),
                                         torch.tensor(pos, dtype=tdt),
                                         torch.tensor(quat, dtype=tdt))
    for g, r in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)


def _deskew_inputs(rng, n=300):
    imu_t = 0.985 + 0.005 * np.arange(32)
    imu_gyro = np.c_[rng.normal(0, 0.02, (32, 2)), 0.3 + rng.normal(0, 0.02, 32)]
    rel = np.sort(rng.uniform(-0.1, 0.0, n))
    r = rng.uniform(2.0, 60.0, n)
    az = rng.uniform(-np.pi, np.pi, n)
    pts = np.c_[r * np.cos(az), r * np.sin(az), rng.normal(0, 1.0, n)]
    valid = rng.uniform(size=n) > 0.1
    return imu_t, imu_gyro, rel, pts, valid


@pytest.mark.parametrize("scan_time_end", [True, False], ids=["end", "start"])
@pytest.mark.parametrize("bug_compat_z", [False, True], ids=["fixed_z", "bug_compat_z"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_deskew(dt_name, bug_compat_z, scan_time_end):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(17)
    imu_t, imu_gyro, rel_raw, pts, valid = _deskew_inputs(rng)
    if not scan_time_end:
        rel_raw = rel_raw + 0.1
    stamp = 1.08
    jr = _ego_ring(jdt, count=16)
    tr = _port_ring(jr, trings.EgoRing, tdt)
    imu_valid = np.arange(32) < 30

    jrel, jcur, jend = jdeskew.normalize_scan_times(
        jnp.asarray(rel_raw, jdt), jnp.asarray(valid), jnp.asarray(stamp, jdt),
        scan_time_end)
    trel, tcur, tend = tdeskew.normalize_scan_times(
        _t(rel_raw, tdt), _t(valid, tdt), torch.tensor(stamp, dtype=tdt),
        scan_time_end)
    for g, r in ((trel, jrel), (tcur, jcur), (tend, jend)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)

    jinfo = jdeskew.make_deskew_info(
        jnp.asarray(imu_t, jdt), jnp.asarray(imu_gyro, jdt), jnp.asarray(imu_valid),
        jr.t, jr.pos, jr.rpy, jr.vel_local, jr.gyro, jr.valid_mask(), jcur, jend,
        window_budget=24)
    tinfo = tdeskew.make_deskew_info(
        _t(imu_t, tdt), _t(imu_gyro, tdt), _t(imu_valid, tdt),
        tr.t, tr.pos, tr.rpy, tr.vel_local, tr.gyro, tr.valid_mask(), tcur, tend,
        window_budget=24)
    assert_tree_close(flatten(tinfo), flatten(jinfo), atol=atol)
    assert bool(tinfo.imu_available) and bool(tinfo.odom_available)

    jout, jok = jdeskew.deskew_points(jnp.asarray(pts, jdt), jrel, jnp.asarray(valid),
                                      jinfo, bug_compat_z=bug_compat_z)
    tout, tok = tdeskew.deskew_points(_t(pts, tdt), trel, _t(valid, tdt), tinfo,
                                      bug_compat_z=bug_compat_z)
    assert bool(tok) == bool(jok)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=atol)
    # deskew moved the valid points and left the invalid ones untouched
    assert np.abs(tout.numpy()[valid] - pts[valid]).max() > 1e-3
    np.testing.assert_array_equal(tout.numpy()[~valid], np.asarray(pts, tout.numpy().dtype)[~valid])


# --------------------------------------------------------------------------- #
# The plain versions of kernels J, K and L against the JAX functions
# --------------------------------------------------------------------------- #

def _imu_ring(jdt, cap=16, count=10, t0=0.9):
    ring = _ego_ring(jdt, cap=cap, count=count, t0=t0)
    return jrings.ImuRing(t=ring.t, gyro=ring.gyro, acc=ring.pos, count=ring.count)


@pytest.mark.parametrize("case", sorted(PUSHES))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_push_rings_plain_matches_jax(dt_name, case):
    """Kernel J's plain version: both rings' batch pushes of one frame, the
    IMU ring fed its own stamps (1 us later than the ego ring's)."""
    jdt, tdt, atol = DTYPES[dt_name]
    count, new_t, valid = PUSHES[case]
    rng = np.random.default_rng(6)
    m = len(new_t)
    vals = [rng.normal(size=(m, 3)) for _ in range(4)]
    je, ji = _ego_ring(jdt, count=count), _imu_ring(jdt, count=min(count, 16))
    jout = (jrings.push_ego_batch(je, jnp.asarray(new_t, jdt),
                                  *(jnp.asarray(v, jdt) for v in vals), jnp.asarray(valid)),
            jrings.push_imu_batch(ji, jnp.asarray(new_t + 1e-6, jdt), jnp.asarray(vals[0], jdt),
                                  jnp.asarray(vals[1], jdt), jnp.asarray(valid)))
    tout = trings.push_rings_plain(
        _port_ring(je, trings.EgoRing, tdt), _port_ring(ji, trings.ImuRing, tdt),
        (_t(new_t, tdt), *(_t(v, tdt) for v in vals)),
        (_t(new_t + 1e-6, tdt), _t(vals[0], tdt), _t(vals[1], tdt)), _t(valid, tdt))
    for t, j in zip(tout, jout):
        assert_tree_close(flatten(t), flatten(j), atol=atol)


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_one_row_push_matches_jax_sequential_push(dt_name):
    """imu_step's push is the batch push of one row: 13 one-row pushes into
    rings of 8 (an overflow, a repeat within 1e-5, a time regression) equal
    JAX's sequential push_ego / push_imu (rings.py:75-123) exactly."""
    jdt, tdt, _ = DTYPES[dt_name]
    rng = np.random.default_rng(8)
    je, ji = jrings.make_ego_ring(8, jdt), jrings.make_imu_ring(8, jdt)
    te, ti = _port_ring(je, trings.EgoRing, tdt), _port_ring(ji, trings.ImuRing, tdt)
    one = _t(np.ones(1, bool), tdt)
    stamps = np.r_[0.01 * np.arange(1, 10), 0.09 + 5e-6, 0.05, 0.06, 0.07]
    for t in stamps:
        v = rng.normal(size=(4, 3))
        je = jrings.push_ego(je, jnp.asarray(t, jdt), *(jnp.asarray(x, jdt) for x in v))
        ji = jrings.push_imu(ji, jnp.asarray(t, jdt), jnp.asarray(v[0], jdt),
                             jnp.asarray(v[1], jdt))
        te, ti = trings.push_rings_plain(
            te, ti, (_t([t], tdt), *(_t(x[None], tdt) for x in v)),
            (_t([t], tdt), _t(v[0][None], tdt), _t(v[1][None], tdt)), one)
        assert_tree_close(flatten(te), flatten(je), atol=0.0)
        assert_tree_close(flatten(ti), flatten(ji), atol=0.0)
    assert int(te.count) == 3 and int(ti.count) == 3


def _tf_ego_to_lidar():
    tf = np.eye(4)
    tf[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    tf[:3, 3] = [1.0, 0.2, 1.5]
    return tf


@pytest.mark.parametrize("case", ["inside", "extrapolate", "overflow", "empty"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_scan_ring_query_plain_matches_jax(dt_name, case):
    """Kernel K's plain version against JAX make_deskew_info +
    get_interpolated_pose + compose(sync_pose, tf_ego_to_lidar)
    (runtime.py:317-338)."""
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(17)
    imu_t, imu_gyro, *_ = _deskew_inputs(rng)
    ego_count, imu_count, cur, window = {
        "inside": (16, 30, 1.0, 64), "extrapolate": (10, 30, 1.02, 64),
        "overflow": (16, 32, 1.0, 8), "empty": (0, 0, 1.0, 64)}[case]
    end = cur + 0.1
    jr = _ego_ring(jdt, count=ego_count)
    ji = jrings.ImuRing(t=jnp.asarray(imu_t, jdt), gyro=jnp.asarray(imu_gyro, jdt),
                        acc=jnp.zeros((32, 3), jdt), count=jnp.asarray(imu_count, jnp.int32))
    tf = _tf_ego_to_lidar()
    jinfo = jdeskew.make_deskew_info(ji.t, ji.gyro, ji.valid_mask(), jr.t, jr.pos, jr.rpy,
                                     jr.vel_local, jr.gyro, jr.valid_mask(),
                                     jnp.asarray(cur, jdt), jnp.asarray(end, jdt),
                                     window_budget=window)
    jsync, jfound = jrings.get_interpolated_pose(jr, jnp.asarray(end, jdt))
    jguess = jlie.compose(jsync, jnp.asarray(tf, jdt))
    tinfo, tguess, tfound, tusable = tdeskew.scan_ring_query_plain(
        _port_ring(ji, trings.ImuRing, tdt), _port_ring(jr, trings.EgoRing, tdt),
        torch.tensor(cur, dtype=tdt), torch.tensor(end, dtype=tdt), _t(tf, tdt), window)
    assert_tree_close(flatten(tinfo), flatten(jinfo), atol=atol)
    np.testing.assert_allclose(tguess.numpy(), np.asarray(jguess), atol=atol)
    assert bool(tfound) == bool(jfound)
    usable = bool(jinfo.imu_available & jinfo.odom_available & jfound) and ego_count > 0
    assert bool(tusable) == usable == (case != "empty")


@pytest.mark.parametrize("cov", ["gicp", "identity", "tiny"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_pcm_measurement_plain_matches_jax(dt_name, cov):
    """Kernel L's plain version against JAX's scan tail (runtime.py:341-358):
    compose with tf_lidar_to_ego, rot_to_quat, shape_icp_covariance (the
    "tiny" covariance takes the 1e-9 rescale) and gnss_time_compensation."""
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(23)
    jr = _ego_ring(jdt)
    pose = np.eye(4)
    c, s = np.cos(1.52), np.sin(1.52)
    pose[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    pose[:3, 3] = [60.4, 0.3, 0.1]
    a = rng.normal(size=(6, 6))
    local_cov = {"gicp": a @ a.T * 1e-4, "identity": np.eye(6),
                 "tiny": a @ a.T * 1e-13}[cov]
    tf = np.linalg.inv(_tf_ego_to_lidar())
    fitness, end = 0.4, 0.955
    jpose = jlie.compose(jnp.asarray(pose, jdt), jnp.asarray(tf, jdt))
    jquat = jlie.rot_to_quat(jpose[:3, :3])
    jpos_cov, jrot_cov = jruntime.shape_icp_covariance(
        jpose[:3, :3], jnp.asarray(local_cov, jdt), jnp.asarray(fitness, jdt))
    jt, jpos, jq, jok = jrings.gnss_time_compensation(jr, jnp.asarray(end, jdt),
                                                      jpose[:3, 3], jquat)
    res = ticp.IcpResult(pose=_t(pose, tdt), success=torch.tensor(True),
                         fitness=torch.tensor(fitness, dtype=tdt),
                         local_cov=_t(local_cov, tdt), iterations=torch.tensor(3),
                         overlap=torch.tensor(0.9, dtype=tdt), dropped=torch.tensor(0))
    tpose, meas, apply = truntime.pcm_measurement_plain(
        res, _t(tf, tdt), _port_ring(jr, trings.EgoRing, tdt), torch.tensor(end, dtype=tdt),
        torch.tensor(True), True)
    for got, want in ((tpose, jpose), (meas.timestamp, jt), (meas.pos, jpos), (meas.rot, jq),
                      (meas.pos_cov, jpos_cov), (meas.rot_cov, jrot_cov)):
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol * scale)
    assert bool(apply) == bool(jok) is True
    assert meas.pos_cov.is_contiguous() and meas.rot_cov.is_contiguous()
    off = truntime.pcm_measurement_plain(res, _t(tf, tdt), _port_ring(jr, trings.EgoRing, tdt),
                                         torch.tensor(end, dtype=tdt), torch.tensor(True),
                                         False)[2]
    assert not bool(off)
