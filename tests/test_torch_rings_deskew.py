"""Port parity: elimaloc_tpu_torch.pipeline.rings and .deskew vs JAX.

Rings and scans are generated from a seeded NumPy generator and fed to both
sides. Tolerances: float64 atol 1e-12 (same formulas, rounding-order ulps);
float32 atol 1e-5 m (a few ulps at the ~60 m ranges used). Ring pushes copy
values, so they are compared at those same bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import deskew as jdeskew
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu_torch import deskew as tdeskew
from elimaloc_tpu_torch.pipeline import rings as trings
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
