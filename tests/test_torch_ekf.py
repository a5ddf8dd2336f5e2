"""Port parity: elimaloc_tpu_torch.ekf vs elimaloc_tpu.ekf.

The JAX state is built first, flattened to NumPy and converted into the
port (elimaloc_tpu_torch.convert), so both sides start from the same bits;
the IMU samples and measurements come from a seeded NumPy generator.
Tolerances: float64 atol 1e-9 on every state field and P (the forms are the
same, only summation order and libm ulps differ, and 20 steps compound
them); float32 atol 1e-5 with the sparse F P F^T selected (asserted), on a
P of order 1e-2.

The samples turn at 2 rad/s. At a near-zero rate the right Jacobian's
(t - sin t) / t^3 and (1 - cos t) / t^2 terms cancel catastrophically in
float32 (t ~ 5e-4 per 10 ms sample), so a one-ulp difference between two
libm sin/cos implementations already moves P by ~1e-3 within 20 steps —
a property of the reference formula in float32, measured identically when
the port borrows JAX's Jacobian (then both agree to 7e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.ekf import state as jstate
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.ekf import state as tstate
from torch_parity import assert_tree_close, flatten

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-9),
          "f32": (jnp.float32, torch.float32, 1e-5)}


def _start(preset, jdt, rng):
    """A JAX EkfState past initialization: 'fresh' (loose P, at rest) or
    'converged' (tight P, moving at 5 m/s so calibration runs)."""
    params = jstate.make_params(jconfig.EkfConfig(), dtype=jdt)
    st = jfilter.init_state(params, dtype=jdt)
    a = rng.normal(size=(27, 27)) * (1e-4 if preset == "fresh" else 1e-5)
    P = a @ a.T + np.eye(27) * (1e-2 if preset == "fresh" else 1e-8)
    vel = [0.02, -0.01, 0.0] if preset == "fresh" else [5.0, 0.3, 0.0]
    st = st.replace(
        P=jnp.asarray(P, jdt), vel=jnp.asarray(vel, jdt),
        state_initialized=jnp.asarray(True), yaw_initialized=jnp.asarray(True),
        rotation_stabilized=jnp.asarray(preset == "converged"),
        prev_timestamp=jnp.asarray(1.0, jdt),
    )
    return params, st


def _imu_samples(rng, n=20):
    t = 1.0 + 0.01 * np.arange(1, n + 1)
    t[10] = t[9]                               # duplicate stamp: dt gate
    acc = rng.normal(0, 0.3, (n, 3)) + [0.5, 0.1, 9.81]
    gyro = rng.normal(0, 0.05, (n, 3)) + [0.0, 0.0, 2.0]   # a turning vehicle
    return t, acc, gyro


def _port(jobj, cls_fn, tdt):
    return cls_fn(flatten(jobj), dtype=tdt)


@pytest.mark.parametrize("preset", ["fresh", "converged"])
@pytest.mark.parametrize("flags_kind", ["default", "zupt_calib"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_predict_imu_chain(dt_name, flags_kind, preset, monkeypatch):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(7)
    params, jst = _start(preset, jdt, rng)
    kw = ({} if flags_kind == "default"
          else dict(use_zupt=True, imu_estimate_calibration=True))
    jflags = jfilter.EkfFlags(**kw)
    tflags = tfilter.EkfFlags(**kw)
    tparams = _port(params, convert.ekf_params, tdt)
    tst = _port(jst, convert.ekf_state, tdt)

    used = []
    for name in ("_fpf_sparse", "_fpf_dense"):
        orig = getattr(tfilter, name)
        monkeypatch.setattr(
            tfilter, name, lambda *a, _o=orig, _n=name, **k: used.append(_n) or _o(*a, **k))

    t, acc, gyro = _imu_samples(rng)
    for i in range(len(t)):
        jm = jstate.ImuMeas(timestamp=jnp.asarray(t[i], jdt),
                            acc=jnp.asarray(acc[i], jdt), gyro=jnp.asarray(gyro[i], jdt))
        tm = tstate.ImuMeas(timestamp=torch.tensor(t[i], dtype=tdt),
                            acc=torch.tensor(acc[i], dtype=tdt),
                            gyro=torch.tensor(gyro[i], dtype=tdt))
        jst = jfilter.predict_imu(jst, jm, params, jflags)
        tst = tfilter.predict_imu(tst, tm, tparams, tflags)
        assert_tree_close(flatten(tst), flatten(jst), atol=atol, path=f"step{i}")
    # the dtype picks the F P F^T form exactly as _vpu_forms does in JAX
    expect = "_fpf_sparse" if tdt == torch.float32 else "_fpf_dense"
    assert used and set(used) == {expect}


@pytest.mark.parametrize("idx", [(3, 4), (24, 25, 26), tuple(range(6))],
                         ids=["m2", "m3", "m6"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_measurement_update(dt_name, idx):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(11)
    _, jst = _start("fresh", jdt, rng)
    m = len(idx)
    Y = rng.normal(0, 0.05, m)
    a = rng.normal(size=(m, m)) * 0.01
    R = a @ a.T + np.eye(m) * 1e-3
    jout = jfilter._ekf_measurement_update(jst, idx, jnp.asarray(Y, jdt),
                                           jnp.asarray(R, jdt))
    tout = tfilter._ekf_measurement_update(
        _port(jst, convert.ekf_state, tdt), idx, torch.tensor(Y, dtype=tdt),
        torch.tensor(R, dtype=tdt))
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)


@pytest.mark.parametrize("source", ["PCM", "PCM_INIT", "NAVSATFIX"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_update_gnss(dt_name, source):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(13)
    params, jst = _start("fresh", jdt, rng)
    jst = jst.replace(pcm_init_on_going=jnp.asarray(True),
                      pcm_update_count=jnp.asarray(11, jnp.int32))
    src = int(getattr(jconfig.GnssSource, source))
    q = rng.normal(size=4) * 0.05 + [1, 0, 0, 0]
    pos = rng.normal(size=3)
    a = rng.normal(size=(3, 3)) * 0.05
    pos_cov = a @ a.T + 0.01 * np.eye(3)
    rot_cov = np.eye(3) * 1e-4
    jm = jstate.GnssMeas(timestamp=jnp.asarray(1.5, jdt), source=jnp.asarray(src),
                         pos=jnp.asarray(pos, jdt), rot=jnp.asarray(q, jdt),
                         pos_cov=jnp.asarray(pos_cov, jdt),
                         rot_cov=jnp.asarray(rot_cov, jdt))
    tm = tstate.GnssMeas(timestamp=torch.tensor(1.5, dtype=tdt), source=src,
                         pos=torch.tensor(pos, dtype=tdt), rot=torch.tensor(q, dtype=tdt),
                         pos_cov=torch.tensor(pos_cov, dtype=tdt),
                         rot_cov=torch.tensor(rot_cov, dtype=tdt))
    flags = jfilter.EkfFlags()
    jout = jfilter.update_gnss(jst, jm, params, flags)
    tout = tfilter.update_gnss(_port(jst, convert.ekf_state, tdt), tm,
                               _port(params, convert.ekf_params, tdt),
                               tfilter.EkfFlags())
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_params_init_and_ego_state(dt_name):
    """make_params / init_state from the same config, and ego_state."""
    jdt, tdt, atol = DTYPES[dt_name]
    cfg = dataclasses.replace(jconfig.EkfConfig(), ekf_init_x_m=12.5,
                              ekf_init_yaw_deg=33.0, ekf_init_pitch_deg=1.5)
    tcfg = tconfig.EkfConfig(**dataclasses.asdict(cfg))
    jp = jstate.make_params(cfg, dtype=jdt)
    tp = tstate.make_params(tcfg, dtype=tdt)
    assert_tree_close(flatten(tp), flatten(jp), atol=0.0)
    jst = jfilter.init_state(jp, dtype=jdt)
    tst = tfilter.init_state(tp, dtype=tdt)
    assert_tree_close(flatten(tst), flatten(jst), atol=atol)
    jst = jst.replace(vel=jnp.asarray([3.0, -1.0, 0.2], jdt),
                      acc=jnp.asarray([0.1, 0.2, -0.3], jdt))
    tst = _port(jst, convert.ekf_state, tdt)
    jes, tes = jfilter.ego_state(jst), tfilter.ego_state(tst)
    assert set(jes) == set(tes)
    for k in jes:
        np.testing.assert_allclose(tes[k].numpy(), np.asarray(jes[k]), atol=atol,
                                   err_msg=k)
