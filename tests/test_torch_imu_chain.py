"""The IMU chain of the fused frame: elimaloc_tpu_torch vs the JAX package.

``ekf.filter.imu_chain_plain`` (the plain version of kernel H) against the
scan body of JAX ``runtime.imu_subbatch`` (``predict_imu`` per sample, then
the select by validity), carry and per-sample history (t, pos, rot, vel,
gyro), and the port's whole ``runtime.imu_subbatch`` (the EKF plus both
ring pushes) against JAX's, for each flag set: the defaults, ``use_zupt``,
``imu_estimate_calibration`` and the gravity estimate off. The budget holds
invalid samples (one inside, two of padding at its end) and a repeated
stamp (the dt gate). Inputs are made with NumPy from a seed; both sides
start from the same state bits.

The samples turn at 2 rad/s, as in tests/test_torch_ekf.py: at a near-zero
rate the f32 right Jacobian cancels catastrophically and one ulp of libm
sin/cos moves P by ~1e-3 (ROADMAP Queue 3 note). The ZUPT case stands
still with an exactly zero rate instead (the Jacobian's zero branch), so
that its bias updates run. Bounds: float64 atol 1e-10, float32 atol 1e-5
on states of order 1-60 and P of order 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.ekf import state as jstate
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.pipeline import rings as trings
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import assert_tree_close, flatten, one_torch_thread, t  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10),
          "f32": (jnp.float32, torch.float32, 1e-5)}
FLAG_SETS = {"default": {}, "zupt": dict(use_zupt=True),
             "calibration": dict(imu_estimate_calibration=True),
             "no_gravity": dict(imu_estimate_gravity=False)}
N = 12


def _cfg(cfg_mod, flags):
    cfg = cfg_mod.ElimalocConfig()
    for k, v in FLAG_SETS[flags].items():
        setattr(cfg.ekf, k, v)
    cfg.calib.ego_to_imu_rot_deg = (0.5, -0.3, 1.0)
    cfg.calib.ego_to_imu_trans = (0.2, 0.0, 0.1)
    return cfg


def _start(flags, jdt, params, rng):
    """Past initialization: stationary for ZUPT, else moving at 5 m/s with a
    tight P (rotation stabilized, so calibration runs)."""
    st = jfilter.init_state(params, dtype=jdt)
    a = rng.normal(size=(27, 27)) * 1e-5
    P = a @ a.T + np.eye(27) * 1e-8
    vel = [0.02, -0.01, 0.0] if flags == "zupt" else [5.0, 0.3, 0.0]
    return st.replace(
        P=jnp.asarray(P, jdt), vel=jnp.asarray(vel, jdt),
        pos=jnp.asarray([60.0, 2.0, 0.1], jdt),
        state_initialized=jnp.asarray(True), yaw_initialized=jnp.asarray(True),
        prev_timestamp=jnp.asarray(1.0, jdt))


def _batch(flags, rng):
    """A frame's raw IMU budget: N slots, slot 4 invalid, the last two padding
    (zeros, as build_fused_batches leaves them), slot 7 repeats slot 6's
    stamp."""
    ts = 1.0 + 0.01 * np.arange(1, N + 1)
    ts[7] = ts[6]
    if flags == "zupt":
        acc = rng.normal(0, 0.01, (N, 3)) + [0.0, 0.0, 9.81]
        gyro = np.zeros((N, 3))
    else:
        acc = rng.normal(0, 0.3, (N, 3)) + [0.5, 0.1, 9.81]
        gyro = rng.normal(0, 0.05, (N, 3)) + [0.0, 0.0, 2.0]
    valid = np.ones(N, bool)
    valid[4] = False
    valid[-2:] = False
    ts[-2:], acc[-2:], gyro[-2:] = 0.0, 0.0, 0.0
    return ts, acc, gyro, valid


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_imu_chain_matches_jax(dt_name, flags):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(17)
    jcfg, tcfg = _cfg(jconfig, flags), _cfg(tconfig, flags)
    jpp = jruntime.make_pipeline_params(jcfg, dtype=jdt)
    jps = jruntime.make_pipeline_static(jcfg)
    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    tps = truntime.make_pipeline_static(tcfg)
    jekf = _start(flags, jdt, jpp.ekf, rng)
    ts, acc, gyro, valid = _batch(flags, rng)

    # the chain alone: the scan body of JAX imu_subbatch
    jacc, jgyro = (jnp.asarray(x, jdt) for x in (acc, gyro))
    ekf, jhist = jekf, []
    for i in range(N):
        nxt = jfilter.predict_imu(ekf, jstate.ImuMeas(timestamp=jnp.asarray(ts[i], jdt),
                                                      acc=jacc[i], gyro=jgyro[i]),
                                  jpp.ekf, jps.ekf_flags)
        ekf = jax.tree_util.tree_map(lambda a_, b_: jnp.where(valid[i], a_, b_), nxt, ekf)
        jhist.append((ekf.prev_timestamp, ekf.pos, ekf.rot, ekf.vel, ekf.gyro))
    tekf, thist = tfilter.imu_chain_plain(
        convert.ekf_state(flatten(jekf), dtype=tdt), t(ts, tdt), t(acc, tdt),
        t(gyro, tdt), t(valid), tpp.ekf, tps.ekf_flags)
    assert_tree_close(flatten(tekf), flatten(ekf), atol=atol)
    for name, a, b in zip(("t", "pos", "rot", "vel", "gyro"), thist, zip(*jhist)):
        np.testing.assert_allclose(a.numpy(), np.stack([np.asarray(x) for x in b]),
                                   rtol=0, atol=atol, err_msg=name)
    if flags == "zupt":      # the stationary case really ran the bias updates
        assert np.any(np.asarray(ekf.ba) != np.asarray(jekf.ba))
    if flags == "calibration":
        assert bool(ekf.vehicle_imu_calib_started)

    # the whole sub-batch: chain, ego-state conversions and both ring pushes
    jst = jruntime.PipelineState(ekf=jekf, ego_ring=jrings.make_ego_ring(16, jdt),
                                 imu_ring=jrings.make_imu_ring(16, jdt))
    b = dict(imu_t=ts, imu_acc=acc, imu_gyro=gyro, imu_valid=valid)
    jout = jruntime.imu_subbatch(jst, {k: jnp.asarray(v, jdt if v.dtype.kind == "f"
                                                      else None) for k, v in b.items()},
                                 jpp, jps)
    tout = truntime.imu_subbatch(convert.pipeline_state(flatten(jst), dtype=tdt),
                                 {k: t(v, tdt) for k, v in b.items()}, tpp, tps)
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)
    assert int(tout.ego_ring.count) == int(valid.sum()) - 1   # the repeated stamp


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_imu_chain_dispatch_returns_the_ego_history(dt_name):
    """``runtime.imu_subbatch`` on CPU tensors is its plain composition: the
    plain chain, the ring's batched Euler / local-velocity conversions (JAX
    runtime.py:435-436) pushed into the ego ring, and PCM's rotated samples
    into the IMU ring."""
    _, tdt, _ = DTYPES[dt_name]
    rng = np.random.default_rng(23)
    tcfg = _cfg(tconfig, "default")
    tpp = truntime.make_pipeline_params(tcfg, dtype=tdt)
    tps = truntime.make_pipeline_static(tcfg)
    st = tfilter.init_state(tpp.ekf, dtype=tdt).replace(
        state_initialized=torch.tensor(True), prev_timestamp=torch.tensor(1.0, dtype=tdt))
    ts, acc, gyro, valid = (t(x, tdt) for x in _batch("default", rng))
    pst = truntime.PipelineState(ekf=st, ego_ring=trings.make_ego_ring(16, tdt),
                                 imu_ring=trings.make_imu_ring(16, tdt))
    out = truntime.imu_subbatch(pst, dict(imu_t=ts, imu_acc=acc, imu_gyro=gyro,
                                          imu_valid=valid), tpp, tps)
    acc_e, gyro_e = truntime.imu_to_ego(acc, gyro, tpp.ego_to_imu_rot, tpp.ego_to_imu_trans)
    e1, (t_s, pos_s, rot_s, vel_s, gyro_s) = tfilter.imu_chain_plain(
        st, ts, acc_e, gyro_e, valid, tpp.ekf, tps.ekf_flags)
    assert_tree_close(flatten(out.ekf), flatten(e1), atol=0.0)
    rpy = tfilter.lie.rot_to_euler(tfilter.lie.quat_to_rot(rot_s))
    want = trings.push_ego_batch(pst.ego_ring, t_s, pos_s, rpy,
                                 tfilter.global_to_local_velocity(vel_s, rpy), gyro_s, valid)
    assert_tree_close(flatten(out.ego_ring), flatten(want), atol=0.0)
    want = trings.push_imu_batch(pst.imu_ring, ts, gyro @ tpp.ego_to_imu_rot.T,
                                 acc @ tpp.ego_to_imu_rot.T, valid)
    assert_tree_close(flatten(out.imu_ring), flatten(want), atol=0.0)
