"""The Joseph-form covariance update of elimaloc_tpu_torch against the JAX
package (``EkfFlags.joseph_form``: (I - K H) P (I - K H)^T + K R K^T instead
of the reference's P -= K H P; JAX ``ekf/filter.py:221-259``).

* ``imu_chain_plain`` (kernel H's plain version) with the complementary
  filter (m = 2) and the mounting calibration (m = 3) in the Joseph form,
  against JAX ``predict_imu`` per sample: float64 atol 1e-10, float32 1e-5,
  as tests/test_torch_imu_chain.py.
* ``update_chain_plain`` (kernel I's plain version) over CAN samples (m = 4),
  a GPS fix (3-DOF, m = 3; 6-DOF ODOMETRY, m = 6) and the PCM pose (m = 6),
  against JAX ``update_can`` / ``gps_step`` / ``update_gnss``: float64 atol
  1e-10, float32 1e-5 on P of order 1e-2.
* A pipeline given the flag as the JAX package's own test gives it
  (``pipe.static = dataclasses.replace(pipe.static, ekf_flags=...)`` after
  construction, tests/test_long_horizon.py:59-66): ``run``, ``run_frames``
  and ``run_fused`` on the GPS + CAN fusion configuration of
  tests/test_torch_stream.py in float64, each within 1e-6 m of JAX's with
  the same scans applied, and ``run_fused`` off the reference form's
  trajectory by rounding only (with the optimal gain the two forms are
  equal in exact arithmetic; the difference shows the flag took effect).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.ekf import state as jstate
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.ekf import GnssMeas
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import assert_tree_close, flatten, one_torch_thread, t, tiny_cfg  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10),
          "f32": (jnp.float32, torch.float32, 1e-5)}


def _joseph(flags):
    return dataclasses.replace(flags, joseph_form=True)


@pytest.mark.parametrize("flags", ["default", "calibration"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_imu_chain_plain_joseph_matches_jax(dt_name, flags):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(19)
    jcfg, tcfg = jconfig.ElimalocConfig(), tconfig.ElimalocConfig()
    jcfg.ekf.imu_estimate_calibration = tcfg.ekf.imu_estimate_calibration = (
        flags == "calibration")
    jpp = jruntime.make_pipeline_params(jcfg, dtype=jdt)
    jflags = _joseph(jruntime.make_pipeline_static(jcfg).ekf_flags)
    tflags = _joseph(truntime.make_pipeline_static(tcfg).ekf_flags)
    assert jflags.run_cf and tflags.run_cf
    a = rng.normal(size=(27, 27)) * 1e-5
    ekf = jfilter.init_state(jpp.ekf, dtype=jdt).replace(
        P=jnp.asarray(a @ a.T + np.eye(27) * 1e-8, jdt), vel=jnp.asarray([5.0, 0.3, 0.0], jdt),
        pos=jnp.asarray([60.0, 2.0, 0.1], jdt), state_initialized=jnp.asarray(True),
        yaw_initialized=jnp.asarray(True), prev_timestamp=jnp.asarray(1.0, jdt))
    n = 10
    ts = 1.0 + 0.01 * np.arange(1, n + 1)
    acc = rng.normal(0, 0.3, (n, 3)) + [0.5, 0.1, 9.81]
    gyro = rng.normal(0, 0.05, (n, 3)) + [0.0, 0.0, 2.0]
    valid = np.ones(n, bool)
    valid[3] = False
    tin = convert.ekf_state(flatten(ekf), dtype=tdt)
    plain_form = jnp.asarray(0.0)
    for i in range(n):
        meas = jstate.ImuMeas(timestamp=jnp.asarray(ts[i], jdt), acc=jnp.asarray(acc[i], jdt),
                              gyro=jnp.asarray(gyro[i], jdt))
        nxt = jfilter.predict_imu(ekf, meas, jpp.ekf, jflags)
        ref = jfilter.predict_imu(ekf, meas, jpp.ekf, dataclasses.replace(jflags,
                                                                         joseph_form=False))
        if valid[i]:
            plain_form = jnp.maximum(plain_form, jnp.max(jnp.abs(nxt.P - ref.P)))
            ekf = nxt
    tout, _ = tfilter.imu_chain_plain(tin, t(ts, tdt), t(acc, tdt), t(gyro, tdt), t(valid),
                                      convert.ekf_params(flatten(jpp.ekf), dtype=tdt), tflags)
    assert_tree_close(flatten(tout), flatten(ekf), atol=atol)
    if flags == "calibration":
        assert bool(tout.vehicle_imu_calib_started)
    if dt_name == "f64":    # the Joseph form, not the reference form, ran
        assert float(plain_form) > 0.0


def _moving(jdt, rng):
    params = jstate.make_params(jconfig.EkfConfig(), dtype=jdt)
    a = rng.normal(size=(27, 27)) * 2e-2
    q = np.array([1.0, 0.02, -0.03, 0.4])
    st = jfilter.init_state(params, dtype=jdt).replace(
        P=jnp.asarray(a @ a.T + np.eye(27) * 1e-3, jdt),
        rot=jnp.asarray(q / np.linalg.norm(q), jdt), pos=jnp.asarray([60.0, 1.5, 0.2], jdt),
        vel=jnp.asarray([0.8, 5.0, 0.1], jdt), gyro=jnp.asarray([0.01, -0.02, 0.3], jdt),
        prev_can_timestamp=jnp.asarray(1.0, jdt), prev_timestamp=jnp.asarray(1.0, jdt),
        state_initialized=jnp.asarray(True), yaw_initialized=jnp.asarray(True))
    return params, st


@pytest.mark.parametrize("gps_type", ["NAVSATFIX", "ODOMETRY"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_update_chain_plain_joseph_matches_jax(dt_name, gps_type):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(29)
    params, jst = _moving(jdt, rng)
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    for c, mod in ((jcfg, jconfig), (tcfg, tconfig)):
        c.ekf.use_gps = c.ekf.use_can = True
        c.ekf.gps_type = mod.GpsType[gps_type]
    jpp = jruntime.make_pipeline_params(jcfg, dtype=jdt).replace(ekf=params)
    jps = jruntime.make_pipeline_static(jcfg)
    jps = dataclasses.replace(jps, ekf_flags=_joseph(jps.ekf_flags))
    tflags = _joseph(truntime.make_pipeline_static(tcfg).ekf_flags)
    can = (np.array([1.02, 1.04, 1.045, 1.06]), np.array([5.1, 5.0, 4.9, 0.03]),
           np.array([0.31, 0.3, 0.29, 0.002]), np.array([True, True, True, False]))
    gps = (np.array([1.07]), np.array([[60.3, 1.8, 0.15]]), np.array([[0.3, 0.3, 0.3]]),
           np.array([True]))
    qm = np.array([1.0, 0.025, -0.028, 0.41])
    b = rng.normal(size=(3, 3)) * 0.05
    pcm = dict(t=1.1, pos=[60.35, 1.9, 0.12], rot=qm / np.linalg.norm(qm),
               pos_cov=b @ b.T + 0.01 * np.eye(3), rot_cov=np.eye(3) * 1e-4)

    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    st = jruntime.PipelineState(ekf=jst, ego_ring=jrings.make_ego_ring(8, jdt),
                                imu_ring=jrings.make_imu_ring(8, jdt))
    for k in range(4):
        if can[3][k]:
            st = jruntime.can_step(st, J(can[0][k]), J(can[1][k]), J(can[2][k]), jpp, jps)
    st = jruntime.gps_step(st, J(gps[0][0]), J(gps[1][0]), J(gps[2][0]), jpp, jps)
    jmeas = jstate.GnssMeas(timestamp=J(pcm["t"]), source=jnp.asarray(3), pos=J(pcm["pos"]),
                            rot=J(pcm["rot"]), pos_cov=J(pcm["pos_cov"]),
                            rot_cov=J(pcm["rot_cov"]))
    jout = jfilter.update_gnss(st.ekf, jmeas, params, jps.ekf_flags)

    T = lambda a, dt=tdt: t(a, dt)  # noqa: E731
    tmeas = GnssMeas(timestamp=T(pcm["t"]), source=3, pos=T(pcm["pos"]), rot=T(pcm["rot"]),
                     pos_cov=T(pcm["pos_cov"]), rot_cov=T(pcm["rot_cov"]))
    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    tout = tfilter.update_chain_plain(
        convert.ekf_state(flatten(jst), dtype=tdt), tpp.ekf, tflags,
        can=tuple(T(x) for x in can[:3]) + (torch.as_tensor(can[3]),),
        gps=tuple(T(x) for x in gps[:3]) + (torch.as_tensor(gps[3]),),
        gnss_uncertainty_max=tpp.gnss_uncertainty_max, pcm=(tmeas, torch.tensor(True)))
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)
    assert float(tout.prev_gnss_timestamp) == pytest.approx(pcm["t"])
    if dt_name == "f64":
        ref = tfilter.update_chain_plain(
            convert.ekf_state(flatten(jst), dtype=tdt), tpp.ekf,
            dataclasses.replace(tflags, joseph_form=False),
            can=tuple(T(x) for x in can[:3]) + (torch.as_tensor(can[3]),),
            gps=tuple(T(x) for x in gps[:3]) + (torch.as_tensor(gps[3]),),
            gnss_uncertainty_max=tpp.gnss_uncertainty_max, pcm=(tmeas, torch.tensor(True)))
        # the same P up to rounding (with the optimal gain both forms are
        # exact), through another computation
        assert 0.0 < float((ref.P - tout.P).abs().max()) <= 1e-15
        assert float((tout.P - tout.P.T).abs().max()) <= 1e-15


@pytest.fixture(scope="module")
def fusion_pipes():
    """The GPS + CAN fusion configuration of tests/test_torch_stream.py in
    float64, each package's pipeline switched to the Joseph form after
    construction, and a port pipeline left in the reference form."""
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=1.6, points_per_scan=1024, max_range=50.0,
                              seed=10, gps_hz=5.0)
    kw = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128)

    def cfg(mod):
        c = tiny_cfg(mod)
        c.ekf.use_gps = c.ekf.use_can = True
        return c

    jpipe = LocalizationPipeline(cfg(jconfig), world, dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **kw)
    jpipe.static = dataclasses.replace(jpipe.static,
                                       ekf_flags=_joseph(jpipe.static.ekf_flags))
    jpipe._build_jitted()
    pipes = {}
    for joseph in (True, False):
        p = TPipeline(cfg(tconfig), world, dtype=torch.float64, device="cpu",
                      tile_budget=TBudget(qb=8, max_slots=1024), **kw)
        if joseph:
            p.static = dataclasses.replace(p.static, ekf_flags=_joseph(p.static.ekf_flags))
        pipes[joseph] = p
    return log, jpipe, pipes


@pytest.mark.parametrize("loop", ["run", "run_frames", "run_fused"])
def test_joseph_pipeline_matches_jax(fusion_pipes, loop):
    log, jpipe, pipes = fusion_pipes
    tpipe = pipes[True]
    assert tpipe.static.ekf_flags.joseph_form
    if loop == "run":
        jt, tt = jpipe.run(log)[1], tpipe.run(log)[1]
        jpos, tpos = np.asarray(jt["pos"]), tt["pos"]
        japp = [bool(s["applied"]) for s in jt["scans"]]
        tapp = [bool(s["applied"]) for s in tt["scans"]]
    else:
        jo, to = getattr(jpipe, loop)(log)[1], getattr(tpipe, loop)(log)[1]
        jpos, tpos = np.asarray(jo["ego_pos"]), to["ego_pos"]
        japp, tapp = np.asarray(jo["applied"]).tolist(), to["applied"].tolist()
        assert float(np.max(to["p_asym"])) <= 1e-12
    assert tpos.shape == (len(log.scan_t), 3)
    np.testing.assert_allclose(tpos, jpos, rtol=0, atol=1e-6)
    assert tapp == japp and sum(tapp) >= 0.9 * len(tapp)
    if loop == "run_fused":
        ref = pipes[False].run_fused(log)[1]["ego_pos"]
        assert 0.0 < float(np.abs(ref - tpos).max()) <= 1e-9
