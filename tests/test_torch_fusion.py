"""GPS + CAN fusion: elimaloc_tpu_torch vs the JAX package.

Open loop, each function on the same NumPy-made state and measurement in
float64 (atol 1e-10: one update, only summation order and libm ulps differ)
and float32 (atol 1e-5, on states of order 1-60 and P of order 1e-2):
``update_can`` and the pipeline's ``can_step`` (ZuptCan on and off, and the
0.01 s dt gate), the Kalman
update on CAN's non-contiguous selector (6, 7, 8, 11), and ``gps_step`` for
NAVSATFIX, BESTPOS and ODOMETRY plus a fix the variance gate rejects (the
cases of tests/test_pipeline_modes.py:46-79).

Fused frames, float64, open loop per frame with ``use_gps = use_can =
True``: P2P on ``tiny_pipe(gps_hz=5)`` and AVGICP on the bench_methods world
(the denser world where the method converges, tests/test_torch_methods_
replay.py), against the JAX pipeline's own frame on the same state, map and
batches. Seven frames, not five: the logs' first GPS fix (t = 0.5 s) lands
in frame 6. Bounds: ego_pos atol 1e-6 m, EKF P atol 1e-9, equal applied and
iterations.

Closed loop, float32: the whole P2P+GPS+CAN log of test_pipeline_modes.py:
194 on each side's own pipeline, held to the closed-loop contract (max
< 3 cm, median < 5 mm, last 3 frames < 5 mm).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.ekf import state as jstate
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import ate_rmse
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import (assert_tree_close, flatten, method_cfg,  # noqa: F401
                          one_torch_thread, tiny_cfg)

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10),
          "f32": (jnp.float32, torch.float32, 1e-5)}


def _state(preset, jdt, rng):
    """A JAX EkfState: 'init' (the filter as reset: P = 100 I, yaw not
    initialized) or 'moving' (a random SPD P of order 1e-2, tilted and
    turning at 5 m/s, a CAN yaw-rate bias, the last CAN update at 1.0 s)."""
    params = jstate.make_params(jconfig.EkfConfig(), dtype=jdt)
    st = jfilter.init_state(params, dtype=jdt)
    if preset == "init":
        return params, st
    a = rng.normal(size=(27, 27)) * 2e-2
    P = a @ a.T + np.eye(27) * 1e-3
    q = np.array([1.0, 0.02, -0.03, 0.4])
    st = st.replace(
        P=jnp.asarray(P, jdt), rot=jnp.asarray(q / np.linalg.norm(q), jdt),
        pos=jnp.asarray([60.0, 1.5, 0.2], jdt), vel=jnp.asarray([0.8, 5.0, 0.1], jdt),
        gyro=jnp.asarray([0.01, -0.02, 0.3], jdt),
        can_yaw_rate_bias=jnp.asarray(0.01, jdt),
        prev_can_timestamp=jnp.asarray(1.0, jdt), prev_timestamp=jnp.asarray(1.0, jdt),
        state_initialized=jnp.asarray(True), yaw_initialized=jnp.asarray(True))
    return params, st


def _port(jobj, fn, tdt):
    return fn(flatten(jobj), dtype=tdt)


#: CAN sample per case: (t, vel_x, yaw_rate) against a state whose last CAN
#: update was at 1.0 s
CAN_CASES = {"zupt_off": (1.02, 5.1, 0.31), "zupt_on": (1.02, 0.03, 0.002),
             "dt_gate": (1.005, 5.1, 0.31)}


@pytest.mark.parametrize("case", sorted(CAN_CASES))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_update_can(dt_name, case):
    jdt, tdt, atol = DTYPES[dt_name]
    params, jst = _state("moving", jdt, np.random.default_rng(3))
    t, vx, yr = CAN_CASES[case]
    jcan = jstate.CanMeas(timestamp=jnp.asarray(t, jdt),
                          vel=jnp.asarray([vx, 0.0, 0.0], jdt),
                          gyro=jnp.asarray([0.0, 0.0, yr], jdt))
    tcan = tfilter.can_meas(torch.tensor(t, dtype=tdt), torch.tensor(vx, dtype=tdt),
                            torch.tensor(yr, dtype=tdt))
    flags = jfilter.EkfFlags()
    jout = jfilter.update_can(jst, jcan, params, flags)
    tin = _port(jst, convert.ekf_state, tdt)
    tout = tfilter.update_can(tin, tcan, _port(params, convert.ekf_params, tdt),
                              tfilter.EkfFlags())
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)
    if case == "dt_gate":
        assert_tree_close(flatten(tout), flatten(tin), atol=0.0)
    else:
        assert float(tout.prev_can_timestamp) == pytest.approx(t)
        moved = float(tout.can_yaw_rate_bias) != float(tin.can_yaw_rate_bias)
        assert moved == (case == "zupt_on")

    # the pipeline's CAN step on the same sample (JAX runtime.py:260)
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    jcfg.ekf.use_can = tcfg.ekf.use_can = True
    jpp = jruntime.make_pipeline_params(jcfg, dtype=jdt)
    jps_st = jruntime.PipelineState(ekf=jst, ego_ring=jrings.make_ego_ring(8, jdt),
                                    imu_ring=jrings.make_imu_ring(8, jdt))
    jout = jruntime.can_step(jps_st, *(jnp.asarray(x, jdt) for x in (t, vx, yr)), jpp,
                             jruntime.make_pipeline_static(jcfg))
    tout = truntime.can_step(convert.pipeline_state(flatten(jps_st), dtype=tdt),
                             *(torch.tensor(x, dtype=tdt) for x in (t, vx, yr)),
                             convert.pipeline_params(flatten(jpp), dtype=tdt),
                             truntime.make_pipeline_static(tcfg))
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_measurement_update_on_can_selector(dt_name):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(5)
    _, jst = _state("moving", jdt, rng)
    idx = (6, 7, 8, 11)
    Y = rng.normal(0, 0.2, 4)
    a = rng.normal(size=(4, 4)) * 0.1
    R = a @ a.T + np.eye(4) * 1e-2
    jout = jfilter._ekf_measurement_update(jst, idx, jnp.asarray(Y, jdt),
                                           jnp.asarray(R, jdt))
    tout = tfilter._ekf_measurement_update(
        _port(jst, convert.ekf_state, tdt), idx, torch.tensor(Y, dtype=tdt),
        torch.tensor(R, dtype=tdt))
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)


#: case -> (gps_type, gnss_uncertainty_max_m, cov_diag); "rejected" squares
#: 5 m into 25 > 0.5 (test_pipeline_modes.py:72-79)
GPS_CASES = {"NAVSATFIX": ("NAVSATFIX", 1.0, 0.3), "BESTPOS": ("BESTPOS", 1.0, 0.3),
             "ODOMETRY": ("ODOMETRY", 1.0, 0.3), "rejected": ("NAVSATFIX", 0.5, 5.0)}


@pytest.mark.parametrize("case", sorted(GPS_CASES))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_gps_step(dt_name, case):
    jdt, tdt, atol = DTYPES[dt_name]
    gps_type, gate, cov = GPS_CASES[case]
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = tiny_cfg(mod)
        cfg.ekf.use_gps = True
        cfg.ekf.gps_type = mod.GpsType[gps_type]
        cfg.ekf.gnss_uncertainty_max_m = gate
        cfgs.append(cfg)
    jpp = jruntime.make_pipeline_params(cfgs[0], dtype=jdt)
    jps = jruntime.make_pipeline_static(cfgs[0])
    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    tps = truntime.make_pipeline_static(cfgs[1])
    pos, cov_d = np.array([60.0, 0.1, 0.0]), np.full(3, cov)
    for preset in ("init", "moving"):
        _, jekf = _state(preset, jdt, np.random.default_rng(9))
        jst = jruntime.PipelineState(ekf=jekf, ego_ring=jrings.make_ego_ring(8, jdt),
                                     imu_ring=jrings.make_imu_ring(8, jdt))
        jout = jruntime.gps_step(jst, jnp.asarray(0.5, jdt), jnp.asarray(pos, jdt),
                                 jnp.asarray(cov_d, jdt), jpp, jps)
        tst = convert.pipeline_state(flatten(jst), dtype=tdt)
        tout = truntime.gps_step(tst, torch.tensor(0.5, dtype=tdt),
                                 torch.tensor(pos, dtype=tdt),
                                 torch.tensor(cov_d, dtype=tdt), tpp, tps)
        assert_tree_close(flatten(tout), flatten(jout), atol=atol, path=preset)
        P0, P1 = float(tst.ekf.P[0, 0]), float(tout.ekf.P[0, 0])
        # an accepted fix shrinks the position covariance, a rejected one
        # leaves the state as it was
        assert (P1 < P0) == (case != "rejected"), preset
        if case == "rejected":
            assert_tree_close(flatten(tout), flatten(tst), atol=0.0)


def _fusion_cfg(cfg_mod, method):
    cfg = method_cfg(cfg_mod, method)
    cfg.ekf.use_gps = True
    cfg.ekf.use_can = True
    return cfg


def _world_and_log(method):
    """P2P: the ``tiny_pipe(gps_hz=5)`` world and log; AVGICP: the
    bench_methods world (bench.py:562, cut to 2 s at 8192 points)."""
    if method == "P2P":
        world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
        log = jlog.synthesize_log(world, duration=3.0, points_per_scan=1024,
                                  max_range=50.0, seed=10, gps_hz=5.0)
        return world, log, 1024
    world = jlog.make_world(seed=7, extent=60.0, n_ground=150_000, n_wall=80_000)
    log = jlog.synthesize_log(world, duration=2.0, points_per_scan=8192,
                              max_range=60.0, seed=8, imu_noise_gyro=0.001,
                              imu_noise_acc=0.01)
    built = jbuilder.build_voxel_map(world, 1.0, 30, use_native=False,
                                     compute_voxel_cov=True)
    return built, log, 4096


@pytest.mark.parametrize("method", ["AVGICP", "P2P"])
def test_seven_frames_f64_match_jax(method):
    world, log, ds_points = _world_and_log(method)
    budget = dict(qb=8, max_slots=1024)
    pipe = LocalizationPipeline(
        _fusion_cfg(jconfig, method), world, dtype=jnp.float64, ds_points=ds_points,
        tile_budget=TileQueryBudget(**budget), use_native=False, ego_ring_size=128,
        imu_ring_size=128)
    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = jruntime.build_fused_batches(log, dtype=np.float64,
                                           time_base=pipe.time_base)

    tstate = convert.pipeline_state(flatten(state), dtype=torch.float64)
    tparams = convert.pipeline_params(flatten(pipe.params), dtype=torch.float64)
    tmap = convert.tile_map(flatten(pipe.map), dtype=torch.float64)
    tstatic = truntime.make_pipeline_static(
        _fusion_cfg(tconfig, method), tile_budget=TBudget(**budget),
        ds_points=ds_points, reassign_each_iter=False if method == "AVGICP" else None)
    assert tstatic.use_gps and tstatic.use_can
    tbatches = truntime.batches_to_device(
        truntime.build_fused_batches(log, dtype=np.float64, time_base=pipe.time_base),
        dtype=torch.float64)

    n_frames = 7
    assert tbatches["gps_valid"][:n_frames].sum() >= 1
    assert tbatches["can_valid"][:n_frames].sum() >= 5 * n_frames
    for k in range(n_frames):
        state, jout = pipe._frame(state, {key: v[k] for key, v in batches.items()},
                                  pipe.map)
        tstate, tout = truntime.fused_frame(
            tstate, {key: v[k] for key, v in tbatches.items()}, tmap, tparams, tstatic)
        np.testing.assert_allclose(tout["ego_pos"].numpy(), np.asarray(jout["ego_pos"]),
                                   rtol=0, atol=1e-6, err_msg=f"frame {k}")
        np.testing.assert_allclose(tstate.ekf.P.numpy(), np.asarray(state.ekf.P),
                                   rtol=0, atol=1e-9, err_msg=f"frame {k}")
        np.testing.assert_allclose(float(tstate.ekf.can_yaw_rate_bias),
                                   float(state.ekf.can_yaw_rate_bias), rtol=0, atol=1e-12)
        assert float(tstate.ekf.prev_gnss_timestamp) == float(state.ekf.prev_gnss_timestamp)
        assert bool(tout["applied"]) == bool(jout["applied"]), k
        assert int(tout["iterations"]) == int(jout["iterations"]), k
    assert bool(tout["applied"])


def test_whole_log_f32_closed_loop_contract():
    """test_pipeline_modes.py:194's configuration: tiny_pipe(gps_hz=5,
    duration=2, use_gps, use_can), each side's own fused replay."""
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=2.0, points_per_scan=1024,
                              max_range=50.0, seed=10, gps_hz=5.0)
    kw = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128)
    jpipe = LocalizationPipeline(_fusion_cfg(jconfig, "P2P"), world,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **kw)
    _, jouts = jpipe.run_fused(log)
    tpipe = TPipeline(_fusion_cfg(tconfig, "P2P"), world, device="cpu",
                      tile_budget=TBudget(qb=8, max_slots=1024), **kw)
    assert tpipe.static.use_gps and tpipe.static.use_can
    _, touts = tpipe.run_fused(log)

    err = np.linalg.norm(touts["ego_pos"] - np.asarray(jouts["ego_pos"]), axis=1)
    assert float(np.max(err)) < 0.03, err.max()
    assert float(np.median(err)) < 0.005, np.median(err)
    assert float(np.max(err[-3:])) < 0.005, err[-3:]
    assert touts["applied"].mean() >= 0.9
    assert int(touts["slots_dropped"].max()) == 0
    ate = ate_rmse(touts["ego_t_abs"], touts["ego_pos"], log.truth_t, log.truth_pos)
    assert ate < 0.1, ate
