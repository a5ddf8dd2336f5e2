"""The ``use_imu=False`` tick mode of elimaloc_tpu_torch against the JAX
package: the constant-acceleration tick ``ekf.filter.predict`` (kernel O's
plain version), the tick mode's event steps ``tick_step`` / ``imu_ring_step``
and the event loop ``run`` with ``use_imu`` off.

Bounds:

* ``predict`` over a sequence through every gate (the reset flag, the
  PCM-init quarantine, a repeated stamp under the 1e-6 s gate, a negative
  dt), interleaved with CAN updates as tests/test_oracle_parity.py:384-419
  does: every float field within atol 1e-9 (float64) or 1e-5 (float32; the
  dense F P F^T rounds in another order), the flags equal.
* ``tick_step`` / ``imu_ring_step``: ring times and counts exactly equal,
  the other ring fields within 1e-12 (float64; the EKF's libm and matmul
  ulps, as tests/test_torch_stream.py's ``imu_step``) or 1e-5 (float32).
* ``run`` on ``tiny_pipe(use_imu=False)`` (tests/test_pipeline_modes.py:82-90)
  in float64: the trajectory after every scan within 1e-6 m of the JAX
  loop's, the same scans applied, and JAX's own tick-mode ATE bound
  (< 2.0 m after the first 2 s); the events of equal time run in the JAX
  order pcm_imu < tick < scan (the first IMU sample and the first tick share
  the log's first stamp).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.ekf import init_state as jinit
from elimaloc_tpu.ekf.state import CanMeas as JCan
from elimaloc_tpu.map import TileQueryBudget
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
from torch_parity import flatten, one_torch_thread, tiny_cfg  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-9),
          "f32": (jnp.float32, torch.float32, 1e-5)}
KW = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128)


def _moving_state(jpp, jdt):
    """A filter in motion with nonzero body rates and acceleration and a
    correlated P, so every block of F moves P."""
    rng = np.random.default_rng(17)
    a = rng.normal(size=(27, 27)) * 0.03
    q = np.array([0.72, 0.01, -0.02, 0.69])
    return jinit(jpp.ekf, dtype=jdt).replace(
        P=jnp.asarray(a @ a.T + np.eye(27) * 1e-3, jdt),
        rot=jnp.asarray(q / np.linalg.norm(q), jdt), vel=jnp.asarray([0.2, 8.0, 0.1], jdt),
        acc=jnp.asarray([0.3, -0.2, 0.05], jdt), gyro=jnp.asarray([0.01, -0.02, 0.2], jdt),
        state_initialized=jnp.asarray(True), yaw_initialized=jnp.asarray(True),
        prev_timestamp=jnp.asarray(1.0, jdt))


#: (tick time, state flags set before the tick); the state starts with its
#: reset flag on, so the first tick only stamps the time and clears it
TICK_SEQUENCE = [
    (1.01, {}), (1.02, {}), (1.0200004, {}), (1.03, {}), (1.025, {}),
    (1.04, {"pcm_init_on_going": True}), (1.05, {}), (1.06, {"pcm_init_on_going": False}),
    (1.07, {"reset_for_init_prediction": True}), (1.08, {}), (1.09, {}), (1.10, {}),
]


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_predict_matches_jax_through_every_gate(dt_name):
    jdt, tdt, atol = DTYPES[dt_name]
    cfg = jconfig.ElimalocConfig()
    jpp = jruntime.make_pipeline_params(cfg, dtype=jdt)
    jflags = jfilter.EkfFlags.from_config(cfg.ekf)
    js = _moving_state(jpp, jdt)
    ts = convert.ekf_state(flatten(js), dtype=tdt)
    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    tflags = tfilter.EkfFlags.from_config(tconfig.ElimalocConfig().ekf)
    jpredict = jax.jit(jfilter.predict)
    jcan = jax.jit(functools.partial(jfilter.update_can, flags=jflags))
    moved = 0
    for k, (t, over) in enumerate(TICK_SEQUENCE):
        if over:
            js = js.replace(**{f: jnp.asarray(v) for f, v in over.items()})
            ts = ts.replace(**{f: torch.tensor(v) for f, v in over.items()})
        before = np.asarray(js.P)
        js = jpredict(js, jnp.asarray(t, jdt), jpp.ekf)
        ts = tfilter.predict(ts, torch.tensor(t, dtype=tdt), tpp.ekf)
        moved += not np.array_equal(before, np.asarray(js.P))
        if k % 4 == 1:
            vel_x, yaw_rate = 7.5 + 0.1 * k, 0.15
            z = jnp.asarray(0.0, jdt)
            js = jcan(js, JCan(timestamp=jnp.asarray(t, jdt),
                               vel=jnp.stack([jnp.asarray(vel_x, jdt), z, z]),
                               gyro=jnp.stack([z, z, jnp.asarray(yaw_rate, jdt)])),
                      params=jpp.ekf)
            ts = tfilter.update_can(ts, tfilter.can_meas(
                torch.tensor(t, dtype=tdt), torch.tensor(vel_x, dtype=tdt),
                torch.tensor(yaw_rate, dtype=tdt)), tpp.ekf, tflags)
        got, ref = flatten(ts), flatten(js)
        for f, v in got.items():
            if v.dtype.kind == "f":
                np.testing.assert_allclose(v, np.asarray(ref[f]), rtol=0, atol=atol,
                                           err_msg=f"tick {k}: {f}")
            else:
                np.testing.assert_array_equal(v, np.asarray(ref[f]), err_msg=f"tick {k}: {f}")
    # the gates let 7 of the 12 ticks predict: not the two that clear a
    # reset flag, the repeated stamp or the two in the PCM-init quarantine
    assert moved == 7


def _ring_states(jdt, tdt):
    cfg = tiny_cfg(jconfig)
    jpp = jruntime.make_pipeline_params(cfg, dtype=jdt)
    jst = jruntime.PipelineState(ekf=_moving_state(jpp, jdt).replace(
        reset_for_init_prediction=jnp.asarray(False)),
        ego_ring=jrings.make_ego_ring(8, jdt), imu_ring=jrings.make_imu_ring(8, jdt))
    tst = convert.pipeline_state(flatten(jst), dtype=tdt)
    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    return jpp, jruntime.make_pipeline_static(cfg), jst, tpp, truntime.make_pipeline_static(
        tiny_cfg(tconfig)), tst


#: 13 stamps into rings of 8: an overflow, a repeat within 1e-5 (the ego
#: ring drops it, the IMU ring's eps is 0) and a time regression that clears
#: both rings
STAMPS = np.r_[1.0 + 0.01 * np.arange(1, 10), 1.09 + 5e-6, 1.05, 1.06, 1.07]


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_tick_and_imu_ring_steps_match_jax(dt_name):
    jdt, tdt, _ = DTYPES[dt_name]
    atol = 1e-12 if dt_name == "f64" else 1e-5
    jpp, jps, jst, tpp, tps, tst = _ring_states(jdt, tdt)
    jtick = jax.jit(functools.partial(jruntime.tick_step, ps=jps))
    jimu = jax.jit(functools.partial(jruntime.imu_ring_step, ps=jps))
    rng = np.random.default_rng(23)
    for k, t in enumerate(STAMPS):
        acc = np.array([0.3, 0.1, 9.81]) + rng.normal(0, 0.1, 3)
        gyro = np.array([0.0, 0.0, 0.13]) + rng.normal(0, 0.02, 3)
        jst = jimu(jst, jnp.asarray(t, jdt), jnp.asarray(acc, jdt), jnp.asarray(gyro, jdt),
                   pp=jpp)
        tst = truntime.imu_ring_step(tst, torch.tensor(t, dtype=tdt),
                                     torch.tensor(acc, dtype=tdt),
                                     torch.tensor(gyro, dtype=tdt), tpp, tps)
        jst = jtick(jst, jnp.asarray(t + 0.002, jdt), pp=jpp)
        tst = truntime.tick_step(tst, torch.tensor(t + 0.002, dtype=tdt), tpp, tps)
        for ring in ("ego_ring", "imu_ring"):
            jr, tr = flatten(getattr(jst, ring)), flatten(getattr(tst, ring))
            assert int(tr["count"]) == int(jr["count"]), (k, ring)
            np.testing.assert_array_equal(tr["t"], np.asarray(jr["t"]), err_msg=f"{k} {ring}")
            for f in tr:
                if f not in ("t", "count"):
                    np.testing.assert_allclose(tr[f], jr[f], rtol=0, atol=atol,
                                               err_msg=f"{k} {ring}.{f}")
        np.testing.assert_allclose(tst.ekf.P.numpy(), np.asarray(jst.ekf.P), rtol=0,
                                   atol=atol * 10)
    # the regression cleared both rings and they refilled
    assert int(tst.imu_ring.count) == 3 and int(tst.ego_ring.count) == 3


@pytest.fixture(scope="module")
def tick_pipes():
    """tiny_pipe(use_imu=False) in float64 on both sides, and its log."""
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=3.0, points_per_scan=1024, max_range=50.0,
                              seed=10, gps_hz=1.0)
    jc, tc = tiny_cfg(jconfig), tiny_cfg(tconfig)
    jc.ekf.use_imu = tc.ekf.use_imu = False
    jpipe = LocalizationPipeline(jc, world, dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **KW)
    tpipe = TPipeline(tc, world, dtype=torch.float64, device="cpu",
                      tile_budget=TBudget(qb=8, max_slots=1024), **KW)
    return log, jpipe, tpipe


def test_tick_mode_run_f64_matches_jax(tick_pipes):
    log, jpipe, tpipe = tick_pipes
    assert tpipe.static.use_imu is False and tpipe.static.tick_hz == 100.0
    _, jtraj = jpipe.run(log)
    _, ttraj = tpipe.run(log)
    assert ttraj["pos"].shape == (len(log.scan_t), 3)
    np.testing.assert_allclose(ttraj["pos"], np.asarray(jtraj["pos"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ttraj["t"], np.asarray(jtraj["t"]), rtol=0, atol=1e-9)
    applied = [bool(s["applied"]) for s in ttraj["scans"]]
    assert applied == [bool(s["applied"]) for s in jtraj["scans"]]
    assert sum(applied) >= 0.9 * len(applied)
    tail = ttraj["t"] > log.scan_t[0] + 2.0
    ate = ate_rmse(ttraj["t"][tail], ttraj["pos"][tail], log.truth_t, log.truth_pos)
    assert ate < 2.0, ate


def test_tick_mode_events_run_in_the_jax_order(tick_pipes, monkeypatch):
    """The kinds of the events, in the order each loop ran them, over the
    first 0.6 s of the log: equal, with a pcm_imu and a tick at the same
    stamp (the log's first) run pcm_imu first, and no IMU prediction."""
    log, jpipe, tpipe = tick_pipes
    short = jlog.synthesize_log(jlog.make_world(seed=9, extent=70.0, n_ground=60_000,
                                                n_wall=30_000),
                                duration=0.6, points_per_scan=1024, max_range=50.0, seed=10)
    order = {"jax": [], "port": []}
    for name, kind in (("_tick_step", "tick"), ("_imu_ring_step", "pcm_imu"),
                       ("_scan_step", "scan"), ("_imu_step", "imu")):
        orig = getattr(jpipe, name)

        def rec(*a, _orig=orig, _kind=kind, **k):
            order["jax"].append((_kind, float(a[1])))
            return _orig(*a, **k)
        monkeypatch.setattr(jpipe, name, rec)
    for name, kind in (("tick_step", "tick"), ("imu_ring_step", "pcm_imu"),
                       ("scan_step", "scan"), ("imu_step", "imu")):
        orig = getattr(truntime, name)

        def rec(*a, _orig=orig, _kind=kind, **k):
            order["port"].append((_kind, float(a[1])))
            return _orig(*a, **k)
        monkeypatch.setattr(truntime, name, rec)
    jpipe.run(short)
    tpipe.run(short)
    kinds = [k for k, _ in order["port"]]
    assert kinds == [k for k, _ in order["jax"]]
    assert "imu" not in kinds and kinds.count("scan") == len(short.scan_t)
    assert kinds[:2] == ["pcm_imu", "tick"] and order["port"][0][1] == order["port"][1][1]
    np.testing.assert_allclose([t for _, t in order["port"]], [t for _, t in order["jax"]],
                               rtol=0, atol=1e-12)
