"""The port against its copy of the float64 NumPy oracle,
``elimaloc_tpu_torch/reference_cpu.py`` (JAX's file byte for byte:
tests/test_torch_guards.py), as tests/test_oracle_parity.py holds the JAX
package to ``elimaloc_tpu/reference_cpu.py``.

* The three golden classes, with JAX's inputs, steps and bounds
  (test_oracle_parity.py:45, 325, 383), run on the port's float64 EKF on
  the CPU: the PCM_INIT quarantine window (every intermediate state: pos,
  vel, rot 1e-6, P 1e-5, the timestamp 1e-12, the flags and the counter
  equal), the stationary ZUPT (vel, bg, ba, grav 1e-6 a step) and the CA
  model with CAN updates (pos, vel, rot 1e-7, P 1e-4 a step).
* ``slow``: the closed-loop P2P trajectory parity of
  test_oracle_parity.py:146-220: the port's float64 event loop ``run``
  against ``CpuPipeline`` on the same log, ATE between them < 1 cm and
  both within 0.25 m of the truth.

The port imports no JAX here: the oracle and the filter are both the
port's.
"""

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import reference_cpu as oracle
from elimaloc_tpu_torch.config import ElimalocConfig, GnssSource, IcpMethod
from elimaloc_tpu_torch.ekf import (
    CanMeas,
    EkfFlags,
    GnssMeas,
    ImuMeas,
    init_state,
    make_params,
    predict,
    predict_imu,
    update_can,
    update_gnss,
)
from torch_parity import one_torch_thread  # noqa: F401

F64 = torch.float64


def _t(v):
    return torch.as_tensor(np.asarray(v, float), dtype=F64)


def _n(x):
    return x.numpy()


def _imu(t, acc, gyro):
    return ImuMeas(timestamp=_t(t), acc=_t(acc), gyro=_t(gyro))


def _gnss(t, source, pos, rot, pc, rc):
    return GnssMeas(timestamp=_t(t), source=int(source), pos=_t(pos), rot=_t(rot),
                    pos_cov=_t(pc), rot_cov=_t(rc))


class TestQuarantineGolden:
    def test_pcm_init_release_window(self):
        """Both filters stepped through a cold IMU, a PCM_INIT reset, 12
        interleaved (IMU, PCM) pairs and the release (test_oracle_parity.py:
        46-143), every intermediate state compared."""
        cfg = ElimalocConfig()
        cfg.ekf.ekf_init_x_m = 1.0
        cfg.ekf.ekf_init_yaw_deg = 30.0
        params = make_params(cfg.ekf, dtype=F64)
        flags = EkfFlags.from_config(cfg.ekf)
        ts = init_state(params, dtype=F64)
        cs = oracle.CpuEkf(cfg)
        rng = np.random.default_rng(7)

        def step_imu(ts, t):
            acc = np.array([0.1, 0.0, 9.81]) + rng.normal(0, 0.01, 3)
            gyro = np.array([0.0, 0.0, 0.05]) + rng.normal(0, 0.001, 3)
            ts = predict_imu(ts, _imu(t, acc, gyro), params, flags)
            cs.run_prediction_imu(t, acc, gyro)
            return ts

        def step_pcm(ts, t, source, pos, yaw):
            rot = oracle.rot_to_quat(oracle.euler_to_rot([0.0, 0.0, yaw]))
            pc = np.eye(3) * (1e-9 if source == GnssSource.PCM_INIT else 0.05)
            rc = np.eye(3) * (1e-9 if source == GnssSource.PCM_INIT else 0.01)
            ts = update_gnss(ts, _gnss(t, source, pos, rot, pc, rc), params, flags)
            cs.run_gnss_update(t, source, np.asarray(pos, float), rot, pc, rc)
            return ts

        def compare(ts, tag):
            np.testing.assert_allclose(_n(ts.pos), cs.pos, rtol=0, atol=1e-6,
                                       err_msg=f"{tag}: pos")
            np.testing.assert_allclose(_n(ts.vel), cs.vel, rtol=0, atol=1e-6,
                                       err_msg=f"{tag}: vel")
            q_t = _n(ts.rot)
            q_c = cs.rot if np.dot(cs.rot, q_t) >= 0 else -cs.rot
            np.testing.assert_allclose(q_t, q_c, rtol=0, atol=1e-6, err_msg=f"{tag}: rot")
            np.testing.assert_allclose(_n(ts.P), cs.P, rtol=0, atol=1e-5, err_msg=f"{tag}: P")
            assert float(ts.prev_timestamp) == pytest.approx(cs.prev_timestamp, abs=1e-12), tag
            assert bool(ts.pcm_init_on_going) == cs.pcm_init_on_going, tag
            assert int(ts.pcm_update_count) == cs.pcm_update_count, tag
            assert bool(ts.state_initialized) == cs.state_initialized, tag

        t = 1.0
        for _ in range(5):
            ts = step_imu(ts, t)
            compare(ts, f"cold imu @{t:.2f}")
            t += 0.01
        ts = step_pcm(ts, t, GnssSource.PCM_INIT, [2.0, -1.0, 0.2], 0.6)
        compare(ts, "pcm_init")
        for k in range(12):
            t += 0.01
            ts = step_imu(ts, t)
            compare(ts, f"quarantine imu {k}")
            t += 0.001
            ts = step_pcm(ts, t, GnssSource.PCM, [2.0 + 0.01 * k, -1.0, 0.2], 0.6)
            compare(ts, f"quarantine pcm {k}")
        assert not bool(ts.pcm_init_on_going), "released after >10 updates"
        for _ in range(5):
            t += 0.01
            ts = step_imu(ts, t)
            compare(ts, f"released imu @{t:.2f}")


class TestZuptGolden:
    def test_stationary_zupt_matches_oracle(self):
        """The IMU-only EKF with ZUPT on a stationary vehicle, the
        complementary filter off (test_oracle_parity.py:326-380): velocity,
        biases and gravity step for step."""
        cfg = ElimalocConfig()
        cfg.ekf.use_zupt = True
        cfg.ekf.use_complementary_filter = False
        params = make_params(cfg.ekf, dtype=F64)
        flags = EkfFlags.from_config(cfg.ekf)
        ts = init_state(params, dtype=F64)
        cs = oracle.CpuEkf(cfg)
        rot = np.array([1.0, 0.0, 0.0, 0.0])
        for k in range(3):
            t = 1.0 + 0.05 * k
            pc, rc = np.eye(3) * 0.01, np.eye(3) * 0.001
            ts = update_gnss(ts, _gnss(t, GnssSource.NOVATEL, np.zeros(3), rot, pc, rc),
                             params, flags)
            cs.run_gnss_update(t, GnssSource.NOVATEL, np.zeros(3), rot, pc, rc)
        rng = np.random.default_rng(3)
        t = 1.2
        for k in range(40):
            t += 0.01
            acc = np.array([0.0, 0.0, 9.81]) + rng.normal(0, 0.005, 3)
            gyro = rng.normal(0, 0.0005, 3)
            ts = predict_imu(ts, _imu(t, acc, gyro), params, flags)
            cs.run_prediction_imu(t, acc, gyro)
            for name in ("vel", "bg", "ba", "grav"):
                np.testing.assert_allclose(_n(getattr(ts, name)), getattr(cs, name), rtol=0,
                                           atol=1e-6, err_msg=f"step {k}: {name}")
        assert np.abs(cs.bg).max() > 0


class TestCaModelGolden:
    def test_ca_prediction_matches_oracle(self):
        """The use_imu=False CA-model tick at 100 Hz, with CAN updates every
        fifth tick (test_oracle_parity.py:384-428)."""
        cfg = ElimalocConfig()
        cfg.ekf.use_can = True
        params = make_params(cfg.ekf, dtype=F64)
        flags = EkfFlags.from_config(cfg.ekf)
        ts = init_state(params, dtype=F64)
        cs = oracle.CpuEkf(cfg)
        t = 1.0
        for k in range(30):
            t += 0.01
            ts = predict(ts, _t(t), params)
            cs.run_prediction(t)
            if k % 5 == 2:
                vel_x, yaw_rate = 2.0 + 0.1 * k, 0.1
                ts = update_can(ts, CanMeas(timestamp=_t(t), vel=_t([vel_x, 0.0, 0.0]),
                                            gyro=_t([0.0, 0.0, yaw_rate])), params, flags)
                cs.run_can_update(t, vel_x, yaw_rate)
            np.testing.assert_allclose(_n(ts.pos), cs.pos, rtol=0, atol=1e-7,
                                       err_msg=f"step {k}: pos")
            np.testing.assert_allclose(_n(ts.vel), cs.vel, rtol=0, atol=1e-7,
                                       err_msg=f"step {k}: vel")
            q_t = _n(ts.rot)
            q_c = cs.rot if np.dot(cs.rot, q_t) >= 0 else -cs.rot
            np.testing.assert_allclose(q_t, q_c, rtol=0, atol=1e-7, err_msg=f"step {k}: rot")
            np.testing.assert_allclose(_n(ts.P), cs.P, rtol=0, atol=1e-4,
                                       err_msg=f"step {k}: P")
            assert float(ts.prev_timestamp) == pytest.approx(cs.prev_timestamp, abs=1e-12)


@pytest.mark.slow
def test_p2p_trajectory_matches_oracle():
    """The port's float64 event loop against ``CpuPipeline`` on the P2P log
    of test_oracle_parity.py:166-220: ATE between them < 1 cm, each within
    0.25 m of the truth."""
    from elimaloc_tpu_torch.map.builder import build_voxel_map
    from elimaloc_tpu_torch.map.tiles import TileQueryBudget
    from elimaloc_tpu_torch.pipeline import LocalizationPipeline, ate_rmse, make_world
    from elimaloc_tpu_torch.pipeline import synthesize_log

    world = make_world(seed=5, extent=90.0, n_ground=120_000, n_wall=60_000)
    log = synthesize_log(world, duration=4.0, points_per_scan=2048, max_range=60.0, seed=6,
                         imu_noise_gyro=0.001, imu_noise_acc=0.01)
    cfg = ElimalocConfig()
    cfg.pcm.icp_method = IcpMethod.P2P
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    cfg.pcm.lidar_time_delay = 0.0
    built = build_voxel_map(world, cfg.pcm.pcm_voxel_size, cfg.pcm.pcm_voxel_max_point,
                            use_native=False)
    pipe = LocalizationPipeline(cfg, built, dtype=F64, device="cpu", ds_points=2048,
                                tile_budget=TileQueryBudget(qb=32, max_slots=768),
                                ego_ring_size=256, imu_ring_size=128)
    _, traj = pipe.run(log)
    cpu = oracle.CpuPipeline(cfg, built, ego_ring_size=256, imu_ring_size=128)
    ctraj = cpu.run(log, time_base=pipe.time_base)
    assert len(traj["t"]) == len(ctraj["t"])
    err = np.linalg.norm(np.asarray(traj["pos"]) - ctraj["pos"], axis=1)
    parity_ate = float(np.sqrt(np.mean(err ** 2)))
    assert parity_ate < 0.01, f"port-vs-oracle ATE {parity_ate}"
    ate_port = ate_rmse(np.asarray(traj["t"]), np.asarray(traj["pos"]), log.truth_t,
                        log.truth_pos)
    ate_cpu = ate_rmse(ctraj["t"], ctraj["pos"], log.truth_t, log.truth_pos)
    assert ate_port < 0.25 and ate_cpu < 0.25, (ate_port, ate_cpu)
