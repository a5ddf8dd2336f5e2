"""A whole f32 replay with radar covariances (``use_radar_cov``): the GICP
replay of tests/test_torch_methods_replay.py (the tiny_pipe world, 4096
points a scan) in a map frame whose origin lies 1 km away, where the
reference's world-frame radar model is well-posed (test_torch_radar.py
says why it is not near the origin). JAX's and the port's float32
``run_fused`` under the closed-loop contract (max < 3 cm, median < 5 mm,
last 3 frames < 5 mm), applied >= 0.9, no dropped slot, truth ATE < 0.15 m.
"""

import dataclasses

import numpy as np

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import ate_rmse
from torch_parity import method_cfg, one_torch_thread, tiny_world_and_log  # noqa: F401

#: the map frame's origin, 1 km away from the drive
FAR = np.array([1000.0, 0.0, 0.0])


def test_radar_replay_f32_closed_loop_contract():
    """The GICP replay of tests/test_torch_methods_replay.py (4096 points a
    scan) with radar covariances, in the map frame 1 km away: JAX's and the
    port's f32 run_fused under the closed-loop contract."""
    world, _ = tiny_world_and_log(jlog)
    log = jlog.synthesize_log(world, duration=3.0, points_per_scan=4096, max_range=50.0,
                              seed=10, gps_hz=1.0)
    world = world + FAR
    log = dataclasses.replace(log, truth_pos=log.truth_pos + FAR, gps_pos=log.gps_pos + FAR)
    built = jbuilder.build_voxel_map(world, 1.0, 30, use_native=False, compute_point_cov=True)

    def cfg(mod):
        c = method_cfg(mod, "GICP")
        c.pcm.use_radar_cov = True
        c.ekf.ekf_init_x_m += FAR[0]
        return c

    kw = dict(ds_points=2048, ego_ring_size=128, imu_ring_size=128)
    jpipe = LocalizationPipeline(cfg(jconfig), built,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **kw)
    _, jouts = jpipe.run_fused(log)
    tbuilt = tbuilder.BuiltMap(**{k: getattr(built, k) for k in
                                  tbuilder.BuiltMap.__dataclass_fields__})
    tpipe = TPipeline(cfg(tconfig), tbuilt, device="cpu",
                      tile_budget=ttiles.TileQueryBudget(qb=8, max_slots=1024), **kw)
    assert tpipe.static.icp_static.use_radar_cov
    _, touts = tpipe.run_fused(log)
    err = np.linalg.norm(touts["ego_pos"] - np.asarray(jouts["ego_pos"]), axis=1)
    assert float(np.max(err)) < 0.03, err.max()
    assert float(np.median(err)) < 0.005, np.median(err)
    assert float(np.max(err[-3:])) < 0.005, err[-3:]
    assert touts["applied"].mean() >= 0.9 and np.asarray(jouts["applied"]).mean() >= 0.9
    assert int(touts["slots_dropped"].max()) == 0
    ate = ate_rmse(touts["ego_t_abs"], touts["ego_pos"], log.truth_t, log.truth_pos)
    assert ate < 0.15, ate
