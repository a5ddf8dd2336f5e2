"""The GICP, VGICP and AVGICP slices as a whole in float32: each side builds
its own pipeline from the config and the same BuiltMap, replays the whole
log closed loop, and the two trajectories are held to the repo's
windowed-vs-full contract (test_pipeline_modes.py:217-236): max < 3 cm,
median < 5 mm, last 3 frames < 5 mm, with applied >= 0.9 and no dropped slot
on the port. (The float64 open-loop frames are in test_torch_methods.py.)

Each method runs on a log where the method itself converges. On the sparse
``tiny_pipe`` scans (1024 points, ~600 after the 1 m downsample) GICP in
the JAX package leaves the map in float32 and VGICP / AVGICP hit the
10-iteration cap frame after frame; a closed loop then amplifies f32 ulps
into decimetres on both sides, which says nothing about parity
(test_oracle_parity.py:157-162 notes the same). So GICP replays the
``tiny_pipe`` world at 4096 points per scan, and VGICP / AVGICP the denser
bench_methods world (bench.py:562, cut to 2 s at 8192 points per scan).
"""

import numpy as np
import pytest

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.pipeline import LocalizationPipeline, log as jlog
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import ate_rmse
from torch_parity import method_cfg, one_torch_thread, tiny_world_and_log  # noqa: F401

#: method -> (ds_points, truth ATE bound in m): the port's own accuracy on
#: its log, a guard against both sides drifting together
CASES = {"GICP": (2048, 0.1), "VGICP": (4096, 0.15), "AVGICP": (4096, 0.15)}


@pytest.fixture(scope="module")
def scenes():
    """(BuiltMap, log) per world, each built once: VGICP and AVGICP share
    the bench_methods world."""
    cache = {}

    def get(method):
        key = method == "GICP"
        if key not in cache:
            cache[key] = _world_and_log(method)
        return cache[key]
    return get


def _world_and_log(method):
    if method == "GICP":
        world, _ = tiny_world_and_log(jlog)
        log = jlog.synthesize_log(world, duration=3.0, points_per_scan=4096,
                                  max_range=50.0, seed=10, gps_hz=1.0)
    else:
        world = jlog.make_world(seed=7, extent=60.0, n_ground=150_000, n_wall=80_000)
        log = jlog.synthesize_log(world, duration=2.0, points_per_scan=8192,
                                  max_range=60.0, seed=8, imu_noise_gyro=0.001,
                                  imu_noise_acc=0.01)
    built = jbuilder.build_voxel_map(world, 1.0, 30, use_native=False,
                                     compute_voxel_cov=method != "GICP",
                                     compute_point_cov=method == "GICP")
    return built, log


@pytest.mark.parametrize("method", sorted(CASES))
def test_whole_log_f32_closed_loop_contract(scenes, method):
    built, log = scenes(method)
    ds_points, ate_bound = CASES[method]
    jpipe = LocalizationPipeline(
        method_cfg(jconfig, method), built, ds_points=ds_points,
        tile_budget=TileQueryBudget(qb=8, max_slots=1024), ego_ring_size=128,
        imu_ring_size=128)
    _, jouts = jpipe.run_fused(log)
    tbuilt = tbuilder.BuiltMap(**{k: getattr(built, k) for k in
                                  tbuilder.BuiltMap.__dataclass_fields__})
    tpipe = TPipeline(
        method_cfg(tconfig, method), tbuilt, device="cpu", ds_points=ds_points,
        tile_budget=TBudget(qb=8, max_slots=1024), ego_ring_size=128,
        imu_ring_size=128)
    _, touts = tpipe.run_fused(log)

    err = np.linalg.norm(touts["ego_pos"] - np.asarray(jouts["ego_pos"]), axis=1)
    assert float(np.max(err)) < 0.03, err.max()
    assert float(np.median(err)) < 0.005, np.median(err)
    assert float(np.max(err[-3:])) < 0.005, err[-3:]
    assert touts["applied"].mean() >= 0.9
    assert np.asarray(jouts["applied"]).mean() >= 0.9
    assert int(touts["slots_dropped"].max()) == 0
    ate = ate_rmse(touts["ego_t_abs"], touts["ego_pos"], log.truth_t, log.truth_pos)
    assert ate < ate_bound, ate
