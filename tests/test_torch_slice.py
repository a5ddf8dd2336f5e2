"""The fused P2P slice as a whole: elimaloc_tpu_torch's fused frame vs the
JAX LocalizationPipeline, on the ``tiny_pipe`` configuration of
tests/test_pipeline_modes.py:22-43 (P2P, 1024 points per scan,
ds_points=1024, qb=8).

* float64, 5 frames, open loop per frame: the JAX pipeline runs frame by
  frame through ``pipe._frame`` on float64 batches (``run_fused`` always
  builds float32 batches, runtime.py:1585); the port starts from the same
  params, state, map and batches through elimaloc_tpu_torch.convert. Bound:
  ego_pos atol 1e-6 m with equal ``applied`` and ``iterations``.
* float32, whole log, closed loop: each side builds its own pipeline from
  the config and the map points and replays the log. Two closed-loop
  float32 replays are not bit-comparable (the ICP<->EKF loop amplifies ulps
  into cm-scale transients that contract again), so the bound is the
  repo's windowed-vs-full contract (test_pipeline_modes.py:217-236): max
  < 3 cm, median < 5 mm, last 3 frames < 5 mm.
"""

import jax.numpy as jnp
import numpy as np
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.pipeline import LocalizationPipeline, log as jlog
from elimaloc_tpu.pipeline.runtime import build_fused_batches
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import ate_rmse
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import flatten, tiny_cfg, tiny_world_and_log


def test_five_frames_f64_match_jax():
    world, log = tiny_world_and_log(jlog)
    cfg = tiny_cfg(jconfig)
    pipe = LocalizationPipeline(
        cfg, world, dtype=jnp.float64, ds_points=1024,
        tile_budget=TileQueryBudget(qb=8, max_slots=1024), use_native=False,
        ego_ring_size=128, imu_ring_size=128)
    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = build_fused_batches(log, dtype=np.float64, time_base=pipe.time_base)

    tstate = convert.pipeline_state(flatten(state), dtype=torch.float64)
    tparams = convert.pipeline_params(flatten(pipe.params), dtype=torch.float64)
    tmap = convert.tile_map(flatten(pipe.map), dtype=torch.float64)
    tstatic = truntime.make_pipeline_static(
        tiny_cfg(tconfig), tile_budget=TBudget(qb=8, max_slots=1024), ds_points=1024)
    tbatches = truntime.batches_to_device(
        truntime.build_fused_batches(log, dtype=np.float64, time_base=pipe.time_base),
        dtype=torch.float64)

    for k in range(5):
        state, jout = pipe._frame(state, {key: v[k] for key, v in batches.items()},
                                  pipe.map)
        tstate, tout = truntime.fused_frame(
            tstate, {key: v[k] for key, v in tbatches.items()}, tmap, tparams, tstatic)
        np.testing.assert_allclose(tout["ego_pos"].numpy(), np.asarray(jout["ego_pos"]),
                                   rtol=0, atol=1e-6, err_msg=f"frame {k}")
        assert bool(tout["applied"]) == bool(jout["applied"]), k
        assert int(tout["iterations"]) == int(jout["iterations"]), k
        assert bool(tout["applied"])


def test_whole_log_f32_closed_loop_contract():
    world, log = tiny_world_and_log(jlog)
    jpipe = LocalizationPipeline(
        tiny_cfg(jconfig), world, ds_points=1024,
        tile_budget=TileQueryBudget(qb=8, max_slots=1024), use_native=False,
        ego_ring_size=128, imu_ring_size=128)
    _, jouts = jpipe.run_fused(log)
    tpipe = TPipeline(
        tiny_cfg(tconfig), world, device="cpu", ds_points=1024,
        tile_budget=TBudget(qb=8, max_slots=1024), use_native=False,
        ego_ring_size=128, imu_ring_size=128)
    _, touts = tpipe.run_fused(log)

    err = np.linalg.norm(touts["ego_pos"] - np.asarray(jouts["ego_pos"]), axis=1)
    assert float(np.max(err)) < 0.03, err.max()
    assert float(np.median(err)) < 0.005, np.median(err)
    assert float(np.max(err[-3:])) < 0.005, err[-3:]
    assert touts["applied"].mean() >= 0.9
    assert int(touts["slots_dropped"].max()) == 0
    ate = ate_rmse(touts["ego_t_abs"], touts["ego_pos"], log.truth_t, log.truth_pos)
    assert ate < 0.1, ate
