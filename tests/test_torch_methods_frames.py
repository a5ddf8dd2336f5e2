"""The fused frame of the GICP, VGICP and AVGICP slices, 5 frames in
float64 on the ``tiny_pipe`` configuration (tests/test_pipeline_modes.py:
22-43, with the method switched and bench.py's ``max_fitness_score=2.0``
for the voxel methods), against the JAX pipeline's own frame on the same
state, map and batches — as tests/test_torch_slice.py does for P2P.

Bounds: ego_pos atol 1e-6 m, the EKF covariance atol 1e-9 (GICP's exported
local_cov shapes the PCM measurement covariance), equal ``applied`` and
``iterations``, no dropped slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.pipeline.runtime import build_fused_batches
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import flatten, method_cfg, one_torch_thread, tiny_world_and_log  # noqa: F401


@pytest.fixture(scope="module")
def tiny_built():
    """The tiny_pipe world with both covariances, built once, and its log."""
    world, log = tiny_world_and_log(jlog)
    built = jbuilder.build_voxel_map(world, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    return built, log


@pytest.mark.parametrize("method", ["AVGICP", "GICP", "VGICP"])
def test_five_frames_f64_match_jax(tiny_built, method):
    built, log = tiny_built
    budget = dict(qb=8, max_slots=1024)
    # the JAX pipeline packs AVGICP's map at halo margin 2 and then keeps the
    # hoisted assignment (runtime.py:728-736)
    pipe = LocalizationPipeline(
        method_cfg(jconfig, method), built, dtype=jnp.float64, ds_points=1024,
        tile_budget=jtiles.TileQueryBudget(**budget), ego_ring_size=128,
        imu_ring_size=128)
    assert pipe._tiles_host_full.halo_margin == (2 if method == "AVGICP" else 1)
    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = build_fused_batches(log, dtype=np.float64, time_base=pipe.time_base)

    tstate = convert.pipeline_state(flatten(state), dtype=torch.float64)
    tparams = convert.pipeline_params(flatten(pipe.params), dtype=torch.float64)
    tmap = convert.tile_map(flatten(pipe.map), dtype=torch.float64)
    tstatic = truntime.make_pipeline_static(
        method_cfg(tconfig, method), tile_budget=ttiles.TileQueryBudget(**budget),
        ds_points=1024, reassign_each_iter=False if method == "AVGICP" else None)
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
        np.testing.assert_allclose(tstate.ekf.P.numpy(), np.asarray(state.ekf.P),
                                   rtol=0, atol=1e-9, err_msg=f"frame {k}")
        assert bool(tout["applied"]) == bool(jout["applied"]), k
        assert int(tout["iterations"]) == int(jout["iterations"]), k
        assert int(tout["slots_dropped"]) == 0, k
    assert bool(tout["applied"])
