"""The hash backend's radar forms (``use_radar_cov``) through whole replays:
``run_fused`` of the port's hash pipeline on the CPU against the JAX
package's, float64, GICP and VGICP, on the tiny_pipe drive in a map frame
1 km off the origin (where the reference's world-frame radar model is
well-posed; tests/test_torch_radar.py says why not near it), one BuiltMap
with both covariances shared by both packages: every frame's ego position
within 1e-6 m, applied, iterations and success equal, applied >= 0.9.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from elimaloc_tpu.pipeline import log as jlog
from test_torch_hash_replay import FAR, assert_frames_match, build, pipes
from torch_parity import one_torch_thread, tiny_world_and_log  # noqa: F401


@pytest.fixture(scope="module")
def far():
    world, log = tiny_world_and_log(jlog, duration=1.5)
    log = dataclasses.replace(log, truth_pos=log.truth_pos + FAR, gps_pos=log.gps_pos + FAR)
    return log, build(world + FAR)


@pytest.mark.parametrize("method", ["GICP", "VGICP"])
def test_run_fused_radar_f64_matches_jax(far, method):
    log, built = far
    jpipe, tpipe = pipes(method, built, jnp.float64, torch.float64, radar=True, far=True)
    assert tpipe.static.icp_static.use_radar_cov
    touts = tpipe.run_fused(log)[1]
    assert_frames_match(jpipe.run_fused(log)[1], touts, 1e-6)
    assert float(touts["applied"].mean()) >= 0.9
