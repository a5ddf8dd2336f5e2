"""Whole replays on the hash backend (``LocalizationPipeline(...,
backend="hash")``) of elimaloc_tpu_torch on the CPU against the JAX
package's hash pipeline, on the tiny_pipe world (tests/torch_parity.py) and
one BuiltMap with both covariances, shared by both packages.

* ``run_fused`` per method (P2P, GICP, VGICP, AVGICP), float64: every
  frame's ego position within 1e-6 m, applied, iterations and success equal
  (with radar covariances: tests/test_torch_hash_radar_replay.py).
* One float32 ``run_fused`` (P2P) against JAX's float32 one under the
  closed-loop contract: max < 3 cm, median < 5 mm, last 3 frames < 5 mm;
  applied >= 0.9 and truth ATE < 0.1 m.
(``run``, ``run_frames``, ``initialize_at``, hot reload and the refusals:
tests/test_torch_hash_stream.py.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import ate_rmse
from torch_parity import method_cfg, one_torch_thread, tiny_world_and_log  # noqa: F401

KW = dict(ds_points=1024, ego_ring_size=128, imu_ring_size=128)
#: the radar replays' map frame origin, 1 km away from the drive
FAR = np.array([1000.0, 0.0, 0.0])


def port_built(jb):
    """The JAX BuiltMap's arrays as the port's BuiltMap (the builders are
    bit-identical, tests/test_torch_guards.py)."""
    return tbuilder.BuiltMap(**{f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)})


def build(world):
    return jbuilder.build_voxel_map(world, 1.0, 30, compute_voxel_cov=True,
                                    compute_point_cov=True, use_native=False)


@pytest.fixture(scope="module")
def tiny():
    world, log = tiny_world_and_log(jlog, duration=1.5)
    return world, log, build(world)


def pipes(method, built, jdt, tdt, radar=False, far=False):
    def cfg(mod):
        c = method_cfg(mod, method)
        c.pcm.use_radar_cov = radar
        if far:
            c.ekf.ekf_init_x_m += FAR[0]
        return c

    jpipe = LocalizationPipeline(cfg(jconfig), built, backend="hash", dtype=jdt, **KW)
    tpipe = TPipeline(cfg(tconfig), port_built(built), backend="hash", dtype=tdt,
                      device="cpu", **KW)
    assert isinstance(tpipe.map, tgrid.MapGrid)
    return jpipe, tpipe


def assert_frames_match(jouts, touts, atol):
    np.testing.assert_allclose(touts["ego_pos"], np.asarray(jouts["ego_pos"]), rtol=0,
                               atol=atol)
    for k in ("applied", "iterations", "icp_success"):
        np.testing.assert_array_equal(np.asarray(touts[k]), np.asarray(jouts[k]), err_msg=k)
    assert int(np.max(touts["slots_dropped"])) == 0


@pytest.mark.parametrize("method", ["P2P", "GICP", "VGICP", "AVGICP"])
def test_run_fused_f64_matches_jax(tiny, method):
    _, log, built = tiny
    jpipe, tpipe = pipes(method, built, jnp.float64, torch.float64)
    assert_frames_match(jpipe.run_fused(log)[1], tpipe.run_fused(log)[1], 1e-6)


def test_run_fused_f32_closed_loop_contract(tiny):
    _, log, built = tiny
    jpipe, tpipe = pipes("P2P", built, jnp.float32, torch.float32)
    touts = tpipe.run_fused(log)[1]
    err = np.linalg.norm(touts["ego_pos"] - np.asarray(jpipe.run_fused(log)[1]["ego_pos"]),
                         axis=1)
    assert float(np.max(err)) < 0.03, err.max()
    assert float(np.median(err)) < 0.005, np.median(err)
    assert float(np.max(err[-3:])) < 0.005, err[-3:]
    assert float(np.mean(touts["applied"])) >= 0.9
    ate = ate_rmse(touts["ego_t_abs"], touts["ego_pos"], log.truth_t, log.truth_pos)
    assert ate < 0.1, ate
