"""The online entry points on the hash backend: the port's ``run`` (the
per-event loop), ``run_frames`` (the online frame loop), ``initialize_at``
and ``reload_config`` on ``LocalizationPipeline(..., backend="hash",
device="cpu")`` against the JAX package's hash pipeline (P2P, tiny_pipe,
float64, one shared BuiltMap), and the two ValueErrors of JAX's
constructor.

* ``run``: the trajectory after every scan within 1e-6 m, per-scan
  applied / success / iterations equal, applied >= 0.9.
* ``run_frames``: every frame within 1e-6 m, ``on_scan`` once per frame.
* ``initialize_at`` (a click ~1 m and ~2 deg off the truth at scan 0): the
  same ``ok``, the filter state within 1e-6; a click off the map fails.
* ``reload_config``: a flag change makes a new static configuration that
  keeps ``backend="hash"`` and the same grid.
* A packed ``HostTileMap`` or ``map_window_radius`` with the hash backend
  raise ValueError in both packages, with the same message.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from test_torch_hash_replay import KW, build, pipes, port_built
from torch_parity import method_cfg, one_torch_thread, tiny_world_and_log  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    world, log = tiny_world_and_log(jlog, duration=1.5)
    built = build(world)
    return log, built, pipes("P2P", built, jnp.float64, torch.float64)


def test_run_f64_matches_jax_per_scan(tiny):
    log, _, (jpipe, tpipe) = tiny
    jtraj, ttraj = jpipe.run(log)[1], tpipe.run(log)[1]
    assert len(ttraj["scans"]) == len(jtraj["scans"]) == len(log.scan_t)
    np.testing.assert_allclose(ttraj["t"], jtraj["t"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(ttraj["pos"], jtraj["pos"], rtol=0, atol=1e-6)
    for k, (ts, js) in enumerate(zip(ttraj["scans"], jtraj["scans"])):
        for name in ("applied", "icp_success", "iterations", "slots_dropped"):
            np.testing.assert_array_equal(ts[name], js[name], err_msg=f"{k} {name}")
    assert np.mean([s["applied"] for s in ttraj["scans"]]) >= 0.9


def test_run_frames_f64_matches_jax(tiny):
    log, _, (jpipe, tpipe) = tiny
    seen = []
    jframes = jpipe.run_frames(log)[1]
    tframes = tpipe.run_frames(log, on_scan=seen.append)[1]
    assert len(seen) == len(log.scan_t)
    np.testing.assert_allclose(tframes["ego_pos"], np.asarray(jframes["ego_pos"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tframes["applied"], np.asarray(jframes["applied"]))


def test_initialize_at_matches_jax(tiny):
    log, _, (jpipe, tpipe) = tiny
    x, y = log.truth_pos[0][:2] + 0.7
    yaw = log.truth_rpy[0][2] + np.deg2rad(2.0)
    click = (x, y, yaw, log.scan_points[0], log.scan_valid[0], log.scan_t[0])
    jst, jok = jpipe.initialize_at(jpipe.reset(), *click)
    tst, tok = tpipe.initialize_at(tpipe.reset(), *click)
    assert tok == jok is True
    assert bool(tst.ekf.pcm_init_on_going)
    for name in ("pos", "rot", "vel", "P", "prev_timestamp", "pcm_init_on_going"):
        np.testing.assert_allclose(getattr(tst.ekf, name).numpy(),
                                   np.asarray(getattr(jst.ekf, name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert np.linalg.norm(tst.ekf.pos.numpy()[:2] - log.truth_pos[0][:2]) < 1.5
    st, ok = tpipe.initialize_at(tst, 500.0, 500.0, 0.0, *click[3:])
    assert ok is False and st is tst


def test_reload_config_keeps_the_hash_backend(tiny):
    _, built, _ = tiny
    pipe = TPipeline(method_cfg(tconfig, "P2P"), port_built(built), backend="hash",
                     device="cpu", **KW)
    grid, static = pipe.map, pipe.static
    cfg = copy.deepcopy(pipe.cfg)
    cfg.ekf.use_zupt = True
    pipe.reload_config(cfg)
    assert pipe.static is not static and pipe.static.ekf_flags.use_zupt
    assert pipe.static.icp_static.backend == "hash"
    assert pipe.map is grid and isinstance(grid, tgrid.MapGrid)


@pytest.mark.parametrize("case", ["host_tile_map", "window"])
def test_hash_backend_refuses_like_jax(tiny, case):
    _, built, _ = tiny
    if case == "host_tile_map":
        jargs = (jtiles.build_tile_map(built),)
        targs = (ttiles.build_tile_map(port_built(built)),)
        kw = {}
        match = "a HostTileMap input requires the tile backend"
    else:
        jargs, targs = (built,), (port_built(built),)
        kw = dict(map_window_radius=48.0)
        match = "map_window_radius requires the tile backend"
    with pytest.raises(ValueError, match=match):
        LocalizationPipeline(method_cfg(jconfig, "P2P"), *jargs, backend="hash", **kw)
    with pytest.raises(ValueError, match=match):
        TPipeline(method_cfg(tconfig, "P2P"), *targs, backend="hash", device="cpu", **kw)
