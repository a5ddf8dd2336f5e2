"""The chunked windowed frame loop of elimaloc_tpu_torch against the JAX
package: ``run_frames(chunk=)``, the branch that ``run_fused(window_chunk=)``
takes on a windowed pipeline (the motion-model ladder ``_fit_motion`` /
``_predict``, the forward warm-up with prefetch, the ragged final chunk).

A 19-frame drive at up to 12 m/s on 2 m tiles (a 24 m window, a 20 m sensor
gate) in f64, with chunks of 4 and of 7 (both leave a ragged final chunk),
prefetch off and "forced" (the worker finishes each prefetch before the
ladder goes on, tests/test_pipeline_modes.py:270-278). Both sides consult the
ladder on poses that have landed: the port's CPU fetches land at once, and
the JAX fetches are made to block here (the JAX loop re-anchors its motion
model on whichever fetch ``is_ready()``, which is timing-dependent).

Bounds: each frame within 1e-6 m of JAX's, ``applied`` equal, ``on_scan``
given ``min(chunk, n - k0)`` rows per chunk on both sides, the same window
statistics and the same final window anchor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elimaloc_tpu.pipeline.runtime as jruntime
from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from torch_parity import one_torch_thread, tiny_cfg  # noqa: F401

STATS = ("swaps", "prefetch_hits", "prefetch_joins", "sync_swaps", "incr_crops")


@pytest.fixture(scope="module")
def drive():
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=2.05, points_per_scan=1024, max_range=20.0,
                              seed=10, speed=12.0, ramp=0.4)
    return log, jbuilder.build_voxel_map(world, 1.0, 30, use_native=False)


def _cfg(mod):
    c = tiny_cfg(mod)
    c.pcm.input_max_dist = 20.0
    return c


def _forced(pipe):
    orig = pipe._start_prefetch

    def start_and_wait(pos_xy):
        orig(pos_xy)
        if pipe._prefetch is not None:
            assert pipe._prefetch["done"].wait(timeout=120)

    pipe._start_prefetch = start_and_wait


@pytest.mark.parametrize("chunk,prefetch", [(4, "off"), (7, "off"), (4, "forced"),
                                            (7, "forced")])
def test_windowed_chunked_run_frames_f64_matches_jax(drive, chunk, prefetch, monkeypatch):
    log, built = drive
    n = len(log.scan_t)
    assert n % chunk
    on = prefetch == "forced"
    monkeypatch.setattr(jruntime, "_async_host_fetch", lambda a: a.block_until_ready())
    kw = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128,
              map_window_radius=24.0, map_window_prefetch=on)
    jpipe = LocalizationPipeline(_cfg(jconfig), jtiles.build_tile_map(built, tile_voxels=2),
                                 dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **kw)
    tpipe = TPipeline(_cfg(tconfig), ttiles.build_tile_map(built, tile_voxels=2),
                      dtype=torch.float64, device="cpu",
                      tile_budget=ttiles.TileQueryBudget(qb=8, max_slots=1024), **kw)
    if on:
        _forced(jpipe)
        _forced(tpipe)
    jseen, tseen = [], []
    _, jout = jpipe.run_frames(log, chunk=chunk, on_scan=jseen.append)
    _, tout = tpipe.run_frames(log, chunk=chunk, on_scan=tseen.append)
    rows = [min(chunk, n - k0) for k0 in range(0, n, chunk)]
    assert [len(o["ego_pos"]) for o in tseen] == [len(o["ego_pos"]) for o in jseen] == rows
    assert tout["ego_pos"].shape == (n, 3)
    np.testing.assert_allclose(tout["ego_pos"], np.asarray(jout["ego_pos"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tout["applied"], np.asarray(jout["applied"]))
    for k in STATS:
        assert tpipe.window_stats[k] == jpipe.window_stats[k], (k, tpipe.window_stats,
                                                                jpipe.window_stats)
    assert tpipe.window_stats["swaps"] >= 1 and tpipe.window_stats["incr_crops"] >= 1
    if not on:
        assert tpipe.window_stats["sync_swaps"] == tpipe.window_stats["swaps"]
    assert tpipe._window_offset_tiles == jpipe._window_offset_tiles
    assert tpipe.map.tile_anchor == tuple(int(a) for a in np.asarray(jpipe.map.tile_anchor))
