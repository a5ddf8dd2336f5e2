"""Windowed replays of elimaloc_tpu_torch in float32 against the JAX package
and against the port's own full-map pipeline, the setup of
tests/test_pipeline_modes.py:240-311 with the P2P ``tiny_cfg``: a drive of 29
scans with a 40 m sensor gate over a 48 m window that swaps several times. The
port serves the window from a disk-backed map (``build_tile_map(storage_dir=)``
reopened with ``load_tile_map(mmap=True)``); the JAX package from the same
map in RAM.

Bounds: the repo's closed-loop contract (max < 3 cm, median < 5 mm, last 3
frames < 5 mm; tests/test_pipeline_modes.py:217-236), for the event loop
``run`` against the JAX windowed ``run`` and against the port's full-map
``run``, with prefetch off and "forced" (the worker finishes each prefetch
before any swap, so every swap is served by it: no synchronous swap, as many
prefetch hits as swaps, the same counts as JAX's); and for
``run_fused(window_chunk=4)`` and ``(window_chunk=7)`` (each leaves a ragged
final chunk of one frame), n rows each, against the full-map ``run``.
"""

import jax.numpy as jnp  # noqa: F401  (the JAX package runs on the CPU here)
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from torch_parity import one_torch_thread, tiny_cfg  # noqa: F401

KW = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128)


def _contract(err, label):
    assert float(np.max(err)) < 0.03, f"{label} max diff {err.max()}"
    assert float(np.median(err)) < 0.005, f"{label} median diff {np.median(err)}"
    assert float(np.max(err[-3:])) < 0.005, f"{label} tail diff {err[-3:]}"


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """The world and log, the port's disk-backed tile map, and the port's
    full-map ``run`` trajectory."""
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=3.05, points_per_scan=1024, max_range=40.0,
                              seed=10)
    built = tbuilder.build_voxel_map(world, 1.0, 30, use_native=False)
    store = tmp_path_factory.mktemp("tiles")
    ttiles.build_tile_map(built, tile_voxels=4, storage_dir=store)
    disk = ttiles.load_tile_map(store, mmap=True)
    full = TPipeline(tiny_cfg(tconfig), built, device="cpu",
                     tile_budget=ttiles.TileQueryBudget(qb=32, max_slots=512), **KW)
    _, traj = full.run(log)
    assert np.mean([s["applied"] for s in traj["scans"]]) >= 0.9
    return world, log, disk, traj


def _forced(pipe):
    """Make the worker finish each prefetch before the ladder goes on
    (tests/test_pipeline_modes.py:270-278)."""
    orig = pipe._start_prefetch

    def start_and_wait(pos_xy):
        orig(pos_xy)
        if pipe._prefetch is not None:
            assert pipe._prefetch["done"].wait(timeout=120)

    pipe._start_prefetch = start_and_wait


@pytest.mark.parametrize("prefetch", ["off", "forced"])
def test_windowed_run_matches_jax_and_full(drive, prefetch):
    world, log, disk, full = drive
    on = prefetch == "forced"
    jpipe = LocalizationPipeline(tiny_cfg(jconfig), world, map_window_radius=48.0,
                                 map_window_prefetch=on,
                                 tile_budget=TileQueryBudget(qb=32, max_slots=512), **KW)
    tpipe = TPipeline(tiny_cfg(tconfig), disk, device="cpu", map_window_radius=48.0,
                      map_window_prefetch=on,
                      tile_budget=ttiles.TileQueryBudget(qb=32, max_slots=512), **KW)
    assert tpipe.windowed and tpipe.map.num_tiles < disk.tx_dim * disk.ty_dim
    if on:
        _forced(jpipe)
        _forced(tpipe)
    _, jtraj = jpipe.run(log)
    _, ttraj = tpipe.run(log)
    assert len(ttraj["scans"]) == len(log.scan_t)
    _contract(np.linalg.norm(ttraj["pos"] - jtraj["pos"], axis=1), "port vs JAX windowed")
    _contract(np.linalg.norm(ttraj["pos"] - full["pos"], axis=1), "windowed vs full")
    assert np.mean([s["applied"] for s in ttraj["scans"]]) >= 0.9
    st = tpipe.window_stats
    assert st["swaps"] >= 1 and st["incr_crops"] >= 1, st
    if on:
        assert st["sync_swaps"] == 0, st
        assert st["prefetch_hits"] == st["swaps"], st
        for k in ("swaps", "prefetch_hits", "sync_swaps", "incr_crops"):
            assert st[k] == jpipe.window_stats[k], (k, st, jpipe.window_stats)
    else:
        assert st["sync_swaps"] == st["swaps"] == jpipe.window_stats["swaps"]


@pytest.mark.parametrize("chunk", [4, 7])
def test_windowed_run_fused_chunks(drive, chunk):
    """``run_fused(window_chunk=)`` on a windowed pipeline is the chunked
    frame loop ``run_frames(chunk=)``: n rows, each chunk's outputs stacked
    for ``on_scan`` (``n - k0`` rows for the final one), and the full map's
    trajectory under the contract."""
    _, log, disk, full = drive
    pipe = TPipeline(tiny_cfg(tconfig), disk, device="cpu", map_window_radius=48.0,
                     tile_budget=ttiles.TileQueryBudget(qb=32, max_slots=512), **KW)
    seen = []
    frames = pipe.run_frames
    pipe.run_frames = lambda *a, **k: frames(*a, on_scan=seen.append, **k)
    n = len(log.scan_t)
    assert n % chunk
    _, outs = pipe.run_fused(log, window_chunk=chunk)
    assert outs["ego_pos"].shape == (n, 3)
    assert [len(o["ego_pos"]) for o in seen] == [min(chunk, n - k0)
                                                 for k0 in range(0, n, chunk)]
    assert isinstance(seen[0]["ego_pos"], torch.Tensor)
    _contract(np.linalg.norm(outs["ego_pos"] - full["pos"], axis=1),
              f"windowed run_fused(window_chunk={chunk}) vs full")
    assert np.mean(outs["applied"]) >= 0.9
    assert pipe.window_stats["swaps"] >= 1
