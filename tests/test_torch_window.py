"""Active-window (city-scale) map serving of elimaloc_tpu_torch against the
JAX package: the host crops, the incremental window shift (K14; kernel N on
the card, ``shift_window_plain`` here), the searches and registration on a
shifted window, and the windowed frame loop.

Bounds:

* ``crop_window``, ``window_anchor``, ``crop_entering_rows``, the
  ``storage_dir`` / ``load_tile_map(mmap=True)`` round trip: bit-identical
  (the same NumPy code).
* ``shift_window_plain`` over a multi-step drive (1-, 2- and 3-tile shifts,
  both axes, clamped at the map edge; tests/test_tiles.py:322-379): every
  tensor bit-identical to the JAX ``shift_window`` and to a fresh pack of
  the same rows at the same origin; the anchor moves, the origin stays.
* On a shifted window (tests/test_tiles.py:381-438): ``assign_slots`` and
  ``slot_centers`` exactly equal; ``run_register`` pose atol 1e-9 (f64) or
  1e-4 m (f32) with equal iteration counts, as tests/test_torch_icp.py.
* Windowed ``run_frames`` in f64 over 9 frames with an incremental swap:
  within 1e-6 m per frame of the JAX windowed ``run_frames``, the same
  window statistics; windowed ``initialize_at`` from a click 100 m from the
  resident window: the same re-window and filter state to 1e-6 (f64).
* A prefetch worker whose shift fails fails the run on the main thread.

Kernel N itself runs only on the card: tests/test_torch_kernels.py holds it
against ``shift_window_plain`` there (``cuda`` marker), in the file the card
runs without JAX.
"""

import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.config import IcpMethod, PcmConfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.register import make_icp_params, make_icp_static, run_register
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp
from torch_parity import flatten, one_torch_thread, tiny_cfg  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-9),
          "f32": (jnp.float32, torch.float32, 1e-4)}
DIMS = (7, 7)


@pytest.fixture(scope="module")
def maps():
    """A flat 80 m map with voxel and point covariances (all six halo
    tensors), packed by both packages at tile 4 m."""
    rng = np.random.default_rng(41)
    pts = rng.uniform(-40, 40, (15_000, 3)) * np.array([1, 1, 0.08])
    built = jbuilder.build_voxel_map(pts, 1.0, 20, use_native=False, compute_voxel_cov=True,
                                     compute_point_cov=True)
    return pts, jtiles.build_tile_map(built, tile_voxels=4), ttiles.build_tile_map(
        built, tile_voxels=4)


def _assert_host_equal(t, j):
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("offset", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("center", [(0.0, 0.0), (-20.0, -20.0), (35.0, -38.0),
                                    (100.0, 100.0)], ids=["mid", "sw", "edge", "off_map"])
def test_crop_window_bit_identical(maps, center, offset):
    _, jh, th = maps
    c = np.asarray(center)
    assert th.window_anchor(c, DIMS) == jh.window_anchor(c, DIMS)
    _assert_host_equal(th.crop_window(c, 3, dims=DIMS, offset_dtype=offset),
                       jh.crop_window(c, 3, dims=DIMS, offset_dtype=offset))
    _assert_host_equal(th.crop_window(c, 4), jh.crop_window(c, 4))


def _clamped(h, anchor, step, dims=DIMS):
    return (int(np.clip(anchor[0] + step[0], h.tx0, h.tx0 + h.tx_dim - dims[0])),
            int(np.clip(anchor[1] + step[1], h.ty0, h.ty0 + h.ty_dim - dims[1])))


@pytest.mark.parametrize("step", [(1, 0), (0, -2), (3, 1), (-2, -3), (3, 3)],
                         ids=["x1", "y-2", "x3y1", "x-2y-3", "edge"])
def test_crop_entering_rows_bit_identical(maps, step):
    _, jh, th = maps
    start = (14.0, 14.0) if step == (3, 3) else (-6.0, 5.0)  # (3, 3) ends in the corner
    old = th.window_anchor(np.asarray(start), DIMS)
    new = _clamped(th, old, step)
    k = max(abs(new[0] - old[0]), abs(new[1] - old[1]))
    assert k >= 1
    origin = _clamped(th, old, (-1, 1))
    tdst, tpay = th.crop_entering_rows(old, new, DIMS, origin, k * sum(DIMS))
    jdst, jpay = jh.crop_entering_rows(old, new, DIMS, origin, k * sum(DIMS))
    np.testing.assert_array_equal(tdst, jdst)
    assert set(tpay) == set(jpay)
    for f, v in tpay.items():
        assert v.dtype == jpay[f].dtype, f
        np.testing.assert_array_equal(v, jpay[f], err_msg=f)
    with pytest.raises(ValueError, match="pad budget"):
        th.crop_entering_rows(old, new, DIMS, origin, 1)


def test_storage_dir_round_trip(maps, tmp_path):
    """``build_tile_map(storage_dir=)`` writes the same files as the JAX
    package; ``load_tile_map(mmap=True)`` of either directory gives the
    in-RAM map back, disk-backed, and crops from it equal the RAM crops."""
    pts, jh, th = maps
    built = jbuilder.build_voxel_map(pts, 1.0, 20, use_native=False, compute_voxel_cov=True,
                                     compute_point_cov=True)
    ttiles.build_tile_map(built, tile_voxels=4, storage_dir=tmp_path / "port")
    jtiles.build_tile_map(built, tile_voxels=4, storage_dir=tmp_path / "jax")
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir()))
    assert ((tmp_path / "port" / "meta.json").read_text()
            == (tmp_path / "jax" / "meta.json").read_text())
    for src in ("port", "jax"):
        loaded = ttiles.load_tile_map(tmp_path / src, mmap=True)
        assert isinstance(loaded.halo_points, np.memmap)
        _assert_host_equal(loaded, th)
        _assert_host_equal(loaded, jtiles.load_tile_map(tmp_path / src, mmap=True))
        c = np.array([12.0, -7.0])
        _assert_host_equal(loaded.crop_window(c, 3, dims=DIMS), jh.crop_window(c, 3, dims=DIMS))
        loaded.drop_page_cache()
        np.testing.assert_array_equal(loaded.halo_vox_coord, th.halo_vox_coord)
    assert ttiles.load_tile_map(tmp_path / "port", mmap=False).halo_points.__class__ is np.ndarray


#: a drive across the map: mixed-axis shifts, a 3-tile jump, an edge-clamped
#: segment (tests/test_tiles.py:341-342)
DRIVE = [(1, 0), (1, 1), (0, 2), (3, 1), (2, 2), (1, 0), (-3, -2)]


def _payload(payload, dtype, device=None):
    """crop_entering_rows' payload as tensors (float arrays take ``dtype``)."""
    return {f: None if v is None else torch.as_tensor(
        v, dtype=dtype if v.dtype.kind == "f" else None, device=device)
        for f, v in payload.items()}


def _drive(h, on_step):
    """Walk DRIVE from the window at (-20, -20): on_step(old anchor, new
    anchor, dst, payload, origin anchor) for each step that moves."""
    origin = h.window_anchor(np.array([-20.0, -20.0]), DIMS)
    anchor = origin
    for step in DRIVE:
        new = _clamped(h, anchor, step)
        k = max(abs(new[0] - anchor[0]), abs(new[1] - anchor[1]))
        if k:
            on_step(anchor, new, *h.crop_entering_rows(anchor, new, DIMS, origin,
                                                       k * sum(DIMS)), origin)
        anchor = new
    return origin


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_shift_window_plain_matches_jax(maps, dt_name):
    jdt, tdt, _ = DTYPES[dt_name]
    _, jh, th = maps
    c0 = np.array([-20.0, -20.0])
    cur = {"jax": jh.crop_window(c0, 3, dims=DIMS).to_device(dtype=jdt),
           "port": th.crop_window(c0, 3, dims=DIMS).to_device("cpu", tdt)}
    kernels.reset_launches()
    steps = []

    def on_step(old, new, dst, payload, origin):
        dx, dy = new[0] - old[0], new[1] - old[1]
        cur["jax"] = jtiles.shift_window(cur["jax"], dx, dy, dst, payload)
        cur["port"] = ttiles.shift_window(cur["port"], dx, dy, torch.as_tensor(dst),
                                          _payload(payload, tdt))
        steps.append(max(abs(dx), abs(dy)))
        j, t = cur["jax"], cur["port"]
        assert t.tile_anchor == tuple(int(a) for a in np.asarray(j.tile_anchor))
        assert t.tile_anchor == (new[0] - origin[0], new[1] - origin[1])
        np.testing.assert_array_equal(t.origin.numpy(), np.asarray(j.origin))
        # the same rows packed fresh at the same origin
        fresh = th._pack_rows(th.window_rows(new, DIMS), *th._origin_offsets(origin))
        for f in ttiles.HALO_FIELDS:
            got = getattr(t, f).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(j, f)), err_msg=f"{f} @ {new}")
            np.testing.assert_array_equal(got, fresh[f].astype(got.dtype), err_msg=f"{f} @ {new}")

    _drive(th, on_step)
    assert sorted(set(steps)) == [1, 2, 3]
    assert kernels.launches["shift_window"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_shifted_window_search_and_register_match_jax(maps, dt_name):
    """Slot assignment, slot centres and a P2P registration on a window
    shifted twice, port (the JAX window converted, anchor as host ints)
    against JAX."""
    jdt, tdt, atol = DTYPES[dt_name]
    pts, jh, th = maps
    dims = (9, 9)
    origin = jh.window_anchor(np.array([-10.0, -10.0]), dims)
    jdev = jh.crop_window(np.array([-10.0, -10.0]), 4, dims=dims).to_device(dtype=jdt)
    tdev = th.crop_window(np.array([-10.0, -10.0]), 4, dims=dims).to_device("cpu", tdt)
    anchor = origin
    for target in ([-2.0, -6.0], [6.0, 2.0]):
        new = jh.window_anchor(np.array(target), dims)
        k = max(abs(new[0] - anchor[0]), abs(new[1] - anchor[1]))
        dst, payload = jh.crop_entering_rows(anchor, new, dims, origin, k * sum(dims),
                                             offset_dtype=np.dtype(jdt))
        jdev = jtiles.shift_window(jdev, new[0] - anchor[0], new[1] - anchor[1], dst, payload)
        tdev = ttiles.shift_window(tdev, new[0] - anchor[0], new[1] - anchor[1],
                                   torch.as_tensor(dst), _payload(payload, tdt))
        anchor = new
    conv = convert.tile_map(flatten(jdev), dtype=tdt)
    assert conv.tile_anchor == tdev.tile_anchor != (0, 0)
    for f in ttiles.HALO_FIELDS:
        assert torch.equal(getattr(conv, f), getattr(tdev, f)), f

    rng = np.random.default_rng(42)
    origin_xy = np.asarray(jdev.origin, np.float64)
    q = np.c_[np.array([6.0, 2.0]) + rng.uniform(-12, 12, (600, 2)), rng.uniform(-1, 1, 600)]
    q[:, :2] -= origin_xy
    valid = np.ones(len(q), bool)
    valid[::9] = False
    jb, tb = TileQueryBudget(qb=16, max_slots=256), ttiles.TileQueryBudget(qb=16, max_slots=256)
    ja = jtiles.assign_slots(jdev, jnp.asarray(q, jdt), jnp.asarray(valid), jb)
    ta = ttiles.assign_slots(tdev, torch.as_tensor(q, dtype=tdt), torch.as_tensor(valid), tb)
    for f in dataclasses.fields(ta):
        np.testing.assert_array_equal(getattr(ta, f.name).numpy(),
                                      np.asarray(getattr(ja, f.name)), err_msg=f.name)
    assert int(ta.qmask.sum()) > 300
    np.testing.assert_array_equal(
        ttiles.slot_centers(tdev, ta.slot_tile, tdt).numpy(),
        np.asarray(jtiles._slot_centers(jdev, ja.slot_tile, jdt)))

    true_pose = np.eye(4)
    true_pose[:3, 3] = [6.0, 2.0, 0.0]
    sel = pts[np.linalg.norm(pts[:, :2] - true_pose[:2, 3], axis=1) < 12]
    scan = sel[rng.choice(len(sel), 800, replace=False)] - true_pose[:3, 3]
    init = true_pose.copy()
    init[:3, 3] += [0.3, -0.2, 0.05]
    cfg = PcmConfig(icp_method=IcpMethod.P2P, max_iteration=15)
    jres = jax.jit(run_register, static_argnums=5)(
        jnp.asarray(scan, jdt), jnp.ones(len(scan), bool), jdev, jnp.asarray(init, jdt),
        make_icp_params(cfg, dtype=jdt), make_icp_static(cfg, tile_budget=jb))
    tcfg = tconfig.PcmConfig(icp_method=tconfig.IcpMethod.P2P, max_iteration=15)
    tres = ticp.run_register(
        torch.as_tensor(scan, dtype=tdt), torch.ones(len(scan), dtype=torch.bool), tdev,
        torch.as_tensor(init, dtype=tdt), ticp.make_icp_params(tcfg, dtype=tdt),
        ticp.make_icp_static(tcfg, tile_budget=tb))
    assert bool(tres.success) and bool(jres.success)
    assert int(tres.iterations) == int(jres.iterations)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), rtol=0, atol=atol)
    assert np.linalg.norm(tres.pose.numpy()[:3, 3] - true_pose[:3, 3]) < 0.05


def _fast_drive():
    """The 9-frame drive at up to 12 m/s on 2 m tiles (a 24 m window, a 20 m
    sensor gate) that swaps the window once."""
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=1.05, points_per_scan=1024, max_range=20.0,
                              seed=10, speed=12.0, ramp=0.4)
    return world, log, jbuilder.build_voxel_map(world, 1.0, 30, use_native=False)


def _fast_cfg(mod):
    c = tiny_cfg(mod)
    c.pcm.input_max_dist = 20.0
    return c


def test_windowed_run_frames_f64_matches_jax():
    """A 9-frame drive at up to 12 m/s on 2 m tiles: the window ladder
    shifts the window incrementally once; each frame within 1e-6 m of the
    JAX windowed frame loop, the same window statistics."""
    _, log, built = _fast_drive()
    kw = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128,
              map_window_radius=24.0, map_window_prefetch=False)
    jpipe = LocalizationPipeline(_fast_cfg(jconfig), jtiles.build_tile_map(built, tile_voxels=2),
                                 dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **kw)
    tpipe = TPipeline(_fast_cfg(tconfig), ttiles.build_tile_map(built, tile_voxels=2),
                      dtype=torch.float64, device="cpu",
                      tile_budget=ttiles.TileQueryBudget(qb=8, max_slots=1024), **kw)
    _, jout = jpipe.run_frames(log)
    _, tout = tpipe.run_frames(log)
    assert tout["ego_pos"].shape == (len(log.scan_t), 3)
    np.testing.assert_allclose(tout["ego_pos"], np.asarray(jout["ego_pos"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tout["applied"], np.asarray(jout["applied"]))
    for k in ("swaps", "prefetch_hits", "prefetch_joins", "sync_swaps", "incr_crops"):
        assert tpipe.window_stats[k] == jpipe.window_stats[k], k
    assert tpipe.window_stats["incr_crops"] >= 1
    assert tpipe._window_offset_tiles == jpipe._window_offset_tiles
    assert tpipe.map.tile_anchor == tuple(int(a) for a in np.asarray(jpipe.map.tile_anchor))


def test_windowed_initialize_at_matches_jax():
    """A relocalization click far from the resident window (the first one
    is cropped around a configured pose 100 m away): both packages re-crop
    around the click before registering (JAX runtime.py:1225-1228) and land
    on the same filter state to 1e-6 in f64; a click off the map finds no
    ground and keeps the window."""
    world = jlog.make_world(seed=5, extent=90.0, n_ground=120_000, n_wall=60_000)
    log = jlog.synthesize_log(world, duration=1.0, points_per_scan=2048, max_range=60.0,
                              seed=6, imu_noise_gyro=0.001, imu_noise_acc=0.01)
    kw = dict(ds_points=2048, use_native=False, ego_ring_size=256, imu_ring_size=128,
              map_window_radius=48.0)

    def cfg(mod):
        c = tiny_cfg(mod)
        c.ekf.ekf_init_x_m, c.ekf.ekf_init_y_m = -40.0, -60.0
        return c

    jpipe = LocalizationPipeline(cfg(jconfig), world, dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=32, max_slots=768), **kw)
    tpipe = TPipeline(cfg(tconfig), world, dtype=torch.float64, device="cpu",
                      tile_budget=ttiles.TileQueryBudget(qb=32, max_slots=768), **kw)
    assert tpipe._window_offset_tiles == jpipe._window_offset_tiles
    first = tpipe._window_offset_tiles
    click = (61.0, 0.5, np.pi / 2 * 0.98, log.scan_points[0], log.scan_valid[0], log.scan_t[0])
    jst, jok = jpipe.initialize_at(jpipe.reset(), *click)
    tst, tok = tpipe.initialize_at(tpipe.reset(), *click)
    assert tok == jok is True
    assert tpipe._window_offset_tiles == jpipe._window_offset_tiles != first
    assert tpipe.window_stats["sync_swaps"] == jpipe.window_stats["sync_swaps"] == 1
    for name in ("pos", "rot", "vel", "P", "prev_timestamp", "pcm_init_on_going"):
        np.testing.assert_allclose(getattr(tst.ekf, name).numpy(),
                                   np.asarray(getattr(jst.ekf, name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert np.linalg.norm(tst.ekf.pos.numpy()[:2] - log.truth_pos[0][:2]) < 1.5
    window = tpipe._window_offset_tiles
    st, ok = tpipe.initialize_at(tst, 500.0, 500.0, 0.0, *click[3:])
    assert ok is False and st is tst and tpipe._window_offset_tiles == window


def test_failed_prefetch_worker_fails_the_run(monkeypatch):
    """No hidden fallback: a window shift that fails in the prefetch worker
    fails the run on the main thread (the JAX package would crop
    synchronously instead), with the worker's exception as the cause."""
    _, log, built = _fast_drive()
    pipe = TPipeline(_fast_cfg(tconfig), ttiles.build_tile_map(built, tile_voxels=2),
                     device="cpu", tile_budget=ttiles.TileQueryBudget(qb=8, max_slots=1024),
                     ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128,
                     map_window_radius=24.0)
    shift = ttiles.shift_window
    calls = []

    def broken(*a, **k):
        if threading.current_thread() is not threading.main_thread():
            calls.append(1)
            raise ValueError("injected shift failure")
        return shift(*a, **k)

    monkeypatch.setattr(ttiles, "shift_window", broken)
    with pytest.raises(RuntimeError, match="prefetch worker failed") as info:
        pipe.run_frames(log)
    assert calls and isinstance(info.value.__cause__, ValueError)


def test_window_stats_updates_are_atomic():
    """The frame loop and overlapping prefetch workers add to the same
    window counters: under contention (more threads than cores, a short
    switch interval) no update is lost."""
    pipe = object.__new__(TPipeline)
    pipe.window_stats = {"incr_crops": 0, "crop_s": 0.0}
    pipe._stats_lock = threading.Lock()
    n_threads, n = max(16, 2 * (os.cpu_count() or 1)), 2000

    def work():
        for _ in range(n):
            pipe._stat("incr_crops", 1)
            pipe._stat("crop_s", 0.5)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert pipe.window_stats == {"incr_crops": n_threads * n, "crop_s": 0.5 * n_threads * n}


def test_windowed_initialize_at_fails_the_overlap_ratio_as_jax(monkeypatch):
    """Relocalization on a windowed pipeline from a scan that reaches far
    past the window (a 60 m scan against a 24 m window radius: most valid
    points find no map, as the 100 m scan of the chip smoke run against its
    48 m window): both packages register the whole scan, with no sensor-range
    gate (JAX runtime.py:1213-1246), stop on the 0.4 overlap ratio after the
    same number of iterations and return ok False; the same scan gated to the
    window's reach relocalizes on both."""
    world = jlog.make_world(seed=5, extent=90.0, n_ground=120_000, n_wall=60_000)
    log = jlog.synthesize_log(world, duration=1.0, points_per_scan=2048, max_range=60.0,
                              seed=6, imu_noise_gyro=0.001, imu_noise_acc=0.01)
    kw = dict(ds_points=2048, use_native=False, ego_ring_size=256, imu_ring_size=128,
              map_window_radius=24.0)

    def cfg(mod):
        c = tiny_cfg(mod)
        c.pcm.input_max_dist = 20.0
        return c

    jpipe = LocalizationPipeline(cfg(jconfig), world, dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=32, max_slots=768), **kw)
    tpipe = TPipeline(cfg(tconfig), world, dtype=torch.float64, device="cpu",
                      tile_budget=ttiles.TileQueryBudget(qb=32, max_slots=768), **kw)
    seen = {"jax": [], "port": []}
    jreg = jpipe._register

    def jrec(*a):
        res = jreg(*a)
        seen["jax"].append((int(res.iterations), bool(res.success), float(res.overlap)))
        return res

    monkeypatch.setattr(jpipe, "_register", jrec)
    treg = truntime.run_register

    def trec(*a, **k):
        res = treg(*a, **k)
        seen["port"].append((int(res.iterations), bool(res.success), float(res.overlap)))
        return res

    monkeypatch.setattr(truntime, "run_register", trec)
    pts, valid = log.scan_points[0], log.scan_valid[0]
    reach = np.linalg.norm(pts, axis=1) <= 20.0
    click = (log.truth_pos[0][0] + 0.5, log.truth_pos[0][1] - 0.4,
             log.truth_rpy[0][2] + np.deg2rad(1.0))
    out = {}
    for name, v in (("whole", valid), ("gated", valid & reach)):
        jst, jok = jpipe.initialize_at(jpipe.reset(), *click, pts, v, log.scan_t[0])
        tst, tok = tpipe.initialize_at(tpipe.reset(), *click, pts, v, log.scan_t[0])
        out[name] = (jok, tok, jst, tst)
    assert (valid & reach).sum() < 0.4 * valid.sum()
    jok, tok, _, _ = out["whole"]
    assert jok is False and tok is False
    assert seen["port"][0][:2] == seen["jax"][0][:2]      # iterations, success
    assert seen["port"][0][2] == pytest.approx(seen["jax"][0][2], abs=1e-12)
    assert seen["port"][0][2] < 0.4
    jok, tok, jst, tst = out["gated"]
    assert jok is True and tok is True
    assert seen["port"][1][:2] == seen["jax"][1][:2]
    np.testing.assert_allclose(tst.ekf.pos.numpy(), np.asarray(jst.ekf.pos), rtol=0, atol=1e-6)
    assert np.linalg.norm(tst.ekf.pos.numpy()[:2] - log.truth_pos[0][:2]) < 1.5
