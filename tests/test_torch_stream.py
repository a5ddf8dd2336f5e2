"""The online entry points of elimaloc_tpu_torch's LocalizationPipeline
against the JAX package: ``imu_step``, the event loop ``run``, the frame
loop ``run_frames``, relocalization (``initialize_at``), config hot reload
and the geodetic projection.

Logs and maps are made from seeds on both sides (the port's NumPy copies are
bit-identical, tests/test_torch_guards.py). Bounds:

* ``imu_step``: 13 samples into rings of 8, with a duplicate within 1e-5 and
  a time regression: ring times and counts exactly equal, the other fields
  within 1e-12 (f64; the EKF's libm and matmul ulps) or 1e-4 (f32: the
  predictions round in another order, and the f32 right Jacobian cancels at
  these rates, ROADMAP Queue 3).
* ``run`` on ``tiny_pipe(gps_hz=5, duration=2, use_gps, use_can)``
  (tests/test_pipeline_modes.py:22-43, 194): f64 trajectory after every scan
  within 1e-6 m of the JAX loop's, the same scans applied; f32 each side's
  own loop under the closed-loop contract (max < 3 cm, median < 5 mm, last
  3 < 5 mm).
* ``run_frames`` is ``run_fused``'s frame loop: equal outputs, ``on_scan``
  once per frame; with ``chunk=2`` on a full map, the same frames to 1e-6 m
  and ``on_scan`` once per chunk.
* ``initialize_at`` on tests/test_pipeline.py:313's inputs: the same ``ok``
  and the filter state within 1e-6 (f64; one registration, rounding only).
* ``project_gps`` / ``unproject``, ENU and UTM: within 1e-9 m / 1e-9 deg of
  the JAX package's geodesy in float64.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.ops import geo as jgeo
from elimaloc_tpu.pipeline import LocalizationPipeline
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import ate_rmse
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import flatten, one_torch_thread, tiny_cfg  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
KW = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128)


def _fusion_cfg(cfg_mod):
    cfg = tiny_cfg(cfg_mod)
    cfg.ekf.use_gps = cfg.ekf.use_can = True
    return cfg


@pytest.fixture(scope="module")
def tiny():
    """tiny_pipe(gps_hz=5, duration=2, use_gps, use_can): the world, the
    log, and the JAX and port pipelines per dtype."""
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=2.0, points_per_scan=1024, max_range=50.0,
                              seed=10, gps_hz=5.0)
    pipes = {}
    jmap = tmap = world
    for name, (jdt, tdt) in DTYPES.items():
        pipes[name] = (
            LocalizationPipeline(_fusion_cfg(jconfig), jmap, dtype=jdt,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **KW),
            TPipeline(_fusion_cfg(tconfig), tmap, dtype=tdt, device="cpu",
                      tile_budget=TBudget(qb=8, max_slots=1024), **KW))
        jmap, tmap = pipes[name][0].built, pipes[name][1].built
    return world, log, pipes


@pytest.fixture(scope="module")
def fused32(tiny):
    """The port's f32 ``run_fused`` over the log."""
    _, log, pipes = tiny
    return pipes["f32"][1].run_fused(log)[1]


@pytest.fixture(scope="module")
def runs(tiny):
    """Each side's event loop over the log, per dtype."""
    _, log, pipes = tiny
    return {name: (jp.run(log)[1], tp.run(log)[1]) for name, (jp, tp) in pipes.items()}


#: 13 IMU stamps into rings of 8: an overflow, a repeat within 1e-5 (the ego
#: ring drops it, the IMU ring's eps is 0), then a time regression that clears
#: both rings
IMU_T = np.r_[0.01 * np.arange(1, 10), 0.09 + 5e-6, 0.05, 0.06, 0.07]


@pytest.mark.parametrize("preset", ["init", "moving"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_imu_step_sequence_matches_jax(dt_name, preset):
    jdt, tdt = DTYPES[dt_name]
    cfg = tiny_cfg(jconfig)
    jpp = jruntime.make_pipeline_params(cfg, dtype=jdt)
    jps = jruntime.make_pipeline_static(cfg)
    from elimaloc_tpu.ekf import init_state

    ekf = init_state(jpp.ekf, dtype=jdt)
    if preset == "moving":
        q = np.array([0.72, 0.01, -0.02, 0.69])
        ekf = ekf.replace(
            P=jnp.asarray(np.eye(27) * 1e-3, jdt), rot=jnp.asarray(q / np.linalg.norm(q), jdt),
            vel=jnp.asarray([0.2, 8.0, 0.0], jdt), state_initialized=jnp.asarray(True),
            yaw_initialized=jnp.asarray(True))
    jst = jruntime.PipelineState(ekf=ekf, ego_ring=jrings.make_ego_ring(8, jdt),
                                 imu_ring=jrings.make_imu_ring(8, jdt))
    tst = convert.pipeline_state(flatten(jst), dtype=tdt)
    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    tps = truntime.make_pipeline_static(tiny_cfg(tconfig))
    rng = np.random.default_rng(21)
    atol = 1e-12 if dt_name == "f64" else 1e-4
    jstep = jax.jit(functools.partial(jruntime.imu_step, ps=jps))
    for k, t in enumerate(IMU_T):
        acc = np.array([0.3, 0.1, 9.81]) + rng.normal(0, 0.1, 3)
        gyro = np.array([0.0, 0.0, 0.13]) + rng.normal(0, 0.02, 3)
        jst = jstep(jst, jnp.asarray(t, jdt), jnp.asarray(acc, jdt), jnp.asarray(gyro, jdt),
                    jpp)
        tst = truntime.imu_step(tst, torch.tensor(t, dtype=tdt), torch.tensor(acc, dtype=tdt),
                                torch.tensor(gyro, dtype=tdt), tpp, tps)
        for ring in ("ego_ring", "imu_ring"):
            jr, tr = flatten(getattr(jst, ring)), flatten(getattr(tst, ring))
            assert int(tr["count"]) == int(jr["count"]), (k, ring)
            np.testing.assert_array_equal(tr["t"], np.asarray(jr["t"]), err_msg=f"{k} {ring}")
            for f in tr:
                if f not in ("t", "count"):
                    np.testing.assert_allclose(tr[f], jr[f], rtol=0, atol=atol,
                                               err_msg=f"{k} {ring}.{f}")
        np.testing.assert_allclose(tst.ekf.pos.numpy(), np.asarray(jst.ekf.pos), atol=atol)
    # the repeat stayed out of the ego ring, the regression cleared both
    assert int(tst.ego_ring.count) == int(tst.imu_ring.count) == 3
    assert float(tst.ego_ring.t[0]) == float(tst.imu_ring.t[0]) == pytest.approx(0.05)


def test_run_f64_matches_jax_per_scan(tiny, runs):
    _, log, _ = tiny
    jtraj, ttraj = runs["f64"]
    assert len(ttraj["scans"]) == len(jtraj["scans"]) == len(log.scan_t)
    np.testing.assert_allclose(ttraj["t"], jtraj["t"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(ttraj["pos"], jtraj["pos"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ttraj["rpy"], jtraj["rpy"], rtol=0, atol=1e-6)
    for k, (ts, js) in enumerate(zip(ttraj["scans"], jtraj["scans"])):
        assert set(ts) == set(js), k
        for name in ("applied", "icp_success", "pose_sync_ok", "deskew_ok", "iterations",
                     "slots_dropped", "ds_kept"):
            np.testing.assert_array_equal(ts[name], js[name], err_msg=f"{k} {name}")
    applied = np.array([s["applied"] for s in ttraj["scans"]])
    assert applied.mean() >= 0.9


def test_run_f32_closed_loop_contract(tiny, runs, fused32):
    _, log, pipes = tiny
    jtraj, ttraj = runs["f32"]
    err = np.linalg.norm(ttraj["pos"] - jtraj["pos"], axis=1)
    assert float(np.max(err)) < 0.03, err.max()
    assert float(np.median(err)) < 0.005, np.median(err)
    assert float(np.max(err[-3:])) < 0.005, err[-3:]
    assert np.mean([s["applied"] for s in ttraj["scans"]]) >= 0.9
    ate = ate_rmse(ttraj["t"], ttraj["pos"], log.truth_t, log.truth_pos)
    assert ate < 0.1, ate
    # the per-event loop against the port's own fused frames, the JAX
    # package's contract (tests/test_pipeline_modes.py:194-203)
    np.testing.assert_allclose(ttraj["pos"][-1], fused32["ego_pos"][-1], atol=0.15)


def test_run_collects_every_imu_sample(tiny):
    _, log, pipes = tiny
    tpipe = pipes["f32"][1]
    seen = []
    short = jlog.ReplayLog(**{**log.__dict__})
    keep = log.scan_t < log.scan_t[0] + 0.35
    short.scan_t, short.scan_points = log.scan_t[keep], log.scan_points[keep]
    short.scan_times, short.scan_valid = log.scan_times[keep], log.scan_valid[keep]
    _, traj = tpipe.run(short, collect_every_imu=True, on_scan=seen.append)
    assert len(seen) == keep.sum() == len(traj["scans"])
    assert len(traj["t"]) == len(log.imu_t) + keep.sum()
    assert np.all(np.diff(traj["t"]) >= -1e-6)
    assert {"ego_pos", "ego_t", "applied"} <= set(seen[-1])


def test_run_frames_is_run_fused_frame_loop(tiny, fused32):
    _, log, pipes = tiny
    tpipe = pipes["f32"][1]
    seen = []
    _, frames = tpipe.run_frames(log, on_scan=seen.append)
    fused = fused32
    assert len(seen) == len(log.scan_t)
    assert isinstance(seen[0]["ego_pos"], torch.Tensor)
    assert set(frames) == set(fused)
    np.testing.assert_allclose(frames["ego_pos"], fused["ego_pos"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(frames["applied"], fused["applied"])


def test_run_frames_chunked_on_full_map(tiny, fused32):
    """``run_frames(chunk=2)`` on a full map (JAX runtime.py:1422): the same
    frames as ``run_fused`` to 1e-6 m, ``on_scan`` once per chunk with the
    chunk's outputs stacked."""
    _, log, pipes = tiny
    seen = []
    _, chunked = pipes["f32"][1].run_frames(log, chunk=2, on_scan=seen.append)
    n = len(log.scan_t)
    assert [len(o["ego_pos"]) for o in seen] == [min(2, n - k0) for k0 in range(0, n, 2)]
    assert set(chunked) == set(fused32)
    np.testing.assert_allclose(chunked["ego_pos"], fused32["ego_pos"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(chunked["applied"], fused32["applied"])


def _reloc_setup(cfg_mod):
    """tests/test_pipeline.py:261's small_setup(duration=2) configuration."""
    cfg = cfg_mod.ElimalocConfig()
    cfg.pcm.icp_method = cfg_mod.IcpMethod.P2P
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    cfg.pcm.lidar_time_delay = 0.0
    return cfg


def test_initialize_at_matches_jax():
    world = jlog.make_world(seed=5, extent=90.0, n_ground=120_000, n_wall=60_000)
    log = jlog.synthesize_log(world, duration=2.0, points_per_scan=2048, max_range=60.0,
                              seed=6, imu_noise_gyro=0.001, imu_noise_acc=0.01)
    kw = dict(ds_points=2048, use_native=False, ego_ring_size=256, imu_ring_size=128)
    jpipe = LocalizationPipeline(_reloc_setup(jconfig), world, dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=32, max_slots=768), **kw)
    tpipe = TPipeline(_reloc_setup(tconfig), world, dtype=torch.float64, device="cpu",
                      tile_budget=TBudget(qb=32, max_slots=768), **kw)
    click = (61.0, 0.5, np.pi / 2 * 0.98, log.scan_points[0], log.scan_valid[0], log.scan_t[0])
    jst, jok = jpipe.initialize_at(jpipe.reset(), *click)
    tst, tok = tpipe.initialize_at(tpipe.reset(), *click)
    assert tok == jok is True
    assert bool(tst.ekf.pcm_init_on_going)
    for name in ("pos", "rot", "vel", "P", "prev_timestamp", "state_initialized",
                 "pcm_init_on_going"):
        np.testing.assert_allclose(getattr(tst.ekf, name).numpy(),
                                   np.asarray(getattr(jst.ekf, name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert np.linalg.norm(tst.ekf.pos.numpy()[:2] - log.truth_pos[0][:2]) < 1.5
    # the ground probe of a pipeline built from a packed tile map
    assert tpipe._ground_from_tiles([61.0, 0.5]) == jpipe._ground_from_tiles([61.0, 0.5])
    packed = TPipeline(_reloc_setup(tconfig), tpipe.host_map, dtype=torch.float32,
                       device="cpu", tile_budget=TBudget(qb=32, max_slots=768), **kw)
    assert packed.built is None
    pst, pok = packed.initialize_at(packed.reset(), *click)
    assert pok and np.linalg.norm(pst.ekf.pos.numpy()[:2] - log.truth_pos[0][:2]) < 1.5
    # a click off the map finds no ground
    st, ok = tpipe.initialize_at(tst, 500.0, 500.0, 0.0, *click[3:])
    assert ok is False and st is tst


@pytest.mark.parametrize("mode", ["Cartesian", "UTM"])
def test_project_gps_and_unproject_match_jax(tiny, mode):
    _, _, pipes = tiny
    tpipe = pipes["f64"][1]
    e = tpipe.cfg.ekf
    rng = np.random.default_rng(4)
    lat = e.ref_latitude + rng.uniform(-0.01, 0.01, 20)
    lon = e.ref_longitude + rng.uniform(-0.01, 0.01, 20)
    h = e.ref_height + rng.uniform(-20, 20, 20)
    cfg = copy.deepcopy(tpipe.cfg)
    cfg.pcm.projection_mode = mode
    tpipe_mode = copy.copy(tpipe)
    tpipe_mode.cfg = cfg
    xyz = tpipe_mode.project_gps(lat, lon, h)
    utm = mode == "UTM"
    fwd = jgeo.project_gps_point_utm if utm else jgeo.project_gps_point
    ref = fwd(lat, lon, h, e.ref_latitude, e.ref_longitude, e.ref_height, xp=np)
    np.testing.assert_allclose(xyz, ref, rtol=0, atol=1e-9)
    assert xyz.dtype == np.float64 and np.abs(xyz[:, :2]).max() > 100.0
    back = tpipe_mode.unproject(xyz)
    rev = jgeo.unproject_local_point_utm if utm else jgeo.unproject_local_point
    for got, want, orig in zip(back, rev(ref, e.ref_latitude, e.ref_longitude, e.ref_height,
                                          xp=np), (lat, lon, h)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got, orig, rtol=0, atol=1e-6)


def _reload_pipe(world):
    return TPipeline(tiny_cfg(tconfig), world, device="cpu",
                     tile_budget=TBudget(qb=8, max_slots=1024), **KW)


def test_reload_config_swaps_params_without_losing_state(tiny):
    """tests/test_pipeline_modes.py:93 on the port: a value change swaps the
    parameters only; a flag change makes a new PipelineStatic; the filter
    state stays valid across both."""
    world, _, _ = tiny
    pipe = _reload_pipe(world)
    state = pipe.reset()
    g = torch.tensor([0.0, 0.0, 9.81])
    state = pipe.imu_step(state, torch.tensor(0.01), g, torch.zeros(3))
    static, tmap = pipe.static, pipe.map
    old_max = float(pipe.params.icp.max_search_dist)
    cfg2 = copy.deepcopy(pipe.cfg)
    cfg2.pcm.max_search_dist = 2.5
    pipe.reload_config(cfg2)
    assert float(pipe.params.icp.max_search_dist) == 2.5 != old_max
    assert pipe.static is static and pipe.map is tmap
    cfg3 = copy.deepcopy(cfg2)
    cfg3.ekf.use_zupt = True
    pipe.reload_config(cfg3)
    assert pipe.static is not static and pipe.static.ekf_flags.use_zupt is True
    assert pipe.map is tmap
    state = pipe.imu_step(state, torch.tensor(0.02), g, torch.zeros(3))
    assert np.isfinite(state.ekf.P.numpy()).all()
    assert int(state.ego_ring.count) == 2


def test_ini_hot_reload_mid_run_frames(tiny, tmp_path):
    """tests/test_pipeline_modes.py:117 on the port: an ini edited halfway
    through ``run_frames`` swaps the parameters at the next frame, the
    static switches stay the same object, and the replay keeps localizing."""
    world, log, _ = tiny
    pipe = _reload_pipe(world)
    ini = tmp_path / "localization.ini"
    tconfig.export_ini(pipe.cfg, str(ini))
    pipe.watch_config(str(ini))
    static = pipe.static
    assert float(pipe.params.icp.max_search_dist) != 3.75
    n = len(log.scan_t)
    progress = {"k": 0, "edited_at": None}

    def on_scan(out):
        progress["k"] += 1
        if progress["k"] == n // 2:
            cfg2 = copy.deepcopy(pipe.cfg)
            cfg2.pcm.max_search_dist = 3.75
            tconfig.export_ini(cfg2, str(ini))
            st = os.stat(str(ini))
            os.utime(str(ini), ns=(st.st_atime_ns, st.st_mtime_ns + 1))
            progress["edited_at"] = progress["k"]
            assert float(pipe.params.icp.max_search_dist) != 3.75

    _, outs = pipe.run_frames(log, on_scan=on_scan)
    assert progress["edited_at"] == n // 2
    assert float(pipe.params.icp.max_search_dist) == 3.75
    assert pipe.static is static
    assert np.isfinite(outs["ego_pos"]).all()
    ate = ate_rmse(outs["ego_t_abs"], outs["ego_pos"], log.truth_t, log.truth_pos)
    assert ate < 0.5, ate


@pytest.mark.parametrize("mode", ["debug_print_run", "debug_print_frames"])
def test_unported_modes_refuse(tiny, mode, capsys):
    """``debug_print``, which this test once held refused, runs as JAX's
    does (runtime.py:1378-1390): the state dashboard once a simulated
    second of the filter's time, checked after each scan of ``run`` and each
    frame of ``run_frames``."""
    world, log, _ = tiny
    pipe = _reload_pipe(world)
    pipe.cfg.ekf.debug_print = True
    seen = []
    check = pipe._maybe_dashboard

    def watch(state):
        seen.append(float(state.ekf.prev_timestamp))
        check(state)

    pipe._maybe_dashboard = watch
    if mode == "debug_print_run":
        pipe.run(log)
    else:
        pipe.run_frames(log)
    expected, last = 0, None
    for t in seen:
        if last is None or t - last >= 1.0:
            expected, last = expected + 1, t
    printed = capsys.readouterr().out.count("State Std")
    assert len(seen) == len(log.scan_t) and printed == expected >= 2, (seen, printed)


def test_use_imu_off_by_hot_reload_switches_run_to_the_tick_mode(tiny):
    """use_imu=False, the refusal this test once held, now runs: switched
    off by a hot reload, the event loop runs the tick mode (CA ticks and the
    IMU ring intake, no IMU prediction) and still localizes under JAX's own
    tick-mode bound (tests/test_pipeline_modes.py:82-90, ATE < 2.0 m); the
    frame loops ignore the switch as JAX's fused_frame does."""
    world, log, _ = tiny
    pipe = _reload_pipe(world)
    cfg = copy.deepcopy(pipe.cfg)
    cfg.ekf.use_imu = False
    pipe.reload_config(cfg)
    assert pipe.static.use_imu is False
    seen = {"imu": 0, "tick": 0, "pcm_imu": 0}
    orig = {k: getattr(truntime, f"{k}_step") for k in ("imu", "tick")}
    orig["pcm_imu"] = truntime.imu_ring_step

    def count(kind):
        def step(*a, **k):
            seen[kind] += 1
            return orig[kind](*a, **k)
        return step

    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(truntime, "imu_step", count("imu"))
        m.setattr(truntime, "tick_step", count("tick"))
        m.setattr(truntime, "imu_ring_step", count("pcm_imu"))
        _, traj = pipe.run(log)
    assert seen["imu"] == 0 and seen["pcm_imu"] == len(log.imu_t)
    base = np.floor(min(log.imu_t[0], log.scan_t[0]))
    assert seen["tick"] == len(np.arange(log.imu_t[0] - base, log.imu_t[-1] - base, 0.01))
    ate = ate_rmse(traj["t"], traj["pos"], log.truth_t, log.truth_pos)
    assert ate < 2.0, ate
    _, outs = pipe.run_frames(log)
    assert np.isfinite(outs["ego_pos"]).all() and len(outs["ego_pos"]) == len(log.scan_t)


def test_run_fused_accepts_debug_print(tiny, fused32):
    """The whole-log replay has no dashboard (JAX runtime.py:1573-1588), so
    ``debug_print`` changes nothing there: the same outputs as without it."""
    _, log, pipes = tiny
    pipe = pipes["f32"][1]
    pipe.cfg.ekf.debug_print = True
    try:
        outs = pipe.run_fused(log)[1]
    finally:
        pipe.cfg.ekf.debug_print = False
    assert outs.keys() == fused32.keys()
    for k, v in fused32.items():
        np.testing.assert_array_equal(outs[k], v, err_msg=k)


def test_host_tile_map_pipeline_keeps_no_built_map(tiny):
    world, _, pipes = tiny
    assert pipes["f32"][1].built is not None
    host = ttiles.build_tile_map(pipes["f32"][1].built)
    pipe = TPipeline(tiny_cfg(tconfig), host, device="cpu",
                     tile_budget=TBudget(qb=8, max_slots=1024), **KW)
    assert pipe.built is None and pipe.host_map is host
