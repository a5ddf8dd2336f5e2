"""The functional replay of elimaloc_tpu_torch (``runtime.replay_fused``,
``replay_fused_chunk``, ``fused_frame_at``; JAX runtime.py:494-543)
against the JAX package's, and against the port's own frame loops.

* float64, the same NumPy inputs through JAX's jitted function and its
  port (state, params and map through ``elimaloc_tpu_torch.convert``):
  ``replay_fused`` on the ``tiny_pipe`` configuration (tests/
  test_pipeline_modes.py:22-43, P2P) over a whole 2 s log and on the GPS +
  CAN configuration of tests/test_torch_fusion.py:197-248 over its 7
  frames; ``replay_fused_chunk`` with chunk 4 over the tiny log up to its
  ragged last chunk (the clamped rows included) and one chunk past the end;
  a chunk on an active window around the start (the drive of tests/
  test_torch_window_chunks.py) against JAX's on its own window. Bounds:
  every float output within 1e-6 (ego_pos in m), ``applied``,
  ``iterations``, ``icp_success`` and ``slots_dropped`` equal, the state
  within 1e-6 (the repo's f64 bound, tests/test_oracle_parity.py:88-101).
* float32 on the CPU, the port against itself, bit for bit: ``replay_fused``
  = ``run_fused``, the chunks concatenated = ``replay_fused``,
  ``fused_frame_at(k)`` = ``fused_frame`` on row k, a 2-lane
  ``parallel.replay_fused_fleet`` = two ``replay_fused`` runs, a NumPy
  batch dict = its tensor dict; ``IndexError`` / ``ValueError`` cases.
* ``elimaloc_tpu_torch.pipeline`` exports the ``runtime`` names JAX's
  ``elimaloc_tpu.pipeline`` exports.
* ``cuda``-marked (skipped without a card): ``replay_fused`` = ``run_fused``
  with its launch counts, ``replay_fused`` and every chunk with no host
  sync, a NumPy float64 dict run in float32. This module imports JAX only
  inside its JAX fixtures, so those cases also run on a host without JAX
  (``python -m pytest --noconftest -m cuda``).
"""

import functools

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch import parallel as tparallel
from elimaloc_tpu_torch import pipeline as tpipeline
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import flatten, one_torch_thread, tiny_cfg  # noqa: F401

KW = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128)
QB, SLOTS = 8, 1024
CHUNK = 4
#: the float32 cases' chunk (chip_smoke's), ragged on their 13-frame log
CHUNK32 = 8
#: fused_frame's outputs that must be equal, not close
EXACT = ("applied", "iterations", "icp_success", "slots_dropped")
#: JAX runtime.py's exports in elimaloc_tpu/pipeline/__init__.py
RUNTIME_EXPORTS = ("LocalizationPipeline", "PipelineParams", "PipelineState",
                   "PipelineStatic", "build_fused_batches", "make_pipeline_params",
                   "make_pipeline_static", "replay_fused", "scan_step", "imu_step",
                   "gps_step", "can_step", "shape_icp_covariance")


def _rows_close(tout, jout, rows=None, what=""):
    """Port outputs (tensors [F, ...]) against JAX's, ``rows`` of them."""
    assert set(tout) == set(jout), set(tout) ^ set(jout)
    for k, v in jout.items():
        j = np.asarray(v)[rows]
        t = tout[k].numpy()[rows]
        assert t.shape == j.shape, (what, k)
        if k in EXACT or j.dtype.kind != "f":
            np.testing.assert_array_equal(t, j, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, err_msg=f"{what} {k}")


def _state_close(tstate, jstate, what=""):
    jflat = flatten(jstate)
    for part, fields in flatten(tstate).items():
        for k, v in fields.items():
            r = np.asarray(jflat[part][k])
            if v.dtype.kind == "f":
                np.testing.assert_allclose(v, r, rtol=0, atol=1e-6, err_msg=f"{what} {part}.{k}")
            else:
                np.testing.assert_array_equal(v, r, err_msg=f"{what} {part}.{k}")


def _same_state(a, b, what=""):
    fa, fb = flatten(a), flatten(b)
    for part, fields in fa.items():
        for k, v in fields.items():
            assert v.dtype == fb[part][k].dtype, (what, part, k)
            np.testing.assert_array_equal(v, fb[part][k], err_msg=f"{what} {part}.{k}")


def _same_outs(got, ref, what=""):
    """Port outputs bit for bit: ``got`` tensors, ``ref`` tensors or NumPy."""
    assert set(got) <= set(ref), set(got) ^ set(ref)
    for k, v in got.items():
        r = ref[k] if isinstance(ref[k], np.ndarray) else ref[k].cpu().numpy()
        g = v.cpu().numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, (what, k, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=f"{what} {k}")


# --------------------------------------------------------------------------- #
# float64 against JAX
# --------------------------------------------------------------------------- #

def _fusion_cfg(mod):
    cfg = tiny_cfg(mod)
    cfg.ekf.use_gps = True
    cfg.ekf.use_can = True
    return cfg


def _jax_case(cfg_name, gps_hz, frames=None):
    """JAX's f64 pipeline on the tiny world and a 2 s log (its first
    ``frames``), its state, params, map and batches, and their port
    conversions."""
    import jax.numpy as jnp

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu.map import TileQueryBudget
    from elimaloc_tpu.pipeline import LocalizationPipeline
    from elimaloc_tpu.pipeline import log as jlog
    from elimaloc_tpu.pipeline import runtime as jruntime

    make_cfg = tiny_cfg if cfg_name == "P2P" else _fusion_cfg
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=2.0, points_per_scan=1024, max_range=50.0,
                              seed=10, gps_hz=gps_hz)
    pipe = LocalizationPipeline(make_cfg(jconfig), world, dtype=jnp.float64,
                                tile_budget=TileQueryBudget(qb=QB, max_slots=SLOTS), **KW)
    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = jruntime.build_fused_batches(log, dtype=np.float64, time_base=pipe.time_base)
    tbatches = truntime.build_fused_batches(log, dtype=np.float64, time_base=pipe.time_base)
    if frames is not None:
        batches = {k: v[:frames] for k, v in batches.items()}
        tbatches = {k: v[:frames] for k, v in tbatches.items()}
    port = dict(
        state=convert.pipeline_state(flatten(state), dtype=torch.float64),
        pp=convert.pipeline_params(flatten(pipe.params), dtype=torch.float64),
        tmap=convert.tile_map(flatten(pipe.map), dtype=torch.float64),
        ps=truntime.make_pipeline_static(make_cfg(tconfig),
                                         tile_budget=TBudget(qb=QB, max_slots=SLOTS),
                                         ds_points=KW["ds_points"]),
        batches=tbatches)
    return pipe, state, batches, port


@pytest.fixture(scope="module")
def p2p64():
    return _jax_case("P2P", 1.0)


@pytest.fixture(scope="module")
def fusion64():
    return _jax_case("GPS+CAN", 5.0, frames=7)


@pytest.mark.parametrize("case", ["p2p64", "fusion64"])
def test_replay_fused_f64_matches_jax(case, request):
    pipe, state, batches, p = request.getfixturevalue(case)
    n = batches["scan_t"].shape[0]
    jstate, jouts = pipe._fused(state, batches, pipe.map)
    tstate, touts = truntime.replay_fused(p["state"], p["batches"], p["tmap"], p["pp"], p["ps"])
    assert touts["ego_pos"].shape == (n, 3) and touts["ego_pos"].dtype == torch.float64
    _rows_close(touts, jouts, what=case)
    _state_close(tstate, jstate, case)
    assert float(touts["applied"].double().mean()) >= 0.9
    if case == "fusion64":
        assert p["ps"].use_gps and p["ps"].use_can
        assert p["batches"]["gps_valid"].sum() >= 1


def test_replay_fused_chunk_f64_matches_jax(p2p64):
    """Chunks of 4 from k0 = 0 to the ragged last chunk (its clamped rows
    held to JAX's row by row), then a chunk past the end: every row clamped
    and the state unchanged."""
    import jax

    from elimaloc_tpu.pipeline import runtime as jruntime

    pipe, jstate, batches, p = p2p64
    # the log's first n frames, n not a multiple of the chunk: the last chunk
    # is ragged
    n = 14
    assert n % CHUNK
    run = jax.jit(functools.partial(jruntime.replay_fused_chunk, ps=pipe.static, chunk=CHUNK))
    jbatches = jax.device_put({k: v[:n] for k, v in batches.items()})
    tbatches = truntime.batches_to_device({k: v[:n] for k, v in p["batches"].items()},
                                          dtype=torch.float64)
    tstate = p["state"]
    for k0 in list(range(0, n, CHUNK)) + [n + 1]:
        jstate, jout = run(jstate, jbatches, k0, pipe.map, pp=pipe._dev_params)
        before = tstate
        tstate, tout = truntime.replay_fused_chunk(tstate, tbatches, k0, p["tmap"], p["pp"],
                                                   p["ps"], CHUNK)
        assert tout["ego_pos"].shape == (CHUNK, 3)
        _rows_close(tout, jout, what=f"chunk {k0}")
        _state_close(tstate, jstate, f"chunk {k0}")
        if k0 >= n:
            assert tstate is before
            # every row is frame n - 1 run on the carried state
            for key in ("ego_pos", "iterations"):
                assert torch.equal(tout[key], tout[key][:1].expand_as(tout[key])), key


@pytest.fixture(scope="module")
def window_drive():
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = tlog.synthesize_log(world, duration=2.05, points_per_scan=1024, max_range=20.0,
                              seed=10, speed=12.0, ramp=0.4)
    return world, log


def _window_cfg(mod):
    c = tiny_cfg(mod)
    c.pcm.input_max_dist = 20.0
    return c


def test_replay_fused_chunk_on_a_window_f64_matches_jax(window_drive):
    """Both packages' pipelines with a 24 m active window on 2 m tiles, the
    window taken around the start; two chunks of 4 over the frames that stay
    inside it, each side on its own window map."""
    import jax
    import jax.numpy as jnp

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu.map import TileQueryBudget
    from elimaloc_tpu.map import builder as jbuilder
    from elimaloc_tpu.map import tiles as jtiles
    from elimaloc_tpu.pipeline import LocalizationPipeline
    from elimaloc_tpu.pipeline import runtime as jruntime

    world, log = window_drive
    built = jbuilder.build_voxel_map(world, 1.0, 30, use_native=False)
    kw = dict(KW, map_window_radius=24.0, map_window_prefetch=False)
    jpipe = LocalizationPipeline(_window_cfg(jconfig), jtiles.build_tile_map(built, tile_voxels=2),
                                 dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=QB, max_slots=SLOTS), **kw)
    tpipe = TPipeline(_window_cfg(tconfig), ttiles.build_tile_map(built, tile_voxels=2),
                      dtype=torch.float64, device="cpu",
                      tile_budget=TBudget(qb=QB, max_slots=SLOTS), **kw)
    start = np.array([60.0, 0.0])
    jpipe._set_window(start)
    tpipe._set_window(start)
    assert tpipe.map.tile_anchor == tuple(int(a) for a in np.asarray(jpipe.map.tile_anchor))
    jstate, tstate = jpipe.reset(), tpipe.reset()
    t0 = min(log.imu_t[0], log.scan_t[0])
    jpipe._rebase(t0)
    tpipe._rebase(t0)
    jbatches = jax.device_put(jruntime.build_fused_batches(log, dtype=np.float64,
                                                           time_base=jpipe.time_base))
    tbatches = truntime.batches_to_device(
        truntime.build_fused_batches(log, dtype=np.float64, time_base=tpipe.time_base),
        dtype=torch.float64)
    run = jax.jit(functools.partial(jruntime.replay_fused_chunk, ps=jpipe.static, chunk=CHUNK))
    for k0 in (0, CHUNK):
        jstate, jout = run(jstate, jbatches, k0, jpipe.map, pp=jpipe._dev_params)
        tstate, tout = truntime.replay_fused_chunk(tstate, tbatches, k0, tpipe.map,
                                                   tpipe.params, tpipe.static, CHUNK)
        np.testing.assert_allclose(tout["ego_pos"].numpy(), np.asarray(jout["ego_pos"]),
                                   rtol=0, atol=1e-6, err_msg=f"chunk {k0}")
        np.testing.assert_array_equal(tout["applied"].numpy(), np.asarray(jout["applied"]))
        assert bool(tout["applied"].all()) and int(tout["slots_dropped"].max()) == 0
        assert int(np.asarray(jout["slots_dropped"]).max()) == 0


# --------------------------------------------------------------------------- #
# float32, the port against itself
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny32():
    """The tiny_pipe configuration on a 1.5 s log of the tiny world."""
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = tlog.synthesize_log(world, duration=1.5, points_per_scan=1024, max_range=50.0,
                              seed=10, gps_hz=1.0)
    pipe = TPipeline(tiny_cfg(tconfig), world, device="cpu", dtype=torch.float32,
                     tile_budget=TBudget(qb=QB, max_slots=SLOTS), **KW)
    fused_state, fused = pipe.run_fused(log)
    return world, log, pipe, fused_state, fused


def _start(pipe, log, dtype=np.float32):
    """A reset state and the log's NumPy batches on the pipeline's time base."""
    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    return state, truntime.build_fused_batches(log, dtype=dtype, time_base=pipe.time_base)


@pytest.fixture(scope="module")
def replay32(tiny32):
    _, log, pipe, _, _ = tiny32
    state, batches = _start(pipe, log)
    tb = truntime.batches_to_device(batches, pipe.device, pipe.dtype)
    return state, tb, truntime.replay_fused(state, tb, pipe.map, pipe.params, pipe.static)


def test_replay_fused_equals_run_fused(tiny32, replay32):
    _, _, _, fused_state, fused = tiny32
    _, _, (state, outs) = replay32
    assert all(v.shape[0] == len(fused["ego_pos"]) for v in outs.values())
    assert set(fused) == set(outs) | {"ego_t_abs"}
    _same_outs(outs, fused, "replay_fused vs run_fused")
    _same_state(state, fused_state, "replay_fused vs run_fused")


def test_chunks_concatenated_equal_replay_fused(tiny32, replay32):
    _, _, pipe, _, _ = tiny32
    state, tb, (ref_state, ref) = replay32
    n = tb["scan_t"].shape[0]
    assert n % CHUNK32
    rows = []
    for k0 in range(0, n, CHUNK32):
        state, out = truntime.replay_fused_chunk(state, tb, k0, pipe.map, pipe.params,
                                                 pipe.static, CHUNK32)
        assert out["ego_pos"].shape[0] == CHUNK32
        rows.append(out)
    cat = {k: torch.cat([o[k] for o in rows])[:n] for k in rows[0]}
    _same_outs(cat, ref, "chunks vs replay_fused")
    _same_state(state, ref_state, "chunks vs replay_fused")
    # the clamped rows: frame n - 1 run from the final state
    _, last = truntime.fused_frame_at(ref_state, tb, n - 1, pipe.map, pipe.params, pipe.static)
    tail = {k: torch.cat([o[k] for o in rows])[n:] for k in rows[0]}
    assert tail["ego_pos"].shape[0] == len(rows) * CHUNK32 - n > 0
    _same_outs(tail, {k: v.expand((len(tail["ego_pos"]),) + v.shape) for k, v in last.items()},
               "clamped rows")


@pytest.mark.parametrize("k", [0, 5, -1])
def test_fused_frame_at_equals_fused_frame(tiny32, replay32, k):
    """Frame k from the reset state (k = -1: the last frame, by index)."""
    _, _, pipe, _, _ = tiny32
    state, tb, _ = replay32
    n = tb["scan_t"].shape[0]
    k = k % n
    got_state, got = truntime.fused_frame_at(state, tb, np.int64(k), pipe.map, pipe.params,
                                             pipe.static)
    ref_state, ref = truntime.fused_frame(state, {key: v[k] for key, v in tb.items()},
                                          pipe.map, pipe.params, pipe.static)
    _same_outs(got, ref, f"frame {k}")
    _same_state(got_state, ref_state, f"frame {k}")


def test_numpy_batches_equal_tensor_batches(tiny32, replay32):
    _, log, pipe, _, _ = tiny32
    state, tb, _ = replay32
    _, batches = _start(pipe, log)
    a_state, a = truntime.replay_fused_chunk(state, batches, 2, pipe.map, pipe.params,
                                             pipe.static, 3)
    b_state, b = truntime.replay_fused_chunk(state, tb, 2, pipe.map, pipe.params,
                                             pipe.static, 3)
    _same_outs(a, b, "NumPy vs tensors")
    _same_state(a_state, b_state, "NumPy vs tensors")
    # a float64 NumPy dict runs in the params' dtype
    _, b64 = _start(pipe, log, np.float64)
    _, c = truntime.fused_frame_at(state, b64, 2, pipe.map, pipe.params, pipe.static)
    assert c["ego_pos"].dtype == torch.float32
    _same_outs(c, {k: v[0] for k, v in a.items()}, "float64 NumPy batches")


def test_out_of_range_and_bad_chunk_raise(tiny32, replay32):
    _, _, pipe, _, _ = tiny32
    state, tb, _ = replay32
    n = tb["scan_t"].shape[0]
    for k in (n, -1, n + 3):
        with pytest.raises(IndexError):
            truntime.fused_frame_at(state, tb, k, pipe.map, pipe.params, pipe.static)
    with pytest.raises(TypeError):
        truntime.fused_frame_at(state, tb, 1.0, pipe.map, pipe.params, pipe.static)
    for chunk in (0, -2):
        with pytest.raises(ValueError):
            truntime.replay_fused_chunk(state, tb, 0, pipe.map, pipe.params, pipe.static,
                                        chunk)


def test_fleet_is_replay_fused_over_lanes(tiny32):
    """``parallel.replay_fused_fleet`` on two lanes (seed 10 and 77 logs of
    1 s, padded to one capacity) equals ``replay_fused`` on each lane's
    batches, every output and state field bit for bit."""
    world, _, pipe, _, _ = tiny32
    logs = [tlog.synthesize_log(world, duration=1.0, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in (10, 77)]
    _, batches = truntime.fleet_batches(logs)
    states, outs = tparallel.replay_fused_fleet(
        tparallel.stack_streams([pipe.reset() for _ in logs]), batches, pipe.map,
        pipe.params, pipe.static)
    for i in range(len(logs)):
        state, ref = truntime.replay_fused(pipe.reset(), {k: v[i] for k, v in batches.items()},
                                           pipe.map, pipe.params, pipe.static)
        _same_outs({k: v[i] for k, v in outs.items()}, ref, f"lane {i}")
        lane_state = flatten(states)
        for part, fields in flatten(state).items():
            for k, v in fields.items():
                np.testing.assert_array_equal(lane_state[part][k][i], v,
                                              err_msg=f"lane {i} {part}.{k}")


# --------------------------------------------------------------------------- #
# The exports
# --------------------------------------------------------------------------- #

def test_pipeline_exports_jax_runtime_names():
    import elimaloc_tpu.pipeline as jpipeline

    from_runtime = sorted(n for n in dir(jpipeline) if getattr(
        getattr(jpipeline, n), "__module__", None) == "elimaloc_tpu.pipeline.runtime")
    assert from_runtime == sorted(RUNTIME_EXPORTS)
    for name in RUNTIME_EXPORTS:
        assert getattr(tpipeline, name) is getattr(truntime, name), name


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = tlog.synthesize_log(world, duration=3.0, points_per_scan=1024, max_range=50.0,
                              seed=10, gps_hz=1.0)
    pipe = TPipeline(tiny_cfg(tconfig), world, device="cuda", dtype=torch.float32,
                     tile_budget=TBudget(qb=QB, max_slots=SLOTS), **KW)
    return log, pipe


#: the kernels a tiny_pipe frame launches once each
FRAME_KERNELS = ("imu_stage", "scan_front", "voxel_downsample", "assign_slots",
                 "p2p_register", "pcm_stage")


@pytest.mark.cuda
def test_replay_fused_equals_run_fused_on_card(card_scene):
    log, pipe = card_scene
    kernels.reset_launches()
    fused_state, fused = pipe.run_fused(log)
    torch.cuda.synchronize()
    want = dict(kernels.launches)
    n = len(log.scan_t)
    state, batches = _start(pipe, log)
    tb = truntime.batches_to_device(batches, pipe.device, pipe.dtype)
    kernels.reset_launches()
    state, outs = truntime.replay_fused(state, tb, pipe.map, pipe.params, pipe.static)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == want
    assert all(want[k] == n for k in FRAME_KERNELS), want
    _same_outs(outs, fused, "card: replay_fused vs run_fused")
    _same_state(state, fused_state, "card: replay_fused vs run_fused")


@pytest.mark.cuda
def test_replay_and_chunks_sync_free_on_card(card_scene):
    log, pipe = card_scene
    state, batches = _start(pipe, log)
    tb = truntime.batches_to_device(batches, pipe.device, pipe.dtype)
    n = tb["scan_t"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ref_state, ref = truntime.replay_fused(state, tb, pipe.map, pipe.params, pipe.static)
        rows = []
        for k0 in range(0, n, CHUNK32):
            state, out = truntime.replay_fused_chunk(state, tb, k0, pipe.map, pipe.params,
                                                     pipe.static, CHUNK32)
            rows.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same_outs({k: torch.cat([o[k] for o in rows])[:n] for k in rows[0]}, ref,
               "card: chunks vs replay_fused")
    _same_state(state, ref_state, "card: chunks vs replay_fused")


@pytest.mark.cuda
def test_numpy_float64_batches_run_in_float32_on_card(card_scene):
    log, pipe = card_scene
    state, b32 = _start(pipe, log)
    _, b64 = _start(pipe, log, np.float64)
    _, ref = truntime.replay_fused_chunk(state, b32, 0, pipe.map, pipe.params, pipe.static, 3)
    _, got = truntime.replay_fused_chunk(state, b64, 0, pipe.map, pipe.params, pipe.static, 3)
    assert got["ego_pos"].dtype == torch.float32 and got["ego_pos"].is_cuda
    _same_outs(got, ref, "card: float64 NumPy batches")
