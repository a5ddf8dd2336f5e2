"""Fleet replay: ``LocalizationPipeline.run_fused_fleet`` of elimaloc_tpu_torch
against the JAX package's (runtime.py:1590-1649), on the ``tiny_pipe``
configuration of tests/test_pipeline_modes.py:22-43,314-336 (P2P, 1024
points a scan, ds_points=1024, qb=8) and its two logs: seed 10 and seed 77
of the same world, 2 s each.

* float64: the port's fleet on the CPU (every stage's plain lane form)
  against JAX's vmapped fleet: ego_pos to 1e-6 m, ``applied``,
  ``iterations`` and ``slots_dropped`` equal, ``ego_t_abs`` equal, the
  lane-axis shapes equal; each port lane against the port's own
  single-stream ``run_fused``, bit for bit (JAX's test allows 1e-6 m).
* float32: the port's fleet against JAX's float64 fleet under the repo's
  closed-loop contract (max < 3 cm, median < 5 mm, last 3 frames < 5 mm).
* The padded, lane-stacked batches equal JAX's key for key, bit for bit;
  JAX's lane-stacked states convert to the port's fleet state.
* Each plain lane form (kernels H, T, C, B, the P2P loop, S) on three lanes
  equals three single-lane plain calls bit for bit, on a fleet frame with
  one lane holding no valid point (its registration fails the overlap gate
  after one iteration, before the others stop).
* The ValueErrors of JAX's run_fused_fleet and ``states=`` passed in.
* Eight configurations past the tile P2P frame (the hash backend, radar
  covariances on every method, ``use_imu=False``, hash GICP, hash AVGICP
  with GPS): a two-lane float32 fleet of short logs, each lane its log's
  run_fused bit for bit. (GICP, VGICP, AVGICP and CAN + GPS fusion:
  tests/test_torch_fleet_methods.py, tests/test_torch_fleet_fusion.py; the
  hash backend and the radar forms against JAX: tests/
  test_torch_fleet_hash.py, tests/test_torch_fleet_radar.py.)
* ``cuda``-marked (skipped without a card): each kernel's lane form against
  its plain lane form and bit for bit against single-lane launches. This
  module imports JAX only inside its JAX fixture, so those cases also run
  on a host without JAX (``python -m pytest --noconftest -m cuda``).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.kernels import build
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.ops import lie
from elimaloc_tpu_torch.parallel import stack_streams
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import ate_rmse
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp
from elimaloc_tpu_torch.struct import lane
from torch_parity import flatten, one_torch_thread, tiny_cfg  # noqa: F401

KW = dict(ds_points=1024, use_native=False, ego_ring_size=128, imu_ring_size=128)
QB, SLOTS = 8, 1024


@pytest.fixture(scope="module")
def world_logs():
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    logs = [tlog.synthesize_log(world, duration=2.0, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in (10, 77)]
    return world, logs


def _pipe(world, dtype, device="cpu", cfg=None, **kw):
    return TPipeline(cfg or tiny_cfg(tconfig), world, device=device, dtype=dtype,
                     tile_budget=TBudget(qb=QB, max_slots=SLOTS), **{**KW, **kw})


@pytest.fixture(scope="module")
def jax_fleet(world_logs):
    """JAX's float64 run_fused_fleet on the two logs, with the states and
    batches it hands replay_fused_fleet, as NumPy."""
    import jax.numpy as jnp

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu import parallel as jparallel
    from elimaloc_tpu.map import TileQueryBudget
    from elimaloc_tpu.pipeline import LocalizationPipeline

    world, logs = world_logs
    pipe = LocalizationPipeline(tiny_cfg(jconfig), world, dtype=jnp.float64,
                                tile_budget=TileQueryBudget(qb=QB, max_slots=SLOTS), **KW)
    seen = {}
    replay = jparallel.replay_fused_fleet

    def spy(states, batches, *rest):
        seen.update(states=states, batches=batches)
        return replay(states, batches, *rest)

    jparallel.replay_fused_fleet = spy
    try:
        _, outs = pipe.run_fused_fleet(logs)
    finally:
        jparallel.replay_fused_fleet = replay
    return ({k: np.asarray(v) for k, v in outs.items()},
            {k: np.asarray(v) for k, v in seen["batches"].items()}, flatten(seen["states"]))


@pytest.fixture(scope="module")
def pipe64(world_logs):
    return _pipe(world_logs[0], torch.float64)


@pytest.fixture(scope="module")
def fleet64(world_logs, pipe64):
    return pipe64.run_fused_fleet(world_logs[1])[1]


@pytest.fixture(scope="module")
def fleet32(world_logs):
    world, logs = world_logs
    pipe = _pipe(world, torch.float32)
    return pipe, pipe.run_fused_fleet(logs)[1]


def test_fleet_f64_matches_jax(fleet64, jax_fleet):
    jouts = jax_fleet[0]
    assert set(fleet64) == set(jouts)
    for k, v in jouts.items():
        assert fleet64[k].shape == v.shape, k
    np.testing.assert_allclose(fleet64["ego_pos"], jouts["ego_pos"], rtol=0, atol=1e-6)
    for k in ("applied", "iterations", "slots_dropped", "ego_t_abs"):
        np.testing.assert_array_equal(fleet64[k], jouts[k], err_msg=k)
    assert fleet64["applied"].mean() >= 0.9


def test_fleet_lanes_match_single_stream(world_logs, fleet32):
    """Each lane of the float32 fleet is its log's single-stream run_fused,
    every output bit for bit (JAX's test_fleet_lanes_match_single_stream
    checks ego_pos to 1e-6 m and ``applied``)."""
    world, logs = world_logs
    pipe, fleet = fleet32
    for i, log in enumerate(logs):
        _, single = pipe.run_fused(log)
        assert set(single) == set(fleet)
        for k, v in single.items():
            np.testing.assert_array_equal(fleet[k][i], v, err_msg=f"lane {i} {k}")
    assert pipe.time_base is not None   # run_fused set it; the fleet leaves it None
    pipe.run_fused_fleet(logs[:1])
    assert pipe.time_base is None


def test_fleet_f32_closed_loop_contract_against_jax(world_logs, fleet32, jax_fleet):
    world, logs = world_logs
    fleet, jouts = fleet32[1], jax_fleet[0]
    for i, log in enumerate(logs):
        err = np.linalg.norm(fleet["ego_pos"][i] - jouts["ego_pos"][i], axis=1)
        assert float(np.max(err)) < 0.03, (i, err.max())
        assert float(np.median(err)) < 0.005, (i, np.median(err))
        assert float(np.max(err[-3:])) < 0.005, (i, err[-3:])
        assert fleet["applied"][i].mean() >= 0.9
        assert int(fleet["slots_dropped"][i].max()) == 0
        ate = ate_rmse(fleet["ego_t_abs"][i], fleet["ego_pos"][i], log.truth_t, log.truth_pos)
        assert ate < 0.1, (i, ate)


def test_fleet_batches_match_jax(world_logs, jax_fleet):
    """runtime.fleet_batches (padding + parallel.stack_streams) against the
    batches JAX's run_fused_fleet hands replay_fused_fleet."""
    _, logs = world_logs
    bases, batches = truntime.fleet_batches(logs)
    jbatches = jax_fleet[1]
    assert set(batches) == set(jbatches)
    for k, v in jbatches.items():
        assert batches[k].dtype == v.dtype, k
        np.testing.assert_array_equal(batches[k], v, err_msg=k)
    np.testing.assert_array_equal(
        bases, [np.floor(min(log.imu_t[0], log.scan_t[0])) for log in logs])
    # the two logs' IMU frames differ in capacity: lane 1 or lane 0 was padded
    caps = [truntime.build_fused_batches(log)["imu_t"].shape[1] for log in logs]
    assert batches["imu_t"].shape[2] == max(caps)


def test_fleet_state_converts_from_jax(jax_fleet):
    """convert.fleet_state: JAX's lane-stacked states as NumPy, and the same
    as a list of per-lane states, give one fleet state: every field with a
    leading lane axis, the EKF state B records of one buffer after a
    pack."""
    jstates = jax_fleet[2]
    got = convert.fleet_state(jstates, dtype=torch.float64)
    per_lane = [{part: {k: np.asarray(v)[i] for k, v in fields.items()}
                 for part, fields in jstates.items()} for i in range(2)]
    again = convert.fleet_state(per_lane, dtype=torch.float64)
    for state in (got, again):
        flat = flatten(state)
        for part, fields in jstates.items():
            for k, v in fields.items():
                np.testing.assert_array_equal(flat[part][k], np.asarray(v), err_msg=f"{part}.{k}")
    assert got.ekf.P.shape == (2, 27, 27) and got.ego_ring.count.shape == (2,)


def test_fleet_refuses_like_jax(world_logs, pipe64):
    world, logs = world_logs
    pipe = pipe64
    short = tlog.synthesize_log(world, duration=1.0, points_per_scan=1024, max_range=50.0,
                                seed=3)
    with pytest.raises(ValueError, match="share a scan count"):
        pipe.run_fused_fleet([logs[0], short])
    no_can = dataclasses.replace(logs[1], can_t=None, can_vel=None, can_yaw_rate=None)
    with pytest.raises(ValueError, match="share sensor streams"):
        pipe.run_fused_fleet([logs[0], no_can])
    win = _pipe(world, torch.float64, map_window_radius=48.0)
    with pytest.raises(ValueError, match="cannot swap map windows"):
        win.run_fused_fleet(logs)


def test_fleet_takes_states(world_logs, pipe64):
    """``states=``: a list of single states, each lane starting from its
    own (two relocalized states here), as JAX's; each lane equals its log's
    run_fused from the same state."""
    world, logs = world_logs
    logs = [tlog.synthesize_log(world, duration=0.5, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in (10, 77)]
    pipe = pipe64
    states = []
    for dx, log in zip((0.3, -0.2), logs):
        pose = torch.eye(4, dtype=torch.float64)
        pose[:3, :3] = lie.euler_to_rot(torch.tensor([0.0, 0.0, np.pi / 2],
                                                     dtype=torch.float64))
        pose[0, 3], pose[2, 3] = 60.0 + dx, 0.0
        t0 = float(log.scan_t[0] - np.floor(min(log.imu_t[0], log.scan_t[0])))
        states.append(pipe.pcm_init_step(pipe.reset(), torch.tensor(t0, dtype=torch.float64),
                                         pose))
    out_states, fleet = pipe.run_fused_fleet(logs, states=states)
    assert out_states.ekf.pos.shape == (2, 3)
    for i, log in enumerate(logs):
        pipe.reset()
        _, single = pipe.run_fused(log, state=states[i])
        for k, v in single.items():
            np.testing.assert_array_equal(fleet[k][i], v, err_msg=f"lane {i} {k}")
        np.testing.assert_array_equal(out_states.ekf.pos[i].numpy(), fleet["ego_pos"][i, -1])


def test_fleet_splits_a_frame_past_one_launch(world_logs, pipe64, monkeypatch):
    """A fleet frame holding more IMU samples than one launch of kernel H
    takes (the launch's limit lowered to 4 samples, so the tiny logs' ~10
    samples a frame split as a long IMU lead's 1,211 do): ``imu_subbatch``
    splits every lane at the same ranges (``runtime.imu_chunks``), and each
    lane still equals its log's run_fused, bit for bit."""
    world, _ = world_logs
    monkeypatch.setattr(kernels, "IMU_STAGE_MAX_SAMPLES", 4)
    logs = [tlog.synthesize_log(world, duration=0.4, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in (10, 77)]
    _, batches = truntime.fleet_batches(logs)
    assert len(truntime.imu_chunks(batches["imu_t"].shape[2])) >= 3
    _, fleet = pipe64.run_fused_fleet(logs)
    for i, log in enumerate(logs):
        _, single = pipe64.run_fused(log)
        for k, v in single.items():
            np.testing.assert_array_equal(fleet[k][i], v, err_msg=f"lane {i} {k}")


def _change_cfg(change):
    """The configuration of a case: "radar" is P2P with radar covariances
    (which P2P ignores), "X+radar" method X with them, "hash X" method X on
    the hash backend, "hash AVGICP+GPS" with GPS, "tick_mode"
    ``use_imu=False``; VGICP and AVGICP with bench.py's
    ``max_fitness_score=2.0``."""
    cfg = tiny_cfg(tconfig)
    method = change.split()[-1].split("+")[0]
    if method in ("GICP", "VGICP", "AVGICP"):
        cfg.pcm.icp_method = tconfig.IcpMethod[method]
    if method in ("VGICP", "AVGICP"):
        cfg.pcm.max_fitness_score = 2.0
    cfg.pcm.use_radar_cov = change.endswith("radar")
    cfg.ekf.use_gps = change.endswith("+GPS")
    cfg.ekf.use_imu = change != "tick_mode"
    return cfg


@pytest.fixture(scope="module")
def world_built(world_logs):
    """The tiny_pipe world's map with both covariances, built once."""
    return tbuilder.build_voxel_map(world_logs[0], 1.0, 30, compute_voxel_cov=True,
                                    compute_point_cov=True, use_native=False)


@pytest.mark.parametrize("change", ["hash", "radar", "tick_mode", "GICP+radar", "VGICP+radar",
                                    "AVGICP+radar", "hash GICP", "hash AVGICP+GPS"])
def test_fleet_runs_every_configuration(world_logs, world_built, change):
    """A float32 pipeline in each configuration past the tile P2P frame
    (all refused before the hash, radar and use_imu=False lane forms):
    a two-lane fleet of 0.4 s logs, each lane its log's run_fused, every
    output of every frame bit for bit; every slot assigned."""
    world, _ = world_logs
    # GPS at 10 Hz: fixes inside the short logs
    logs = [tlog.synthesize_log(world, duration=0.4, points_per_scan=1024, max_range=50.0,
                                seed=seed, gps_hz=10.0) for seed in (10, 77)]
    hashed = change.startswith("hash")
    kw = {"backend": "hash"} if hashed else {"tile_budget": TBudget(qb=8, max_slots=512)}
    pipe = TPipeline(_change_cfg(change), world_built, device="cpu", **{**KW, **kw})
    assert pipe.static.icp_static.backend == ("hash" if hashed else "tile")
    assert pipe.static.use_imu == (change != "tick_mode")
    _, fleet = pipe.run_fused_fleet(logs)
    assert fleet["ego_pos"].shape == (2, len(logs[0].scan_t), 3)
    assert int(fleet["slots_dropped"].max()) == 0
    for i, log in enumerate(logs):
        _, single = pipe.run_fused(log)
        assert set(single) == set(fleet)
        for k, v in single.items():
            np.testing.assert_array_equal(fleet[k][i], v, err_msg=f"{change} lane {i} {k}")


def test_lane_limit_matches_the_loop():
    src = (build.SRC_DIR / "gn_loop.cuh").read_text()
    assert re.search(r"constexpr int kMaxLanes = (\d+);", src).group(1) == \
        str(kernels.MAX_LANES)


# --------------------------------------------------------------------------- #
# The lane forms: three lanes of one fleet frame, stage by stage
# --------------------------------------------------------------------------- #

LANE_SEEDS = (10, 77, 5)
#: the fleet frame the stages run on (after three frames of the fleet)
FRAME = 3
EMPTY_LANE = 2


def _lane_scene(device="cpu"):
    """A float32 tile P2P pipeline and the inputs of a three-lane fleet
    frame: the fleet state after FRAME frames and frame FRAME's padded
    batch, with lane EMPTY_LANE's scan made all invalid."""
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    logs = [tlog.synthesize_log(world, duration=0.8, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in LANE_SEEDS]
    pipe = _pipe(world, torch.float32, device)
    _, batches = truntime.fleet_batches(logs)
    batches["scan_valid"][EMPTY_LANE, FRAME] = False
    frames = {k: v.transpose(0, 1).contiguous() for k, v in
              truntime.batches_to_device(batches, pipe.device, torch.float32).items()}
    st = stack_streams([pipe.reset() for _ in logs])
    for k in range(FRAME):
        st, _ = truntime.fused_frame(st, {key: v[k] for key, v in frames.items()}, pipe.map,
                                     pipe.params, pipe.static)
    return pipe, st, {key: v[FRAME] for key, v in frames.items()}


def _stage_inputs(pipe, st, b):
    """Each stage's lane inputs on the fleet frame, in the frame's order,
    through the plain lane forms (CPU) or the lane kernels (card)."""
    pp, ps = pipe.params, pipe.static
    inp = {"H": (st, b)}
    st = truntime.imu_subbatch(st, b, pp, ps)
    inp["T"] = (st, b["scan_t"], b["scan_points"], b["scan_times"], b["scan_valid"])
    front = truntime.scan_front(st, *inp["T"][1:], pp, ps)
    inp["C"] = (front.points, front.valid)
    ds_pts, ds_valid, _ = tgrid.voxel_downsample(front.points, front.valid, pp.input_voxel_ds,
                                                 ps.ds_points)
    pose = front.init_guess.clone(memory_format=torch.contiguous_format)
    pose[:, :2, 3] -= pipe.map.origin
    inp["B"] = (lie.transform_points(pose, ds_pts), ds_valid)
    asg = ttiles.assign_slots(pipe.map, *inp["B"], ps.icp_static.tile_budget)
    n = ds_pts.shape[1]
    rows = torch.arange(ds_pts.shape[0], device=ds_pts.device)[:, None, None]
    sbuf = torch.where(asg.qmask[..., None],
                       ds_pts[rows, torch.clamp(asg.qidx.to(torch.int64), max=n - 1)],
                       torch.zeros((), device=ds_pts.device))
    lanes = ds_pts.shape[0]
    total = torch.clamp(ds_valid.sum(-1), min=1).to(torch.float32)
    inp["P2P"] = (asg.slot_tile, sbuf, asg.qmask, pose, torch.zeros(lanes, device=pose.device),
                  torch.eye(6, device=pose.device).repeat(lanes, 1, 1), total)
    res = ticp.run_register(ds_pts, ds_valid, pipe.map, front.init_guess, pp.icp, ps.icp_static)
    inp["S"] = (st.ekf, res, st.ego_ring, front.scan_end, front.usable)
    return inp


def _plain_lanes(stage, pipe, args):
    """Stage ``stage``'s plain lane form on ``args``."""
    pp, ps = pipe.params, pipe.static
    if stage == "H":
        return truntime.imu_subbatch_lanes_plain(*args, pp, ps)
    if stage == "T":
        return truntime.scan_front_lanes_plain(*args, pp, ps)
    if stage == "C":
        return tgrid.voxel_downsample_lanes_plain(*args, pp.input_voxel_ds, ps.ds_points)
    if stage == "B":
        return ttiles.assign_slots_lanes_plain(pipe.map, *args, ps.icp_static.tile_budget)
    if stage == "P2P":
        return ticp.p2p_register_lanes_plain(pipe.map, *args, pp.icp, ps.icp_static.tile_budget,
                                             ps.icp_static.max_iteration)
    ekf, res, ego, end, usable = args
    return truntime.pcm_stage_lanes_plain(ekf, res, pp.tf_lidar_to_ego, ego, end, usable,
                                          pp.ekf, ps.ekf_flags, ps.use_pcm)


def _call(stage, pipe, args, plain: bool):
    """Stage ``stage`` on ``args`` through its single plain version
    (``plain``) or its dispatcher (on the card: the kernel, whose lane form
    takes lane inputs)."""
    pp, ps = pipe.params, pipe.static
    if stage == "H":
        fn = truntime.imu_subbatch_plain if plain else truntime._imu_stage
        return fn(*args, pp, ps)
    if stage == "T":
        fn = truntime.scan_front_plain if plain else truntime.scan_front
        return fn(*args, pp, ps)
    if stage == "C":
        fn = tgrid.voxel_downsample_plain if plain else tgrid.voxel_downsample
        return fn(*args, pp.input_voxel_ds, ps.ds_points)
    if stage == "B":
        fn = ttiles.assign_slots_plain if plain else ttiles.assign_slots
        return fn(pipe.map, *args, ps.icp_static.tile_budget)
    if stage == "P2P":
        fn = ticp.p2p_register_plain if plain else ticp.p2p_register
        return fn(pipe.map, *args, pp.icp, ps.icp_static.tile_budget,
                  ps.icp_static.max_iteration)
    ekf, res, ego, end, usable = args
    fn = truntime.pcm_stage_plain if plain else truntime.pcm_stage
    return fn(ekf, res, pp.tf_lidar_to_ego, ego, end, usable, pp.ekf, ps.ekf_flags, ps.use_pcm)


def _single(stage, pipe, args, i, plain: bool):
    """Stage ``stage`` on lane ``i`` of ``args`` alone."""
    return _call(stage, pipe, [lane(x, i) for x in args], plain)


def _leaves(tree):
    """The tensors of a stage's output, in a fixed order."""
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


STAGES = ("H", "T", "C", "B", "P2P", "S")


@pytest.fixture(scope="module")
def lane_scene():
    pipe, st, b = _lane_scene()
    return pipe, _stage_inputs(pipe, st, b)


@pytest.mark.parametrize("stage", STAGES)
def test_plain_lane_form_equals_single_lane_calls(lane_scene, stage):
    """Three lanes through the plain lane form equal the three lanes' single
    plain calls, every output bit for bit; the empty lane's registration
    fails after one iteration while the others iterate on."""
    pipe, inp = lane_scene
    got = _leaves(_plain_lanes(stage, pipe, inp[stage]))
    for i in range(3):
        ref = _leaves(_single(stage, pipe, inp[stage], i, plain=True))
        assert len(ref) == len(got)
        for g, r in zip(got, ref):
            assert torch.equal(g[i], r), (stage, i)
    if stage == "P2P":
        its, failed = got[5], got[4]
        assert int(its[EMPTY_LANE]) == 1 and bool(failed[EMPTY_LANE])
        assert int(its.max()) > 1 and not bool(failed[:EMPTY_LANE].any())


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


#: each stage's kernel (launch counter) and its tolerance against the plain
#: lane form, the single kernels' own (tests/test_torch_kernels.py and the
#: stage tests): the largest absolute difference of any float output over
#: max(1, |plain|)
CARD = {"H": ("imu_stage", 1e-4), "T": ("scan_front", 1e-4), "C": ("voxel_downsample", 0.0),
        "B": ("assign_slots", 0.0), "P2P": ("p2p_register", 1e-4), "S": ("pcm_stage", 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("stage", STAGES)
def test_lane_form_on_card(cuda, stage):
    """Each kernel's lane form on three lanes of a fleet frame: one launch,
    every lane bit for bit its single-lane launch on that lane's inputs, and
    within the kernel's tolerance of the plain lane form (integer and bool
    outputs equal)."""
    pipe, st, b = _lane_scene(cuda)
    inp = _stage_inputs(pipe, st, b)
    name, tol = CARD[stage]
    kernels.reset_launches()
    got = _call(stage, pipe, inp[stage], plain=False)
    torch.cuda.synchronize()
    assert kernels.launches[name] == 1 and kernels.packs["ekf_state"] == 0, kernels.launches
    got = _leaves(got)
    for i in range(3):
        one = _leaves(_single(stage, pipe, inp[stage], i, plain=False))
        for g, r in zip(got, one):
            assert torch.equal(g[i], r), (stage, i)
    ref = _leaves(_plain_lanes(stage, pipe, inp[stage]))
    for g, r in zip(got, ref):
        if g.dtype.is_floating_point:
            scale = torch.clamp(r.abs(), min=1.0)
            ok = torch.isnan(g) == torch.isnan(r)
            assert bool(ok.all()), stage
            err = torch.nan_to_num((g - r).abs() / scale)
            assert err.numel() == 0 or float(err.max()) <= tol, (stage, float(err.max()))
        else:
            assert torch.equal(g, r), stage
