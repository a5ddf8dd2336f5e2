"""Fleet replay on the hash backend: ``run_register`` on a lane axis
(``register.icp.run_register_lanes``: no slot assignment, the world pose,
the hash loop kernel's lane form) and ``LocalizationPipeline.
run_fused_fleet`` with ``backend="hash"``, against the JAX package's
vmapped ``run_register`` and against the port's own single streams.

* float64: three registrations on the structured world of tests/test_icp.py
  in a map frame 1 km off the origin (where the reference's world-frame
  radar model is well-posed, tests/test_torch_radar.py), each lane from its
  own scan and initial pose: hash P2P, and hash GICP, VGICP and AVGICP with
  radar covariances (kernel X's rows in query order), through the port's
  lane set-up and the plain lane form of the hash loop, against
  ``jax.vmap`` of JAX's ``run_register``: pose to 1e-6 m, ``iterations``,
  ``dropped`` and success equal, GICP's exported ``local_cov`` to 1e-6.
* The plain lane forms ``icp.hash_register_lanes_plain`` (every method, the
  radar forms) and ``icp.radar_slots_lanes_plain`` in query order on three
  lanes of a fleet frame equal three single-lane plain calls bit for bit;
  one lane holds no valid point, so its registration fails the overlap gate
  after one iteration while the others iterate on.
* One float32 fleet replay per hash configuration not run in
  tests/test_torch_fleet.py (VGICP, AVGICP, and GICP, VGICP, AVGICP with
  radar covariances): each lane equals its log's ``run_fused``, every output
  of every frame bit for bit.
* A fleet frame of more lanes than one launch of a loop kernel takes
  (``kernels.MAX_LANES`` lowered to 2 for three lanes): the registrations
  run in parts, and each lane still equals its log's ``run_fused``.
* ``cuda``-marked (skipped without a card): the hash loop kernel's lane
  form for every method and radar form, and kernel X's lane form in query
  order, on the three-lane fleet frame (the radar ones FAR off the
  origin): one launch, each lane bit for bit its single-lane launch,
  within 1e-4 x max(1, |plain|) of the plain lane form (AVGICP: 1e-4 a GN
  iteration; X: 1e-5). The module imports JAX only inside its JAX fixture, so
  these cases also run on a host without JAX (``python -m pytest
  --noconftest -m cuda``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.parallel import stack_streams
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp
from elimaloc_tpu_torch.struct import lane
from torch_parity import flatten, method_cfg, one_torch_thread  # noqa: F401

KW = dict(ds_points=1024, ego_ring_size=128, imu_ring_size=128)
#: the map frame's origin of the float64 registrations, 1 km away
FAR = np.array([1000.0, 0.0, 0.0])
#: each lane's (true pose, initial pose) as (x, y, z, yaw), before FAR
LANE_POSES = (((3.0, 1.0, 0.0, 0.5), (3.4, 0.7, 0.1, 0.55)),
              ((-2.0, 4.0, 0.0, 0.2), (-2.1, 4.05, 0.0, 0.21)),
              ((5.0, -3.0, 0.0, -0.4), (5.5, -3.4, 0.1, -0.33)))
#: the registrations held to JAX's: (method, radar covariances)
REGISTRATIONS = (("P2P", False), ("GICP", True), ("VGICP", True), ("AVGICP", True))


def _case(config):
    """(method, radar) of a case id such as "GICP+radar"."""
    return config.split("+")[0], config.endswith("+radar")


def _cfg(cfg_mod, method, radar, far=False):
    cfg = method_cfg(cfg_mod, method)
    cfg.pcm.use_radar_cov = radar
    if far:
        cfg.ekf.ekf_init_x_m += FAR[0]
    return cfg


# --------------------------------------------------------------------------- #
# The lane registration against JAX's vmap (float64)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_register():
    """((method, radar) -> (JAX's vmapped hash run_register as NumPy, the
    port's float64 inputs)) on the tests/test_icp.py world shifted by FAR,
    each JAX side compiled on first use."""
    import jax
    import jax.numpy as jnp

    from elimaloc_tpu.config import IcpMethod, PcmConfig
    from elimaloc_tpu.map import builder as jbuilder
    from elimaloc_tpu.map import grid as jgrid
    from elimaloc_tpu.register import icp as jicp
    from test_icp import make_scan, make_world, pose_xyzyaw

    map_pts = make_world() + FAR
    built = jbuilder.build_voxel_map(map_pts, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    far = lambda x, y, z, yaw: pose_xyzyaw(x + FAR[0], y, z, yaw)  # noqa: E731
    scans = np.stack([make_scan(map_pts, far(*true), n=1024, seed=101 + i)
                      for i, (true, _) in enumerate(LANE_POSES)])
    inits = np.stack([far(*init) for _, init in LANE_POSES])
    valid = np.ones(scans.shape[:2], bool)
    valid[1, ::5] = False  # lanes of different totals
    jgrid_dev = jgrid.to_device(built, dtype=jnp.float64)
    tgrid_dev = convert.map_grid(flatten(jgrid_dev), dtype=torch.float64)
    cache = {}

    def get(method, radar):
        if (method, radar) in cache:
            return cache[method, radar]
        kw = dict(max_fitness_score=2.0, use_radar_cov=radar)
        cfg = PcmConfig(icp_method=IcpMethod[method], **kw)
        jparams = jicp.make_icp_params(cfg, dtype=jnp.float64)
        one = functools.partial(jicp.run_register, params=jparams,
                                static=jicp.make_icp_static(cfg, backend="hash"))
        jres = jax.jit(jax.vmap(lambda s, v, g: one(s, v, jgrid_dev, g)))(
            jnp.asarray(scans), jnp.asarray(valid), jnp.asarray(inits))
        tstatic = ticp.make_icp_static(
            tconfig.PcmConfig(icp_method=tconfig.IcpMethod[method], **kw), backend="hash")
        port = (torch.as_tensor(scans), torch.as_tensor(valid), tgrid_dev,
                torch.as_tensor(inits), convert.icp_params(flatten(jparams), dtype=torch.float64),
                tstatic)
        cache[method, radar] = ({k: np.asarray(v) for k, v in flatten(jres).items()}, port)
        return cache[method, radar]

    return get


@pytest.mark.parametrize("method,radar", REGISTRATIONS)
def test_register_lanes_hash_f64_match_jax_vmap(jax_register, method, radar):
    """The port's lane registration on the hash grid (the world pose, the
    radar rows in query order, the plain lane form of the hash loop, the
    batched tail) against jax.vmap of run_register: each lane iterates
    until its own gates release."""
    ref, port = jax_register(method, radar)
    assert port[5].backend == "hash" and port[5].use_radar_cov == radar
    res = ticp.run_register(*port)
    assert res.pose.shape == (3, 4, 4) and res.dropped.shape == (3,)
    np.testing.assert_allclose(res.pose.numpy(), ref["pose"], rtol=0, atol=1e-6)
    for k in ("iterations", "dropped", "success"):
        np.testing.assert_array_equal(getattr(res, k).numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(res.fitness.numpy(), ref["fitness"], rtol=0, atol=1e-6)
    assert res.success.all() and int(res.dropped.max()) == 0
    if method == "GICP":
        np.testing.assert_allclose(res.local_cov.numpy(), ref["local_cov"], rtol=0, atol=1e-6)
    # lane 2 is lane 2's single registration
    one = ticp.run_register(port[0][2], port[1][2], port[2], port[3][2], *port[4:])
    assert torch.equal(one.pose, res.pose[2]) and int(one.iterations) == int(res.iterations[2])


# --------------------------------------------------------------------------- #
# The plain lane forms and the fleet replays (the tiny_pipe world)
# --------------------------------------------------------------------------- #

LANE_SEEDS = (10, 77, 5)
#: the fleet frame the loops run on (after FRAME frames of the fleet)
FRAME = 1
EMPTY_LANE = 2


@pytest.fixture(scope="module")
def tiny_built():
    """The tiny_pipe world and its map with both covariances, built once."""
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    built = tbuilder.build_voxel_map(world, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    return world, built


@functools.lru_cache(maxsize=1)
def _far_built():
    """The tiny_pipe world moved FAR off the origin and its map with both
    covariances, built on first use (the card's radar cases: near the
    origin the reference's radar model is ill-posed, and the kernel and the
    plain version diverge apart)."""
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    return world, tbuilder.build_voxel_map(world + FAR, 1.0, 30, compute_voxel_cov=True,
                                           compute_point_cov=True, use_native=False)


def _logs(world, seeds, duration=0.4, far=False):
    logs = [tlog.synthesize_log(world, duration=duration, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in seeds]
    if far:  # the truth and the GPS in the FAR frame; the scans are sensor-frame
        logs = [dataclasses.replace(log, truth_pos=log.truth_pos + FAR,
                                    gps_pos=log.gps_pos + FAR) for log in logs]
    return logs


def _pipe(built, method, radar, device="cpu", far=False):
    return TPipeline(_cfg(tconfig, method, radar, far), built, backend="hash", device=device,
                     dtype=torch.float32, **KW)


def _hash_scene(world, built, method, radar, device="cpu", far=False):
    """A float32 hash pipeline of ``method`` and its loop's lane inputs on a
    three-lane fleet frame (frame FRAME, after FRAME fleet frames), with lane
    EMPTY_LANE's scan made all invalid and every initial pose moved off the
    prediction: (pipe, (src, valid, pose, fitness, local_cov, total, radar
    or None)); with ``far``, ``built`` and the drive FAR off the origin."""
    pipe = _pipe(built, method, radar, device, far)
    pp, ps = pipe.params, pipe.static
    _, batches = truntime.fleet_batches(_logs(world, LANE_SEEDS, far=far))
    batches["scan_valid"][EMPTY_LANE, FRAME] = False
    frames = {k: v.transpose(0, 1).contiguous() for k, v in
              truntime.batches_to_device(batches, pipe.device, torch.float32).items()}
    st = stack_streams([pipe.reset() for _ in LANE_SEEDS])
    for k in range(FRAME):
        st, _ = truntime.fused_frame(st, {key: v[k] for key, v in frames.items()}, pipe.map,
                                     pp, ps)
    b = {key: v[FRAME] for key, v in frames.items()}
    st = truntime.imu_subbatch(st, b, pp, ps)
    front = truntime.scan_front(st, b["scan_t"], b["scan_points"], b["scan_times"],
                                b["scan_valid"], pp, ps)
    pts, valid, _ = truntime.voxel_downsample(front.points, front.valid, pp.input_voxel_ds,
                                              ps.ds_points)
    # the initial poses 0.36 m off the prediction: the live lanes iterate
    pose = front.init_guess.clone(memory_format=torch.contiguous_format)
    pose[:, :2, 3] += torch.tensor([0.3, -0.2], device=pose.device)
    lanes = pts.shape[0]
    total = torch.clamp(valid.sum(-1), min=1).to(torch.float32)
    rad = ticp.radar_points(pts, pose, pp.icp) if radar else None
    return pipe, (pts, valid, pose, torch.zeros(lanes, device=pose.device),
                  torch.eye(6, device=pose.device).repeat(lanes, 1, 1), total, rad)


def _loop(pipe, fn, method, args):
    ps = pipe.static.icp_static
    return fn(int(tconfig.IcpMethod[method]), pipe.map, *args[:6], pipe.params.icp,
              ps.max_iteration, args[6])


LOOPS = ("P2P", "GICP", "VGICP", "AVGICP", "GICP+radar", "VGICP+radar", "AVGICP+radar")


@pytest.mark.parametrize("config", ("P2P", "GICP+radar", "VGICP+radar", "AVGICP+radar"))
def test_hash_plain_lane_form_equals_single_lane_calls(tiny_built, config):
    """Three lanes through the hash loop's plain lane form (and the radar
    rows' in query order) equal the three lanes' single plain calls, every
    output bit for bit; the empty lane's registration fails after one
    iteration while the others iterate on."""
    method, radar = _case(config)
    pipe, args = _hash_scene(*tiny_built, method, radar)
    if radar:
        pts, pose = args[0], args[2]
        for i in range(3):
            assert torch.equal(args[6][i], ticp.radar_slots_plain(pts[i], None, None, pose[i],
                                                                  pipe.params.icp))
    got = _loop(pipe, ticp.hash_register_lanes_plain, method, args)
    assert got[0].shape == (3, 4, 4) and got[5].shape == (3,)
    for i in range(3):
        ref = _loop(pipe, ticp.hash_register_plain, method,
                    [None if x is None else lane(x, i) for x in args])
        for g, r in zip(got, ref):
            assert torch.equal(g[i], r), (config, i)
    its, failed = got[5], got[4]
    assert int(its[EMPTY_LANE]) == 1 and bool(failed[EMPTY_LANE])
    assert int(its.max()) > 1


def _assert_lanes_match_single(pipe, logs, fleet, what):
    for i, log in enumerate(logs):
        _, single = pipe.run_fused(log)
        assert set(single) == set(fleet)
        for k, v in single.items():
            np.testing.assert_array_equal(fleet[k][i], v, err_msg=f"{what} lane {i} {k}")


@pytest.mark.parametrize("config", ("VGICP", "AVGICP", "GICP+radar", "VGICP+radar",
                                    "AVGICP+radar"))
def test_hash_fleet_lanes_match_single_stream(tiny_built, config):
    """One float32 fleet replay of two logs on the hash backend: each lane
    is its log's single-stream run_fused, every output of every frame bit
    for bit; no slot is dropped (the hash backend assigns none)."""
    world, built = tiny_built
    logs = _logs(world, LANE_SEEDS[:2])
    pipe = _pipe(built, *_case(config))
    states, fleet = pipe.run_fused_fleet(logs)
    assert states.ekf.P.shape == (2, 27, 27)
    assert fleet["ego_pos"].shape == (2, len(logs[0].scan_t), 3) and len(logs[0].scan_t) >= 2
    assert int(np.abs(fleet["slots_dropped"]).max()) == 0
    _assert_lanes_match_single(pipe, logs, fleet, config)


def test_fleet_past_max_lanes_matches_single_streams(tiny_built, monkeypatch):
    """Three lanes with one launch of a loop kernel limited to two
    (``kernels.MAX_LANES`` lowered): ``run_register_lanes`` registers a fleet
    frame in two runs of lanes (two, then one), concatenated; each lane
    equals its log's run_fused bit for bit, and a run of one lane is the
    single loop's."""
    world, built = tiny_built
    monkeypatch.setattr(kernels, "MAX_LANES", 2)
    calls = []
    loop = ticp.hash_register

    def spy(method, grid, src, *a, **k):
        calls.append(src.shape[0])
        return loop(method, grid, src, *a, **k)

    monkeypatch.setattr(ticp, "hash_register", spy)
    logs = _logs(world, LANE_SEEDS, duration=0.3)
    pipe = _pipe(built, "GICP", True)
    _, fleet = pipe.run_fused_fleet(logs)
    assert fleet["ego_pos"].shape[0] == 3
    assert calls[:2] == [2, 1] and len(calls) == 2 * len(logs[0].scan_t)
    _assert_lanes_match_single(pipe, logs, fleet, "3 lanes in runs of 2")


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


def _close(got, ref, tol, what):
    """Every float output of ``got`` within ``tol`` x max(1, |ref|) of
    ``ref``'s, the rest equal."""
    for g, r in zip(got, ref):
        if g.dtype.is_floating_point:
            err = (g - r).abs() / torch.clamp(r.abs(), min=1.0)
            assert float(err.max()) <= tol, (what, float(err.max()))
        else:
            assert torch.equal(g, r), what


@pytest.mark.cuda
@pytest.mark.parametrize("config", LOOPS)
def test_hash_loop_lane_form_on_card(cuda, tiny_built, config):
    """The hash loop kernel's lane form (the method's, its radar form's, the
    radar forms FAR off the origin) on the three-lane fleet frame: one
    launch, every lane bit for bit its single-lane launch on that lane's
    inputs, within 1e-4 x max(1, |plain|) of the plain lane form, AVGICP's
    1e-4 a GN iteration (its float32 sums' rounding carries from iteration
    to iteration, as chip_smoke.py allows); integer and bool outputs
    equal."""
    method, radar = _case(config)
    scene = _far_built() if radar else tiny_built
    pipe, args = _hash_scene(*scene, method, radar, device=cuda, far=radar)
    kernels.reset_launches()
    got = _loop(pipe, ticp.hash_register, method, args)
    torch.cuda.synchronize()
    assert kernels.launches["hash_register"] == 1, kernels.launches
    for i in range(3):
        one = _loop(pipe, ticp.hash_register, method,
                    [None if x is None else lane(x, i) for x in args])
        for g, r in zip(got, one):
            assert torch.equal(g[i], r), (config, i)
    tol = 1e-4 * (int(got[5].max()) if method == "AVGICP" else 1)
    _close(got, _loop(pipe, ticp.hash_register_lanes_plain, method, args), tol, config)


@pytest.mark.cuda
def test_radar_rows_query_order_lane_form_on_card(cuda):
    """Kernel X's lane form in query order (no index, no mask) on the
    three-lane fleet frame FAR off the origin: one launch, each lane bit for
    bit its single-lane launch, and the plain lane form's rows within
    1e-5."""
    pipe, args = _hash_scene(*_far_built(), "GICP", True, device=cuda, far=True)
    pts, pose, params = args[0], args[2], pipe.params.icp
    kernels.reset_launches()
    got = ticp.radar_slots(pts, None, None, pose, params)
    torch.cuda.synchronize()
    assert kernels.launches["radar_rows"] == 1 and got.shape == pts.shape[:2] + (3, 3)
    for i in range(3):
        assert torch.equal(got[i], ticp.radar_slots(pts[i], None, None, pose[i], params))
    assert float((got - ticp.radar_slots_lanes_plain(pts, None, None, pose, params))
                 .abs().max()) <= 1e-5
