"""Fleet replay with radar covariances (``use_radar_cov``): kernel X's lane
form and the radar forms' lane forms of the GICP, VGICP and AVGICP tile
loops, through ``register.icp.run_register_lanes`` and
``LocalizationPipeline.run_fused_fleet``, against the JAX package's vmapped
``run_register`` and ``run_fused_fleet`` and against the port's own single
streams. Every registration here runs in a map frame 1 km off the origin,
where the reference's world-frame radar model is well-posed
(tests/test_torch_radar.py says why not near it).

* float64: three tile registrations a method (GICP, VGICP, AVGICP, radar)
  on the structured world of tests/test_icp.py, each lane from its own scan
  and initial pose, through the port's lane set-up (kernel B's and X's
  plain lane forms) and the plain lane form of the method's loop, against
  ``jax.vmap`` of JAX's ``run_register``: pose to 1e-6 m, ``iterations``,
  ``dropped`` and success equal, GICP's exported ``local_cov`` to 1e-6.
* The plain lane forms ``icp.radar_slots_lanes_plain`` (the slot layout)
  and the radar forms' ``icp.gicp_register_lanes_plain`` etc. on three
  lanes of a fleet frame equal three single-lane plain calls bit for bit;
  one lane holds no valid point (its radar rows all zero, its registration
  failing after one iteration while the others iterate on).
* One float32 tile GICP fleet with radar covariances: each lane its log's
  ``run_fused``, every output bit for bit, every scan applied.
* float64 ``run_fused_fleet`` against JAX's on the hash backend, GICP with
  radar covariances and ``use_imu=False`` (JAX's fleet runs the IMU chain
  whatever ``use_imu`` says, and so does the port's): every frame's ego
  position to 1e-6 m, ``applied``, ``iterations`` and ``icp_success``
  equal.
* ``cuda``-marked (skipped without a card): the radar lane forms of the
  three tile loops and kernel X's lane form in the slot layout on the
  three-lane fleet frame: one launch, each lane bit for bit its single-lane
  launch, within 1e-4 x max(1, |plain|) of the plain lane form (AVGICP:
  1e-4 a GN iteration; X: 1e-5).
  The module imports JAX only inside its JAX fixtures, so these cases also
  run on a host without JAX (``python -m pytest --noconftest -m cuda``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.ops import lie
from elimaloc_tpu_torch.parallel import stack_streams
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp
from elimaloc_tpu_torch.struct import lane
from torch_parity import flatten, method_cfg, one_torch_thread  # noqa: F401

METHODS = ("GICP", "VGICP", "AVGICP")
KW = dict(ds_points=1024, ego_ring_size=128, imu_ring_size=128)
QB, SLOTS = 8, 512
#: the map frame's origin, 1 km away from the drive
FAR = np.array([1000.0, 0.0, 0.0])
#: each lane's (true pose, initial pose) as (x, y, z, yaw), before FAR
LANE_POSES = (((3.0, 1.0, 0.0, 0.5), (3.4, 0.7, 0.1, 0.55)),
              ((-2.0, 4.0, 0.0, 0.2), (-2.1, 4.05, 0.0, 0.21)),
              ((5.0, -3.0, 0.0, -0.4), (5.5, -3.4, 0.1, -0.33)))
#: each method's radar lane form: its plain lane form, its single plain
#: version and its dispatcher (the kernel on the card)
LOOPS = {"GICP": (ticp.gicp_register_lanes_plain, ticp.gicp_register_plain,
                  ticp.gicp_register),
         "VGICP": (ticp.vgicp_register_lanes_plain, ticp.vgicp_register_plain,
                   ticp.vgicp_register),
         "AVGICP": (ticp.avgicp_register_lanes_plain, ticp.avgicp_register_plain,
                    ticp.avgicp_register)}


def _cfg(cfg_mod, method, far=True):
    """tiny_pipe's configuration of ``method`` with radar covariances, its
    initial position in the FAR map frame."""
    cfg = method_cfg(cfg_mod, method)
    cfg.pcm.use_radar_cov = True
    if far:
        cfg.ekf.ekf_init_x_m += FAR[0]
    return cfg


# --------------------------------------------------------------------------- #
# The lane registration against JAX's vmap (float64)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_register():
    """(method -> (JAX's vmapped radar run_register on tiles as NumPy, the
    port's float64 inputs)) on the tests/test_icp.py world shifted by FAR,
    each JAX side compiled on first use."""
    import jax
    import jax.numpy as jnp

    from elimaloc_tpu.config import IcpMethod, PcmConfig
    from elimaloc_tpu.map import builder as jbuilder
    from elimaloc_tpu.map import tiles as jtiles
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
    budget = dict(qb=16, max_slots=256)
    cache = {}

    def get(method):
        if method in cache:
            return cache[method]
        kw = dict(max_fitness_score=2.0, use_radar_cov=True)
        cfg = PcmConfig(icp_method=IcpMethod[method], **kw)
        jmap = jtiles.build_tile_map(built, tile_voxels=4, halo_margin=2 if method == "AVGICP"
                                     else 1).to_device(dtype=jnp.float64)
        jparams = jicp.make_icp_params(cfg, dtype=jnp.float64)
        jstatic = jicp.make_icp_static(cfg, tile_budget=jtiles.TileQueryBudget(**budget),
                                       reassign_each_iter=False)
        one = functools.partial(jicp.run_register, params=jparams, static=jstatic)
        jres = jax.jit(jax.vmap(lambda s, v, g: one(s, v, jmap, g)))(
            jnp.asarray(scans), jnp.asarray(valid), jnp.asarray(inits))
        tstatic = ticp.make_icp_static(
            tconfig.PcmConfig(icp_method=tconfig.IcpMethod[method], **kw),
            tile_budget=ttiles.TileQueryBudget(**budget), reassign_each_iter=False)
        port = (torch.as_tensor(scans), torch.as_tensor(valid),
                convert.tile_map(flatten(jmap), dtype=torch.float64), torch.as_tensor(inits),
                convert.icp_params(flatten(jparams), dtype=torch.float64), tstatic)
        cache[method] = ({k: np.asarray(v) for k, v in flatten(jres).items()}, port)
        return cache[method]

    return get


@pytest.mark.parametrize("method", METHODS)
def test_register_lanes_radar_f64_match_jax_vmap(jax_register, method):
    """The port's radar lane registration on tiles (the batched set-up, the
    slot-packed radar rows of every lane from its world pose, the plain
    lane form of the method's radar loop, the batched tail) against
    jax.vmap of run_register."""
    ref, port = jax_register(method)
    assert port[5].use_radar_cov and port[5].backend == "tile"
    res = ticp.run_register(*port)
    assert res.pose.shape == (3, 4, 4) and res.local_cov.shape == (3, 6, 6)
    np.testing.assert_allclose(res.pose.numpy(), ref["pose"], rtol=0, atol=1e-6)
    for k in ("iterations", "dropped", "success"):
        np.testing.assert_array_equal(getattr(res, k).numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(res.fitness.numpy(), ref["fitness"], rtol=0, atol=1e-6)
    assert res.success.all() and int(res.dropped.max()) == 0
    if method == "GICP":
        np.testing.assert_allclose(res.local_cov.numpy(), ref["local_cov"], rtol=0, atol=1e-6)
    one = ticp.run_register(port[0][1], port[1][1], port[2], port[3][1], *port[4:])
    assert torch.equal(one.pose, res.pose[1]) and int(one.iterations) == int(res.iterations[1])


# --------------------------------------------------------------------------- #
# The plain lane forms and the fleet replays (the tiny_pipe world, FAR off)
# --------------------------------------------------------------------------- #

LANE_SEEDS = (10, 77, 5)
FRAME = 1
EMPTY_LANE = 2


@pytest.fixture(scope="module")
def far_tiny():
    """The tiny_pipe world shifted by FAR and its map with both
    covariances, built once."""
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    built = tbuilder.build_voxel_map(world + FAR, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    return world, built


def _far_logs(world, seeds, duration=0.4, **kw):
    """Logs of the tiny_pipe drive, their truth and GPS in the FAR frame
    (the scans are sensor-frame)."""
    logs = [tlog.synthesize_log(world, duration=duration, points_per_scan=1024, max_range=50.0,
                                seed=seed, **kw) for seed in seeds]
    return [dataclasses.replace(log, truth_pos=log.truth_pos + FAR, gps_pos=log.gps_pos + FAR)
            for log in logs]


def _pipe(built, method, device="cpu"):
    return TPipeline(_cfg(tconfig, method), built, device=device, dtype=torch.float32,
                     tile_budget=TBudget(qb=QB, max_slots=SLOTS), **KW)


def _radar_scene(world, built, method, device="cpu"):
    """A float32 tile pipeline of ``method`` with radar covariances and its
    radar loop's lane inputs on a three-lane fleet frame (frame FRAME),
    lane EMPTY_LANE's scan all invalid: (pipe, (slot_tile, sbuf, qmask,
    pose, fitness, local_cov, total, radar), (the scans, qidx, qmask, the
    world poses): kernel X's inputs), every initial pose moved off the
    prediction."""
    pipe = _pipe(built, method, device)
    pp, ps = pipe.params, pipe.static
    _, batches = truntime.fleet_batches(_far_logs(world, LANE_SEEDS))
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
    world_pose = front.init_guess.clone(memory_format=torch.contiguous_format)
    world_pose[:, :2, 3] += torch.tensor([0.3, -0.2], device=world_pose.device)
    pose = world_pose.clone()
    pose[:, :2, 3] -= pipe.map.origin
    asg = ttiles.assign_slots(pipe.map, lie.transform_points(pose, pts), valid,
                              ps.icp_static.tile_budget)
    rows = torch.arange(pts.shape[0], device=pts.device)[:, None, None]
    sbuf = torch.where(asg.qmask[..., None],
                       pts[rows, torch.clamp(asg.qidx.to(torch.int64), max=pts.shape[1] - 1)],
                       torch.zeros((), device=pts.device))
    radar = ticp.radar_slots(pts, asg.qidx, asg.qmask, world_pose, pp.icp)
    lanes = pts.shape[0]
    total = torch.clamp(valid.sum(-1), min=1).to(torch.float32)
    return pipe, (asg.slot_tile, sbuf, asg.qmask, pose, torch.zeros(lanes, device=pose.device),
                  torch.eye(6, device=pose.device).repeat(lanes, 1, 1), total, radar), \
        (pts, asg.qidx, asg.qmask, world_pose)


def _loop(pipe, fn, args):
    ps = pipe.static.icp_static
    return fn(pipe.map, *args[:7], pipe.params.icp, ps.tile_budget, ps.max_iteration, args[7])


@pytest.mark.parametrize("method", METHODS)
def test_radar_plain_lane_forms_equal_single_lane_calls(far_tiny, method):
    """Three lanes through kernel X's plain lane form (the slot layout) and
    the method's radar loop's plain lane form equal the three lanes' single
    plain calls, every output bit for bit; the empty lane's rows are zero
    and its registration fails after one iteration while the others
    iterate on."""
    pipe, args, x_in = _radar_scene(*far_tiny, method)
    rows = ticp.radar_slots_lanes_plain(*x_in, pipe.params.icp)
    assert rows.shape == args[1].shape[:3] + (3, 3)
    for i in range(3):
        assert torch.equal(rows[i], ticp.radar_slots_plain(*(x[i] for x in x_in),
                                                           pipe.params.icp))
    assert not bool(rows[EMPTY_LANE].any()) and bool(rows[0].any())
    plain_lanes, single, _ = LOOPS[method]
    got = _loop(pipe, plain_lanes, args)
    for i in range(3):
        ref = _loop(pipe, single, [lane(x, i) for x in args])
        for g, r in zip(got, ref):
            assert torch.equal(g[i], r), (method, i)
    its, failed = got[5], got[4]
    assert int(its[EMPTY_LANE]) == 1 and bool(failed[EMPTY_LANE])
    assert int(its.max()) > 1 and not bool(failed[:EMPTY_LANE].any())


def test_radar_fleet_lanes_match_single_stream(far_tiny):
    """One float32 tile GICP fleet replay with radar covariances, two logs
    in the FAR frame: each lane is its log's single-stream run_fused, every
    output of every frame bit for bit; every scan applied."""
    world, built = far_tiny
    logs = _far_logs(world, LANE_SEEDS[:2])
    pipe = _pipe(built, "GICP")
    assert pipe.static.icp_static.use_radar_cov
    _, fleet = pipe.run_fused_fleet(logs)
    assert bool(fleet["applied"].all()) and int(fleet["slots_dropped"].max()) == 0
    for i, log in enumerate(logs):
        _, single = pipe.run_fused(log)
        for k, v in single.items():
            np.testing.assert_array_equal(fleet[k][i], v, err_msg=f"lane {i} {k}")


def test_hash_radar_tick_mode_fleet_f64_matches_jax(far_tiny):
    """The hash backend's GICP with radar covariances and use_imu=False:
    the port's float64 fleet (every stage's plain lane form) against JAX's
    run_fused_fleet on the same BuiltMap and logs."""
    import jax.numpy as jnp

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu.map import builder as jbuilder
    from elimaloc_tpu.pipeline import LocalizationPipeline

    world, built = far_tiny
    logs = _far_logs(world, LANE_SEEDS[:2], duration=0.5)

    def cfg(mod):
        c = _cfg(mod, "GICP")
        c.ekf.use_imu = False
        return c

    jbuilt = jbuilder.BuiltMap(**{f.name: getattr(built, f.name)
                                  for f in dataclasses.fields(built)})
    jouts = LocalizationPipeline(cfg(jconfig), jbuilt, backend="hash", dtype=jnp.float64,
                                 **KW).run_fused_fleet(logs)[1]
    pipe = TPipeline(cfg(tconfig), built, backend="hash", dtype=torch.float64, device="cpu",
                     **KW)
    assert not pipe.static.use_imu and pipe.static.icp_static.use_radar_cov
    outs = pipe.run_fused_fleet(logs)[1]
    assert outs["ego_pos"].shape == np.asarray(jouts["ego_pos"]).shape == (2, len(logs[0].scan_t), 3)
    np.testing.assert_allclose(outs["ego_pos"], np.asarray(jouts["ego_pos"]), rtol=0, atol=1e-6)
    for k in ("applied", "iterations", "icp_success"):
        np.testing.assert_array_equal(outs[k], np.asarray(jouts[k]), err_msg=k)
    assert float(outs["applied"].mean()) >= 0.9


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_radar_loop_lane_form_on_card(cuda, far_tiny, method):
    """The method's radar loop's lane form on the three-lane fleet frame:
    one launch, every lane bit for bit its single-lane launch (the radar
    form's) on that lane's inputs, within 1e-4 x max(1, |plain|) of the
    plain lane form, AVGICP's 1e-4 a GN iteration (its float32 sums'
    rounding carries from iteration to iteration, as chip_smoke.py
    allows); integer and bool outputs equal."""
    pipe, args, _ = _radar_scene(*far_tiny, method, device=cuda)
    plain, _, dispatch = LOOPS[method]
    name = f"{method.lower()}_register"
    kernels.reset_launches()
    got = _loop(pipe, dispatch, args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == 1, kernels.launches
    for i in range(3):
        one = _loop(pipe, dispatch, [lane(x, i) for x in args])
        for g, r in zip(got, one):
            assert torch.equal(g[i], r), (method, i)
    tol = 1e-4 * (int(got[5].max()) if method == "AVGICP" else 1)
    for g, r in zip(got, _loop(pipe, plain, args)):
        if g.dtype.is_floating_point:
            err = (g - r).abs() / torch.clamp(r.abs(), min=1.0)
            assert float(err.max()) <= tol, (method, float(err.max()))
        else:
            assert torch.equal(g, r), method


@pytest.mark.cuda
def test_radar_rows_slot_lane_form_on_card(cuda, far_tiny):
    """Kernel X's lane form in the slot layout on the three-lane fleet
    frame: one launch, each lane bit for bit its single-lane launch, the
    plain lane form's rows within 1e-5."""
    pipe, _, x_in = _radar_scene(*far_tiny, "GICP", device=cuda)
    params = pipe.params.icp
    kernels.reset_launches()
    got = ticp.radar_slots(*x_in, params)
    torch.cuda.synchronize()
    assert kernels.launches["radar_rows"] == 1
    for i in range(3):
        assert torch.equal(got[i], ticp.radar_slots(*(x[i] for x in x_in), params))
    assert float((got - ticp.radar_slots_lanes_plain(*x_in, params)).abs().max()) <= 1e-5
