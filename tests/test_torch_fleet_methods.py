"""Fleet replay for GICP, VGICP and AVGICP: ``run_register`` on a lane axis
(``register.icp.run_register_lanes``) and ``LocalizationPipeline.
run_fused_fleet`` of elimaloc_tpu_torch, against the JAX package's vmapped
``run_register`` and against the port's own single streams.

* float64: three registrations on the structured world of tests/test_icp.py
  (where every method converges on 1024-point scans; tests/
  test_torch_methods.py::test_run_register), each lane from its own scan
  and initial pose, through the port's lane set-up and the plain lane form
  of the method's loop kernel, against ``jax.vmap`` of JAX's
  ``run_register``: pose to 1e-6 m, ``iterations``, ``dropped`` and
  success equal, GICP's exported ``local_cov`` to 1e-6 (each lane its
  own).
* The plain lane forms (``icp.gicp_register_lanes_plain`` etc.) on three
  lanes of a fleet frame equal three single-lane plain calls bit for bit;
  one lane holds no valid point, so its registration fails the overlap
  gate after one iteration while the others iterate on.
* One float32 fleet replay a method (two logs of the ``tiny_pipe`` world):
  each lane equals its log's single-stream ``run_fused``, every output of
  every frame bit for bit.
* ``cuda``-marked (skipped without a card): each loop kernel's lane form on
  the three-lane fleet frame: one launch, each lane bit for bit its
  single-lane launch, within 1e-4 x max(1, |plain|) of the plain lane form.
  The module imports JAX only inside its JAX fixture, so these cases also
  run on a host without JAX (``python -m pytest --noconftest -m cuda``).
"""

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
QB, SLOTS = 8, 1024
#: the plain lane form, the dispatcher and the kernel's launch counter of
#: each method's loop
LOOPS = {"GICP": (ticp.gicp_register_lanes_plain, ticp.gicp_register, "gicp_register"),
         "VGICP": (ticp.vgicp_register_lanes_plain, ticp.vgicp_register, "vgicp_register"),
         "AVGICP": (ticp.avgicp_register_lanes_plain, ticp.avgicp_register,
                    "avgicp_register")}
SINGLE = {"GICP": ticp.gicp_register_plain, "VGICP": ticp.vgicp_register_plain,
          "AVGICP": ticp.avgicp_register_plain}


# --------------------------------------------------------------------------- #
# The lane registration against JAX's vmap (float64)
# --------------------------------------------------------------------------- #

#: each lane's (true pose, initial pose) as (x, y, z, yaw)
LANE_POSES = (((3.0, 1.0, 0.0, 0.5), (3.4, 0.7, 0.1, 0.55)),
              ((-2.0, 4.0, 0.0, 0.2), (-2.1, 4.05, 0.0, 0.21)),
              ((5.0, -3.0, 0.0, -0.4), (5.5, -3.4, 0.1, -0.33)))


@pytest.fixture(scope="module")
def jax_register():
    """(method -> (JAX's vmapped run_register result as NumPy, the port's
    float64 inputs)) on the tests/test_icp.py world, the JAX side compiled
    on first use."""
    import jax
    import jax.numpy as jnp

    from elimaloc_tpu.config import IcpMethod, PcmConfig
    from elimaloc_tpu.map import builder as jbuilder
    from elimaloc_tpu.map import tiles as jtiles
    from elimaloc_tpu.register import icp as jicp
    from test_icp import make_scan, make_world, pose_xyzyaw

    map_pts = make_world()
    built = jbuilder.build_voxel_map(map_pts, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    scans = np.stack([make_scan(map_pts, pose_xyzyaw(*true), n=1024, seed=101 + i)
                      for i, (true, _) in enumerate(LANE_POSES)])
    inits = np.stack([pose_xyzyaw(*init) for _, init in LANE_POSES])
    valid = np.ones(scans.shape[:2], bool)
    valid[1, ::5] = False  # lanes of different totals
    budget = dict(qb=32, max_slots=1024)
    cache = {}

    def get(method):
        if method in cache:
            return cache[method]
        m = IcpMethod[method]
        cfg = PcmConfig(icp_method=m, max_fitness_score=2.0)
        jmap = jtiles.build_tile_map(built, tile_voxels=4, halo_margin=2 if method == "AVGICP"
                                     else 1).to_device(dtype=jnp.float64)
        jparams = jicp.make_icp_params(cfg, dtype=jnp.float64)
        jstatic = jicp.make_icp_static(cfg, tile_budget=jtiles.TileQueryBudget(**budget),
                                       reassign_each_iter=False)
        one = functools.partial(jicp.run_register, params=jparams, static=jstatic)
        jres = jax.jit(jax.vmap(lambda s, v, g: one(s, v, jmap, g)))(
            jnp.asarray(scans), jnp.asarray(valid), jnp.asarray(inits))
        tstatic = ticp.make_icp_static(
            tconfig.PcmConfig(icp_method=tconfig.IcpMethod(int(m)), max_fitness_score=2.0),
            tile_budget=ttiles.TileQueryBudget(**budget), reassign_each_iter=False)
        port = (torch.as_tensor(scans), torch.as_tensor(valid),
                convert.tile_map(flatten(jmap), dtype=torch.float64), torch.as_tensor(inits),
                convert.icp_params(flatten(jparams), dtype=torch.float64), tstatic)
        cache[method] = ({k: np.asarray(v) for k, v in flatten(jres).items()}, port)
        return cache[method]

    return get


@pytest.mark.parametrize("method", METHODS)
def test_register_lanes_f64_match_jax_vmap(jax_register, method):
    """The port's lane registration (the batched set-up, the plain lane
    form of the method's loop, the batched tail) against jax.vmap of
    run_register: each lane iterates until its own gates release."""
    ref, port = jax_register(method)
    res = ticp.run_register(*port)
    assert res.pose.shape == (3, 4, 4) and res.local_cov.shape == (3, 6, 6)
    np.testing.assert_allclose(res.pose.numpy(), ref["pose"], rtol=0, atol=1e-6)
    for k in ("iterations", "dropped", "success"):
        np.testing.assert_array_equal(getattr(res, k).numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(res.fitness.numpy(), ref["fitness"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.overlap.numpy(), ref["overlap"], rtol=0, atol=1e-6)
    assert res.success.all() and int(res.dropped.max()) == 0
    if method == "GICP":
        np.testing.assert_allclose(res.local_cov.numpy(), ref["local_cov"], rtol=0, atol=1e-6)
        # every lane exports its own (JTJ + lambda diag)^-1
        assert not torch.equal(res.local_cov[0], res.local_cov[1])
    else:
        np.testing.assert_array_equal(res.local_cov.numpy(), np.broadcast_to(np.eye(6),
                                                                             (3, 6, 6)))
    # lane 1 is lane 1's single registration
    one = ticp.run_register(port[0][1], port[1][1], port[2], port[3][1], *port[4:])
    assert torch.equal(one.pose, res.pose[1]) and int(one.iterations) == int(res.iterations[1])


# --------------------------------------------------------------------------- #
# The plain lane forms and the fleet replays (the tiny_pipe world)
# --------------------------------------------------------------------------- #

LANE_SEEDS = (10, 77, 5)
#: the fleet frame the loops run on (after FRAME frames of the fleet)
FRAME = 1
EMPTY_LANE = 2


@pytest.fixture(scope="module")
def tiny_map():
    """The tiny_pipe world and its map with both covariances, built once."""
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    built = tbuilder.build_voxel_map(world, 1.0, 30, compute_voxel_cov=True,
                                     compute_point_cov=True, use_native=False)
    return world, built


def _pipe(built, method, dtype=torch.float32, device="cpu"):
    return TPipeline(method_cfg(tconfig, method), built, device=device, dtype=dtype,
                     tile_budget=TBudget(qb=QB, max_slots=SLOTS), **KW)


def _loop_inputs(world, built, method, device="cpu"):
    """A float32 pipeline of ``method`` and its loop's lane inputs on a
    three-lane fleet frame (frame FRAME, after FRAME fleet frames), with lane
    EMPTY_LANE's scan made all invalid: (pipe, (slot_tile, sbuf, qmask,
    pose, fitness, local_cov, total))."""
    logs = [tlog.synthesize_log(world, duration=0.4, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in LANE_SEEDS]
    pipe = _pipe(built, method, device=device)
    pp, ps = pipe.params, pipe.static
    _, batches = truntime.fleet_batches(logs)
    batches["scan_valid"][EMPTY_LANE, FRAME] = False
    frames = {k: v.transpose(0, 1).contiguous() for k, v in
              truntime.batches_to_device(batches, pipe.device, torch.float32).items()}
    st = stack_streams([pipe.reset() for _ in logs])
    for k in range(FRAME):
        st, _ = truntime.fused_frame(st, {key: v[k] for key, v in frames.items()}, pipe.map,
                                     pp, ps)
    b = {key: v[FRAME] for key, v in frames.items()}
    st = truntime.imu_subbatch(st, b, pp, ps)
    front = truntime.scan_front(st, b["scan_t"], b["scan_points"], b["scan_times"],
                                b["scan_valid"], pp, ps)
    pts, valid, _ = truntime.voxel_downsample(front.points, front.valid, pp.input_voxel_ds,
                                              ps.ds_points)
    pose = front.init_guess.clone(memory_format=torch.contiguous_format)
    pose[:, :2, 3] -= pipe.map.origin
    asg = ttiles.assign_slots(pipe.map, lie.transform_points(pose, pts), valid,
                              ps.icp_static.tile_budget)
    rows = torch.arange(pts.shape[0], device=pts.device)[:, None, None]
    sbuf = torch.where(asg.qmask[..., None],
                       pts[rows, torch.clamp(asg.qidx.to(torch.int64), max=pts.shape[1] - 1)],
                       torch.zeros((), device=pts.device))
    lanes = pts.shape[0]
    total = torch.clamp(valid.sum(-1), min=1).to(torch.float32)
    return pipe, (asg.slot_tile, sbuf, asg.qmask, pose, torch.zeros(lanes, device=pose.device),
                  torch.eye(6, device=pose.device).repeat(lanes, 1, 1), total)


def _loop(pipe, fn, args):
    ps = pipe.static.icp_static
    return fn(pipe.map, *args, pipe.params.icp, ps.tile_budget, ps.max_iteration)


@pytest.mark.parametrize("method", METHODS)
def test_plain_lane_form_equals_single_lane_calls(tiny_map, method):
    """Three lanes through the method's plain lane form equal the three
    lanes' single plain calls, every output bit for bit; the empty lane's
    registration fails after one iteration while the others iterate on."""
    pipe, args = _loop_inputs(*tiny_map, method)
    got = _loop(pipe, LOOPS[method][0], args)
    assert got[0].shape == (3, 4, 4) and got[5].shape == (3,)
    for i in range(3):
        ref = _loop(pipe, SINGLE[method], [lane(x, i) for x in args])
        for g, r in zip(got, ref):
            assert torch.equal(g[i], r), (method, i)
    its, failed = got[5], got[4]
    assert int(its[EMPTY_LANE]) == 1 and bool(failed[EMPTY_LANE])
    assert int(its.max()) > 1 and not bool(failed[:EMPTY_LANE].any())


@pytest.mark.parametrize("method", METHODS)
def test_fleet_lanes_match_single_stream(tiny_map, method):
    """One float32 fleet replay of two logs: each lane is its log's
    single-stream run_fused, every output of every frame bit for bit."""
    world, built = tiny_map
    logs = [tlog.synthesize_log(world, duration=0.4, points_per_scan=1024, max_range=50.0,
                                seed=seed) for seed in LANE_SEEDS[:2]]
    pipe = _pipe(built, method)
    states, fleet = pipe.run_fused_fleet(logs)
    assert states.ekf.P.shape == (2, 27, 27)
    assert fleet["ego_pos"].shape == (2, len(logs[0].scan_t), 3) and len(logs[0].scan_t) >= 2
    for i, log in enumerate(logs):
        _, single = pipe.run_fused(log)
        assert set(single) == set(fleet)
        for k, v in single.items():
            np.testing.assert_array_equal(fleet[k][i], v, err_msg=f"{method} lane {i} {k}")


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
def test_loop_lane_form_on_card(cuda, tiny_map, method):
    """The method's loop kernel's lane form on the three-lane fleet frame:
    one launch, every lane bit for bit its single-lane launch on that
    lane's inputs, within 1e-4 x max(1, |plain|) of the plain lane form
    (integer and bool outputs equal)."""
    pipe, args = _loop_inputs(*tiny_map, method, device=cuda)
    plain, dispatch, name = LOOPS[method]
    kernels.reset_launches()
    got = _loop(pipe, dispatch, args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == 1, kernels.launches
    for i in range(3):
        one = _loop(pipe, dispatch, [lane(x, i) for x in args])
        for g, r in zip(got, one):
            assert torch.equal(g[i], r), (method, i)
    ref = _loop(pipe, plain, args)
    for g, r in zip(got, ref):
        if g.dtype.is_floating_point:
            err = (g - r).abs() / torch.clamp(r.abs(), min=1.0)
            assert float(err.max()) <= 1e-4, (method, float(err.max()))
        else:
            assert torch.equal(g, r), method
