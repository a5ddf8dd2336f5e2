"""The P2P registration loop on the tile backend: the plain version
``icp.p2p_register_plain`` and the loop kernel ``kernels.p2p_register``
(csrc/p2p_register.cu: kernels A and M as one cooperative launch).

On the CPU: the plain loop against JAX's ``run_register`` (tile, P2P) on
tests/test_icp.py's world, float64 at atol 1e-9 and float32 at atol 1e-4
(as tests/test_torch_icp.py), with equal iteration counts and success; the
plain loop bit-equal to the host loop it replaces (``gn_iteration`` + one
stop-flag readback per iteration) in both dtypes, at convergence, at
``max_iteration``, on a first-iteration overlap failure and at
``max_iteration == 0``; and ``run_register``'s dispatch on a stubbed card
route (the loop kernel once for P2P, never kernel A or M; the GICP loop
kernel once for GICP, never kernel E or M). On the card (``cuda``
marker): the loop kernel bit-equal to the three-launch chain (kernel A's
search + reduction, kernel M, the host loop) with one launch a call, over
multi-iteration registrations and over slot counts below, at 0 and well
above the kernel's grid.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.register import icp as ticp
from torch_parity import flatten

import ref_numpy as ref

P2P = tconfig.IcpMethod.P2P
TOL = {"f64": (torch.float64, 1e-9), "f32": (torch.float32, 1e-4)}
BUDGET = dict(qb=32, max_slots=1024)


# tests/test_icp.py's world, copied: the card host has no JAX, so this file
# imports JAX (and test_icp) only inside its JAX tests; held to the original
# by test_the_world_is_test_icps
def make_world(n_map=6000, extent=30.0, seed=100):
    """Structured synthetic world: ground + two walls (well-constrained ICP)."""
    RNG = np.random.default_rng(seed)
    g = np.c_[RNG.uniform(-extent, extent, (n_map, 2)), RNG.normal(0, 0.02, n_map)]
    w1 = np.c_[
        RNG.uniform(-extent, extent, n_map // 2),
        np.full(n_map // 2, extent / 2) + RNG.normal(0, 0.02, n_map // 2),
        RNG.uniform(0, 4, n_map // 2),
    ]
    w2 = np.c_[
        np.full(n_map // 2, -extent / 3) + RNG.normal(0, 0.02, n_map // 2),
        RNG.uniform(-extent, extent, n_map // 2),
        RNG.uniform(0, 4, n_map // 2),
    ]
    return np.r_[g, w1, w2]


def make_scan(map_pts, pose, n=1024, max_range=25.0, seed=101):
    """Sample map points near the pose and express them in the sensor frame."""
    RNG = np.random.default_rng(seed)
    d = np.linalg.norm(map_pts[:, :2] - pose[:2, 3], axis=1)
    near = map_pts[d < max_range]
    sel = near[RNG.choice(len(near), n)]
    R, t = pose[:3, :3], pose[:3, 3]
    return (sel - t) @ R  # R^T (p - t)


def pose_xyzyaw(x, y, z, yaw):
    T = np.eye(4)
    T[:3, :3] = ref.euler_to_rot([0, 0, yaw])
    T[:3, 3] = [x, y, z]
    return T


TRUE_POSE = pose_xyzyaw(3.0, 1.0, 0.0, 0.5)
INITS = {"perturbed": pose_xyzyaw(3.4, 0.7, 0.1, 0.55), "aligned": TRUE_POSE,
         # ~1 m and 8 deg off: more GN iterations before the step is small
         "far": pose_xyzyaw(3.9, 0.3, 0.1, 0.64)}


@pytest.fixture(scope="module")
def world():
    """The map points, the port's BuiltMap (bit-identical to the JAX
    builder's, tests/test_torch_guards.py), a scan at TRUE_POSE and the
    host tile map."""
    map_pts = make_world()
    cfg = tconfig.PcmConfig(icp_method=P2P)
    built = tbuilder.build_voxel_map(map_pts, cfg.pcm_voxel_size, cfg.pcm_voxel_max_point,
                                     use_native=False)
    host = ttiles.build_tile_map(built, tile_voxels=4)
    return map_pts, built, make_scan(map_pts, TRUE_POSE, n=1024), host


def test_the_world_is_test_icps(world):
    """The copied world, scan and poses are tests/test_icp.py's own."""
    orig = importlib.import_module("test_icp")
    assert np.array_equal(world[0], orig.make_world())
    assert np.array_equal(world[2], orig.make_scan(orig.make_world(), TRUE_POSE, n=1024))
    assert np.array_equal(TRUE_POSE, orig.pose_xyzyaw(3.0, 1.0, 0.0, 0.5))


def _port(world, tdt, device="cpu", **budget):
    """The port's tile map, parameters and static switches for ``world``."""
    tmap = world[3].to_device(device, tdt)
    params = ticp.make_icp_params(tconfig.PcmConfig(icp_method=P2P), dtype=tdt, device=device)
    static = ticp.make_icp_static(tconfig.PcmConfig(icp_method=P2P),
                                  tile_budget=ttiles.TileQueryBudget(**(budget or BUDGET)))
    return tmap, params, static


def _loop_inputs(tmap, scan, init, static):
    """run_register's set-up before its loop (icp.py: the window-origin shift,
    the hoisted slot assignment, the slot-packed scan, the initial carry)."""
    dtype, dev = scan.dtype, scan.device
    valid = torch.ones(len(scan), dtype=torch.bool, device=dev)
    pose = init.to(dtype=dtype, device=dev).clone()
    pose[:2, 3] -= tmap.origin.to(dtype)
    asg = ttiles.assign_slots(tmap, ticp.lie.transform_points(pose, scan), valid,
                              static.tile_budget)
    safe = torch.clamp(asg.qidx.to(torch.int64), max=len(scan) - 1)
    sbuf = torch.where(asg.qmask[..., None], scan[safe], torch.zeros((), dtype=dtype,
                                                                      device=dev))
    total = torch.clamp(torch.sum(valid), min=1).to(dtype)
    carry = (pose, torch.zeros((), dtype=dtype, device=dev),
             torch.eye(6, dtype=dtype, device=dev), total)
    return asg, sbuf, carry


def _host_loop(tmap, asg, sbuf, carry, params, static, max_iteration):
    """The loop that ``p2p_register_plain`` and the loop kernel replace: one
    ``gn_iteration`` and one stop-flag readback per iteration (on a CUDA
    tensor kernel A's search + reduction, then kernel M)."""
    pose, fitness, local_cov, total = carry
    overlap = torch.zeros_like(fitness)
    failed = torch.zeros((), dtype=torch.bool, device=sbuf.device)
    it = 0
    while it < max_iteration:
        pose, local_cov, fitness, overlap, stop, failed = ticp.gn_iteration(
            int(P2P), tmap, asg.slot_tile, sbuf, asg.qmask, pose, fitness,
            local_cov, total, params, static.tile_budget)
        it += 1
        if bool(stop):
            break
    return pose, local_cov, fitness, overlap, failed, it


def _assert_same(got, ref):
    for name, a, b in zip(("pose", "local_cov", "fitness", "overlap", "failed"), got, ref):
        assert torch.equal(a, b), name
    assert int(got[5]) == int(ref[5])
    assert got[5].dtype == torch.int32 and got[5].shape == ()


@pytest.mark.parametrize("init", ["perturbed", "aligned"])
@pytest.mark.parametrize("dt_name", sorted(TOL))
def test_p2p_register_plain_matches_jax(world, dt_name, init):
    """The plain loop against JAX's run_register (tile, P2P) on the JAX
    builder's map: iteration count, success, fitness and pose."""
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    jconfig = importlib.import_module("elimaloc_tpu.config")
    jmapmod = importlib.import_module("elimaloc_tpu.map")
    jreg = importlib.import_module("elimaloc_tpu.register")
    tdt, atol = TOL[dt_name]
    jdt = jnp.float64 if tdt == torch.float64 else jnp.float32
    map_pts, _, scan, _ = world
    cfg = jconfig.PcmConfig(icp_method=jconfig.IcpMethod.P2P)
    built = jmapmod.build_voxel_map(map_pts, cfg.pcm_voxel_size, cfg.pcm_voxel_max_point,
                                    use_native=False)
    jmap = jmapmod.build_tile_map(built, tile_voxels=4).to_device(dtype=jdt)
    jstatic = jreg.make_icp_static(cfg, tile_budget=jmapmod.TileQueryBudget(**BUDGET))
    jparams = jreg.make_icp_params(cfg, dtype=jdt)
    jres = jax.jit(jreg.run_register, static_argnums=5)(
        jnp.asarray(scan, jdt), jnp.ones(len(scan), bool), jmap,
        jnp.asarray(INITS[init], jdt), jparams, jstatic)

    tmap = convert.tile_map(flatten(jmap), dtype=tdt)
    params = convert.icp_params(flatten(jparams), dtype=tdt)
    static = ticp.make_icp_static(tconfig.PcmConfig(icp_method=P2P),
                                  tile_budget=ttiles.TileQueryBudget(**BUDGET))
    asg, sbuf, carry = _loop_inputs(tmap, torch.as_tensor(scan, dtype=tdt),
                                    torch.as_tensor(INITS[init], dtype=tdt), static)
    pose, _, fitness, _, failed, iters = ticp.p2p_register_plain(
        tmap, asg.slot_tile, sbuf, asg.qmask, *carry, params, static.tile_budget,
        static.max_iteration)
    pose = pose.clone()
    pose[:2, 3] += tmap.origin.to(tdt)
    success = bool(~failed & (fitness <= params.max_fitness_score))
    assert int(iters) == int(jres.iterations)
    assert success == bool(jres.success) is True
    np.testing.assert_allclose(pose.numpy(), np.asarray(jres.pose), atol=atol)
    np.testing.assert_allclose(float(fitness), float(jres.fitness), atol=atol)


CASES = {
    # (init, max_iteration or None for the config's, min_overlap_ratio or None)
    "converges": ("far", None, None),
    "max_iteration": ("far", 2, None),
    "overlap_fails": ("perturbed", None, 1.5),
    "zero_iterations": ("perturbed", 0, None),
}


def _case(world, tdt, case, device="cpu"):
    init, max_it, overlap = CASES[case]
    tmap, params, static = _port(world, tdt, device)
    if overlap is not None:
        params = dataclasses.replace(params, min_overlap_ratio=torch.tensor(
            overlap, dtype=tdt, device=device))
    scan = torch.as_tensor(world[2], dtype=tdt, device=device)
    asg, sbuf, carry = _loop_inputs(tmap, scan, torch.as_tensor(INITS[init], dtype=tdt),
                                    static)
    return tmap, params, static, asg, sbuf, carry, (static.max_iteration if max_it is None
                                                    else max_it)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dt_name", sorted(TOL))
def test_p2p_register_plain_equals_the_host_loop(world, dt_name, case):
    """The plain loop is the host loop of gn_iteration + bool(stop) bit for
    bit: the same calls in the same order, the same trip count."""
    tmap, params, static, asg, sbuf, carry, max_it = _case(world, TOL[dt_name][0], case)
    got = ticp.p2p_register_plain(tmap, asg.slot_tile, sbuf, asg.qmask, *carry, params,
                                  static.tile_budget, max_it)
    ref = _host_loop(tmap, asg, sbuf, carry, params, static, max_it)
    _assert_same(got, ref)
    iters, failed = int(got[5]), bool(got[4])
    if case == "converges":
        assert 3 <= iters < max_it and not failed
    elif case == "max_iteration":
        assert iters == 2 and not failed
    elif case == "overlap_fails":
        assert iters == 1 and failed and torch.equal(got[0], carry[0])
    else:
        assert iters == 0 and not failed and torch.equal(got[0], carry[0])
        assert float(got[2]) == float(got[3]) == 0.0


def _stub_card(monkeypatch, tmap, budget):
    """A card route on CPU tensors: the loops' callers take the kernel branch
    (``icp._on_card``), each loop wrapper of the GN loop is a stub that
    records its call and returns its plain version's result, and the
    per-iteration kernels the loops replace (A, E, M) raise."""
    calls = {"p2p_register": [], "gicp_register": []}

    def p2p_loop(halo, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params,
                 max_iteration, **geo):
        calls["p2p_register"].append((halo, geo))
        return ticp.p2p_register_plain(tmap, slot_tile, sbuf, qmask, pose, fitness,
                                       local_cov, total, params, budget, max_iteration)

    def gicp_loop(halo, cov, mean, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                  params, max_iteration, *, radar=None, **geo):
        calls["gicp_register"].append((halo, geo))
        return ticp.gicp_register_plain(tmap, slot_tile, sbuf, qmask, pose, fitness,
                                        local_cov, total, params, budget, max_iteration, radar)

    def refused(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} launched on a path a loop kernel serves")
        return fn

    monkeypatch.setattr(ticp, "_on_card", lambda t: True)
    for name, fn in (("p2p_register", p2p_loop), ("gicp_register", gicp_loop),
                     ("p2p_correspond", refused("p2p_correspond")),
                     ("gicp_correspond", refused("gicp_correspond")),
                     ("gn_step", refused("gn_step"))):
        monkeypatch.setattr(kernels, name, fn)
    return calls


@pytest.mark.parametrize("method", ["P2P", "GICP"])
def test_run_register_dispatch_on_the_card_route(world, method, monkeypatch):
    """On the card route run_register's tile branch makes one call of the
    method's loop kernel (P2P: p2p_register, GICP: gicp_register, with the
    map's halo and geometry) and none of kernel A, E or M. Both give what
    the CPU route gives."""
    map_pts, _, scan, _ = world
    tdt = torch.float64
    m = tconfig.IcpMethod[method]
    cfg = tconfig.PcmConfig(icp_method=m, max_fitness_score=2.0)
    built = tbuilder.build_voxel_map(map_pts, 1.0, 30, use_native=False,
                                     compute_point_cov=method == "GICP")
    tmap = ttiles.build_tile_map(built, tile_voxels=4).to_device("cpu", tdt)
    static = ticp.make_icp_static(cfg, tile_budget=ttiles.TileQueryBudget(**BUDGET))
    params = ticp.make_icp_params(cfg, tdt)
    args = (torch.as_tensor(scan, dtype=tdt), torch.ones(len(scan), dtype=torch.bool), tmap,
            torch.as_tensor(INITS["perturbed"], dtype=tdt), params, static)
    ref = ticp.run_register(*args)
    calls = _stub_card(monkeypatch, tmap, static.tile_budget)
    got = ticp.run_register(*args)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name
    assert int(ref.iterations) >= 2
    mine, other = (("p2p_register", "gicp_register") if method == "P2P"
                   else ("gicp_register", "p2p_register"))
    assert len(calls[mine]) == 1 and calls[other] == []
    halo, geo = calls[mine][0]
    assert halo is tmap.halo_points
    assert geo == dict(voxel_size=tmap.voxel_size, tile_size=tmap.tile_size,
                       tx0=tmap.grid_origin[0], ty0=tmap.grid_origin[1], ty_dim=tmap.ty_dim)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


def _kernel_and_chain(tmap, asg, sbuf, carry, params, static, max_it):
    kernels.reset_launches()
    got = ticp.p2p_register(tmap, asg.slot_tile, sbuf, asg.qmask, *carry, params,
                            static.tile_budget, max_it)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    assert launches["p2p_register"] == 1
    assert sum(launches.values()) == 1, launches
    return got, _host_loop(tmap, asg, sbuf, carry, params, static, max_it)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_p2p_register_equals_the_chain_on_card(world, cuda, case):
    """The loop kernel against kernel A + reduce_partials_kernel + kernel M
    with the host loop, on the same inputs: pose, local_cov, fitness,
    overlap, failed and the iteration count bit for bit, one launch a call;
    the converging case moves the pose over three or more iterations (the
    carry each CTA reads back inside the launch)."""
    tmap, params, static, asg, sbuf, carry, max_it = _case(world, torch.float32, case, cuda)
    got, ref = _kernel_and_chain(tmap, asg, sbuf, carry, params, static, max_it)
    _assert_same(got, ref)
    if case == "converges":
        assert int(got[5]) >= 3 and not bool(got[4])
    # and within the plain version's float32 tolerance of the CPU loop
    tm, pp, st, pa, ps, pc, pm = _case(world, torch.float32, case)
    ref = ticp.p2p_register_plain(tm, pa.slot_tile, ps, pa.qmask, *pc, pp, st.tile_budget, pm)
    assert int(got[5]) == int(ref[5]) and bool(got[4]) == bool(ref[4])
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=0, atol=1e-4)


def _slots(asg, sbuf, order):
    """The assignment with its slot axis taken in ``order`` (live slots moved
    anywhere on the grid; both sides see the same inputs)."""
    return (dataclasses.replace(asg, slot_tile=asg.slot_tile[order].contiguous(),
                                qmask=asg.qmask[order].contiguous()),
            sbuf[order].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("slots", ["below_grid", "zero", "above_grid"])
def test_p2p_register_grid_sizes_on_card(world, cuda, slots):
    """Slot counts below the kernel's co-resident grid (the live slots
    only), zero (one CTA, zero sums: the overlap gate fails after one
    iteration, as kernel A's empty search and kernel M give) and three times
    the grid (the live slots spread over it, so CTAs walk several each):
    bit-equal to the chain, one launch a call."""
    cap = kernels.p2p_register_capacity()
    assert cap > 0
    budget = dict(qb=8, max_slots=3 * cap if slots == "above_grid" else 1024)
    tmap, params, static = _port(world, torch.float32, cuda, **budget)
    scan = torch.as_tensor(world[2], dtype=torch.float32, device=cuda)
    asg, sbuf, carry = _loop_inputs(tmap, scan, torch.as_tensor(INITS["perturbed"]), static)
    live = torch.nonzero(asg.qmask.any(1)).flatten()
    if slots == "below_grid":
        order = live
        assert 0 < len(order) < cap
    elif slots == "zero":
        order = live[:0]
    else:
        gen = torch.Generator().manual_seed(5)
        order = torch.randperm(asg.qmask.shape[0], generator=gen).to(cuda)
        moved = torch.argsort(order)[live]   # where each live slot lands
        assert len(order) == 3 * cap and int(moved.max()) >= 2 * cap
    asg, sbuf = _slots(asg, sbuf, order)
    got, ref = _kernel_and_chain(tmap, asg, sbuf, carry, params, static,
                                 static.max_iteration)
    _assert_same(got, ref)
    if slots == "zero":
        assert int(got[5]) == 1 and bool(got[4])
    else:
        assert int(got[5]) >= 2 and not bool(got[4])
