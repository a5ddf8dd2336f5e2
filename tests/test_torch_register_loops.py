"""The tile GICP, VGICP and AVGICP registration loops and the registration
loop of the hash backend: the plain versions ``icp.gicp_register_plain``,
``icp.vgicp_register_plain``, ``icp.avgicp_register_plain`` and
``icp.hash_register_plain`` and the loop kernels ``kernels.gicp_register``
(csrc/gicp.cu: kernels E and M as one cooperative launch),
``kernels.vgicp_register`` (csrc/vgicp.cu: kernels F and M),
``kernels.avgicp_register`` (csrc/avgicp.cu: kernels G and M) and
``kernels.hash_register`` (csrc/hash_correspond.cu: kernels Q and M).

On the CPU: each plain loop against JAX's ``run_register`` (tile GICP,
VGICP and AVGICP on a halo margin 2 map; hash AVGICP and GICP) on
tests/test_icp.py's world, float64 at atol 1e-9 and float32 at atol 1e-4
(tests/test_torch_gn_loop.py's bounds), with equal iteration counts and
success; each plain loop bit-equal to the host loop it replaces
(``gn_iteration`` / ``gn_iteration_hash`` + one stop-flag readback per
iteration) for tile GICP, VGICP and AVGICP, every hash method and the
radar forms of the tile methods and of hash GICP (in a map frame 1 km off
the origin, where the reference's world-frame radar model is well-posed),
at convergence, at ``max_iteration``, on a first-iteration overlap failure
and at ``max_iteration == 0``; ``run_register``'s dispatch on a stubbed
card route (one loop call per registration for tile GICP, VGICP, AVGICP
and their radar forms and every hash method, never kernel E, F, G, Q or
M); each loop wrapper refuses a CPU tensor. On the card (``cuda``
marker): each loop kernel bit-equal to its three-launch chain (E, F, G or
Q's search + reduction, kernel M, the host loop), one launch a call, at
slot or block counts below, at and well above the kernel's grid.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.register import icp as ticp
from test_torch_gn_loop import INITS, TOL, TRUE_POSE, _loop_inputs, make_scan, make_world
from torch_parity import flatten, one_torch_thread  # noqa: F401

M = tconfig.IcpMethod
#: 135-139 live slots of 32 queries for the scan below: no slot dropped
BUDGET = dict(qb=32, max_slots=256)
#: the radar forms' map frame (tests/test_torch_radar.py)
FAR = np.array([1000.0, 0.0, 0.0])
#: loop -> (backend, method, radar form)
LOOPS = {"tile GICP": ("tile", "GICP", False), "tile GICP radar": ("tile", "GICP", True),
         "tile VGICP": ("tile", "VGICP", False), "tile VGICP radar": ("tile", "VGICP", True),
         "tile AVGICP": ("tile", "AVGICP", False), "tile AVGICP radar": ("tile", "AVGICP", True),
         "hash P2P": ("hash", "P2P", False), "hash GICP": ("hash", "GICP", False),
         "hash VGICP": ("hash", "VGICP", False), "hash AVGICP": ("hash", "AVGICP", False),
         "hash GICP radar": ("hash", "GICP", True)}
CASES = {
    # (init, max_iteration or None for the config's, min_overlap_ratio or None);
    # AVGICP counts (point, voxel) pairs, up to 7 a point: no ratio passes 8
    "converges": ("far", None, None),
    "max_iteration": ("far", 2, None),
    "overlap_fails": ("perturbed", None, 8.0),
    "zero_iterations": ("perturbed", 0, None),
}


@pytest.fixture(scope="module")
def maps():
    """The port's BuiltMaps with both covariances, at the world and 1 km off
    it, each with its halo margin 2 tile map, and the scan at TRUE_POSE (the
    same sensor-frame points in both frames)."""
    pts = make_world()
    out = {}
    for frame, off in (("near", np.zeros(3)), ("far", FAR)):
        built = tbuilder.build_voxel_map(pts + off, 1.0, 30, use_native=False,
                                         compute_voxel_cov=True, compute_point_cov=True)
        out[frame] = (built, ttiles.build_tile_map(built, tile_voxels=4, halo_margin=2))
    return out, make_scan(pts, TRUE_POSE, n=1024)


def _cfg(method, radar=False):
    return tconfig.PcmConfig(icp_method=M[method], use_radar_cov=radar, max_fitness_score=2.0)


def _host_loop(step, pose, fitness, local_cov, max_iteration):
    """The loop the plain loops and the loop kernels replace: one GN
    iteration (``gn_iteration`` or ``gn_iteration_hash``) and one stop-flag
    readback per iteration."""
    overlap = torch.zeros_like(fitness)
    failed = torch.zeros((), dtype=torch.bool, device=pose.device)
    it = 0
    while it < max_iteration:
        pose, local_cov, fitness, overlap, stop, failed = step(pose, fitness, local_cov)
        it += 1
        if bool(stop):
            break
    return pose, local_cov, fitness, overlap, failed, it


def _case(maps, loop, tdt, case, device="cpu", budget=None):
    """The inputs of one registration of ``loop`` as run_register makes them,
    and its three routes: ``plain`` (the plain loop), ``host`` (the host loop
    of gn_iteration / gn_iteration_hash) and ``loop`` (the dispatcher: the
    loop kernel on a CUDA tensor)."""
    backend, method, radar = LOOPS[loop]
    init, max_it, overlap = CASES[case]
    (built, host), scan0 = maps[0]["far" if radar else "near"], maps[1]
    cfg = _cfg(method, radar)
    params = ticp.make_icp_params(cfg, dtype=tdt, device=device)
    if overlap is not None:
        params = dataclasses.replace(params, min_overlap_ratio=torch.tensor(
            overlap, dtype=tdt, device=device))
    max_it = cfg.max_iteration if max_it is None else max_it
    world = INITS[init].copy()
    if radar:
        world[:3, 3] += FAR
    init_pose = torch.as_tensor(world, dtype=tdt, device=device)
    scan = torch.as_tensor(scan0, dtype=tdt, device=device)
    code = int(M[method])
    if backend == "tile":
        tmap = host.to_device(device, tdt)
        static = ticp.make_icp_static(cfg, tile_budget=ttiles.TileQueryBudget(
            **(budget or BUDGET)), reassign_each_iter=False)
        asg, sbuf, carry = _loop_inputs(tmap, scan, init_pose, static)
        rad = (ticp.radar_slots(scan, asg.qidx, asg.qmask, init_pose, params) if radar
               else None)
        args = (tmap, asg.slot_tile, sbuf, asg.qmask, *carry, params, static.tile_budget,
                max_it, rad)

        def step(pose, fitness, local_cov):
            return ticp.gn_iteration(code, tmap, asg.slot_tile, sbuf, asg.qmask, pose,
                                     fitness, local_cov, carry[3], params,
                                     static.tile_budget, rad)

        plain = getattr(ticp, f"{method.lower()}_register_plain")
        loop_fn = getattr(ticp, f"{method.lower()}_register")
    else:
        grid = tgrid.to_device(built, device, tdt)
        valid = torch.ones(len(scan), dtype=torch.bool, device=device)
        carry = (init_pose, torch.zeros((), dtype=tdt, device=device),
                 torch.eye(6, dtype=tdt, device=device),
                 torch.tensor(float(len(scan)), dtype=tdt, device=device))
        rad = ticp.radar_points(scan, init_pose, params) if radar else None
        args = (code, grid, scan, valid, *carry, params, max_it, rad)

        def step(pose, fitness, local_cov):
            return ticp.gn_iteration_hash(code, grid, scan, valid, pose, fitness, local_cov,
                                          carry[3], params, rad)

        plain, loop_fn = ticp.hash_register_plain, ticp.hash_register
    return types.SimpleNamespace(
        args=args, plain=lambda: plain(*args), loop=lambda: loop_fn(*args),
        host=lambda: _host_loop(step, *carry[:3], max_it), carry=carry)


def _assert_same(got, ref):
    for name, a, b in zip(("pose", "local_cov", "fitness", "overlap", "failed"), got, ref):
        assert torch.equal(a, b), name
    assert int(got[5]) == int(ref[5])
    assert got[5].dtype == torch.int32 and got[5].shape == ()


# --------------------------------------------------------------------------- #
# The plain loops against JAX
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_built(maps):
    """The JAX builder's map of the same world (the port's BuiltMap equals
    it, tests/test_torch_guards.py)."""
    jbuilder = importlib.import_module("elimaloc_tpu.map.builder")
    return jbuilder.build_voxel_map(make_world(), 1.0, 30, compute_voxel_cov=True,
                                    compute_point_cov=True, use_native=False)


@pytest.mark.parametrize("loop", ["tile GICP", "tile VGICP", "tile AVGICP", "hash AVGICP",
                                  "hash GICP"])
@pytest.mark.parametrize("dt_name", sorted(TOL))
def test_plain_loop_matches_jax(maps, jax_built, dt_name, loop):
    """The plain loop against JAX's run_register on the JAX builder's map
    (tile: halo margin 2, the hoisted assignment): iteration count, success,
    fitness and pose."""
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    jconfig = importlib.import_module("elimaloc_tpu.config")
    jgrid = importlib.import_module("elimaloc_tpu.map.grid")
    jtiles = importlib.import_module("elimaloc_tpu.map.tiles")
    jreg = importlib.import_module("elimaloc_tpu.register")
    backend, method, _ = LOOPS[loop]
    tdt, atol = TOL[dt_name]
    jdt = jnp.float64 if tdt == torch.float64 else jnp.float32
    scan, init = maps[1], INITS["perturbed"]
    cfg = jconfig.PcmConfig(icp_method=jconfig.IcpMethod[method], max_fitness_score=2.0)
    jparams = jreg.make_icp_params(cfg, dtype=jdt)
    if backend == "tile":
        jmap = jtiles.build_tile_map(jax_built, tile_voxels=4, halo_margin=2).to_device(
            dtype=jdt)
        jstatic = jreg.make_icp_static(cfg, tile_budget=jtiles.TileQueryBudget(**BUDGET),
                                       reassign_each_iter=False)
    else:
        jmap = jgrid.to_device(jax_built, dtype=jdt)
        jstatic = jreg.make_icp_static(cfg, backend="hash")
    jres = jax.jit(jreg.run_register, static_argnums=5)(
        jnp.asarray(scan, jdt), jnp.ones(len(scan), bool), jmap, jnp.asarray(init, jdt),
        jparams, jstatic)

    params = convert.icp_params(flatten(jparams), dtype=tdt)
    src = torch.as_tensor(scan, dtype=tdt)
    pose0 = torch.as_tensor(init, dtype=tdt)
    tcfg = _cfg(method)
    if backend == "tile":
        tmap = convert.tile_map(flatten(jmap), dtype=tdt)
        static = ticp.make_icp_static(tcfg, tile_budget=ttiles.TileQueryBudget(**BUDGET),
                                      reassign_each_iter=False)
        asg, sbuf, carry = _loop_inputs(tmap, src, pose0, static)
        pose, _, fitness, _, failed, iters = getattr(ticp, f"{method.lower()}_register_plain")(
            tmap, asg.slot_tile, sbuf, asg.qmask, *carry, params, static.tile_budget,
            static.max_iteration)
        pose = pose.clone()
        pose[:2, 3] += tmap.origin.to(tdt)
    else:
        grid = convert.map_grid(flatten(jmap), dtype=tdt)
        total = torch.tensor(float(len(scan)), dtype=tdt)
        pose, _, fitness, _, failed, iters = ticp.hash_register_plain(
            int(M[method]), grid, src, torch.ones(len(scan), dtype=torch.bool), pose0,
            torch.zeros((), dtype=tdt), torch.eye(6, dtype=tdt), total, params,
            tcfg.max_iteration)
    success = bool(~failed & (fitness <= params.max_fitness_score))
    assert int(iters) == int(jres.iterations)
    assert success == bool(jres.success) is True
    np.testing.assert_allclose(pose.numpy(), np.asarray(jres.pose), atol=atol)
    np.testing.assert_allclose(float(fitness), float(jres.fitness), atol=atol)


# --------------------------------------------------------------------------- #
# The plain loops against the host loops they replace
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("dt_name", sorted(TOL))
def test_plain_loop_equals_the_host_loop(maps, dt_name, loop, case):
    """The plain loop is the host loop of gn_iteration / gn_iteration_hash +
    bool(stop) bit for bit, in both dtypes: the same calls in the same
    order, the same trip count."""
    c = _case(maps, loop, TOL[dt_name][0], case)
    got = c.plain()
    _assert_same(got, c.host())
    iters, failed = int(got[5]), bool(got[4])
    if case == "converges":
        assert iters >= 2 and not failed and torch.isfinite(got[0]).all()
    elif case == "max_iteration":
        assert iters == 2 and not failed
    elif case == "overlap_fails":
        assert iters == 1 and failed and torch.equal(got[0], c.carry[0])
    else:
        assert iters == 0 and not failed and torch.equal(got[0], c.carry[0])
        assert float(got[2]) == float(got[3]) == 0.0


# --------------------------------------------------------------------------- #
# run_register's dispatch on the card route
# --------------------------------------------------------------------------- #

#: the tile backend's loop wrappers of the covariance methods
TILE_LOOPS = ("gicp_register", "vgicp_register", "avgicp_register")
#: the halo fields each tile loop takes
HALO = {"GICP": ("halo_points", "halo_point_cov", "halo_point_cov_mean"),
        "VGICP": ("halo_vox_mean", "halo_vox_cov", "halo_vox_coord"),
        "AVGICP": ("halo_vox_mean", "halo_vox_cov", "halo_vox_coord")}


def _stub_card(monkeypatch, tmap, budget):
    """A card route on CPU tensors: the loops' callers take the kernel branch
    (``icp._on_card``), each loop wrapper is a stub that records its call
    and returns its plain version's result, and the per-iteration kernels
    the loops replace (A, E, F, G, Q and M) raise."""
    calls = {name: [] for name in TILE_LOOPS + ("hash_register",)}

    def tile_loop(name):
        plain = getattr(ticp, f"{name}_plain")

        def fn(a, b, c, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params,
               max_iteration, *, radar=None, **geo):
            calls[name].append(((a, b, c), geo, radar))
            return plain(tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                         params, budget, max_iteration, radar)
        return fn

    def hash_loop(grid, src, valid, pose, fitness, local_cov, total, params, max_iteration,
                  method, radar=None):
        calls["hash_register"].append((grid, method, radar))
        return ticp.hash_register_plain(int(M[method]), grid, src, valid, pose, fitness,
                                        local_cov, total, params, max_iteration, radar)

    def refused(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} launched on a path a loop kernel serves")
        return fn

    monkeypatch.setattr(ticp, "_on_card", lambda t: True)
    stubs = {name: tile_loop(name) for name in TILE_LOOPS}
    stubs["hash_register"] = hash_loop
    for name in ("p2p_correspond", "gicp_correspond", "vgicp_correspond", "avgicp_correspond",
                 "hash_correspond", "gn_step"):
        stubs[name] = refused(name)
    for name, fn in stubs.items():
        monkeypatch.setattr(kernels, name, fn)
    return calls


DISPATCH = ["tile AVGICP", "tile AVGICP radar", "tile GICP", "tile GICP radar", "tile VGICP",
            "tile VGICP radar", "hash P2P", "hash GICP", "hash VGICP", "hash AVGICP",
            "hash GICP radar"]


@pytest.mark.parametrize("route", DISPATCH)
def test_run_register_dispatch_on_the_card_route(maps, route, monkeypatch):
    """On the card route run_register makes one loop call a registration for
    tile GICP, VGICP and AVGICP (with the map's halo fields, the tile
    geometry where the search takes it, and the slot-packed radar) and for
    every hash method (with the grid, the method and the query-order
    radar), and never launches kernel A, E, F, G, Q or M. Each gives what
    the CPU route gives."""
    backend, method, *rest = route.split()
    radar = bool(rest)
    tdt = torch.float64
    built, host = maps[0]["far" if radar else "near"]
    cfg = _cfg(method, radar)
    world = INITS["perturbed"].copy()
    if radar:
        world[:3, 3] += FAR
    tmap = (host.to_device("cpu", tdt) if backend == "tile"
            else tgrid.to_device(built, "cpu", tdt))
    static = ticp.make_icp_static(cfg, backend=backend, reassign_each_iter=False,
                                  tile_budget=ttiles.TileQueryBudget(**BUDGET))
    args = (torch.as_tensor(maps[1], dtype=tdt), torch.ones(len(maps[1]), dtype=torch.bool),
            tmap, torch.as_tensor(world, dtype=tdt), ticp.make_icp_params(cfg, tdt), static)
    ref = ticp.run_register(*args)
    calls = _stub_card(monkeypatch, tmap, static.tile_budget)
    got = ticp.run_register(*args)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name
    assert int(ref.iterations) >= 2
    mine = "hash_register" if backend == "hash" else f"{method.lower()}_register"
    assert len(calls[mine]) == 1
    assert all(c == [] for name, c in calls.items() if name != mine)
    if backend == "tile":
        halo, geo, rad = calls[mine][0]
        assert halo == tuple(getattr(tmap, f) for f in HALO[method])
        full = dict(voxel_size=tmap.voxel_size, tile_size=tmap.tile_size,
                    tx0=tmap.grid_origin[0], ty0=tmap.grid_origin[1], ty_dim=tmap.ty_dim)
        assert geo == (dict(voxel_size=tmap.voxel_size) if method == "AVGICP" else full)
        assert (rad is not None) == radar
    else:
        grid, name, rad = calls[mine][0]
        assert grid is tmap and name == method and (rad is not None) == radar


@pytest.mark.parametrize("which", TILE_LOOPS + ("hash_register",))
def test_loop_wrappers_refuse_cpu_tensors(maps, which):
    """A CPU tensor never reaches a loop kernel: its wrapper raises."""
    loop = ("hash AVGICP" if which == "hash_register"
            else f"tile {which.split('_')[0].upper()}")
    args = _case(maps, loop, torch.float32, "converges").args
    with pytest.raises(ValueError, match="CUDA tensor required"):
        if which == "hash_register":
            _, grid, src, valid, pose, fitness, local_cov, total, params, m, _ = args
            kernels.hash_register(grid, src, valid, pose, fitness, local_cov, total, params,
                                  m, "AVGICP")
        else:
            tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params, _, m, _ = args
            geo = dict(voxel_size=tmap.voxel_size)
            if which != "avgicp_register":
                geo.update(tile_size=tmap.tile_size, tx0=0, ty0=0, ty_dim=tmap.ty_dim)
            halo = [getattr(tmap, f) for f in HALO[LOOPS[loop][1]]]
            getattr(kernels, which)(*halo, slot_tile, sbuf, qmask, pose, fitness, local_cov,
                                    total, params, m, **geo)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


def _kernel_and_chain(c, name):
    """The loop kernel (one launch and nothing else) and the chain it replaces
    (the host loop of the one-iteration kernel G or Q, then M)."""
    kernels.reset_launches()
    got = c.loop()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    assert launches[name] == 1 and sum(launches.values()) == 1, launches
    return got, c.host()


def _loop_name(loop):
    backend, method, _ = LOOPS[loop]
    return "hash_register" if backend == "hash" else f"{method.lower()}_register"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_loop_kernel_equals_the_chain_on_card(maps, cuda, loop, case):
    """Each loop kernel against its chain (kernel E, F, G or Q's search +
    reduce_partials_kernel, kernel M, the host loop) on the same inputs:
    pose, local_cov, fitness, overlap, failed and the iteration count bit
    for bit, one launch a call; the converging case moves the pose over two
    or more iterations (the carry each CTA reads back inside the launch)."""
    c = _case(maps, loop, torch.float32, case, cuda)
    got, ref = _kernel_and_chain(c, _loop_name(loop))
    _assert_same(got, ref)
    if case == "converges":
        assert int(got[5]) >= 2 and not bool(got[4])


def _capacity(loop, qb):
    backend, method, radar = LOOPS[loop]
    if backend == "tile":
        return getattr(kernels, f"{method.lower()}_register_capacity")(qb, radar)
    return kernels.hash_register_capacity(method, radar)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["below_grid", "at_grid", "zero", "above_grid"])
@pytest.mark.parametrize("loop", ["tile GICP", "tile VGICP", "tile AVGICP", "hash AVGICP",
                                  "hash GICP"])
def test_loop_kernel_grid_sizes_on_card(maps, cuda, loop, size):
    """Slot (tile) or 128-point block (hash) counts below the kernel's
    co-resident grid, at it, zero (one CTA, zero sums: the overlap gate fails
    after one iteration, as the chain gives) and three times it (the live
    slots spread over it, or the scan repeated, so CTAs walk several each):
    bit-equal to the chain, one launch a call."""
    cap = _capacity(loop, 8)
    assert cap > 0
    if loop.startswith("tile"):
        slots = {"at_grid": cap, "above_grid": 3 * cap}.get(size, 1024)
        c = _case(maps, loop, torch.float32, "converges", cuda,
                  budget=dict(qb=8, max_slots=max(slots, 1024)))
        # the slot axis in a new order: the live slots first (below), padded
        # with empty slots to ``slots`` (at, above; spread over the grid), or
        # none (zero)
        tmap, slot_tile, sbuf, qmask, *rest = c.args
        live = torch.nonzero(qmask.any(1)).flatten()
        if size == "below_grid":
            order = live
            assert 0 < len(order) < cap
        elif size == "zero":
            order = live[:0]
        else:
            gen = torch.Generator().manual_seed(5)
            dead = torch.nonzero(~qmask.any(1)).flatten()
            fill = dead[torch.randperm(len(dead), generator=gen).to(cuda)[:slots - len(live)]]
            order = torch.cat([live, fill])
            order = order[torch.randperm(len(order), generator=gen).to(cuda)]
            moved = torch.nonzero(qmask[order].any(1)).flatten()   # where the live slots land
            assert len(order) == slots and int(moved.max()) >= slots - cap
        args = (tmap, slot_tile[order].contiguous(), sbuf[order].contiguous(),
                qmask[order].contiguous(), *rest)
    else:
        n = {"below_grid": 1024, "at_grid": cap * 128, "zero": 0,
             "above_grid": 3 * cap * 128 + 5}[size]
        c = _case(maps, loop, torch.float32, "converges", cuda)
        code, grid, scan, valid, *rest = c.args
        reps = (n + len(scan) - 1) // len(scan)
        src = scan.repeat(max(reps, 1), 1)[:n].contiguous()
        val = valid.repeat(max(reps, 1))[:n].contiguous()
        if size == "below_grid":
            assert (n + 127) // 128 < cap
        args = (code, grid, src, val, *rest)
    c.args = args
    backend, method, _ = LOOPS[loop]
    fn = getattr(ticp, _loop_name(loop))
    c.loop = lambda: fn(*args)
    if backend == "tile":
        tmap, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params, budget, m, r = args

        def step(pose, fitness, local_cov):
            return ticp.gn_iteration(int(M[method]), tmap, slot_tile, sbuf, qmask, pose,
                                     fitness, local_cov, total, params, budget, r)
    else:
        code, grid, src, val, pose, fitness, local_cov, total, params, m, r = args

        def step(pose, fitness, local_cov):
            return ticp.gn_iteration_hash(code, grid, src, val, pose, fitness, local_cov,
                                          total, params, r)
    c.host = lambda: _host_loop(step, pose, fitness, local_cov, m)
    got, ref = _kernel_and_chain(c, _loop_name(loop))
    _assert_same(got, ref)
    if size == "zero":
        assert int(got[5]) == 1 and bool(got[4])
    else:
        assert int(got[5]) >= 2 and not bool(got[4])
