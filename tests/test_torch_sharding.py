"""The sharded modes of elimaloc_tpu_torch (``parallel/sharding.py`` and the
sharded registration in ``register/icp.py``) against the JAX package's, on
the CPU.

One module-scoped world of 4 ranks (``torch.multiprocessing`` under
``spawn``, gloo, a ``file://`` rendezvous under ``tmp_path``, one intra-op
thread a rank; tests/torch_sharding_ranks.py, which never imports JAX) runs
every case and hands its results back through files. The JAX references run
in the test process on the conftest's 8-device virtual CPU mesh, with the
same mesh shape: ``make_mesh(4, dp=1)`` (sp), ``dp=4`` and ``dp=2`` (2 x 2).

* Registrations (float64) on tests/test_sharding.py's scene (RNG 55, 512
  points, qb=32, max_slots=256): point-sharded (``register_sharded``) and
  slot-sharded (``run_register`` with ``slot_shard_axis``) for P2P, GICP,
  VGICP and AVGICP on tiles (AVGICP on a halo_margin=2 map with
  ``reassign_each_iter=False``), GICP with radar covariances on the scene
  moved 1 km off the origin, P2P and GICP on the hash grid point-sharded,
  P2P on the hash grid slot-sharded (JAX's ``partial_axis`` all-reduces
  replicated sums there: the overlap comes out 4x, the pose and fitness
  unchanged), ``register_batch_dp`` (dp=4) and ``register_batch_2d``
  (2 x 2) on 4 lanes of their own initial poses. Bounds, JAX's own
  (test_sharding.py:68-73,118-128): pose atol 1e-8, fitness and overlap
  1e-10, iterations and success equal, against JAX's sharded result and
  against the port's unsharded ``run_register`` (``run_register_lanes``
  for the batches). ``dropped`` is rank 0's (a point-sharded rank's own,
  as JAX's unchecked ``P()`` output).
* Replays (float64, the ``tiny_pipe`` P2P configuration, 1 s logs of
  1,024-point scans, seeds 10 and 11 on lanes 0, 2 and 1, 3):
  ``replay_fused_sp`` (sp=4), ``replay_fused_dp`` (dp=4) and
  ``replay_fused_2d`` (2 x 2) against JAX's unsharded ``replay_fused`` of
  each lane's log: every float output within 1e-6 (ego_pos in m; JAX's own
  slow test holds sp to unsharded at 1e-7, test_sharding.py:175),
  ``applied``, ``iterations``, ``icp_success`` and ``slots_dropped`` equal.
* Lockstep: every rank's outputs bit for bit rank 0's (a point-sharded
  ``dropped`` aside); the GN sums all-reduced once an iteration.
* Refusals: a ``psum_axis`` registration with no active mesh (NameError, as
  JAX's unbound axis), a ``max_slots`` the sp axis does not divide or that
  leaves a rank a count of slots not a multiple of 8 (ValueError, JAX's
  ``_shard_slots`` assertions), a mesh whose ``n_devices`` is not the
  world size.
* ``cuda``-marked (skipped without a card): a 2-rank gloo world on cuda:0,
  its ranks bit for bit each other, kernel A and M once an iteration and no
  loop kernel.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch import parallel as tparallel
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.parallel import stack_streams
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp
from torch_parity import flatten, one_torch_thread, tiny_cfg  # noqa: F401

import torch_sharding_ranks as ranks

WORLD = 4
QB, SLOTS = 32, 256
#: JAX's own bounds (tests/test_sharding.py:68-73,118-128)
POSE_ATOL, SCALAR_ATOL = 1e-8, 1e-10
#: the replays' bound against JAX's unsharded replay_fused
REPLAY_ATOL = 1e-6
FAR = np.array([1000.0, 0.0, 0.0])
#: registration cases: (config, mode); "radar" is GICP with radar covariances
#: 1 km off the origin
REGISTRATIONS = [(m, mode) for m in ("P2P", "GICP", "VGICP", "AVGICP", "GICP radar")
                 for mode in ("point", "slot")] + [
    ("P2P hash", "point"), ("GICP hash", "point"), ("P2P hash", "slot")]
BATCHES = ("dp", "2d")
REPLAYS = ("replay_sp", "replay_dp", "replay_2d")
#: the replay lanes' log seeds
LANE_SEEDS = (10, 11, 10, 11)
REPLAY_KW = dict(ds_points=1024, ego_ring_size=128, imu_ring_size=128)
REPLAY_SLOTS = 1024
EXACT = ("applied", "iterations", "icp_success", "slots_dropped")
#: the refusals: (kind, the budget's max_slots, the message's start)
REFUSALS = {"unbound": ("unbound", SLOTS, "unbound axis name: sp"),
            "slots_not_divisible": ("slot", 258, "max_slots=258 must divide"),
            "slots_not_multiple_of_8": ("slot", 260, "max_slots=260 over 4 devices"),
            "world_size": ("world_size", SLOTS, "make_mesh: n_devices=8")}


def _case_id(case):
    return f"{case[0].replace(' ', '_')}-{case[1]}"


def scene(offset=np.zeros(3)):
    """tests/test_sharding.py:18-50's map, scan, initial pose and truth
    (RNG 55, 512 points), everything moved by ``offset``."""
    rng = np.random.default_rng(55)
    ext = 30.0
    g = np.c_[rng.uniform(-ext, ext, (6000, 2)), rng.normal(0, 0.02, 6000)]
    w1 = np.c_[rng.uniform(-ext, ext, 3000), np.full(3000, 15.0) + rng.normal(0, 0.02, 3000),
               rng.uniform(0, 4, 3000)]
    w2 = np.c_[np.full(3000, -10.0) + rng.normal(0, 0.02, 3000), rng.uniform(-ext, ext, 3000),
               rng.uniform(0, 4, 3000)]
    mp = np.r_[g, w1, w2]
    truth = np.eye(4)
    c, s = np.cos(0.4), np.sin(0.4)
    truth[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    truth[:3, 3] = [2.0, 1.0, 0.0]
    d = np.linalg.norm(mp[:, :2] - truth[:2, 3], axis=1)
    near = mp[d < 25]
    sel = near[rng.choice(len(near), 512)]
    scan = (sel - truth[:3, 3]) @ truth[:3, :3]
    init = truth.copy()
    init[:3, 3] += [0.3, -0.2, 0.05]
    truth[:3, 3] += offset
    init[:3, 3] += offset
    return mp + offset, scan, init, truth


def _pcm(mod, name):
    """The PcmConfig of a case: the method, radar covariances for "GICP
    radar", bench.py's fitness bound 2.0 for VGICP and AVGICP."""
    method = name.split()[0]
    kw = {"max_fitness_score": 2.0} if method in ("VGICP", "AVGICP") else {}
    return mod.PcmConfig(icp_method=mod.IcpMethod[method], use_radar_cov="radar" in name, **kw)


def _static(mod_icp, mod_tiles, cfg, name, max_slots=SLOTS):
    return mod_icp.make_icp_static(cfg, backend="hash" if "hash" in name else "tile",
                                   tile_budget=mod_tiles.TileQueryBudget(qb=QB,
                                                                         max_slots=max_slots),
                                   reassign_each_iter=False)


def _map_key(name):
    if "hash" in name:
        return "hash"
    if "radar" in name:
        return "far"
    return "tile2" if name.startswith("AVGICP") else "tile1"


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Everything: the port's inputs, the 4-rank world's results, JAX's
    sharded and unsharded references and the port's unsharded ones."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu import parallel as jparallel
    from elimaloc_tpu.map import TileQueryBudget
    from elimaloc_tpu.map import builder as jbuilder
    from elimaloc_tpu.map import grid as jgrid
    from elimaloc_tpu.map import tiles as jtiles
    from elimaloc_tpu.pipeline import LocalizationPipeline
    from elimaloc_tpu.register import icp as jicp

    f64 = torch.float64
    near, scan, init, truth = scene()
    far_pts, _, far_init, _ = scene(FAR)
    builts = {"near": jbuilder.build_voxel_map(near, 1.0, 20, use_native=False,
                                               compute_point_cov=True, compute_voxel_cov=True),
              "far": jbuilder.build_voxel_map(far_pts, 1.0, 20, use_native=False,
                                              compute_point_cov=True)}
    jmaps = {"tile1": jtiles.build_tile_map(builts["near"], tile_voxels=4),
             "tile2": jtiles.build_tile_map(builts["near"], tile_voxels=4, halo_margin=2),
             "far": jtiles.build_tile_map(builts["far"], tile_voxels=4)}
    jdev = {k: v.to_device(dtype=jnp.float64) for k, v in jmaps.items()}
    jdev["hash"] = jgrid.to_device(builts["near"], dtype=jnp.float64)
    tmaps = {k: convert.tile_map(flatten(v), dtype=f64) for k, v in jdev.items()
             if k != "hash"}
    tmaps["hash"] = tgrid.to_device(tbuilder.BuiltMap(**flatten(builts["near"])), "cpu", f64)

    inp = {"scan": torch.as_tensor(scan), "valid": torch.ones(len(scan), dtype=torch.bool),
           "init": torch.as_tensor(init), "far_init": torch.as_tensor(far_init), **tmaps}
    # 4 lanes: the scan from 4 initial poses (lane 2 with a fifth of its points
    # invalid, so the lanes' totals differ)
    offsets = np.array([[0.0, 0.0, 0.0], [0.2, 0.1, 0.0], [-0.1, 0.25, 0.05], [0.15, -0.3, 0.0]])
    inits = np.stack([init] * 4)
    inits[:, :3, 3] += offsets
    valids = np.ones((4, len(scan)), bool)
    valids[2, ::5] = False
    inp.update(scans=torch.as_tensor(np.stack([scan] * 4)), valids=torch.as_tensor(valids),
               inits=torch.as_tensor(inits))
    cases, jstatics = [], {}
    for name, mode in REGISTRATIONS + [("P2P", b) for b in BATCHES]:
        cfg = _pcm(tconfig, name)
        inp[f"params {name}"] = ticp.make_icp_params(cfg, dtype=f64)
        batch = mode in BATCHES
        cases.append((_case_id((name, mode)), dict(
            kind=mode, scan="scans" if batch else "scan", valid="valids" if batch else "valid",
            map=_map_key(name), init="inits" if batch else ("far_init" if "radar" in name
                                                            else "init"),
            params=f"params {name}", static=_static(ticp, ttiles, cfg, name))))
        jstatics[name] = _static(jicp, jtiles, _pcm(jconfig, name), name)
    p2p = cases[0][1]
    for rid, (kind, max_slots, _) in REFUSALS.items():
        static = _static(ticp, ttiles, _pcm(tconfig, "P2P"), "P2P", max_slots)
        cases.append((rid, dict(p2p, kind=kind, static=static, refusal=True,
                                n_devices=2 * WORLD, device_type="cpu")))

    # the replays: JAX's f64 tiny_pipe pipeline, its state, map and params in the port
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    logs = {s: tlog.synthesize_log(world, duration=1.0, points_per_scan=1024, max_range=50.0,
                                   seed=s) for s in sorted(set(LANE_SEEDS))}
    jpipe = LocalizationPipeline(tiny_cfg(jconfig), world, dtype=jnp.float64,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=REPLAY_SLOTS),
                                 use_native=False, **REPLAY_KW)
    jstate = jpipe.reset()
    jpipe._rebase(min(logs[10].imu_t[0], logs[10].scan_t[0]))
    per = {s: truntime.build_fused_batches(log, dtype=np.float64, time_base=jpipe.time_base)
           for s, log in logs.items()}
    # the fleet's padding (runtime.fleet_batches), in float64
    lane_batches = {}
    for k in per[10]:
        mx = np.max([per[s][k].shape for s in per], axis=0)
        for s in per:
            lane_batches.setdefault(s, {})[k] = np.pad(
                per[s][k], [(0, m - n) for n, m in zip(per[s][k].shape, mx)])
    state = convert.pipeline_state(flatten(jstate), dtype=f64)
    inp.update(state=state, states=stack_streams([state] * WORLD),
               batches=lane_batches[LANE_SEEDS[0]],
               fleet=stack_streams([lane_batches[s] for s in LANE_SEEDS]),
               pp=convert.pipeline_params(flatten(jpipe.params), dtype=f64),
               replay_map=convert.tile_map(flatten(jpipe.map), dtype=f64))
    ps = truntime.make_pipeline_static(tiny_cfg(tconfig),
                                       tile_budget=ttiles.TileQueryBudget(qb=8,
                                                                          max_slots=REPLAY_SLOTS),
                                       ds_points=REPLAY_KW["ds_points"])
    for kind in REPLAYS:
        cases.append((kind, dict(kind=kind, state="state" if kind == "replay_sp" else "states",
                                 batches="batches" if kind == "replay_sp" else "fleet",
                                 map="replay_map", pp="pp", ps=ps)))
    inp["cases"] = cases

    # the world runs while JAX compiles its references below
    handle = ranks.start_world(inp, tmp_path_factory.mktemp("sharding"), WORLD)
    try:
        meshes = {"sp": jparallel.make_mesh(WORLD, dp=1), "dp": jparallel.make_mesh(WORLD, dp=4),
                  "2d": jparallel.make_mesh(WORLD, dp=2)}
        jparams = {name: jicp.make_icp_params(_pcm(jconfig, name), dtype=jnp.float64)
                   for name in jstatics}
        jscan, jinit, jfar = (jnp.asarray(scan), jnp.asarray(init), jnp.asarray(far_init))
        jvalid = jnp.ones(len(scan), bool)
        jax_res, port_ref = {}, {}
        for name, mode in REGISTRATIONS:
            g, st, pr = jdev[_map_key(name)], jstatics[name], jparams[name]
            i0 = jfar if "radar" in name else jinit
            if mode == "point":
                def fn(s, v, gg, i, p, st=st):
                    return jparallel.register_sharded(s, v, gg, i, p, st, meshes["sp"], "sp")
            else:
                st_sp = dataclasses.replace(st, slot_shard_axis="sp")
                rep = jax.tree_util.tree_map(lambda _: P(), (g, pr))
                fn = functools.partial(
                    jax.shard_map, mesh=meshes["sp"], in_specs=(P(), P(), rep[0], P(), rep[1]),
                    out_specs=P(), check_vma=False)(
                    lambda s, v, gg, i, p, st_sp=st_sp: jicp.run_register(s, v, gg, i, p, st_sp))
            # jitted: an eager shard_map of the GN loop dispatches op by op
            jax_res[_case_id((name, mode))] = flatten(jax.jit(fn)(jscan, jvalid, g, i0, pr))
            port_ref[_case_id((name, mode))] = ranks.numpy_tree(ticp.run_register(
                inp["scan"], inp["valid"], tmaps[_map_key(name)],
                inp["far_init" if "radar" in name else "init"], inp[f"params {name}"],
                _static(ticp, ttiles, _pcm(tconfig, name), name)))
        jscans, jvalids, jinits = jnp.asarray(np.stack([scan] * 4)), jnp.asarray(valids), \
            jnp.asarray(inits)
        for mode, batch in (("dp", jparallel.register_batch_dp),
                            ("2d", jparallel.register_batch_2d)):
            def fn(s, v, g, i, p, batch=batch, mesh=meshes[mode]):
                return batch(s, v, g, i, p, jstatics["P2P"], mesh)
            jax_res[_case_id(("P2P", mode))] = flatten(jax.jit(fn)(
                jscans, jvalids, jdev["tile1"], jinits, jparams["P2P"]))
            port_ref[_case_id(("P2P", mode))] = ranks.numpy_tree(ticp.run_register_lanes(
                inp["scans"], inp["valids"], tmaps["tile1"], inp["inits"], inp["params P2P"],
                _static(ticp, ttiles, _pcm(tconfig, "P2P"), "P2P")))
        # JAX's unsharded replay of each lane's log (one compile: equal shapes)
        jreplay = {s: jpipe._fused(jstate, lane_batches[s], jpipe.map)[1] for s in per}
        jreplay = {s: {k: np.asarray(v) for k, v in o.items()} for s, o in jreplay.items()}
    except BaseException:
        ranks.stop_world(handle)
        raise
    results = ranks.finish_world(handle)
    return dict(results=results, jax=jax_res, port=port_ref, replay=jreplay, truth=truth)


def _close(got, ref, what, atol=POSE_ATOL):
    np.testing.assert_allclose(got["pose"], np.asarray(ref["pose"]), rtol=0, atol=atol,
                               err_msg=f"{what} pose")
    for k in ("fitness", "overlap"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0, atol=SCALAR_ATOL,
                                   err_msg=f"{what} {k}")
    for k in ("iterations", "success", "dropped"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=f"{what} {k}")


def _out(sharded, case, rank=0):
    return sharded["results"][rank][case]["out"]


@pytest.mark.parametrize("case", REGISTRATIONS, ids=_case_id)
def test_registration_matches_jax(sharded, case):
    """The sharded registration against JAX's sharded ``run_register``."""
    cid = _case_id(case)
    got, ref = _out(sharded, cid), sharded["jax"][cid]
    _close(got, ref, cid)
    assert bool(got["success"])
    if case[0] == "P2P":  # test_sharding.py:76-77
        assert np.linalg.norm(got["pose"][:3, 3] - sharded["truth"][:3, 3]) < 0.1


@pytest.mark.parametrize("case", REGISTRATIONS, ids=_case_id)
def test_registration_matches_the_unsharded_port(sharded, case):
    """The sharded registration against the port's own unsharded one; on
    the hash grid the slot-sharded mode's overlap is 4x (JAX's behaviour,
    ROADMAP Queue 3 "Noted, not faults"), everything else the same."""
    cid = _case_id(case)
    got, ref = dict(_out(sharded, cid)), dict(sharded["port"][cid])
    if case == ("P2P hash", "slot"):
        np.testing.assert_allclose(got["overlap"], WORLD * ref["overlap"], rtol=0,
                                   atol=SCALAR_ATOL)
        np.testing.assert_allclose(sharded["jax"][cid]["overlap"], WORLD * ref["overlap"],
                                   rtol=0, atol=SCALAR_ATOL)
        got["overlap"] = ref["overlap"]
    _close(got, ref, cid)


@pytest.mark.parametrize("mode", BATCHES)
def test_batches_match_jax_and_the_fleet(sharded, mode):
    """``register_batch_dp`` (dp=4) and ``register_batch_2d`` (2 x 2) on 4
    lanes: every rank holds all 4 lanes, each within JAX's bounds of JAX's
    sharded batch and of the port's unsharded ``run_register_lanes``."""
    cid = _case_id(("P2P", mode))
    got = _out(sharded, cid)
    assert got["pose"].shape == (4, 4, 4)
    for ref, what in ((sharded["jax"][cid], "jax"), (sharded["port"][cid], "port")):
        for lane in range(4):
            _close({k: v[lane] for k, v in got.items()},
                   {k: np.asarray(v)[lane] for k, v in ref.items()}, f"{cid} {what} {lane}")


@pytest.mark.parametrize("kind", REPLAYS)
def test_replays_match_jax(sharded, kind):
    """Each replay lane against JAX's unsharded ``replay_fused`` of its log:
    floats within 1e-6, the flags and counts equal; every frame applied."""
    got = _out(sharded, kind)[1]
    lanes = [LANE_SEEDS[0]] if kind == "replay_sp" else list(LANE_SEEDS)
    for lane, seed in enumerate(lanes):
        ref = sharded["replay"][seed]
        assert set(got) == set(ref)
        for k, v in ref.items():
            g = got[k] if kind == "replay_sp" else got[k][lane]
            assert g.shape == v.shape, (kind, k)
            if k in EXACT or v.dtype.kind != "f":
                np.testing.assert_array_equal(g, v, err_msg=f"{kind} lane {lane} {k}")
            else:
                np.testing.assert_allclose(g, v, rtol=0, atol=REPLAY_ATOL,
                                           err_msg=f"{kind} lane {lane} {k}")
        assert float(np.mean(ref["applied"])) >= 0.9


def _same_tree(a, b, what, skip=()):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            if k not in skip:
                _same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{what}[{i}]", skip)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


@pytest.mark.parametrize("case", [_case_id(c) for c in REGISTRATIONS]
                         + [_case_id(("P2P", b)) for b in BATCHES] + list(REPLAYS))
def test_ranks_in_lockstep(sharded, case):
    """Every rank's outputs are rank 0's bit for bit (a point-sharded
    registration's ``dropped`` is the rank's own), and each sharded GN
    iteration all-reduced its sums once: a rank's count of all-reduces is
    the iterations of the registrations it ran (in 2D its dp block's lanes;
    none in dp), and a point-sharded registration's valid count once."""
    res = sharded["results"]
    skip = ("dropped",) if case.endswith("-point") or case.endswith("-2d") else ()
    for r in range(1, WORLD):
        _same_tree(res[r][case]["out"], res[0][case]["out"], f"{case} rank {r}", skip)
    out = res[0][case]["out"]
    its = out[1]["iterations"] if case in REPLAYS else out["iterations"]
    for r in range(WORLD):
        coll = res[r][case]["collectives"]
        if case.endswith("dp"):  # the fleet: no collective until the gather
            mine = 0
        elif case.endswith("2d"):  # rank r's dp block: lanes 2 (r // 2), + 1
            mine = int(np.sum(its[2 * (r // 2):2 * (r // 2) + 2]))
        else:
            mine = int(np.sum(its))
        assert coll["gn_sums"] == mine, (case, r, coll)
        assert coll["valid_count"] == (case.endswith("-point") or case == "P2P-2d"), (case, coll)


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_refusals(sharded, refusal):
    """What JAX refuses, the port refuses, naming it: an axis with no active
    mesh, a slot axis that does not split ``max_slots`` into multiples of
    8, a mesh of another size than the world."""
    kind, _, start = REFUSALS[refusal]
    err = sharded["results"][0][refusal]["error"]
    assert err[0] == ("NameError" if kind == "unbound" else "ValueError")
    assert err[1].startswith(start), err


def test_exports_jax_names():
    import elimaloc_tpu.parallel as jparallel

    names = {n for n in dir(jparallel) if not n.startswith("_") and n != "sharding"}
    assert names == set(tparallel.__all__)
    assert all(callable(getattr(tparallel, n)) for n in tparallel.__all__)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_two_ranks_on_one_card(tmp_path):
    """A 2-rank gloo world on cuda:0 (float32): P2P point- and slot-sharded
    and GICP on the hash grid point-sharded; the ranks bit for bit each
    other, per iteration one search kernel (A or Q) and one M, no loop
    kernel, and each within 1e-4 m of the unsharded loop kernel."""
    near, scan, init, _ = scene()
    built = tbuilder.build_voxel_map(near, 1.0, 20, use_native=False, compute_point_cov=True)
    f32 = torch.float32
    inp = {"scan": torch.as_tensor(scan, dtype=f32), "valid": torch.ones(len(scan),
                                                                          dtype=torch.bool),
           "init": torch.as_tensor(init, dtype=f32),
           "tile1": ttiles.build_tile_map(built, tile_voxels=4).to_device("cpu", f32),
           "hash": tgrid.to_device(built, "cpu", f32)}
    cases, refs = [], {}
    for name, mode in (("P2P", "point"), ("P2P", "slot"), ("GICP hash", "point")):
        cfg = _pcm(tconfig, name)
        inp[f"params {name}"] = ticp.make_icp_params(cfg, dtype=f32)
        static = _static(ticp, ttiles, cfg, name)
        cases.append((_case_id((name, mode)), dict(
            kind=mode, scan="scan", valid="valid", map=_map_key(name), init="init",
            params=f"params {name}", static=static)))
        cuda = {k: ranks.to_device(inp[k], "cuda") for k in ("scan", "valid", "init",
                                                             _map_key(name), f"params {name}")}
        refs[_case_id((name, mode))] = ranks.numpy_tree(ticp.run_register(
            cuda["scan"], cuda["valid"], cuda[_map_key(name)], cuda["init"],
            cuda[f"params {name}"], static))
    inp["cases"] = cases
    res = ranks.run_world(inp, tmp_path, 2, device="cuda")
    for cid, _ in cases:
        _same_tree(res[1][cid]["out"], res[0][cid]["out"], cid,
                   ("dropped",) if cid.endswith("point") else ())
        out, launches = res[0][cid]["out"], res[0][cid]["launches"]
        search = "hash_correspond" if "hash" in cid else "p2p_correspond"
        its = int(out["iterations"])
        assert launches.get(search) == its and launches.get("gn_step") == its, launches
        assert not any(k.endswith("_register") for k in launches), launches
        assert res[0][cid]["collectives"]["gn_sums"] == its
        np.testing.assert_allclose(out["pose"], refs[cid]["pose"], rtol=0, atol=1e-4)
        assert its == int(refs[cid]["iterations"])
