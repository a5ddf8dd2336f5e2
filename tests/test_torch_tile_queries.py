"""Port parity of the tile map's one-shot queries: ``query_nearest_point``
(with and without ``with_point_cov``), ``query_nearest_voxel_cov`` and
``query_all_voxel_cov`` of elimaloc_tpu_torch.map.tiles, with
``scatter_back`` and ``TileQueryBudget.for_queries``.

On the CPU (the plain assignment, search and scatter) against the JAX
package's functions on tests/test_tiles.py's inputs (4,000 map points over
+-15 m, 512 queries over +-16 m, some off the map; qb 32 and qb 8 with
1,024 slots, and the overflow budget qb 8 with 8 slots; every query valid,
or every other one) in float32 and float64: every output exactly equal
(exact diff^2 sums and first-index ties on both sides, selection and the
scatter are copies). A window (a fresh crop, and one ``shift_window`` step)
queried in its local coordinates: equal to JAX's windowed query bit for
bit, and its targets and means with the origin added back within 1e-5 m of
the port's full-map query, ``ok`` equal.

On the card (``cuda`` marker; skipped without one): every query's card
route (kernel B, then kernel A, A and E, F or G with their matches, then
the scatter) torch.equal to its plain version on the same CUDA tensors,
with the launch counts named in the test, no host sync inside a call
(``set_sync_debug_mode("error")``), kernel A's ``ok`` equal to kernel E's,
and a float64 CUDA call raising. JAX is imported inside the JAX cases
only, so the card cases run on a host without it:
``python -m pytest --noconftest -m cuda tests/test_torch_tile_queries.py``.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import kernels
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import tiles as ttiles
from torch_parity import one_torch_thread  # noqa: F401

DTYPES = {"f32": torch.float32, "f64": torch.float64}
#: (qb, max_slots): tests/test_tiles.py's two budgets and its overflow budget
BUDGETS = {"qb32": (32, 1024), "qb8": (8, 1024), "overflow": (8, 8)}
#: each query form: (function name, keyword arguments)
QUERIES = {"P2P": ("query_nearest_point", {}),
           "GICP": ("query_nearest_point", {"with_point_cov": True}),
           "VGICP": ("query_nearest_voxel_cov", {}),
           "AVGICP": ("query_all_voxel_cov", {})}
MAX_DIST = 5.0


def _valid_of(result):
    """The ``valid`` output of a query's result (second for the point
    query, last for the voxel ones)."""
    return result[-1] if len(result) == 3 else result[1]


def _queries(n=512, extent=16.0, seed=34):
    return np.random.default_rng(seed).uniform(-extent, extent, size=(n, 3))


def _jax():
    """The JAX package's modules (imported here, not at the top: the card
    cases run where there is no JAX)."""
    jnp = importlib.import_module("jax.numpy")
    jbuilder = importlib.import_module("elimaloc_tpu.map.builder")
    jtiles = importlib.import_module("elimaloc_tpu.map.tiles")
    return jnp, jbuilder, jtiles


@pytest.fixture(scope="module")
def scene():
    """tests/test_tiles.py's map (4,000 points over +-15 m, 1 m voxels, 10 a
    voxel) with both covariances, packed by both packages, on the device
    in each dtype; the JAX maps too."""
    jnp, jbuilder, jtiles = _jax()
    pts = np.random.default_rng(33).uniform(-15.0, 15.0, size=(4000, 3))
    built = jbuilder.build_voxel_map(pts, 1.0, 10, use_native=False, compute_point_cov=True,
                                     gicp_cov_search_dist=0.5, compute_voxel_cov=True)
    jh, th = jtiles.build_tile_map(built, tile_voxels=4), ttiles.build_tile_map(
        built, tile_voxels=4)
    return {k: (jh.to_device(dtype=jnp.float32 if k == "f32" else jnp.float64),
                th.to_device("cpu", tdt)) for k, tdt in DTYPES.items()}


@functools.cache
def _jitted(name, with_point_cov):
    """JAX's query ``name``, jitted once for the file (the budget and
    ``max_dist`` static): its slot search is XLA-compiled eagerly too, the
    rest is integer keys, copies and selects."""
    jax = importlib.import_module("jax")
    fn = getattr(_jax()[2], name)
    if with_point_cov:
        fn = functools.partial(fn, with_point_cov=True)
    return jax.jit(fn, static_argnums=(3, 4))


def _run_both(jtiles, jnp, jmap, tmap, name, kw, q, valid, budget, dt_name):
    jdt = jnp.float32 if dt_name == "f32" else jnp.float64
    tdt = DTYPES[dt_name]
    qb, slots = budget
    ref = _jitted(name, bool(kw))(jmap, jnp.asarray(q, jdt), jnp.asarray(valid), MAX_DIST,
                                  jtiles.TileQueryBudget(qb=qb, max_slots=slots))
    got = getattr(ttiles, name)(tmap, torch.as_tensor(q, dtype=tdt), torch.as_tensor(valid),
                                MAX_DIST, ttiles.TileQueryBudget(qb=qb, max_slots=slots), **kw)
    return got, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("valid_name", ["all", "alternate"])
@pytest.mark.parametrize("budget_name", sorted(BUDGETS))
@pytest.mark.parametrize("method", sorted(QUERIES))
def test_query_matches_jax(scene, method, budget_name, valid_name, dt_name):
    """Every output of the port's query (the plain route, no launch) equal
    to JAX's; dropped queries (the overflow budget) come back not valid with
    the query as their target or mean, as in JAX."""
    jnp, _, jtiles = _jax()
    jmap, tmap = scene[dt_name]
    name, kw = QUERIES[method]
    q = _queries()
    valid = np.ones(len(q), bool) if valid_name == "all" else np.arange(len(q)) % 2 == 0
    kernels.reset_launches()
    got, ref = _run_both(jtiles, jnp, jmap, tmap, name, kw, q, valid,
                         BUDGETS[budget_name], dt_name)
    assert not any(kernels.launches.values())
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (method, i)
        np.testing.assert_array_equal(g.numpy(), r, err_msg=f"{method} output {i}")
    ok = _valid_of(got).numpy()
    ok_any = ok if ok.ndim == 1 else ok.any(axis=1)
    assert not ok_any[~valid].any()
    if budget_name == "overflow":
        full = getattr(ttiles, name)(tmap, torch.as_tensor(q, dtype=DTYPES[dt_name]),
                                     torch.as_tensor(valid), MAX_DIST,
                                     ttiles.TileQueryBudget(qb=8, max_slots=1024), **kw)
        assert 0 < ok.sum() < _valid_of(full).numpy().sum()  # some were dropped
    else:
        assert ok.sum() > (150 if valid_name == "all" else 75)
    # a target or mean that is not valid is the query itself
    qt = torch.as_tensor(q, dtype=DTYPES[dt_name])
    means = got[0] if method == "P2P" else got[3] if method == "GICP" else got[1]
    miss = ~_valid_of(got)
    q_at = qt[:, None, :].expand_as(means) if method == "AVGICP" else qt
    assert torch.equal(means[miss], q_at[miss])


@pytest.fixture(scope="module")
def window_scene():
    """A flat 80 m map (15,000 points, both covariances; as
    tests/test_torch_window.py's) packed by both packages, and in each
    dtype: the full map and two windows of 11 x 11 tiles in local
    coordinates, a fresh crop at (10, -5) and a crop at (6, -9) shifted one
    tile in x and y onto the same tiles (``shift_window``), for each
    package."""
    jnp, jbuilder, jtiles = _jax()
    pts = np.random.default_rng(41).uniform(-40, 40, (15_000, 3)) * np.array([1, 1, 0.08])
    built = jbuilder.build_voxel_map(pts, 1.0, 20, use_native=False, compute_voxel_cov=True,
                                     compute_point_cov=True)
    jh, th = jtiles.build_tile_map(built, tile_voxels=4), ttiles.build_tile_map(
        built, tile_voxels=4)
    center, dims = np.array([10.0, -5.0]), (11, 11)
    out = {}
    for dt_name, tdt in DTYPES.items():
        jdt = jnp.float32 if dt_name == "f32" else jnp.float64
        off = np.dtype(jdt)
        wins = {"fresh": (jh.crop_window(center, 5, dims=dims, offset_dtype=off)
                          .to_device(dtype=jdt),
                          th.crop_window(center, 5, dims=dims, offset_dtype=off)
                          .to_device("cpu", tdt))}
        start = center - 4.0
        old = jh.window_anchor(start, dims)
        new = jh.window_anchor(center, dims)
        assert (new[0] - old[0], new[1] - old[1]) == (1, 1)
        dst, payload = jh.crop_entering_rows(old, new, dims, old, sum(dims), offset_dtype=off)
        jwin = jtiles.shift_window(jh.crop_window(start, 5, dims=dims, offset_dtype=off)
                                   .to_device(dtype=jdt), 1, 1, dst, payload)
        twin = ttiles.shift_window(
            th.crop_window(start, 5, dims=dims, offset_dtype=off).to_device("cpu", tdt), 1, 1,
            torch.as_tensor(dst),
            {f: None if v is None else torch.as_tensor(
                v, dtype=tdt if v.dtype.kind == "f" else None) for f, v in payload.items()})
        assert twin.tile_anchor == (1, 1)
        wins["shifted"] = (jwin, twin)
        out[dt_name] = (th.to_device("cpu", tdt), wins)
    return center, out


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("window", ["fresh", "shifted"])
@pytest.mark.parametrize("method", sorted(QUERIES))
def test_windowed_query_matches_jax_and_the_full_map(window_scene, method, window, dt_name):
    """A window's query in its local coordinates: bit for bit JAX's; with
    the window origin added back its targets and means within 1e-5 m of the
    full map's query at the same world points, ``ok`` equal, the
    covariances equal."""
    jnp, _, jtiles = _jax()
    center, maps = window_scene
    full, wins = maps[dt_name]
    jwin, twin = wins[window]
    name, kw = QUERIES[method]
    rng = np.random.default_rng(35)
    q = np.c_[center + rng.uniform(-8.0, 8.0, (256, 2)), rng.uniform(-1.0, 1.0, 256)]
    valid = np.ones(len(q), bool)
    valid[::9] = False
    origin = twin.origin.numpy().astype(np.float64)
    q_loc = q.copy()
    q_loc[:, :2] -= origin
    budget = (32, 128)
    got, ref = _run_both(jtiles, jnp, jwin, twin, name, kw, q_loc, valid, budget, dt_name)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=f"{method} {window} output {i}")
    tdt = DTYPES[dt_name]
    want = getattr(ttiles, name)(full, torch.as_tensor(q, dtype=tdt), torch.as_tensor(valid),
                                 MAX_DIST, ttiles.TileQueryBudget(qb=32, max_slots=128), **kw)
    ok = _valid_of(got)
    assert torch.equal(ok, _valid_of(want))
    assert int(ok.sum()) > 150
    # the world-coordinate outputs: P2P (target), GICP (target, mean),
    # VGICP and AVGICP (mean); the covariances are copies
    world = {"P2P": (0,), "GICP": (0, 3), "VGICP": (1,), "AVGICP": (1,)}[method]
    for i in world:
        w = got[i].numpy().astype(np.float64)
        w[..., :2] += origin
        np.testing.assert_allclose(w, want[i].numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"{method} {window} output {i}")
    for i in {"GICP": (2,), "VGICP": (0,), "AVGICP": (0,)}.get(method, ()):
        assert torch.equal(got[i], want[i]), (method, window, i)


def test_scatter_back_keeps_defaults_where_no_slot_holds_a_query():
    """Slot entries go to their query's row; a query no slot holds (never
    assigned, or dropped) keeps the default, scalar or broadcast row; the
    unused entries (qidx = n) land nowhere."""
    n = 5
    qidx = torch.tensor([[3, 0, 5], [5, 1, 5]], dtype=torch.int32)
    vals = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10.0
    rows = torch.arange(18, dtype=torch.float32).reshape(2, 3, 3)
    ok = torch.tensor([[True, False, True], [True, True, True]])
    out_v, out_r, out_ok = ttiles.scatter_back(
        n, qidx, (-1.0, vals), (torch.tensor([7.0, 8.0, 9.0]), rows), (False, ok))
    assert torch.equal(out_v, torch.tensor([11.0, 14.0, -1.0, 10.0, -1.0], dtype=torch.float64))
    want = torch.tensor([[7.0, 8.0, 9.0]]).repeat(n, 1)
    want[3], want[0], want[1] = rows[0, 0], rows[0, 1], rows[1, 1]
    assert torch.equal(out_r, want)
    assert torch.equal(out_ok, torch.tensor([False, True, False, True, False]))
    assert out_v.shape == (n,) and out_r.shape == (n, 3) and out_r.is_contiguous()


def test_for_queries_is_the_budget_itself():
    budget = ttiles.TileQueryBudget(qb=8, max_slots=64, chunk=4)
    assert budget.for_queries(1) is budget and budget.for_queries(10**6) is budget


def _small_map(device, dtype, point_cov=True):
    """A 2,000-point map over +-12 m with both covariances (or without the
    per-point ones), built by the port alone."""
    pts = np.random.default_rng(36).uniform(-12.0, 12.0, size=(2000, 3))
    built = tbuilder.build_voxel_map(pts, 1.0, 10, use_native=False,
                                     compute_point_cov=point_cov, gicp_cov_search_dist=0.5,
                                     compute_voxel_cov=True)
    return ttiles.build_tile_map(built, tile_voxels=4).to_device(device, dtype)


def test_max_dist_as_a_tensor_and_chunk_change_nothing():
    """``max_dist`` as a 0-dim tensor gives what the Python float gives,
    and the plain search's ``chunk`` changes no output."""
    tmap = _small_map("cpu", torch.float32)
    q = torch.as_tensor(_queries(300, 13.0), dtype=torch.float32)
    valid = torch.ones(300, dtype=torch.bool)
    budget = ttiles.TileQueryBudget(qb=16, max_slots=256)
    for name, kw in QUERIES.values():
        fn = getattr(ttiles, name)
        base = fn(tmap, q, valid, 1.5, budget, **kw)
        assert 0 < int(_valid_of(base).sum()) < _valid_of(base).numel()
        for other in (fn(tmap, q, valid, torch.tensor(1.5, dtype=torch.float64), budget, **kw),
                      fn(tmap, q, valid, 1.5, budget, chunk=3, **kw)):
            for a, b in zip(base, other):
                assert torch.equal(a, b), name


def test_a_map_without_the_covariances_raises():
    """GICP's form on a map without per-point covariances, and the voxel
    queries on one without voxel covariances, raise ValueError (as kernels
    E, F and G do), before any search."""
    q = torch.zeros((4, 3))
    valid = torch.ones(4, dtype=torch.bool)
    budget = ttiles.TileQueryBudget(qb=8, max_slots=16)
    bare = _small_map("cpu", torch.float32, point_cov=False)
    with pytest.raises(ValueError, match="halo_point_cov"):
        ttiles.query_nearest_point(bare, q, valid, 1.0, budget, with_point_cov=True)
    assert _valid_of(ttiles.query_nearest_point(bare, q, valid, 1.0, budget)).shape == (4,)
    no_vox = dataclasses.replace(bare, halo_vox_cov=None)
    for name in ("query_nearest_voxel_cov", "query_all_voxel_cov"):
        with pytest.raises(ValueError, match="halo_vox_cov"):
            getattr(ttiles, name)(no_vox, q, valid, 1.0, budget)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


#: each query form's launches on the card: kernel B once, then its search
LAUNCHES = {"P2P": {"assign_slots": 1, "p2p_correspond": 1},
            "GICP": {"assign_slots": 1, "p2p_correspond": 1, "gicp_correspond": 1},
            "VGICP": {"assign_slots": 1, "vgicp_correspond": 1},
            "AVGICP": {"assign_slots": 1, "avgicp_correspond": 1}}


def _card_window(device):
    """A window of the small map shifted one tile by kernel N."""
    pts = np.random.default_rng(36).uniform(-12.0, 12.0, size=(2000, 3))
    built = tbuilder.build_voxel_map(pts, 1.0, 10, use_native=False, compute_point_cov=True,
                                     gicp_cov_search_dist=0.5, compute_voxel_cov=True)
    th = ttiles.build_tile_map(built, tile_voxels=4)
    dims = (4, 4)
    old = th.window_anchor(np.array([-2.0, -2.0]), dims)
    new = (old[0] + 1, old[1] + 1)
    dst, payload = th.crop_entering_rows(old, new, dims, old, sum(dims))
    win = th.crop_window(np.array([-2.0, -2.0]), 2, dims=dims).to_device(device, torch.float32)
    return ttiles.shift_window(
        win, 1, 1, torch.as_tensor(dst, device=device),
        {f: None if v is None else torch.as_tensor(v, device=device) for f, v in payload.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["qb8", "qb32", "overflow", "window"])
def test_card_routes_match_plain_on_card(cuda, case):
    """Each query on CUDA tensors: B once and its search kernel(s) once,
    every loop kernel never, no host sync inside the call, every output
    torch.equal to its plain version on the same tensors; kernel A's ok
    equal to kernel E's on the same assignment."""
    if case == "window":
        tmap, (qb, slots) = _card_window(cuda), (16, 64)
    else:
        tmap, (qb, slots) = _small_map(cuda, torch.float32), BUDGETS[case]
    budget = ttiles.TileQueryBudget(qb=qb, max_slots=slots)
    q = torch.as_tensor(_queries(700, 13.0), dtype=torch.float32, device=cuda)
    if case == "window":
        q[:, :2] = q[:, :2] * 0.3 + 4.0  # the window's local coordinates
    valid = torch.arange(700, device=cuda) % 5 != 0
    md = torch.tensor(1.5, device=cuda)
    for method, (name, kw) in QUERIES.items():
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = getattr(ttiles, name)(tmap, q, valid, md, budget, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == LAUNCHES[method], method
        want = getattr(ttiles, f"{name}_plain")(tmap, q, valid, md, budget, **kw)
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and torch.equal(a, b), (case, method, i)
        n_ok = int(_valid_of(got).sum())
        assert 0 < n_ok < _valid_of(got).numel(), (case, method)
    asg = ttiles.assign_slots(tmap, q, valid, budget)
    geo = tmap.search_geometry
    args = (asg.slot_tile, asg.qbuf, asg.qmask, torch.eye(4, device=cuda), md)
    a_ok = kernels.p2p_correspond(tmap.halo_points, *args, **geo, with_matches=True)[2]
    e_ok = kernels.gicp_correspond(tmap.halo_points, tmap.halo_point_cov,
                                   tmap.halo_point_cov_mean, *args, **geo,
                                   with_matches=True)[3]
    assert torch.equal(a_ok, e_ok)
    if case == "overflow":
        assert int(asg.dropped) > 0


@pytest.mark.cuda
def test_card_route_refuses_float64_and_a_bare_map(cuda):
    """A float64 CUDA call raises TypeError with no launch (no cast, no
    fallback); a map without the method's covariances raises ValueError
    before any launch."""
    budget = ttiles.TileQueryBudget(qb=8, max_slots=256)
    q = torch.as_tensor(_queries(100, 13.0), device=cuda)
    valid = torch.ones(100, dtype=torch.bool, device=cuda)
    t64 = _small_map(cuda, torch.float64)
    for name, kw in QUERIES.values():
        kernels.reset_launches()
        with pytest.raises(TypeError):
            getattr(ttiles, name)(t64, q, valid, 1.0, budget, **kw)
        assert not any(kernels.launches.values()), name
    bare = _small_map(cuda, torch.float32, point_cov=False)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="halo_point_cov"):
        ttiles.query_nearest_point(bare, q.float(), valid, 1.0, budget, with_point_cov=True)
    assert not any(kernels.launches.values())
