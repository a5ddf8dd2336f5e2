"""Port parity: the hash grid (elimaloc_tpu_torch.map.grid) against
elimaloc_tpu.map.grid, on the same NumPy maps and queries.

* ``convert.map_grid`` of a flattened JAX grid equals the port's own
  ``to_device`` of the same BuiltMap, field for field (the uint32
  fingerprints as their int32 bits).
* ``lookup``: rows exactly equal on hits, misses, negative coordinates and
  long probe chains (a table at load factor 0.9).
* The four queries: rows, slots and valid flags exactly equal, the floats
  to 1e-12 (float64) and 1e-6 (float32, the same float32 arithmetic in
  another order: the JAX transform and sums are XLA's), with an exact tie
  (a query equidistant from two map points: the first in (offset, slot)
  order wins), the +inf padding of every partly filled voxel and queries
  outside ``max_dist``.
* ``find_ground_height``: found exactly equal, z to 1e-12 / 1e-6, with
  the cases of fewer than 5 and at most 3 points in range.
* The port's tile queries against its hash queries (the counterpart of
  tests/test_tiles.py::test_matches_hash_grid): valid flags equal, the
  nearest distances to 1e-5 m (the tile engine may break ties otherwise).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import grid as jgrid
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from torch_parity import flatten, one_torch_thread  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12),
          "f32": (jnp.float32, torch.float32, 1e-6)}
#: a tie: the query (1.0, 0.5, 40.5) lies 0.75 m from both (0.25, 0.5, 40.5)
#: (voxel offset (-1, 0, 0)) and (1.75, 0.5, 40.5) (offset (0, 0, 0)); the
#: VGICP tie the same with single-point voxels (their means)
TIE_POINTS = np.array([[0.25, 0.5, 40.5], [1.75, 0.5, 40.5]])
TIE_QUERY = np.array([[1.0, 0.5, 40.5]])
#: isolated clusters for the ground probe: 4 points (found, fewer than 5:
#: z = +inf) and 3 points (not found), 200 m from the rest of the map
CLUSTER4 = np.array([[200.0, 0.0, 1.0], [200.5, 0.0, 1.5], [200.0, 0.5, 2.0],
                     [200.5, 0.5, 0.5]])
CLUSTER3 = np.array([[0.0, 200.0, 1.0], [0.5, 200.0, 1.5], [0.0, 200.5, 2.0]])


def _world(seed=33, n=4000, extent=15.0):
    rng = np.random.default_rng(seed)
    return np.r_[rng.uniform(-extent, extent, size=(n, 3)), TIE_POINTS, CLUSTER4, CLUSTER3]


def _built(pts, **kw):
    kw = dict(compute_voxel_cov=True, compute_point_cov=True, gicp_cov_search_dist=0.5,
              use_native=False, **kw)
    jb = jbuilder.build_voxel_map(pts, 1.0, 10, **kw)
    return jb, tbuilder.BuiltMap(**{f.name: getattr(jb, f.name)
                                    for f in dataclasses.fields(jb)})


@pytest.fixture(scope="module")
def maps():
    return _built(_world())


def _queries(n=512, extent=16.0, seed=5):
    rng = np.random.default_rng(seed)
    return np.r_[rng.uniform(-extent, extent, size=(n, 3)), TIE_QUERY]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_convert_map_grid_equals_to_device(maps, dt):
    jdt, tdt, _ = DTYPES[dt]
    jb, tb = maps
    got = flatten(convert.map_grid(flatten(jgrid.to_device(jb, dtype=jdt)), dtype=tdt))
    ref = flatten(tgrid.to_device(tb, "cpu", tdt))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    assert ref["table_fp"].dtype == np.int32
    np.testing.assert_array_equal(ref["table_fp"][:jb.table_size].view(np.uint32), jb.table_fp)


@pytest.mark.parametrize("load", [0.25, 0.9], ids=["default", "long_chains"])
def test_lookup_matches_jax(load):
    jb, tb = _built(_world(seed=7), table_load_factor=load)
    if load == 0.9:
        assert jb.max_probe >= 4
    rng = np.random.default_rng(8)
    coords = np.r_[jb.vox_coords, rng.integers(-40, 40, (3000, 3)),
                   -jb.vox_coords[:200] - 1].astype(np.int32)
    want = np.asarray(jgrid.lookup(jgrid.to_device(jb), jnp.asarray(coords)))
    got = tgrid.lookup(tgrid.to_device(tb, "cpu"), torch.as_tensor(coords)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    n = len(jb.vox_coords)
    np.testing.assert_array_equal(got[:n], np.arange(n))        # every hit
    assert (got[n:] == n).any() and (got[n:] < n).any()         # misses and hits


QUERIES = {
    "point": (jgrid.query_nearest_point, tgrid.query_nearest_point),
    "point_cov": (jgrid.query_nearest_point_cov, tgrid.query_nearest_point_cov),
    "voxel_cov": (jgrid.query_nearest_voxel_cov, tgrid.query_nearest_voxel_cov),
    "all_voxel_cov": (jgrid.query_all_voxel_cov, tgrid.query_all_voxel_cov),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_queries_match_jax(maps, query, dt):
    jdt, tdt, atol = DTYPES[dt]
    jb, tb = maps
    jfn, tfn = QUERIES[query]
    q = _queries()
    md = 0.8
    want = jfn(jgrid.to_device(jb, dtype=jdt), jnp.asarray(q, jdt), jnp.asarray(md, jdt))
    got = tfn(tgrid.to_device(tb, "cpu", tdt), torch.as_tensor(q, dtype=tdt),
              torch.tensor(md, dtype=tdt))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=str(i))
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=str(i))
    npdt = got[0].numpy().dtype
    valid = got[1 if query == "point" else -1].numpy()
    assert 0 < valid.sum() < valid.size           # the max_dist gate bites
    if query in ("point", "point_cov"):
        # the tie: the first of (offset, slot) order, the -x neighbour
        np.testing.assert_array_equal(got[0].numpy()[-1], TIE_POINTS[0].astype(npdt))
    if query == "point":
        # the winner's row and slot address it
        rows, slots = got[2].numpy(), got[3].numpy()
        pts = tgrid.to_device(tb, "cpu", tdt).points.numpy()
        np.testing.assert_array_equal(pts[rows, slots][valid], got[0].numpy()[valid])
    if query == "voxel_cov":
        np.testing.assert_array_equal(got[1].numpy()[-1], TIE_POINTS[0].astype(npdt))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_find_ground_height_matches_jax(maps, dt):
    jdt, tdt, atol = DTYPES[dt]
    jb, tb = maps
    jg, tg = jgrid.to_device(jb, dtype=jdt), tgrid.to_device(tb, "cpu", tdt)
    cases = {(0.0, 0.0): (True, True), (7.5, -3.25): (True, True),
             (200.2, 0.2): (True, False), (0.2, 200.2): (False, False),
             (500.0, 500.0): (False, False)}
    for xy, (found, finite) in cases.items():
        jf, jz = jgrid.find_ground_height(jg, jnp.asarray(xy, jdt))
        tf, tz = tgrid.find_ground_height(tg, xy)
        assert bool(tf) == bool(jf) == found, xy
        assert bool(np.isfinite(float(tz))) == finite, xy
        np.testing.assert_allclose(float(tz), float(jz), rtol=0, atol=atol, err_msg=str(xy))


TILE_QUERIES = ("point", "voxel_cov", "all_voxel_cov")


@pytest.mark.parametrize("qb", [32, 8])
@pytest.mark.parametrize("query", TILE_QUERIES)
def test_tile_queries_match_hash_queries(maps, query, qb):
    """The port's tile engine (slot assignment + slot search, scattered back
    to query order) against its hash grid: valid flags equal; the nearest
    distance (P2P) within 1e-5 m, the voxel means and covariances (VGICP,
    AVGICP) within 1e-5."""
    _, tb = maps
    q = torch.as_tensor(_queries(), dtype=torch.float32)
    n = q.shape[0]
    md = torch.tensor(5.0)
    tmap = ttiles.build_tile_map(tb, tile_voxels=4).to_device("cpu")
    grid = tgrid.to_device(tb, "cpu")
    budget = ttiles.TileQueryBudget(qb=qb, max_slots=1024)
    asg = ttiles.assign_slots(tmap, q, torch.ones(n, dtype=torch.bool), budget)
    assert int(asg.dropped) == 0
    at = asg.qidx[asg.qmask].long()

    def back(x):
        out = torch.zeros((n,) + tuple(x.shape[2:]), dtype=x.dtype)
        out[at] = x[asg.qmask]
        return out

    args = (tmap, asg.slot_tile, asg.qbuf, asg.qvox, asg.qmask, md, budget)
    if query == "point":
        tgt_t, ok_t = (back(x) for x in ttiles.nearest_point_slots(*args))
        tgt_h, ok_h, _, _ = tgrid.query_nearest_point(grid, q, md)
        assert torch.equal(ok_t, ok_h)
        d_t = torch.linalg.norm(tgt_t - q, dim=1)[ok_t]
        d_h = torch.linalg.norm(tgt_h - q, dim=1)[ok_h]
        torch.testing.assert_close(d_t, d_h, rtol=0, atol=1e-5)
        return
    if query == "voxel_cov":
        cov_t, mean_t, ok_t = (back(x) for x in ttiles.nearest_voxel_cov_slots(*args))
        cov_h, mean_h, ok_h = tgrid.query_nearest_voxel_cov(grid, q, md)
    else:
        cov_t, mean_t, ok_t = (back(x) for x in ttiles.all_voxel_cov_slots(*args))
        cov_h, mean_h, ok_h = tgrid.query_all_voxel_cov(grid, q, md)
    assert torch.equal(ok_t, ok_h)
    torch.testing.assert_close(mean_t[ok_t], mean_h[ok_h], rtol=0, atol=1e-5)
    torch.testing.assert_close(cov_t[ok_t], cov_h[ok_h], rtol=0, atol=1e-5)
