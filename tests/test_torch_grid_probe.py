"""The hash grid's one-shot queries and ground probe as kernels Y and Z
compute them (csrc/grid_query.cu, csrc/ground_probe.cu), held on the CPU to
the port's plain versions and to elimaloc_tpu.map.grid.

* Z's premise: on every grid the port's tests build (the port's builder and
  the JAX package's, through ``to_device`` and ``convert.map_grid``, with
  M = 10, 30 and 60, a table at load factor 0.9), every slot at or past a
  voxel's count has a non-finite x and the sentinel's count is 0. Z reads
  only the slots below each count and keeps the ``isfinite(x)`` test, so
  this is all its exactness needs.
* Z's count walk (here in NumPy: only the slots below each count, the k
  lowest kept z by value, their sum in ascending order over k): found
  exactly equal to ``find_ground_height_plain`` and to JAX's
  ``find_ground_height``, z within 1e-12 (float64) / one float32 ulp
  (their means sum in another order); at the centre, off the centre, off
  the map, with fewer than 5 and at most 3 points in range, k = 1, k = 8.
* Y's selection rule (here in NumPy over the [N, 27, M] candidate plane:
  the slots below each count; a NaN or +inf distance is no candidate; the
  lexicographic minimum of (d2, offset, slot); with none, offset 0's row
  and slot 0): rows, slots, targets and valid flags equal to
  ``query_nearest_point_plain``'s bit for bit, and (d2, offset) over the
  occupied voxels' means equal to ``query_nearest_voxel_cov_plain``'s, on
  the tie grid of tests/test_torch_hash.py, its long probe chains and an
  M = 60 grid, in float32, with queries whose neighbourhood is empty.
* The grid's functions on CPU tensors run their plain versions: no kernel
  library, no launch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import grid as jgrid
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.kernels import build
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from torch_parity import flatten, one_torch_thread  # noqa: F401

#: tests/test_torch_hash.py's tie and its isolated clusters: 4 points (found,
#: fewer than 5: z = +inf) and 3 points (not found)
TIE_POINTS = np.array([[0.25, 0.5, 40.5], [1.75, 0.5, 40.5]])
TIE_QUERY = np.array([[1.0, 0.5, 40.5]])
CLUSTER4 = np.array([[200.0, 0.0, 1.0], [200.5, 0.0, 1.5], [200.0, 0.5, 2.0],
                     [200.5, 0.5, 0.5]])
CLUSTER3 = np.array([[0.0, 200.0, 1.0], [0.5, 200.0, 1.5], [0.0, 200.5, 2.0]])
#: a query 300 m from every map point: no neighbour voxel is occupied
EMPTY_QUERY = np.array([[500.0, 500.0, 0.0]])
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


def _world(seed=33, n=4000, extent=15.0):
    rng = np.random.default_rng(seed)
    return np.r_[rng.uniform(-extent, extent, size=(n, 3)), TIE_POINTS, CLUSTER4, CLUSTER3]


def _dense(m=60):
    """~90 points a voxel in a 6 m cube: full voxels of M = 60."""
    return np.random.default_rng(61).uniform(-3.0, 3.0, size=(20_000, 3)), m


def _jax_built(pts, m, **kw):
    jb = jbuilder.build_voxel_map(pts, 1.0, m, compute_voxel_cov=True, use_native=False,
                                  **kw)
    return jb, tbuilder.BuiltMap(**{f.name: getattr(jb, f.name)
                                    for f in dataclasses.fields(jb)})


def _port_built(pts, m, **kw):
    return tbuilder.build_voxel_map(pts, 1.0, m, compute_voxel_cov=True, **kw)


#: the grids, each (JAX BuiltMap or None, port BuiltMap), built once
_GRIDS = {}
GRID_MAKERS = {
    "tie": lambda: _jax_built(_world(), 10, compute_point_cov=True, gicp_cov_search_dist=0.5),
    "long_chains": lambda: _jax_built(_world(seed=7), 10, table_load_factor=0.9),
    "m60": lambda: _jax_built(*_dense()),
    "port_m30": lambda: (None, _port_built(_world(seed=9, n=6000), 30, use_native=False,
                                           compute_point_cov=True, gicp_cov_search_dist=0.5)),
    "port_m60": lambda: (None, _port_built(*_dense(), use_native=False)),
    "port_native": lambda: (None, _port_built(_world(seed=11), 10)),
}


def _grid(name):
    if name not in _GRIDS:
        _GRIDS[name] = GRID_MAKERS[name]()
    return _GRIDS[name]


def _padding_ok(points, counts):
    m = points.shape[1]
    past = np.arange(m)[None, :] >= counts[:, None]
    return bool((~np.isfinite(points[..., 0][past])).all()) and int(counts[-1]) == 0


@pytest.mark.parametrize("name", sorted(GRID_MAKERS))
def test_slots_past_each_count_are_not_finite(name):
    """Z's premise, on the port's MapGrid and (for the JAX package's builds)
    on the same grid through ``convert.map_grid``, in both dtypes."""
    jb, tb = _grid(name)
    assert int(tb.counts.max()) <= tb.max_points_per_voxel
    for tdt in (torch.float32, torch.float64):
        g = tgrid.to_device(tb, "cpu", tdt)
        assert _padding_ok(g.points.numpy(), g.counts.numpy()), (name, tdt)
        if jb is not None:
            jdt = jnp.float64 if tdt == torch.float64 else jnp.float32
            c = convert.map_grid(flatten(jgrid.to_device(jb, dtype=jdt)), dtype=tdt)
            assert _padding_ok(c.points.numpy(), c.counts.numpy()), (name, tdt)
    if name == "m60":
        assert int(tb.counts.max()) == 60          # full voxels: more than a warp's 32


def _count_walk(g, xy, r, k):
    """Z's ground probe in NumPy: only the slots below each count, the k
    lowest kept z by value (+inf past the kept ones), summed in ascending
    order, over k."""
    pts, counts = g.points.numpy()[:-1], g.counts.numpy()[:-1]
    dt = pts.dtype.type
    p = pts[np.arange(pts.shape[1])[None, :] < counts[:, None]]
    dx, dy = p[:, 0] - dt(xy[0]), p[:, 1] - dt(xy[1])
    keep = np.isfinite(p[:, 0]) & (dx * dx + dy * dy <= dt(r * r))
    z = np.sort(p[keep, 2])[:k]
    low = np.r_[z, np.full(k - z.size, np.inf, pts.dtype)]
    s = dt(0.0)
    for v in low:
        s = dt(s + v)
    return int(keep.sum()) > 3, dt(s / dt(k))


GROUND_CASES = {"centre": ((0.0, 0.0), 5.0, 5), "off_centre": ((7.5, -3.25), 5.0, 5),
                "off_map": ((500.0, 500.0), 5.0, 5), "four_points": ((200.2, 0.2), 5.0, 5),
                "three_points": ((0.2, 200.2), 5.0, 5), "k1": ((0.0, 0.0), 5.0, 1),
                "k8": ((-4.0, 6.0), 3.0, 8)}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(GROUND_CASES))
def test_count_walk_ground_probe_matches_plain_and_jax(case, dt):
    jdt, tdt = DTYPES[dt]
    jb, tb = _grid("tie")
    xy, r, k = GROUND_CASES[case]
    g = tgrid.to_device(tb, "cpu", tdt)
    found, z = _count_walk(g, xy, r, k)
    pf, pz = tgrid.find_ground_height_plain(g, xy, r, k)
    jf, jz = jgrid.find_ground_height(jgrid.to_device(jb, dtype=jdt), jnp.asarray(xy, jdt), r, k)
    assert found == bool(pf) == bool(jf), case
    want = {"off_map": (False, False), "four_points": (True, False),
            "three_points": (False, False)}.get(case, (True, True))
    assert (found, bool(np.isfinite(z))) == want, case
    for ref in (float(pz), float(jz)):
        if not np.isfinite(ref):
            assert float(z) == ref, case
        elif dt == "f64":
            assert abs(float(z) - ref) <= 1e-12, case
        else:
            assert abs(float(z) - ref) <= float(np.finfo(np.float32).eps) * abs(ref), case


def _queries(name, g):
    rng = np.random.default_rng(5)
    if name.endswith("m60"):
        q = rng.uniform(-3.5, 3.5, size=(200, 3))
    else:
        q = np.r_[rng.uniform(-16.0, 16.0, size=(512, 3)), TIE_QUERY]
    return torch.as_tensor(np.r_[q, EMPTY_QUERY], dtype=torch.float32)


def _plane(g, q):
    """The [N, 27] neighbour rows and the [N, 27, M] candidate distances
    ((dx dx + dy dy) + dz dz, float32) with the candidate mask: the slots
    below each count whose distance is neither NaN nor +inf."""
    rows = tgrid._neighbour_rows(g, q, tgrid.OFFSETS_27).numpy().astype(np.int64)
    pts, counts = g.points.numpy(), g.counts.numpy()
    d = pts[rows] - q.numpy()[:, None, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    below = np.arange(pts.shape[1])[None, None, :] < counts[rows][..., None]
    return rows, d2, below & ~np.isnan(d2) & (d2 < np.inf)


def _lexicographic_min(keys, cand):
    """Per row of ``keys`` (a tuple of [N, K] arrays, the first primary):
    the index of the lexicographic minimum among ``cand``, or -1."""
    best = np.full(cand.shape[0], -1)
    for i in range(cand.shape[0]):
        at = np.nonzero(cand[i])[0]
        if at.size:
            best[i] = at[np.lexsort(tuple(k[i, at] for k in reversed(keys)))[0]]
    return best


@pytest.mark.parametrize("name", ["tie", "long_chains", "m60"])
def test_lexicographic_nearest_point_is_the_plain_first_minimum(name):
    _, tb = _grid(name)
    g = tgrid.to_device(tb, "cpu", torch.float32)
    q = _queries(name, g)
    md = torch.tensor(0.8)
    rows, d2, cand = _plane(g, q)
    n, _, m = d2.shape
    offset = np.broadcast_to(np.arange(27)[None, :, None], d2.shape).reshape(n, -1)
    slot = np.broadcast_to(np.arange(m)[None, None, :], d2.shape).reshape(n, -1)
    best = _lexicographic_min((d2.reshape(n, -1), offset, slot), cand.reshape(n, -1))
    found = best >= 0
    b = np.where(found, best, 0)
    row = np.where(found, rows[np.arange(n), b // m], rows[:, 0])
    slot_w = np.where(found, b % m, 0)
    bd = np.where(found, d2.reshape(n, -1)[np.arange(n), b], np.float32(np.inf))
    valid = bd < np.float32(0.8) * np.float32(0.8)
    target = np.where(valid[:, None], g.points.numpy()[row, slot_w], q.numpy())
    tgt, ok, prow, pslot = tgrid.query_nearest_point_plain(g, q, md)
    np.testing.assert_array_equal(row, prow.numpy())
    np.testing.assert_array_equal(slot_w, pslot.numpy())
    np.testing.assert_array_equal(valid, ok.numpy())
    np.testing.assert_array_equal(target, tgt.numpy())
    assert not found[-1] and row[-1] == g.sentinel    # the empty neighbourhood
    assert 0 < valid.sum() < n
    if name == "m60":
        # the neighbourhoods hold more candidates than a warp reads at once
        assert int(cand.reshape(n, -1).sum(axis=1).max()) > 27 * 32


@pytest.mark.parametrize("name", ["tie", "long_chains", "m60"])
def test_lexicographic_nearest_voxel_is_the_plain_first_minimum(name):
    _, tb = _grid(name)
    g = tgrid.to_device(tb, "cpu", torch.float32)
    q = _queries(name, g)
    rows = tgrid._neighbour_rows(g, q, tgrid.OFFSETS_27).numpy().astype(np.int64)
    means, counts = g.vox_mean.numpy(), g.counts.numpy()
    d = means[rows] - q.numpy()[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    cand = (counts[rows] > 0) & ~np.isnan(d2) & (d2 < np.inf)
    n = q.shape[0]
    best = _lexicographic_min((d2, np.broadcast_to(np.arange(27), d2.shape)), cand)
    found = best >= 0
    b = np.where(found, best, 0)
    row = np.where(found, rows[np.arange(n), b], rows[:, 0])
    bd = np.where(found, d2[np.arange(n), b], np.float32(np.inf))
    valid = bd < np.float32(0.8) * np.float32(0.8)
    cov = np.where(valid[:, None, None], g.vox_cov.numpy()[row], np.eye(3, dtype=np.float32))
    mean = np.where(valid[:, None], means[row], q.numpy())
    pcov, pmean, pok = tgrid.query_nearest_voxel_cov_plain(g, q, torch.tensor(0.8))
    np.testing.assert_array_equal(valid, pok.numpy())
    np.testing.assert_array_equal(cov, pcov.numpy())
    np.testing.assert_array_equal(mean, pmean.numpy())
    assert not found[-1] and 0 < valid.sum() < n


def test_grid_functions_run_plain_on_cpu(monkeypatch):
    """On CPU tensors the queries and the ground probe never reach the kernel
    library (Y, Z run only on CUDA tensors)."""
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(kernels, "library", no_library)
    _, tb = _grid("tie")
    g = tgrid.to_device(tb, "cpu")
    q = _queries("tie", g)
    kernels.reset_launches()
    for fn, plain in ((tgrid.query_nearest_point, tgrid.query_nearest_point_plain),
                      (tgrid.query_nearest_point_cov, tgrid.query_nearest_point_cov_plain),
                      (tgrid.query_nearest_voxel_cov, tgrid.query_nearest_voxel_cov_plain),
                      (tgrid.query_all_voxel_cov, tgrid.query_all_voxel_cov_plain)):
        for a, b in zip(fn(g, q, 0.8), plain(g, q, 0.8)):
            assert torch.equal(a, b)
    for a, b in zip(tgrid.find_ground_height(g, (0.0, 0.0), 5.0, 8),
                    tgrid.find_ground_height_plain(g, (0.0, 0.0), 5.0, 8)):
        assert torch.equal(a, b)
    assert all(v == 0 for v in kernels.launches.values()), kernels.launches


def test_ground_probe_workspace_matches_the_source():
    """The wrapper's per-stream workspace holds the done counter and a count
    and 8 floats for each of csrc/ground_probe.cu's ``kMaxProbeCtas``."""
    import re

    src = (build.SRC_DIR / "ground_probe.cu").read_text()
    ctas = int(re.search(r"constexpr int kMaxProbeCtas = (\d+);", src).group(1))
    k = int(re.search(r"constexpr int kGroundK = (\d+);", src).group(1))
    assert kernels._PROBE_WORDS == 1 + (1 + k) * ctas
