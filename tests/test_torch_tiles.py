"""Port parity: the tile engine and the downsample of elimaloc_tpu_torch.map,
and the P2P reduction of elimaloc_tpu_torch.register, vs the JAX package.

All on the ``tiny_pipe`` world of tests/test_pipeline_modes.py:22-43
(make_world(seed=9, extent=70, n_ground=60k, n_wall=30k)). Bounds:
  * build_tile_map: bit-identical arrays (same NumPy code);
  * voxel_downsample, assign_slots: exact equality of every output (integer
    keys, stable sorts, copies);
  * nearest_point_slots: ``ok`` and the selected targets exactly equal
    (exact diff^2 sums, first-index ties on both sides);
  * _p2p_tail: float64 rtol 1e-10, float32 rtol 1e-5 on the norms of JTJ and
    JTr (summation order differs), matched count equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import grid as jgrid
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.register import icp as jicp
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.register import icp as ticp
from torch_parity import flatten, tiny_world_and_log

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def world_log_built():
    world, log = tiny_world_and_log(jlog, duration=1.0)
    built = jbuilder.build_voxel_map(world, 1.0, 30, use_native=False)
    return world, log, built


def test_build_tile_map_bit_identical(world_log_built):
    _, _, built = world_log_built
    for margin in (1, 2):
        jh = jtiles.build_tile_map(built, tile_voxels=4, halo_margin=margin)
        th = ttiles.build_tile_map(built, tile_voxels=4, halo_margin=margin)
        for f in dataclasses.fields(th):
            a, b = getattr(th, f.name), getattr(jh, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


def _scan(log, k=3):
    pts = log.scan_points[k].astype(np.float64)
    valid = log.scan_valid[k].copy()
    valid[::7] = False
    return pts, valid


@pytest.mark.parametrize("voxel,out_size", [(1.0, 2048), (1.5, 1024), (1.0, 300)],
                         ids=["v1", "v1.5", "overflow"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_voxel_downsample_exact(world_log_built, dt_name, voxel, out_size):
    jdt, tdt = DTYPES[dt_name]
    _, log, _ = world_log_built
    pts, valid = _scan(log)
    jo = jgrid.voxel_downsample(jnp.asarray(pts, jdt), jnp.asarray(valid),
                                jnp.asarray(voxel, jdt), out_size)
    to = tgrid.voxel_downsample(torch.as_tensor(pts, dtype=tdt),
                                torch.as_tensor(valid), torch.tensor(voxel, dtype=tdt),
                                out_size)
    for g, r in zip(to, jo):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if out_size == 300:
        assert int(to[2]) == 300  # the overflow case really overflows


def _tile_maps(built, jdt, tdt):
    jt = jtiles.build_tile_map(built, tile_voxels=4).to_device(dtype=jdt)
    return jt, convert.tile_map(flatten(jt), dtype=tdt)


def _queries(rng, world, n=900):
    """Map points + noise, a few out-of-map, every 11th invalid."""
    q = world[rng.integers(0, len(world), n)] + rng.normal(0, 0.3, (n, 3))
    q[:20, :2] += 200.0
    q[20:25, 0] = -70.4  # just outside the grid edge: clamped, still in reach
    valid = np.ones(n, bool)
    valid[::11] = False
    return q, valid


@pytest.mark.parametrize("budget", [(8, 1024), (16, 512), (8, 40)],
                         ids=["qb8", "qb16", "overflow"])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_assign_slots_exact(world_log_built, dt_name, budget):
    jdt, tdt = DTYPES[dt_name]
    world, _, built = world_log_built
    jt, tt = _tile_maps(built, jdt, tdt)
    q, valid = _queries(np.random.default_rng(23), world)
    jb = jtiles.TileQueryBudget(qb=budget[0], max_slots=budget[1])
    tb = ttiles.TileQueryBudget(qb=budget[0], max_slots=budget[1])
    ja = jtiles.assign_slots(jt, jnp.asarray(q, jdt), jnp.asarray(valid), jb)
    ta = ttiles.assign_slots(tt, torch.as_tensor(q, dtype=tdt), torch.as_tensor(valid), tb)
    for f in dataclasses.fields(ta):
        np.testing.assert_array_equal(getattr(ta, f.name).numpy(),
                                      np.asarray(getattr(ja, f.name)), err_msg=f.name)
    if budget[1] == 40:
        assert int(ta.dropped) > 0


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_nearest_point_slots_exact(world_log_built, dt_name):
    jdt, tdt = DTYPES[dt_name]
    world, _, built = world_log_built
    jt, tt = _tile_maps(built, jdt, tdt)
    q, valid = _queries(np.random.default_rng(29), world)
    jb = jtiles.TileQueryBudget(qb=8, max_slots=1024)
    ja = jtiles.assign_slots(jt, jnp.asarray(q, jdt), jnp.asarray(valid), jb)
    jtgt, jok = jtiles.nearest_point_slots(jt, ja.slot_tile, ja.qbuf, ja.qvox,
                                           ja.qmask, jnp.asarray(5.0, jdt), jb)
    d = flatten(ja)
    ttgt, tok = ttiles.nearest_point_slots(
        tt, torch.as_tensor(d["slot_tile"]), torch.as_tensor(d["qbuf"], dtype=tdt),
        torch.as_tensor(d["qvox"]), torch.as_tensor(d["qmask"]),
        torch.tensor(5.0, dtype=tdt), ttiles.TileQueryBudget(qb=8, max_slots=1024))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ttgt.numpy(), np.asarray(jtgt))
    assert tok.sum() > 0.8 * valid.sum()


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_p2p_tail(dt_name):
    jdt, tdt = DTYPES[dt_name]
    rng = np.random.default_rng(31)
    n = 2000
    pose = np.eye(4)
    pose[:3, :3] = np.asarray(jicp.lie.so3_exp(jnp.asarray([0.01, -0.02, 0.8])))
    pose[:3, 3] = [60.0, 5.0, 0.3]
    src = rng.normal(0, 15.0, (n, 3))
    tgt = src @ pose[:3, :3].T + pose[:3, 3] + rng.normal(0, 0.2, (n, 3))
    valid = rng.uniform(size=n) > 0.2
    jp = jicp.make_icp_params(jicp.PcmConfig(), dtype=jdt)
    tp = convert.icp_params(flatten(jp), dtype=tdt)
    jres = jicp._p2p_tail(jnp.asarray(pose, jdt), jnp.asarray(src, jdt),
                          jnp.asarray(tgt, jdt), jnp.asarray(valid), jp)
    tres = ticp._p2p_tail(torch.as_tensor(pose, dtype=tdt), torch.as_tensor(src, dtype=tdt),
                          torch.as_tensor(tgt, dtype=tdt), torch.as_tensor(valid), tp)
    rtol = 1e-10 if dt_name == "f64" else 1e-5
    assert int(tres[0]) == int(jres[0])
    for g, r in zip(tres[1:], jres[1:]):
        r = np.asarray(r, np.float64)
        assert np.linalg.norm(g.numpy().astype(np.float64) - r) <= rtol * np.linalg.norm(r)
