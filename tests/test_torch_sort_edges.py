"""The plain versions of kernels B and C against JAX on the sort's edge inputs.

Kernels B (slot assignment) and C (voxel downsample) are one launch each
around a cluster-wide radix sort (elimaloc_tpu_torch/csrc/sort.cuh). The
inputs of tests/sort_edges.py are where that design splits its work: every
row invalid, n = 1 / 31 / 1025 / 131,072, every query in one tile, a tile
grid past kernel B's shared-memory tables (3 sort passes), an interleaved
hash collision. Here, on the CPU, the port's callers run the plain versions
(``torch.sort(stable=True)``) and every output must equal JAX's exactly,
in float32 and float64; tests/test_torch_kernels.py holds the kernels to the
plain versions on the same inputs on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sort_edges
from elimaloc_tpu.map import grid as jgrid
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from torch_parity import one_torch_thread  # noqa: F401  (fixture)

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


def test_collision_case_really_collides():
    """Voxels A, B, A with one key: kept as three points on both sides."""
    p, valid, voxel, out_size = sort_edges.downsample_cases()["collision"]
    c = np.floor(p[[10, 20, 30]] / voxel).astype(np.int32)
    k = sort_edges.mix32(c)
    assert k[0] == k[1] == k[2] and (c[0] == c[2]).all() and (c[0] != c[1]).any()
    j = jgrid.voxel_downsample(jnp.asarray(p), jnp.asarray(valid), jnp.asarray(voxel),
                               out_size)
    kept = np.asarray(j[0])[: int(j[2])]
    assert sum(bool(np.all(np.floor(r / voxel) == c[0])) for r in kept) == 2


@pytest.mark.parametrize("case", sort_edges.DOWNSAMPLE_CASES)
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_voxel_downsample_edges_match_jax(dt_name, case):
    jdt, tdt = DTYPES[dt_name]
    p, valid, voxel, out_size = sort_edges.downsample_cases()[case]
    jo = jgrid.voxel_downsample(jnp.asarray(p, jdt), jnp.asarray(valid),
                                jnp.asarray(voxel, jdt), out_size)
    to = tgrid.voxel_downsample(torch.as_tensor(p, dtype=tdt), torch.as_tensor(valid),
                                torch.tensor(voxel, dtype=tdt), out_size)
    for name, g, r in zip(("points", "valid", "kept"), to, jo):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    if case == "all_invalid":
        assert int(to[2]) == 0


def _tile_maps(grid, jdt, tdt):
    """Geometry-only tile maps: assign_slots reads no halo row."""
    geo = dict(voxel_size=sort_edges.VOXEL, tile_size=sort_edges.TILE, **grid)
    jt = jtiles.TileMap(halo_points=jnp.zeros((1, 1, 3), jdt), halo_point_cov=None,
                        halo_point_cov_mean=None, halo_vox_mean=jnp.zeros((1, 1, 3), jdt),
                        halo_vox_cov=jnp.zeros((1, 1, 3, 3), jdt),
                        halo_vox_coord=jnp.zeros((1, 1, 3), jnp.int32), **geo)
    tt = ttiles.TileMap(halo_points=torch.zeros((1, 1, 3), dtype=tdt),
                        origin=torch.zeros(2, dtype=tdt), **geo)
    return jt, tt


@pytest.mark.parametrize("case", sort_edges.ASSIGN_CASES)
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_assign_slots_edges_match_jax(dt_name, case):
    jdt, tdt = DTYPES[dt_name]
    q, valid, grid, qb, slots = sort_edges.assign_cases()[case]
    jt, tt = _tile_maps(grid, jdt, tdt)
    ja = jtiles.assign_slots(jt, jnp.asarray(q, jdt), jnp.asarray(valid),
                             jtiles.TileQueryBudget(qb=qb, max_slots=slots))
    ta = ttiles.assign_slots(tt, torch.as_tensor(q, dtype=tdt), torch.as_tensor(valid),
                             ttiles.TileQueryBudget(qb=qb, max_slots=slots))
    for f in dataclasses.fields(ta):
        np.testing.assert_array_equal(getattr(ta, f.name).numpy(),
                                      np.asarray(getattr(ja, f.name)), err_msg=f.name)
    used = int(ta.qmask.sum())
    if case == "all_invalid":
        assert used == 0 and int(ta.dropped) == 0
    elif case == "one_tile":
        assert used == len(q) and len(set(ta.slot_tile[:used // qb].tolist())) == 1
    elif case in ("n1025", "big_grid"):
        assert int(ta.dropped) > 0
    if case == "big_grid":
        assert tt.sentinel + 1 > 2 ** 13 and tt.sentinel >= 2 ** 16  # global tables, 3 passes
