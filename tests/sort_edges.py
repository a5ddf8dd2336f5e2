"""Seeded edge inputs of kernels B (slot assignment) and C (voxel downsample).

The inputs on which the one-launch design of the two kernels splits its
work: the sort's cluster stripes, its pass count, kernel B's per-tile tables
in shared or global memory, and kernel C's coords-not-keys keep test. NumPy
only, so that the CPU tests (JAX against the plain versions,
test_torch_sort_edges.py), the card tests (kernel against plain,
test_torch_kernels.py) and chip_smoke.py build the same inputs from the
same seeds.

* every row invalid;
* n = 1, 31 and 1025 (fewer rows than the cluster has CTAs, than a warp,
  than one CTA's chunk);
* every query in one tile: its segment spans every CTA of the cluster;
* n = 131,072: many chunks per CTA;
* a 257 x 257 tile grid: T + 1 = 66,050 > 2^13 tiles, so kernel B keeps its
  per-tile tables in global scratch, and the 17-bit tile id takes 3 passes;
* an interleaved hash collision (kernel C): voxel A, voxel B, voxel A again,
  all three with one mixed key. Sorted stably they stay A, B, A, so the
  coords test keeps three points where the voxels are two (JAX grid.py:
  290-296).
"""

import functools

import numpy as np

VOXEL = 1.0
TILE = 4.0  # 4 voxels a tile
SEED = 2024
#: the case names, for parametrizing without building the inputs
DOWNSAMPLE_CASES = ("all_invalid", "n1", "n31", "n1025", "n131072", "collision")
ASSIGN_CASES = ("all_invalid", "n1", "n31", "n1025", "one_tile", "n131072", "big_grid")


def mix32(c):
    """grid.py:_mix on int32 coords [n, 3] in uint32 arithmetic, clamped to
    0xFFFFFFFE as the downsample key is."""
    cx, cy, cz = (c[:, k].astype(np.int64).astype(np.uint32) for k in range(3))
    u = np.uint32
    with np.errstate(over="ignore"):
        h = u(0x9E3779B1) ^ (cx * u(0x85EBCA6B))
        h = (h ^ (h >> u(13))) * u(0xC2B2AE35)
        h = h ^ (cy * u(0x27D4EB2F))
        h = (h ^ (h >> u(13))) * u(0x165667B1)
        h = h ^ (cz * u(0x9E3779B1))
        h = h ^ (h >> u(16))
        h = h * u(0x7FEB352D)
        h = h ^ (h >> u(15))
        h = h * u(0x846CA68B)
        h = h ^ (h >> u(16))
    return np.minimum(h, u(0xFFFFFFFE))


def colliding_voxels():
    """Two voxels of [-400,400) x [-400,400) x [-4,4) with one key: the
    first colliding pair in key order (the block holds 2,790)."""
    x, y, z = np.meshgrid(np.arange(-400, 400), np.arange(-400, 400), np.arange(-4, 4),
                          indexing="ij")
    c = np.stack([x.ravel(), y.ravel(), z.ravel()], 1).astype(np.int32)
    k = mix32(c)
    order = np.argsort(k, kind="stable")
    ks = k[order]
    i = int(np.nonzero(ks[1:] == ks[:-1])[0][0])
    return c[order[i]], c[order[i + 1]]


def _scan_points(rng, n, half=30.0):
    p = rng.uniform(-half, half, (n, 3))
    p[:, 2] *= 0.1
    return p


@functools.lru_cache(maxsize=None)
def downsample_cases():
    """name -> (points [n, 3] float64, valid [n], voxel size, out_size)."""
    rng = np.random.default_rng(SEED)
    cases = {}
    p = _scan_points(rng, 1000)
    cases["all_invalid"] = (p, np.zeros(1000, bool), VOXEL, 256)
    for n in (1, 31, 1025):
        p = _scan_points(rng, n)
        valid = rng.random(n) > 0.1
        cases[f"n{n}"] = (p, valid, VOXEL, n)
    p = _scan_points(rng, 131072)
    cases["n131072"] = (p, rng.random(131072) > 0.1, VOXEL, 32768)
    a, b = colliding_voxels()
    p = _scan_points(rng, 64)
    p[10] = a + 0.5
    p[20] = b + 0.5
    p[30] = a + 0.25
    cases["collision"] = (p, np.ones(64, bool), VOXEL, 64)
    assert tuple(cases) == DOWNSAMPLE_CASES
    return cases


@functools.lru_cache(maxsize=None)
def assign_cases():
    """name -> (queries [n, 3] float64, valid [n], grid dict(tx0, ty0,
    tx_dim, ty_dim), qb, max_slots) on VOXEL / TILE."""
    rng = np.random.default_rng(SEED + 1)
    small = dict(tx0=-8, ty0=-8, tx_dim=16, ty_dim=16)  # [-32, 32)^2, T = 256
    cases = {}
    q = rng.uniform(-40.0, 40.0, (1000, 3))
    cases["all_invalid"] = (q, np.zeros(1000, bool), small, 16, 64)
    for n, slots in ((1, 4), (31, 8), (1025, 64)):  # n1025 overflows its slots
        q = rng.uniform(-40.0, 40.0, (n, 3))
        cases[f"n{n}"] = (q, rng.random(n) > 0.1, small, 16, slots)
    q = rng.uniform(0.05, 3.95, (20000, 3)) + np.array([8.0, 12.0, 0.0])
    cases["one_tile"] = (q, np.ones(20000, bool), small, 16, 1500)
    q = rng.uniform(-36.0, 36.0, (131072, 3))
    cases["n131072"] = (q, rng.random(131072) > 0.1, small, 16, 8800)
    big = dict(tx0=-128, ty0=-128, tx_dim=257, ty_dim=257)  # T = 66,049
    q = rng.uniform(-520.0, 520.0, (20000, 3))
    cases["big_grid"] = (q, rng.random(20000) > 0.05, big, 8, 12000)
    assert tuple(cases) == ASSIGN_CASES
    return cases
