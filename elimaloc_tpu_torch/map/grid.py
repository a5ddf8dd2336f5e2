"""The device voxel grid (the hash-grid backend, K13) and the scan
downsample — port of ``elimaloc_tpu/map/grid.py``.

:class:`MapGrid` holds the packed map on the device with a sentinel row V
(``to_device``, grid.py:72): an open-addressing table [T+P] (linear probing,
extended by ``max_probe`` entries so probe windows never wrap) with 32-bit
coordinate fingerprints, the voxels' points [V+1, M, 3] (+inf padded), their
means and covariances, and for GICP each point's neighbourhood covariance
and mean. :func:`lookup` (grid.py:153) maps voxel coords to rows, misses to
the sentinel; the four queries (grid.py:181-268) find, per world query, the
nearest point of its 27-voxel neighbourhood (P2P; with that point's
covariance for GICP), the nearest voxel mean (VGICP) or every occupied
face-adjacent voxel within range (AVGICP); :func:`find_ground_height`
(grid.py:320) is the relocalization's ground probe. On a CUDA tensor the
lookup launches kernel Q's lookup entry (csrc/hash_correspond.cu, the
lookup in csrc/hash.cuh), the queries kernel Y (csrc/grid_query.cu: Q's
query entry redesigned, a warp a query) and the ground probe kernel Z
(csrc/ground_probe.cu: kernel R redesigned, one launch reading only the
slots below each voxel's count); on a CPU tensor they run their
``*_plain`` versions. Q's query entry and R stay as Y's and Z's bit-exact
references and launch on no path. The registration's hash backend fuses Q's search with the GN
reduction (register/icp.py).

The fingerprints are uint32 in the builder; here they are kept as their
int32 bit pattern (the kernels reinterpret it) and widened to int64 in the
plain versions, as :func:`_mix` computes the hashes in int64.

``voxel_downsample`` (grid.py:271) launches kernel C (csrc/downsample.cu,
one launch with the radix sort of csrc/sort.cuh inside) on a CUDA tensor
and runs :func:`voxel_downsample_plain` on a CPU one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..struct import Struct

_M32 = 0xFFFFFFFF
_SENTINEL_COORD = np.int32(2**30)

#: the 3x3x3 neighbourhood (GetAdjacentVoxels range 2), in the order of
#: elimaloc_tpu/map/grid.py:31; csrc/hash.cuh walks the same order
OFFSETS_27 = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1))
#: the 7 face-adjacent voxel offsets of AVGICP, in the order of
#: elimaloc_tpu/map/grid.py:36 (GetCorrespondencesAllCov)
OFFSETS_7 = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
             (0, 0, -1))


@dataclasses.dataclass
class MapGrid(Struct):
    """Packed map tensors (grid.py:42-69). Row V (the last) of every
    voxel-indexed tensor is a sentinel: coords that never match, count 0,
    +inf geometry, identity covariances. Points past a voxel's count are
    +inf (the builder's padding): kernel Z reads only the slots below each
    count and is exact because of it (tests/test_torch_grid_probe.py)."""

    table: torch.Tensor            # [T+P] int32: voxel row or -1
    table_fp: torch.Tensor         # [T+P] int32: the uint32 fingerprint's bits
    vox_coords: torch.Tensor       # [V+1, 3] int32
    points: torch.Tensor           # [V+1, M, 3], padded +inf
    counts: torch.Tensor           # [V+1] int32
    vox_mean: torch.Tensor         # [V+1, 3], sentinel +inf
    vox_cov: torch.Tensor          # [V+1, 3, 3]
    point_cov: Optional[torch.Tensor]       # [V+1, M, 3, 3] or None (GICP only)
    point_cov_mean: Optional[torch.Tensor]  # [V+1, M, 3] or None
    voxel_size: float
    table_size: int
    max_probe: int

    @property
    def num_voxels(self) -> int:
        return self.vox_coords.shape[0] - 1

    @property
    def sentinel(self) -> int:
        return self.vox_coords.shape[0] - 1


def to_device(built, device=None, dtype=torch.float32) -> MapGrid:
    """BuiltMap (host NumPy) -> :class:`MapGrid` on ``device``, with the
    sentinel row appended and the table extended by ``max_probe`` entries
    (grid.py:72-119)."""
    m = built.max_points_per_voxel
    eye = np.eye(3, dtype=np.float32)

    def f(*parts):
        return torch.as_tensor(np.concatenate(parts), dtype=dtype, device=device)

    def i(*parts):
        return torch.as_tensor(np.concatenate(parts), device=device)

    point_cov = point_cov_mean = None
    if built.point_cov is not None:
        point_cov = f(built.point_cov, np.tile(eye, (1, m, 1, 1)))
        point_cov_mean = f(built.point_cov_mean, np.full((1, m, 3), np.inf, np.float32))
    p = built.max_probe
    fp = np.asarray(built.table_fp, np.uint32).view(np.int32)
    return MapGrid(
        table=i(built.table, built.table[:p]),
        table_fp=i(fp, fp[:p]),
        vox_coords=i(built.vox_coords, np.full((1, 3), _SENTINEL_COORD, np.int32)),
        points=f(built.points, np.full((1, m, 3), np.inf, np.float32)),
        counts=i(built.counts, np.zeros(1, np.int32)),
        vox_mean=f(built.vox_mean, np.full((1, 3), np.inf, np.float32)),
        vox_cov=f(built.vox_cov, eye[None]),
        point_cov=point_cov,
        point_cov_mean=point_cov_mean,
        voxel_size=float(built.voxel_size),
        table_size=int(built.table_size),
        max_probe=int(p),
    )


def div(x, s):
    """``x / s`` as a true division. ``s`` goes in as a device tensor:
    PyTorch turns a CUDA tensor divided by a Python number into a product
    with the number's reciprocal, which can move a point across a voxel
    boundary and break equality with the kernels (IEEE division)."""
    return x / torch.as_tensor(s, dtype=x.dtype, device=x.device)


def point_to_voxel(points, voxel_size):
    """floor(p / voxel) as int32 (PointToVoxel, hpp:176-180)."""
    return torch.floor(div(points, voxel_size)).to(torch.int32)


def _mul32(a, c: int):
    """(a * c) mod 2^32 for 0 <= a < 2^32 held in int64, without leaving
    int64: split c in 16-bit halves so no partial product passes 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(coords, seed=0x9E3779B1):
    """Chained uint32 mix + fmix32 (grid.py:127-141 / builder._mix_coords) in
    int64 arithmetic; returns the uint32 hash as int64."""
    c = coords.to(torch.int64) & _M32
    h = seed ^ _mul32(c[..., 0], 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ _mul32(c[..., 1], 0x27D4EB2F)
    h = _mul32(h ^ (h >> 13), 0x165667B1)
    h = h ^ _mul32(c[..., 2], 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _hash(coords, table_size: int):
    """Table slot of voxel coords (grid.py:144), int64."""
    return _mix(coords) & (table_size - 1)


def _fingerprint(coords):
    """32-bit coordinate fingerprint, 0 made 1 (0 marks an empty slot;
    grid.py:148-150), int64."""
    fp = _mix(coords, seed=0x51ED270B)
    return torch.where(fp == 0, torch.ones_like(fp), fp)


def sq_norm3(d):
    """((dx*dx + dy*dy) + dz*dz): the summation order the kernels use."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _offsets(offsets, device):
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def lookup_plain(grid: MapGrid, coords):
    """Plain PyTorch version of :func:`lookup` (grid.py:153-178): the probe
    window [h, h + max_probe) gathered at once; a slot hits when its
    fingerprint matches and no empty slot precedes it; the first hit wins;
    a miss is the sentinel row."""
    h = _hash(coords, grid.table_size)
    fp = _fingerprint(coords)
    idx = h[..., None] + torch.arange(grid.max_probe, device=coords.device)
    rows = grid.table[idx]
    fps = grid.table_fp[idx].to(torch.int64) & _M32
    empty = (rows < 0).to(torch.int32)
    empty_before = torch.cumsum(empty, dim=-1) - empty > 0
    hit = (fps == fp[..., None]) & (empty == 0) & ~empty_before
    first = torch.argmax(hit.to(torch.int32), dim=-1, keepdim=True)
    row = torch.gather(rows, -1, first)[..., 0]
    return torch.where(hit.any(dim=-1), row, torch.full_like(row, grid.sentinel))


def lookup(grid: MapGrid, coords):
    """Voxel coords [..., 3] (int32) -> voxel row [...] (int32), misses the
    sentinel row: :func:`lookup_plain` on CPU tensors, kernel Q's lookup on
    CUDA ones."""
    if coords.device.type == "cpu":
        return lookup_plain(grid, coords)
    return kernels.hash_lookup(grid, coords)


def _md2(max_dist, like):
    """max_dist^2 in the queries' dtype (the kernels square the float32
    value)."""
    md = torch.as_tensor(max_dist, dtype=like.dtype, device=like.device)
    return md * md


def _neighbour_rows(grid: MapGrid, queries, offsets):
    c = point_to_voxel(queries, grid.voxel_size)
    return lookup_plain(grid, c[:, None, :] + _offsets(offsets, queries.device))


def _eye_like(cov):
    return torch.eye(3, dtype=cov.dtype, device=cov.device).expand(cov.shape)


def query_nearest_point_plain(grid: MapGrid, queries, max_dist):
    """Plain version of :func:`query_nearest_point` (grid.py:181-208): the
    first strict minimum of the exact d2 over the 27 x M candidates in
    (offset, slot) order (an empty neighbourhood gives row 0's first slot,
    as ``argmin`` does)."""
    n = queries.shape[0]
    rows = _neighbour_rows(grid, queries, OFFSETS_27)                # [N,27]
    cand = grid.points[rows.long()]                                  # [N,27,M,3]
    d2 = sq_norm3(cand - queries[:, None, None, :]).reshape(n, -1)
    best = torch.argmin(d2, dim=1, keepdim=True)
    best_d2 = torch.gather(d2, 1, best)[:, 0]
    m = grid.points.shape[1]
    best_row = torch.gather(rows, 1, best // m)[:, 0]
    best_slot = (best % m)[:, 0].to(torch.int32)
    target = grid.points[best_row.long(), best_slot.long()]
    valid = best_d2 < _md2(max_dist, queries)
    target = torch.where(valid[:, None], target, queries)
    return target, valid, best_row, best_slot


def _require_point_cov(grid: MapGrid):
    if grid.point_cov is None:
        raise ValueError("MapGrid was built without per-point covariances; "
                         "build with compute_point_cov=True for GICP")


def query_nearest_point_cov_plain(grid: MapGrid, queries, max_dist):
    """Plain version of :func:`query_nearest_point_cov` (grid.py:211-230)."""
    target, valid, row, slot = query_nearest_point_plain(grid, queries, max_dist)
    _require_point_cov(grid)
    cov = grid.point_cov[row.long(), slot.long()]
    mean = grid.point_cov_mean[row.long(), slot.long()]
    cov = torch.where(valid[:, None, None], cov, _eye_like(cov))
    mean = torch.where(valid[:, None], mean, queries)
    return target, cov, mean, valid


def query_nearest_voxel_cov_plain(grid: MapGrid, queries, max_dist):
    """Plain version of :func:`query_nearest_voxel_cov` (grid.py:233-251):
    the first minimum of d2 over the 27 voxel means, unoccupied voxels +inf."""
    rows = _neighbour_rows(grid, queries, OFFSETS_27)                # [N,27]
    means = grid.vox_mean[rows.long()]                               # [N,27,3]
    occupied = grid.counts[rows.long()] > 0
    d2 = sq_norm3(means - queries[:, None, :])
    d2 = torch.where(occupied, d2, torch.full_like(d2, torch.inf))
    best = torch.argmin(d2, dim=1, keepdim=True)
    best_d2 = torch.gather(d2, 1, best)[:, 0]
    best_row = torch.gather(rows, 1, best)[:, 0].long()
    valid = best_d2 < _md2(max_dist, queries)
    cov = grid.vox_cov[best_row]
    cov = torch.where(valid[:, None, None], cov, _eye_like(cov))
    mean = torch.where(valid[:, None], grid.vox_mean[best_row], queries)
    return cov, mean, valid


def query_all_voxel_cov_plain(grid: MapGrid, queries, max_dist):
    """Plain version of :func:`query_all_voxel_cov` (grid.py:254-268): each
    of the 7 face-adjacent voxels is a match when occupied and its mean lies
    within ``max_dist``."""
    rows = _neighbour_rows(grid, queries, OFFSETS_7).long()          # [N,7]
    means = grid.vox_mean[rows]
    occupied = grid.counts[rows] > 0
    valid = occupied & (sq_norm3(means - queries[:, None, :]) < _md2(max_dist, queries))
    cov = grid.vox_cov[rows]
    cov = torch.where(valid[..., None, None], cov, _eye_like(cov))
    mean = torch.where(valid[..., None], means, queries[:, None, :])
    return cov, mean, valid


def query_nearest_point(grid: MapGrid, queries, max_dist):
    """Nearest map point in the 27-voxel neighbourhood of each world query
    [N,3] (GetCorrespondencePoints, voxel_hash_map.cpp:31-88), gated on
    ``max_dist``. Returns (target [N,3], valid [N], rows [N], slots [N]);
    an invalid target is the query."""
    if queries.device.type == "cpu":
        return query_nearest_point_plain(grid, queries, max_dist)
    out = kernels.grid_query(grid, queries, max_dist, "P2P")
    return out["target"], out["valid"], out["rows"], out["slots"]


def query_nearest_point_cov(grid: MapGrid, queries, max_dist):
    """GICP correspondence: :func:`query_nearest_point` plus that point's
    neighbourhood covariance and mean (identity and the query where
    invalid). Returns (target, cov [N,3,3], mean [N,3], valid)."""
    if queries.device.type == "cpu":
        return query_nearest_point_cov_plain(grid, queries, max_dist)
    out = kernels.grid_query(grid, queries, max_dist, "GICP")
    return out["target"], out["cov"], out["mean"], out["valid"]


def query_nearest_voxel_cov(grid: MapGrid, queries, max_dist):
    """VGICP correspondence (GetCorrespondencesCov, cpp:90-151): the
    covariance and mean of the neighbourhood voxel whose mean is nearest.
    Returns (cov [N,3,3], mean [N,3], valid [N])."""
    if queries.device.type == "cpu":
        return query_nearest_voxel_cov_plain(grid, queries, max_dist)
    out = kernels.grid_query(grid, queries, max_dist, "VGICP")
    return out["cov"], out["mean"], out["valid"]


def query_all_voxel_cov(grid: MapGrid, queries, max_dist):
    """AVGICP correspondence (GetCorrespondencesAllCov, cpp:153-206): every
    occupied face-adjacent voxel within ``max_dist``. Returns
    (cov [N,7,3,3], mean [N,7,3], valid [N,7])."""
    if queries.device.type == "cpu":
        return query_all_voxel_cov_plain(grid, queries, max_dist)
    out = kernels.grid_query(grid, queries, max_dist, "AVGICP")
    return out["cov"], out["mean"], out["valid"]


def find_ground_height_plain(grid: MapGrid, position_xy, search_range: float = 5.0,
                             k: int = 5):
    """Plain version of :func:`find_ground_height` (grid.py:320-331): the
    mean z of the ``k`` lowest finite map points within ``search_range`` in
    XY (+inf when fewer are in range: their ``top_k`` entries are -inf);
    found when more than 3 are."""
    pts = grid.points[:-1].reshape(-1, 3)
    xy = torch.as_tensor(position_xy, dtype=pts.dtype, device=pts.device)
    d = pts[:, :2] - xy
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
    within = torch.isfinite(pts[:, 0]) & (d2 <= search_range * search_range)
    neg_z = torch.where(within, -pts[:, 2], torch.full_like(d2, -torch.inf))
    top = torch.topk(neg_z, k).values
    return torch.sum(within) > 3, -torch.mean(top)


def find_ground_height(grid: MapGrid, position_xy, search_range: float = 5.0, k: int = 5):
    """Mean z of the ``k`` lowest map points within ``search_range`` (XY) —
    FindGroundHeight (voxel_hash_map.hpp:285-322) on the device. Returns
    (found, ground_z) as device scalars: kernel Z on a CUDA grid,
    :func:`find_ground_height_plain` on a CPU one."""
    if grid.points.device.type == "cpu":
        return find_ground_height_plain(grid, position_xy, search_range, k)
    return kernels.ground_probe(grid, position_xy, search_range, k)


def voxel_downsample_plain(points, valid, voxel_size, out_size: int):
    """Plain PyTorch version of kernel C (grid.py:271-317): keep the first
    valid point per voxel in input order, static output budget. The voxel
    key is the mixed 32-bit hash, 0xFFFFFFFF reserved for invalid rows, and
    "first" is found by comparing the sorted neighbours' coordinates."""
    n = points.shape[0]
    keys = point_to_voxel(points, voxel_size)
    key = torch.where(valid, torch.clamp(_mix(keys), max=0xFFFFFFFE),
                      torch.full_like(keys[:, 0], _M32, dtype=torch.int64))
    _, order = torch.sort(key, stable=True)
    sc = keys[order]
    first = torch.ones(n, dtype=torch.bool, device=points.device)
    first[1:] = torch.any(sc[1:] != sc[:-1], dim=-1)
    keep = first & valid[order]
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    dst = torch.where(keep, rank, torch.full_like(rank, out_size))
    out = torch.zeros((out_size + 1, 3), dtype=points.dtype, device=points.device)
    out[torch.clamp(dst, max=out_size)] = points[order]
    kept = torch.sum(keep)
    out_valid = torch.arange(out_size, device=points.device) < kept
    return out[:out_size], out_valid, torch.clamp(kept, max=out_size)


def voxel_downsample_lanes_plain(points, valid, voxel_size, out_size: int):
    """Plain lane form of kernel C: :func:`voxel_downsample_plain` on each
    lane of points [B, N, 3] and valid [B, N], stacked (a fleet frame's
    downsample, JAX's vmap of grid.py:271)."""
    outs = [voxel_downsample_plain(p, v, voxel_size, out_size) for p, v in zip(points, valid)]
    return tuple(torch.stack(x) for x in zip(*outs))


def voxel_downsample(points, valid, voxel_size, out_size: int):
    """VoxelDownsample (hpp:260-283) on the device. Returns (points
    [out_size,3], valid [out_size], kept_count); with a leading lane axis
    on every input and output for a fleet frame (kernel C's lane form, or
    :func:`voxel_downsample_lanes_plain` on CPU tensors)."""
    if points.device.type == "cpu":
        plain = voxel_downsample_lanes_plain if points.dim() == 3 else voxel_downsample_plain
        return plain(points, valid, voxel_size, out_size)
    return kernels.voxel_downsample(points, valid, voxel_size, out_size)
