"""Voxel helpers and the scan downsample — port of the downsample part of
``elimaloc_tpu/map/grid.py`` (``point_to_voxel`` :122, ``_mix`` :127,
``voxel_downsample`` :271). The hash-grid backend and its queries are ROADMAP
Queue 1 #13.

``voxel_downsample`` is the hot op: on a CUDA tensor it launches kernel C
(csrc/downsample.cu, with ``torch.sort`` in the middle); on a CPU tensor it
runs :func:`voxel_downsample_plain`.
"""

from __future__ import annotations

import torch

from .. import kernels

_M32 = 0xFFFFFFFF


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


def voxel_downsample(points, valid, voxel_size, out_size: int):
    """VoxelDownsample (hpp:260-283) on the device. Returns (points
    [out_size,3], valid [out_size], kept_count)."""
    if points.device.type == "cpu":
        return voxel_downsample_plain(points, valid, voxel_size, out_size)
    return kernels.voxel_downsample(points, valid, voxel_size, out_size)
