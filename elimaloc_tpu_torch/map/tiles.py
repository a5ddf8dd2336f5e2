"""Tile-blocked correspondence engine — port of ``elimaloc_tpu/map/tiles.py``.

Host half (NumPy copy, bit-identical packing): ``_halo_membership``,
``_pack_halo``, ``build_tile_map`` and ``HostTileMap``. Each map tile owns a
HALO row: every map point inside the tile's footprint grown by one voxel,
exactly the candidates an in-tile query's 27-voxel cube can reach.

Device half: ``TileMap`` (tensors on the device), ``TileQueryBudget``,
``assign_slots`` (scan queries sorted by tile and packed into [S, QB]
slots) and ``nearest_point_slots`` (per slot, the nearest halo point inside
each query's exact 27-voxel cube). ``assign_slots`` launches kernel B
(csrc/assign.cu) on a CUDA tensor and runs :func:`assign_slots_plain` on a
CPU one. The CUDA form of ``nearest_point_slots`` is fused with the P2P
reduction into kernel A (register/icp.py); the plain version here is its
search half. The windowed-map crop and shift (K14) and the voxel-level
queries (K9/K10) are ROADMAP Queue 1 #11/#14.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..struct import Struct
from .builder import BuiltMap
from .grid import div

_COORD_SENTINEL = np.int32(2**30)


@dataclasses.dataclass
class TileMap(Struct):
    """Device tile map (point level). Row T (last) of ``halo_points`` is the
    sentinel row: all +inf."""

    halo_points: torch.Tensor   # [T+1, MHP, 3], pad +inf
    voxel_size: float
    tile_size: float
    tx0: int
    ty0: int
    tx_dim: int
    ty_dim: int
    origin: torch.Tensor        # [2] world offset, zero for full maps

    @property
    def num_tiles(self) -> int:
        return self.tx_dim * self.ty_dim

    @property
    def sentinel(self) -> int:
        return self.num_tiles


@dataclasses.dataclass(frozen=True)
class TileQueryBudget:
    """Static shape budgets for one query batch (tiles.py:97-110). ``chunk``
    bounds how many slots the plain search evaluates at once."""

    qb: int = 32
    max_slots: int = 2560
    chunk: int = 88


def _halo_membership(vox_xy, tile_voxels, tx0, ty0, tx_dim, ty_dim,
                     margin: int = 1):
    """(tile_row, item_idx) pairs: item k belongs to the halo of every tile
    whose (tile +- ``margin`` voxels) footprint contains its voxel column."""
    tv = tile_voxels
    if not 1 <= margin <= tv:
        raise ValueError(f"halo margin {margin} must be in [1, {tv}]")
    vx, vy = vox_xy[:, 0], vox_xy[:, 1]
    tx, ty = vx // tv, vy // tv
    ox, oy = vx - tx * tv, vy - ty * tv
    rows, idxs = [], []
    for dx in (-1, 0, 1):
        mx = (np.ones_like(ox, bool) if dx == 0
              else (ox < margin) if dx == -1 else (ox >= tv - margin))
        for dy in (-1, 0, 1):
            my = (np.ones_like(oy, bool) if dy == 0
                  else (oy < margin) if dy == -1 else (oy >= tv - margin))
            gx, gy = tx + dx - tx0, ty + dy - ty0
            ok = (mx & my & (gx >= 0) & (gx < tx_dim)
                  & (gy >= 0) & (gy < ty_dim))
            rows.append(gx[ok] * ty_dim + gy[ok])
            idxs.append(np.nonzero(ok)[0])
    return np.concatenate(rows), np.concatenate(idxs)


def _pack_halo(rows, idxs, t, fills_payloads):
    """Scatter (tile_row, item) membership into padded [T+1, M, ...] blocks;
    ``fills_payloads`` = [(fill_value_or_array, payload [K, ...]), ...]."""
    order = np.argsort(rows, kind="stable")
    sr = rows[order]
    rank = np.arange(len(order)) - np.searchsorted(sr, sr)
    m = int(np.bincount(sr, minlength=t).max()) if len(sr) else 1
    out = []
    for fill, payload in fills_payloads:
        block = np.empty((t + 1, m) + payload.shape[1:], payload.dtype)
        block[...] = np.asarray(fill, payload.dtype)
        block[sr, rank] = payload[idxs[order]]
        out.append(block)
    return out


@dataclasses.dataclass
class HostTileMap:
    """Packed host tile map (the fields the JAX ``HostTileMap`` carries; the
    windowed-crop methods are ROADMAP Queue 1 #14)."""

    halo_points: np.ndarray
    halo_point_cov: np.ndarray | None
    halo_point_cov_mean: np.ndarray | None
    halo_vox_mean: np.ndarray
    halo_vox_cov: np.ndarray
    halo_vox_coord: np.ndarray
    voxel_size: float
    tile_size: float
    tx0: int
    ty0: int
    tx_dim: int
    ty_dim: int
    world_offset: tuple = (0.0, 0.0)
    halo_margin: int = 1

    def to_device(self, device=None, dtype=torch.float32) -> TileMap:
        return TileMap(
            halo_points=torch.as_tensor(self.halo_points, dtype=dtype,
                                        device=device),
            voxel_size=self.voxel_size,
            tile_size=self.tile_size,
            tx0=self.tx0,
            ty0=self.ty0,
            tx_dim=self.tx_dim,
            ty_dim=self.ty_dim,
            origin=torch.tensor(self.world_offset, dtype=dtype, device=device),
        )


def build_tile_map(built: BuiltMap, tile_voxels: int = 4,
                   halo_margin: int = 1) -> HostTileMap:
    """Re-block a BuiltMap into per-tile halo candidate tensors (host side,
    tiles.py:173-266 without the disk-backed ``storage_dir`` mode)."""
    vs = built.voxel_size
    ts = vs * tile_voxels
    vox_tx = built.vox_coords[:, 0] // tile_voxels
    vox_ty = built.vox_coords[:, 1] // tile_voxels
    tx0, ty0 = int(vox_tx.min()), int(vox_ty.min())
    tx_dim = int(vox_tx.max()) - tx0 + 1
    ty_dim = int(vox_ty.max()) - ty0 + 1
    t = tx_dim * ty_dim
    v, m = built.counts.shape[0], built.max_points_per_voxel

    vrows, vidxs = _halo_membership(
        built.vox_coords[:, :2], tile_voxels, tx0, ty0, tx_dim, ty_dim,
        margin=halo_margin)
    halo_vox_mean, halo_vox_cov, halo_vox_coord = _pack_halo(
        vrows, vidxs, t,
        [
            (np.inf, built.vox_mean.astype(np.float32)),
            (np.eye(3, dtype=np.float32), built.vox_cov.astype(np.float32)),
            (_COORD_SENTINEL, built.vox_coords.astype(np.int32)),
        ],
    )

    pt_mask = np.arange(m)[None, :] < built.counts[:, None]
    flat_pts = built.points[pt_mask].astype(np.float32)
    pt_vox = np.repeat(np.arange(v), m).reshape(v, m)[pt_mask]
    prows, pidxs = _halo_membership(
        built.vox_coords[pt_vox][:, :2], tile_voxels, tx0, ty0,
        tx_dim, ty_dim, margin=halo_margin)
    payloads = [(np.inf, flat_pts)]
    if built.point_cov is not None:
        payloads += [
            (np.eye(3, dtype=np.float32),
             built.point_cov[pt_mask].astype(np.float32)),
            (np.inf, built.point_cov_mean[pt_mask].astype(np.float32)),
        ]
    packed = _pack_halo(prows, pidxs, t, payloads)
    has_cov = built.point_cov is not None
    return HostTileMap(
        halo_points=packed[0],
        halo_point_cov=packed[1] if has_cov else None,
        halo_point_cov_mean=packed[2] if has_cov else None,
        halo_vox_mean=halo_vox_mean,
        halo_vox_cov=halo_vox_cov,
        halo_vox_coord=halo_vox_coord,
        voxel_size=float(vs),
        tile_size=float(ts),
        tx0=tx0,
        ty0=ty0,
        tx_dim=tx_dim,
        ty_dim=ty_dim,
        halo_margin=int(halo_margin),
    )


# --------------------------------------------------------------------------- #
# Slot assignment: sort queries by tile, pack into [max_slots, qb] blocks
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class SlotAssignment(Struct):
    qbuf: torch.Tensor       # [S, QB, 3] queries (0 where ~qmask)
    qvox: torch.Tensor       # [S, QB, 3] int32 query voxel coords
    qmask: torch.Tensor      # [S, QB] bool
    qidx: torch.Tensor       # [S, QB] int32 original query index (N if unused)
    slot_tile: torch.Tensor  # [S] int32 tile id (sentinel T if unused)
    dropped: torch.Tensor    # queries dropped on slot overflow


def query_tiles(tmap: TileMap, queries, valid):
    """Per-query voxel coords and tile id (tiles.py:582-603): the edge clamp
    keeps a query up to one voxel outside the grid on the edge tile, farther
    ones (and invalid rows) get the sentinel tile."""
    qv = torch.floor(div(queries, tmap.voxel_size)).to(torch.int32)
    tx = torch.floor(div(queries[:, 0], tmap.tile_size)).to(torch.int32) - tmap.tx0
    ty = torch.floor(div(queries[:, 1], tmap.tile_size)).to(torch.int32) - tmap.ty0
    tv = int(round(tmap.tile_size / tmap.voxel_size))
    in_reach = (
        (qv[:, 0] >= tmap.tx0 * tv - 1)
        & (qv[:, 0] <= (tmap.tx0 + tmap.tx_dim) * tv)
        & (qv[:, 1] >= tmap.ty0 * tv - 1)
        & (qv[:, 1] <= (tmap.ty0 + tmap.ty_dim) * tv)
    )
    tx = torch.clamp(tx, 0, tmap.tx_dim - 1)
    ty = torch.clamp(ty, 0, tmap.ty_dim - 1)
    tile = torch.where(valid & in_reach, tx * tmap.ty_dim + ty,
                       torch.full_like(tx, tmap.sentinel))
    return qv, tile


def assign_slots_plain(tmap: TileMap, queries, valid,
                       budget: TileQueryBudget) -> SlotAssignment:
    """Plain PyTorch version of kernel B (tiles.py:577-645): stable sort by
    tile, segment starts by cummax, a new slot every QB queries of a tile,
    scatter into the [S, QB] buffers, count the overflow."""
    n = queries.shape[0]
    qb, s = budget.qb, budget.max_slots
    t_sent = tmap.sentinel
    dev = queries.device
    qv, tile = query_tiles(tmap, queries, valid)
    st, order = torch.sort(tile, stable=True)
    idx = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = st[1:] != st[:-1]
    seg_start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0)[0]
    rank = idx - seg_start
    new_slot = first | (rank % qb == 0)
    slot = torch.cumsum(new_slot.to(torch.int64), 0) - 1
    pos = rank % qb
    usable = (slot < s) & (st != t_sent)
    flat = torch.where(usable, slot * qb + pos, torch.full_like(slot, s * qb))

    def scatter(fill, vals, dtype):
        buf = torch.full((s * qb + 1,) + vals.shape[1:], fill, dtype=dtype,
                         device=dev)
        buf[flat] = vals.to(dtype)
        return buf[:s * qb].reshape((s, qb) + vals.shape[1:])

    slot_tile = torch.full((s + 1,), t_sent, dtype=torch.int32, device=dev)
    slot_tile[torch.where(usable, slot, torch.full_like(slot, s))] = st
    return SlotAssignment(
        qbuf=scatter(0, queries[order], queries.dtype),
        qvox=scatter(0, qv[order], torch.int32),
        qmask=scatter(False, usable, torch.bool),
        qidx=scatter(n, order, torch.int32),
        slot_tile=slot_tile[:s],
        dropped=torch.sum((st != t_sent) & ~usable),
    )


def assign_slots(tmap: TileMap, queries, valid,
                 budget: TileQueryBudget) -> SlotAssignment:
    """Tile-slot assignment; kernel B on CUDA, the plain version on CPU."""
    if queries.device.type == "cpu":
        return assign_slots_plain(tmap, queries, valid, budget)
    out = kernels.assign_slots(
        queries, valid, budget.qb, budget.max_slots, voxel_size=tmap.voxel_size,
        tile_size=tmap.tile_size, tx0=tmap.tx0, ty0=tmap.ty0,
        tx_dim=tmap.tx_dim, ty_dim=tmap.ty_dim)
    return SlotAssignment(**out)


# --------------------------------------------------------------------------- #
# Nearest-point search on the slot layout
# --------------------------------------------------------------------------- #

def slot_centers(tmap: TileMap, slot_tile, dtype):
    """Per-slot tile-centre offsets (tiles.py:648-660): distances are taken
    on tile-local coordinates so f32 keeps its precision at map scale."""
    tx = (slot_tile // tmap.ty_dim + tmap.tx0).to(dtype)
    ty = (slot_tile % tmap.ty_dim + tmap.ty0).to(dtype)
    return torch.stack([(tx + 0.5) * tmap.tile_size, (ty + 0.5) * tmap.tile_size,
                        torch.zeros_like(tx)], dim=-1)


def _sq_norm3(d):
    """((dx*dx + dy*dy) + dz*dz), the summation order kernel A uses."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def nearest_point_slots(tmap: TileMap, slot_tile, qbuf, qvox, qmask, max_dist,
                        budget: TileQueryBudget):
    """Per slot, the nearest finite halo point inside each query's exact
    27-voxel cube, on tile-local coordinates, first index winning ties, gated
    by ``d2 < max_dist^2`` (tiles.py:712-773, P2P form). Returns
    (target [S,QB,3], ok [S,QB]); target is the query where not ok."""
    s = slot_tile.shape[0]
    centers = slot_centers(tmap, slot_tile, qbuf.dtype)
    tgts, oks = [], []
    chunk = max(1, min(budget.chunk, s))
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        q, qv, qm, ctr = qbuf[sl], qvox[sl], qmask[sl], centers[sl]
        cand = tmap.halo_points[slot_tile[sl].long()]           # [C,MHP,3]
        finite = torch.isfinite(cand[..., 0])
        cand_safe = torch.where(finite[..., None], cand, torch.zeros_like(cand))
        cvox = torch.floor(div(cand_safe, tmap.voxel_size)).to(torch.int32)
        cube = finite[:, None, :]
        for d in range(3):
            cube = cube & (torch.abs(cvox[:, None, :, d] - qv[:, :, None, d]) <= 1)
        ql = q - ctr[:, None, :]
        cl = torch.where(finite[..., None], cand_safe - ctr[:, None, :],
                         torch.zeros_like(cand_safe))
        d2 = _sq_norm3(ql[:, :, None, :] - cl[:, None, :, :])   # [C,QB,MHP]
        d2 = torch.where(cube, d2, torch.full_like(d2, torch.inf))
        best_d2, best = torch.min(d2, dim=2)
        ok = qm & (best_d2 < max_dist * max_dist)
        sel = torch.gather(cand_safe, 1, best[..., None].expand(-1, -1, 3))
        tgts.append(torch.where(ok[..., None], sel, q))
        oks.append(ok)
    return torch.cat(tgts), torch.cat(oks)
