"""Tile-blocked correspondence engine — port of ``elimaloc_tpu/map/tiles.py``.

Host half (NumPy copy, bit-identical packing): ``_halo_membership``,
``_pack_halo``, ``build_tile_map`` (in RAM, or disk-backed with
``storage_dir``), ``load_tile_map`` and ``HostTileMap`` with the
active-window crops ``crop_window`` and ``crop_entering_rows``. Each map
tile owns a HALO row: every map point inside the tile's footprint grown by
one voxel, exactly the candidates an in-tile query's 27-voxel cube can
reach.

Device half: ``TileMap`` (tensors on the device), ``TileQueryBudget``,
``assign_slots`` (scan queries sorted by tile and packed into [S, QB]
slots) and the three slot searches: ``nearest_point_slots`` (per slot, the
nearest halo point inside each query's exact 27-voxel cube, and for GICP
that point's covariance and neighbourhood mean), ``nearest_voxel_cov_slots``
(the nearest voxel mean in the cube, VGICP) and ``all_voxel_cov_slots`` (the
7 face-adjacent voxels, AVGICP). ``assign_slots`` launches kernel B
(csrc/assign.cu) on a CUDA tensor and runs :func:`assign_slots_plain` on a
CPU one. On CUDA each search is fused with its method's GN reduction into
one kernel (A, E, F, G; register/icp.py); the plain versions here are their
search halves. The map's own one-shot queries in query order,
``query_nearest_point`` (``with_point_cov`` for GICP),
``query_nearest_voxel_cov`` and ``query_all_voxel_cov``, run B and then
kernel A (A and E), F or G with its matches on a CUDA tensor, the plain
assignment and search on a CPU one, and go back to query order through
:func:`scatter_back`. ``shift_window`` moves a resident window incrementally:
kernel N (csrc/window_shift.cu) on CUDA, :func:`shift_window_plain` on CPU.
A window's ``tile_anchor`` reaches every search through
``TileMap.grid_origin``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..parallel import stack_streams
from ..struct import Struct
from .builder import BuiltMap
from .grid import OFFSETS_7, div, sq_norm3

_COORD_SENTINEL = np.int32(2**30)


@dataclasses.dataclass
class TileMap(Struct):
    """Device tile map. Row T (last) of every tile-indexed tensor is the
    sentinel row (+inf geometry, eye covariances, sentinel coords). The
    covariance fields are None where the map was built without them."""

    halo_points: torch.Tensor   # [T+1, MHP, 3], pad +inf
    voxel_size: float
    tile_size: float
    tx0: int
    ty0: int
    tx_dim: int
    ty_dim: int
    origin: torch.Tensor        # [2] world offset, zero for full maps
    halo_point_cov: Optional[torch.Tensor] = None       # [T+1, MHP, 3, 3], pad eye
    halo_point_cov_mean: Optional[torch.Tensor] = None  # [T+1, MHP, 3], pad +inf
    halo_vox_mean: Optional[torch.Tensor] = None        # [T+1, MHV, 3], pad +inf
    halo_vox_cov: Optional[torch.Tensor] = None         # [T+1, MHV, 3, 3], pad eye
    halo_vox_coord: Optional[torch.Tensor] = None       # [T+1, MHV, 3] int32, pad 2^30
    # the window's anchor in tile units relative to ``origin``: zero for
    # full maps and fresh crops; an incremental shift (:func:`shift_window`)
    # keeps ``origin`` and moves this instead. Host ints: the host decides
    # every shift, so it knows the anchor without a readback, and the
    # kernels take it in their grid origin (``grid_origin``) as before
    tile_anchor: tuple = (0, 0)

    @property
    def grid_origin(self) -> tuple:
        """(tx0, ty0) plus the window anchor: the tile that row 0 holds,
        in the units of the map's coordinates (JAX tiles.py:585-586)."""
        return self.tx0 + self.tile_anchor[0], self.ty0 + self.tile_anchor[1]

    @property
    def search_geometry(self) -> dict:
        """The tile geometry the search kernels take as host numbers, the
        window anchor included (``grid_origin``)."""
        ax0, ay0 = self.grid_origin
        return dict(voxel_size=self.voxel_size, tile_size=self.tile_size, tx0=ax0, ty0=ay0,
                    ty_dim=self.ty_dim)

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

    def for_queries(self, n: int) -> "TileQueryBudget":
        """The budget for a batch of ``n`` queries: this one, whatever
        ``n`` (tiles.py:109-110)."""
        return self


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


def _pack_halo(rows, idxs, t, fills_payloads, out_path=None):
    """Scatter (tile_row, item) membership into padded [T+1, M, ...] blocks;
    ``fills_payloads`` = [(name, fill_value_or_array, payload [K, ...]), ...].
    With ``out_path`` the blocks are disk-backed ``np.memmap`` files
    (<out_path>/<name>.npy), so a city-scale map never holds the dense
    tensors in host RAM (tiles.py:147-170)."""
    order = np.argsort(rows, kind="stable")
    sr = rows[order]
    rank = np.arange(len(order)) - np.searchsorted(sr, sr)
    m = int(np.bincount(sr, minlength=t).max()) if len(sr) else 1
    out = []
    for name, fill, payload in fills_payloads:
        shape = (t + 1, m) + payload.shape[1:]
        if out_path is None:
            block = np.empty(shape, payload.dtype)
        else:
            block = np.lib.format.open_memmap(
                str(out_path / f"{name}.npy"), mode="w+", dtype=payload.dtype,
                shape=shape)
        block[...] = np.asarray(fill, payload.dtype)
        block[sr, rank] = payload[idxs[order]]
        out.append(block)
    return out


def _h2d(a, device, dtype, staging=None):
    """Host array -> tensor on ``device`` (float arrays take ``dtype``).
    With a ``staging`` list and a CUDA device the array goes through a
    pinned host buffer, appended to the list, and is copied ``non_blocking``
    on the current stream: the caller keeps the list until that stream has
    passed the copy. Otherwise the copy is synchronous."""
    if a is None:
        return None
    a = np.asarray(a)
    dt = dtype if a.dtype.kind == "f" else None
    if staging is None or torch.device(device).type != "cuda":
        return torch.as_tensor(a, dtype=dt, device=device)
    pinned = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                         pin_memory=True)
    pinned.numpy()[...] = a
    staging.append(pinned)
    return pinned.to(device=device, dtype=dt, non_blocking=True)


@dataclasses.dataclass
class HostTileMap:
    """Packed host tile map (tiles.py:296-506): the halo blocks, in RAM or
    disk-backed (:func:`load_tile_map`), and the active-window crops
    :meth:`crop_window` (a whole window) and :meth:`crop_entering_rows` (the
    rows an incremental shift brings in)."""

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

    def to_device(self, device=None, dtype=torch.float32, staging=None) -> TileMap:
        """The device :class:`TileMap` (window anchor zero). ``staging``: a
        list, for an asynchronous upload to the card through pinned buffers
        that the list keeps (see :func:`_h2d`)."""
        def cast(a):
            return _h2d(a, device, dtype, staging)

        return TileMap(
            halo_points=cast(self.halo_points),
            halo_point_cov=cast(self.halo_point_cov),
            halo_point_cov_mean=cast(self.halo_point_cov_mean),
            halo_vox_mean=cast(self.halo_vox_mean),
            halo_vox_cov=cast(self.halo_vox_cov),
            halo_vox_coord=cast(self.halo_vox_coord),
            voxel_size=self.voxel_size,
            tile_size=self.tile_size,
            tx0=self.tx0,
            ty0=self.ty0,
            tx_dim=self.tx_dim,
            ty_dim=self.ty_dim,
            origin=cast(np.asarray(self.world_offset, np.float64)),
        )

    def drop_page_cache(self):
        """Release file-backed pages of memmapped halo tensors (crops copy
        what they need; the touched pages would otherwise accumulate in RSS
        for the life of the process). No-op for RAM-backed maps."""
        import mmap as _mmap

        for a in (self.halo_points, self.halo_point_cov,
                  self.halo_point_cov_mean, self.halo_vox_mean,
                  self.halo_vox_cov, self.halo_vox_coord):
            mm = getattr(a, "_mmap", None)
            if mm is not None:
                try:
                    mm.madvise(_mmap.MADV_DONTNEED)
                except (AttributeError, OSError):
                    # keep evicting the OTHER tensors: one transiently
                    # failing madvise must not pin the rest in RSS
                    continue

    def window_anchor(self, center_xy, dims):
        """(x0, y0) tile anchor a crop_window at this centre would use,
        clamped at the map edges, where the window cannot follow the pose."""
        nx, ny = dims
        cx = int(np.floor(center_xy[0] / self.tile_size))
        cy = int(np.floor(center_xy[1] / self.tile_size))
        x0 = int(np.clip(cx - nx // 2, self.tx0, self.tx0 + self.tx_dim - nx))
        y0 = int(np.clip(cy - ny // 2, self.ty0, self.ty0 + self.ty_dim - ny))
        return x0, y0

    def window_rows(self, anchor, dims):
        """The full-map rows of the window with tile ``anchor`` and ``dims``,
        row-major, then the sentinel row; tiles off the map take the
        sentinel (tiles.py:440-447)."""
        nx, ny = dims
        t_full = self.tx_dim * self.ty_dim  # sentinel row index
        gx = np.arange(anchor[0] - self.tx0, anchor[0] - self.tx0 + nx)
        gy = np.arange(anchor[1] - self.ty0, anchor[1] - self.ty0 + ny)
        in_map = (gx[:, None] >= 0) & (gx[:, None] < self.tx_dim) \
            & (gy[None, :] >= 0) & (gy[None, :] < self.ty_dim)
        rows = np.where(in_map, gx[:, None] * self.ty_dim + gy[None, :], t_full)
        return np.concatenate([rows.reshape(-1), [t_full]])

    def _origin_offsets(self, anchor, offset_dtype=np.float32):
        """(coordinate shift, voxel-coordinate shift) for a window whose
        coordinate origin is tile ``anchor``. Quantized to the DEVICE dtype
        (a NumPy dtype): the same value must be subtracted here and added
        back by run_register's origin conjugation, or city-scale coordinates
        (~1e6 m, f32 ulp ~0.06 m) pick up a per-window pose bias."""
        off = np.array([anchor[0] * self.tile_size,
                        anchor[1] * self.tile_size])
        off = off.astype(offset_dtype).astype(np.float64)
        voff = (np.array(anchor)
                * int(round(self.tile_size / self.voxel_size)))
        return off, voff

    def _pack_rows(self, rows, off, voff):
        """Gather full-map halo rows ``rows`` (sentinel index allowed) and
        shift their coordinates into the origin frame (``off``, ``voff``):
        the shared part of :meth:`crop_window` (all window rows) and
        :meth:`crop_entering_rows` (the rows an incremental shift uploads)."""
        def sel(a):
            return None if a is None else a[rows]

        def shift_xy(a, o, sentinel=None):
            if a is None:
                return None
            a = a.copy()
            # padded entries (coord sentinel) KEEP their sentinel value: the
            # voxel searches test coords against _COORD_SENTINEL exactly,
            # and a shifted pad would read as occupied
            keep = None if sentinel is None else (a[..., 0] == sentinel)
            a[..., 0] -= o[0]
            a[..., 1] -= o[1]
            if keep is not None:
                a[keep] = sentinel
            return a

        return dict(
            halo_points=shift_xy(sel(self.halo_points), off),
            halo_point_cov=sel(self.halo_point_cov),
            halo_point_cov_mean=shift_xy(sel(self.halo_point_cov_mean), off),
            halo_vox_mean=shift_xy(sel(self.halo_vox_mean), off),
            halo_vox_cov=sel(self.halo_vox_cov),
            halo_vox_coord=shift_xy(sel(self.halo_vox_coord), voff,
                                    sentinel=_COORD_SENTINEL),
        )

    def crop_window(self, center_xy, radius_tiles: int,
                    dims: Optional[tuple] = None,
                    offset_dtype=np.float32) -> "HostTileMap":
        """Fixed-size active-window crop in WINDOW-LOCAL coordinates
        (tiles.py:410-461): the (2 radius_tiles + 1)^2 tiles around
        ``center_xy`` (``dims`` overrides the size), coordinates shifted by
        the window origin (``world_offset``, quantized to ``offset_dtype``),
        the grid anchored at tx0 = ty0 = 0, so every crop has the same
        static geometry. Out-of-map tiles take the sentinel row; halo rows
        keep their full-map contents, so results equal the full map for any
        query whose tile lies inside the window."""
        if dims is None:
            nx = min(2 * radius_tiles + 1, self.tx_dim)
            ny = min(2 * radius_tiles + 1, self.ty_dim)
        else:
            nx, ny = dims
        x0, y0 = self.window_anchor(center_xy, (nx, ny))
        off, voff = self._origin_offsets((x0, y0), offset_dtype)
        packed = self._pack_rows(self.window_rows((x0, y0), (nx, ny)), off, voff)
        return HostTileMap(
            **packed,
            voxel_size=self.voxel_size,
            tile_size=self.tile_size,
            tx0=0,
            ty0=0,
            tx_dim=nx,
            ty_dim=ny,
            world_offset=(float(off[0]), float(off[1])),
            halo_margin=self.halo_margin,
        )

    def crop_entering_rows(self, old_anchor, new_anchor, dims,
                           origin_anchor, r_pad: int,
                           offset_dtype=np.float32):
        """The rows an incremental window shift ``old_anchor ->
        new_anchor`` must upload (tiles.py:463-506): window rows (new
        layout) whose source tile was not resident before, their
        coordinates shifted by ``origin_anchor``, the FIXED origin of the
        incrementally maintained window (see :func:`shift_window`), so they
        are bit-identical to a fresh crop at that origin. Returns
        ``(dst_rows [r_pad] int32, payload dict)``; pad entries point past
        the sentinel row and the shift drops them."""
        nx, ny = dims
        dx = new_anchor[0] - old_anchor[0]
        dy = new_anchor[1] - old_anchor[1]
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        src_i, src_j = ii + dx, jj + dy
        entering = ((src_i < 0) | (src_i >= nx)
                    | (src_j < 0) | (src_j >= ny))
        wrows = np.nonzero(entering.reshape(-1))[0].astype(np.int32)
        if len(wrows) > r_pad:
            raise ValueError(
                f"entering rows {len(wrows)} exceed pad budget {r_pad} "
                f"(shift ({dx},{dy}) on {nx}x{ny})"
            )
        gx = new_anchor[0] + (wrows // ny) - self.tx0
        gy = new_anchor[1] + (wrows % ny) - self.ty0
        t_full = self.tx_dim * self.ty_dim
        in_map = ((gx >= 0) & (gx < self.tx_dim)
                  & (gy >= 0) & (gy < self.ty_dim))
        rows_full = np.where(in_map, gx * self.ty_dim + gy, t_full)
        off, voff = self._origin_offsets(origin_anchor, offset_dtype)
        packed = self._pack_rows(rows_full, off, voff)

        def pad(a):
            if a is None:
                return None
            out = np.zeros((r_pad,) + a.shape[1:], a.dtype)
            out[: len(a)] = a
            return out

        dst = np.full(r_pad, nx * ny + 1, np.int32)  # pad -> dropped
        dst[: len(wrows)] = wrows
        return dst, {k: pad(v) for k, v in packed.items()}


def build_tile_map(built: BuiltMap, tile_voxels: int = 4, storage_dir=None,
                   halo_margin: int = 1) -> HostTileMap:
    """Re-block a BuiltMap into per-tile halo candidate tensors (host side,
    tiles.py:173-266). ``storage_dir``: back the packed tensors with
    ``np.memmap`` files there (with a ``meta.json``) instead of RAM, as a
    city-scale map needs; reopen with :func:`load_tile_map`."""
    import json
    import pathlib

    out_path = None
    if storage_dir is not None:
        out_path = pathlib.Path(storage_dir)
        out_path.mkdir(parents=True, exist_ok=True)
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
            ("halo_vox_mean", np.inf, built.vox_mean.astype(np.float32)),
            ("halo_vox_cov", np.eye(3, dtype=np.float32),
             built.vox_cov.astype(np.float32)),
            ("halo_vox_coord", _COORD_SENTINEL, built.vox_coords.astype(np.int32)),
        ],
        out_path=out_path,
    )

    pt_mask = np.arange(m)[None, :] < built.counts[:, None]
    flat_pts = built.points[pt_mask].astype(np.float32)
    pt_vox = np.repeat(np.arange(v), m).reshape(v, m)[pt_mask]
    prows, pidxs = _halo_membership(
        built.vox_coords[pt_vox][:, :2], tile_voxels, tx0, ty0,
        tx_dim, ty_dim, margin=halo_margin)
    payloads = [("halo_points", np.inf, flat_pts)]
    has_cov = built.point_cov is not None
    if has_cov:
        payloads += [
            ("halo_point_cov", np.eye(3, dtype=np.float32),
             built.point_cov[pt_mask].astype(np.float32)),
            ("halo_point_cov_mean", np.inf,
             built.point_cov_mean[pt_mask].astype(np.float32)),
        ]
    packed = _pack_halo(prows, pidxs, t, payloads, out_path=out_path)

    if out_path is not None:
        meta = dict(voxel_size=float(vs), tile_size=float(ts), tx0=tx0,
                    ty0=ty0, tx_dim=tx_dim, ty_dim=ty_dim,
                    halo_margin=int(halo_margin), has_point_cov=has_cov)
        (out_path / "meta.json").write_text(json.dumps(meta))
        for b in packed + [halo_vox_mean, halo_vox_cov, halo_vox_coord]:
            b.flush()

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


def load_tile_map(storage_dir, mmap: bool = True) -> HostTileMap:
    """Reopen a tile map persisted by ``build_tile_map(storage_dir=...)``
    (tiles.py:269-293). With ``mmap`` (default) the halo tensors stay
    disk-backed and pages are read on demand: the host RSS of active-window
    serving is bounded by the window, not the map."""
    import json
    import pathlib

    p = pathlib.Path(storage_dir)
    meta = json.loads((p / "meta.json").read_text())
    meta.setdefault("halo_margin", 1)  # maps persisted before the margin field
    mode = "r" if mmap else None

    def ld(name):
        return np.load(str(p / f"{name}.npy"), mmap_mode=mode)

    has_cov = meta.pop("has_point_cov")
    return HostTileMap(
        halo_points=ld("halo_points"),
        halo_point_cov=ld("halo_point_cov") if has_cov else None,
        halo_point_cov_mean=ld("halo_point_cov_mean") if has_cov else None,
        halo_vox_mean=ld("halo_vox_mean"),
        halo_vox_cov=ld("halo_vox_cov"),
        halo_vox_coord=ld("halo_vox_coord"),
        **meta,
    )


# --------------------------------------------------------------------------- #
# Incremental window shift (K14): kernel N on the card
# --------------------------------------------------------------------------- #

#: a TileMap's tile-indexed tensors, in kernel N's table order
HALO_FIELDS = ("halo_points", "halo_point_cov", "halo_point_cov_mean",
               "halo_vox_mean", "halo_vox_cov", "halo_vox_coord")


def shift_sources(nx: int, ny: int, dx: int, dy: int, device=None):
    """[T+1] int64: the old row that each row of an (nx, ny) window shifted
    by (dx, dy) copies before the entering rows come in, the sentinel T for
    vacated rows and for the sentinel row itself (tiles.py:512-521)."""
    si = torch.arange(nx, device=device)[:, None] + dx
    sj = torch.arange(ny, device=device)[None, :] + dy
    ok = (si >= 0) & (si < nx) & (sj >= 0) & (sj < ny)
    lin = si * ny + sj
    src = torch.where(ok, lin, torch.full_like(lin, nx * ny)).reshape(-1)
    return torch.cat([src, src.new_full((1,), nx * ny)])


def shift_window_plain(tmap: TileMap, dx: int, dy: int, dst_rows, payload) -> TileMap:
    """Plain PyTorch version of kernel N (tiles.py:511-540): new row
    ``i ny + j`` copies old row ``(i + dx) ny + (j + dy)`` where that lies
    inside the window and the sentinel row otherwise (``index_select``),
    then payload row k overwrites row ``dst_rows[k]`` where that is at most
    T (``index_copy_``; pad entries point past the sentinel and are
    dropped); the sentinel row stays. The anchor moves by (dx, dy), the
    coordinate ``origin`` stays."""
    t = tmap.num_tiles
    src = shift_sources(tmap.tx_dim, tmap.ty_dim, dx, dy, tmap.halo_points.device)
    keep = dst_rows <= t
    rows = dst_rows[keep].long()

    def move(a, new):
        if a is None:
            return None
        out = a.index_select(0, src)
        out.index_copy_(0, rows, new[keep].to(a.dtype))
        return out

    moved = {f: move(getattr(tmap, f), payload[f]) for f in HALO_FIELDS}
    a0, a1 = tmap.tile_anchor
    return tmap.replace(**moved, tile_anchor=(a0 + dx, a1 + dy))


def shift_window(tmap: TileMap, dx: int, dy: int, dst_rows, payload) -> TileMap:
    """Move a resident window by (dx, dy) tiles without re-uploading it
    (tiles.py:546-562): the retained rows roll on the device, the entering
    rows of :meth:`HostTileMap.crop_entering_rows` (``dst_rows`` [r_pad]
    int32 and ``payload``, on the map's device) come in, and the anchor
    moves while the coordinate origin stays, so retained coordinates keep
    their bits and the result equals a fresh crop at that origin. Kernel N
    (csrc/window_shift.cu) writes the new window out of place on a CUDA
    map; :func:`shift_window_plain` runs on a CPU one."""
    if tmap.halo_points.device.type == "cpu":
        return shift_window_plain(tmap, dx, dy, dst_rows, payload)
    out = kernels.shift_window({f: getattr(tmap, f) for f in HALO_FIELDS},
                               tmap.tx_dim, tmap.ty_dim, dx, dy, dst_rows, payload)
    a0, a1 = tmap.tile_anchor
    return tmap.replace(**out, tile_anchor=(a0 + dx, a1 + dy))


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
    """Per-query voxel coords and tile id (tiles.py:582-603) on the grid
    from ``tmap.grid_origin`` (the window anchor included): the edge clamp
    keeps a query up to one voxel outside the grid on the edge tile, farther
    ones (and invalid rows) get the sentinel tile."""
    ax0, ay0 = tmap.grid_origin
    qv = torch.floor(div(queries, tmap.voxel_size)).to(torch.int32)
    tx = torch.floor(div(queries[:, 0], tmap.tile_size)).to(torch.int32) - ax0
    ty = torch.floor(div(queries[:, 1], tmap.tile_size)).to(torch.int32) - ay0
    tv = int(round(tmap.tile_size / tmap.voxel_size))
    in_reach = (
        (qv[:, 0] >= ax0 * tv - 1)
        & (qv[:, 0] <= (ax0 + tmap.tx_dim) * tv)
        & (qv[:, 1] >= ay0 * tv - 1)
        & (qv[:, 1] <= (ay0 + tmap.ty_dim) * tv)
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


def assign_slots_lanes_plain(tmap: TileMap, queries, valid,
                             budget: TileQueryBudget) -> SlotAssignment:
    """Plain lane form of kernel B: :func:`assign_slots_plain` on each lane
    of queries [B, N, 3] and valid [B, N] against the one map, stacked (a
    fleet frame's assignment, JAX's vmap of tiles.py:577)."""
    return stack_streams([assign_slots_plain(tmap, q, v, budget)
                          for q, v in zip(queries, valid)])


def assign_slots(tmap: TileMap, queries, valid,
                 budget: TileQueryBudget) -> SlotAssignment:
    """Tile-slot assignment; kernel B on CUDA, the plain version on CPU.
    With a leading lane axis on the queries and valid (a fleet frame) every
    field has one: kernel B's lane form, or
    :func:`assign_slots_lanes_plain`."""
    if queries.device.type == "cpu":
        plain = assign_slots_lanes_plain if queries.dim() == 3 else assign_slots_plain
        return plain(tmap, queries, valid, budget)
    ax0, ay0 = tmap.grid_origin
    out = kernels.assign_slots(
        queries, valid, budget.qb, budget.max_slots, voxel_size=tmap.voxel_size,
        tile_size=tmap.tile_size, tx0=ax0, ty0=ay0,
        tx_dim=tmap.tx_dim, ty_dim=tmap.ty_dim)
    return SlotAssignment(**out)


# --------------------------------------------------------------------------- #
# Nearest-point search on the slot layout
# --------------------------------------------------------------------------- #

def slot_centers(tmap: TileMap, slot_tile, dtype):
    """Per-slot tile-centre offsets (tiles.py:648-660): distances are taken
    on tile-local coordinates so f32 keeps its precision at map scale."""
    ax0, ay0 = tmap.grid_origin
    tx = (slot_tile // tmap.ty_dim + ax0).to(dtype)
    ty = (slot_tile % tmap.ty_dim + ay0).to(dtype)
    return torch.stack([(tx + 0.5) * tmap.tile_size, (ty + 0.5) * tmap.tile_size,
                        torch.zeros_like(tx)], dim=-1)


def _cube_argmin(q, qv, ctr, cand_safe, cvox, present):
    """Per query, the candidate with the least exact diff^2 distance inside
    the 27-voxel cube, on tile-local coordinates, the first index winning
    ties (tiles.py:663 ``_cube_mask`` + the argmin of :712/:803). ``q`` [C,QB,3]
    world queries, ``qv`` their voxels, ``cand_safe`` [C,M,3] world candidates
    (0 where not ``present``), ``cvox`` [C,M,3] their voxels. Returns
    (best_d2 [C,QB], best [C,QB]); best_d2 is +inf with no candidate."""
    cube = present[:, None, :]
    for d in range(3):
        cube = cube & (torch.abs(cvox[:, None, :, d] - qv[:, :, None, d]) <= 1)
    ql = q - ctr[:, None, :]
    cl = torch.where(present[..., None], cand_safe - ctr[:, None, :],
                     torch.zeros_like(cand_safe))
    d2 = sq_norm3(ql[:, :, None, :] - cl[:, None, :, :])       # [C,QB,M]
    d2 = torch.where(cube, d2, torch.full_like(d2, torch.inf))
    return torch.min(d2, dim=2)


def _take(rows, best):
    """rows [C,M,...] at index best [C,QB] -> [C,QB,...] (an exact copy)."""
    return rows[torch.arange(rows.shape[0], device=rows.device)[:, None], best]


def _eye_like(x):
    """Identity 3x3 broadcast to x [..., 3, 3]."""
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape)


def _chunks(s: int, budget: TileQueryBudget):
    chunk = max(1, min(budget.chunk, s))
    return [slice(lo, lo + chunk) for lo in range(0, s, chunk)]


def nearest_point_slots(tmap: TileMap, slot_tile, qbuf, qvox, qmask, max_dist,
                        budget: TileQueryBudget, *, with_point_cov: bool = False):
    """Per slot, the nearest finite halo point inside each query's exact
    27-voxel cube, on tile-local coordinates, first index winning ties, gated
    by ``d2 < max_dist^2`` (tiles.py:712-773). Returns (target [S,QB,3],
    ok [S,QB]); target is the query where not ok. With ``with_point_cov``
    (GICP) also (cov [S,QB,3,3], mean [S,QB,3]): the winner's covariance and
    neighbourhood mean, the identity and the query where not ok."""
    centers = slot_centers(tmap, slot_tile, qbuf.dtype)
    outs = []
    for sl in _chunks(slot_tile.shape[0], budget):
        q, qv, qm, ctr = qbuf[sl], qvox[sl], qmask[sl], centers[sl]
        tid = slot_tile[sl].long()
        cand = tmap.halo_points[tid]                            # [C,MHP,3]
        finite = torch.isfinite(cand[..., 0])
        cand_safe = torch.where(finite[..., None], cand, torch.zeros_like(cand))
        cvox = torch.floor(div(cand_safe, tmap.voxel_size)).to(torch.int32)
        best_d2, best = _cube_argmin(q, qv, ctr, cand_safe, cvox, finite)
        ok = qm & (best_d2 < max_dist * max_dist)
        out = [torch.where(ok[..., None], _take(cand_safe, best), q), ok]
        if with_point_cov:
            cov = _take(tmap.halo_point_cov[tid], best)
            mean = _take(tmap.halo_point_cov_mean[tid], best)
            out += [torch.where(ok[..., None, None], cov, _eye_like(cov)),
                    torch.where(ok[..., None], mean, q)]
        outs.append(out)
    return tuple(torch.cat(x) for x in zip(*outs))


def nearest_voxel_cov_slots(tmap: TileMap, slot_tile, qbuf, qvox, qmask,
                            max_dist, budget: TileQueryBudget):
    """VGICP search (tiles.py:803-845): per query, the occupied halo voxel of
    the 27-voxel cube (by stored voxel coords) whose mean is nearest, on
    tile-local coordinates, first index winning ties, gated by
    ``d2 < max_dist^2``. Returns (cov [S,QB,3,3], mean [S,QB,3], ok [S,QB]);
    the identity and the query where not ok."""
    centers = slot_centers(tmap, slot_tile, qbuf.dtype)
    outs = []
    for sl in _chunks(slot_tile.shape[0], budget):
        q, qv, qm, ctr = qbuf[sl], qvox[sl], qmask[sl], centers[sl]
        tid = slot_tile[sl].long()
        means = tmap.halo_vox_mean[tid]                          # [C,MHV,3]
        cvox = tmap.halo_vox_coord[tid]
        occupied = cvox[..., 0] != int(_COORD_SENTINEL)
        m_safe = torch.where(occupied[..., None], means, torch.zeros_like(means))
        best_d2, best = _cube_argmin(q, qv, ctr, m_safe, cvox, occupied)
        ok = qm & (best_d2 < max_dist * max_dist)
        cov = _take(tmap.halo_vox_cov[tid], best)
        outs.append((torch.where(ok[..., None, None], cov, _eye_like(cov)),
                     torch.where(ok[..., None], _take(m_safe, best), q), ok))
    return tuple(torch.cat(x) for x in zip(*outs))


def all_voxel_cov_slots(tmap: TileMap, slot_tile, qbuf, qvox, qmask, max_dist,
                        budget: TileQueryBudget):
    """AVGICP search (tiles.py:869-906): per query and each offset of
    ``OFFSETS_7``, the halo voxel whose stored coord equals ``qvox + off``
    (a coord occurs at most once per halo row), gated by
    ``d2 < max_dist^2`` with d2 in world coordinates. Returns
    (cov [S,QB,7,3,3], mean [S,QB,7,3], ok [S,QB,7]); the identity and the
    query where not ok."""
    off7 = torch.tensor(OFFSETS_7, dtype=torch.int32, device=qvox.device)
    outs = []
    for sl in _chunks(slot_tile.shape[0], budget):
        q, qv, qm = qbuf[sl], qvox[sl], qmask[sl]
        tid = slot_tile[sl].long()
        cvox = tmap.halo_vox_coord[tid]                          # [C,MHV,3]
        occupied = cvox[..., 0] != int(_COORD_SENTINEL)
        want = qv[:, :, None, :] + off7                          # [C,QB,7,3]
        eq = torch.all(cvox[:, None, None, :, :] == want[..., None, :], dim=-1)
        eq = eq & occupied[:, None, None, :]                     # [C,QB,7,MHV]
        found = torch.any(eq, dim=-1)
        idx = torch.argmax(eq.to(torch.int8), dim=-1).reshape(eq.shape[0], -1)
        means = tmap.halo_vox_mean[tid]
        m_safe = torch.where(occupied[..., None], means, torch.zeros_like(means))
        mean = _take(m_safe, idx).reshape(q.shape[:2] + (7, 3))
        mean = torch.where(found[..., None], mean, torch.zeros_like(mean))
        d2 = sq_norm3(mean - q[:, :, None, :])
        ok = qm[..., None] & found & (d2 < max_dist * max_dist)
        cov = _take(tmap.halo_vox_cov[tid], idx).reshape(q.shape[:2] + (7, 3, 3))
        outs.append((torch.where(ok[..., None, None], cov, _eye_like(cov)),
                     torch.where(ok[..., None], mean, q[:, :, None, :]), ok))
    return tuple(torch.cat(x) for x in zip(*outs))


# --------------------------------------------------------------------------- #
# One-shot queries in query order: kernel B, then A, E, F or G with matches
# --------------------------------------------------------------------------- #

#: the halo fields each one-shot query reads
_POINT_FIELDS = ("halo_points",)
_POINT_COV_FIELDS = ("halo_points", "halo_point_cov", "halo_point_cov_mean")
_VOXEL_FIELDS = ("halo_vox_mean", "halo_vox_cov", "halo_vox_coord")


def _need(tmap: TileMap, name: str, fields):
    """Raise as kernels E, F and G do (``kernels._halo_rows``) where the map
    lacks a field the query reads, on either route and before any launch."""
    for field in fields:
        if getattr(tmap, field) is None:
            raise ValueError(f"{name}: the tile map has no {field} "
                             "(build it with the covariances this method needs)")


def _max_dist(max_dist, queries):
    """``max_dist`` (a Python float or a 0-dim tensor) as a 0-dim tensor of
    the queries' dtype on their device (a fill, no host copy)."""
    if isinstance(max_dist, torch.Tensor):
        return max_dist.to(device=queries.device, dtype=queries.dtype).reshape(())
    return torch.full((), max_dist, dtype=queries.dtype, device=queries.device)


def _with_chunk(budget: TileQueryBudget, chunk):
    """The budget whose ``chunk`` the plain searches use: ``chunk`` when
    given (JAX's per-call override), else the budget's own."""
    return budget if chunk is None else dataclasses.replace(budget, chunk=chunk)


def scatter_back(n: int, qidx, *fields):
    """[S,QB,...] slot results -> [N,...] in query order (tiles.py:696-705):
    each ``(default, buf)`` gives ``default`` (a scalar or a tensor that
    broadcasts over a row) wherever no slot holds the query (dropped, or
    never assigned), ``buf``'s entry elsewhere. A scatter into n + 1 rows,
    the unused entries (``qidx == n``) landing in the last, then a slice:
    ``qidx`` is unique below n, so every kept row is written once and no
    mask or readback is needed."""
    idx = qidx.reshape(-1).long()
    outs = []
    for default, buf in fields:
        flat = buf.reshape((-1,) + buf.shape[2:])
        out = torch.empty((n + 1,) + flat.shape[1:], dtype=flat.dtype, device=flat.device)
        if isinstance(default, torch.Tensor):
            out.copy_(default)
        else:
            out.fill_(default)
        out.index_copy_(0, idx, flat)
        outs.append(out[:n])
    return outs


def _point_result(queries, qidx, res):
    """Kernel A's or the plain search's (target, ok[, cov, mean]) in query
    order; a target or mean that is not valid is the query itself, a
    covariance the identity (tiles.py:788-799)."""
    fields = [(0.0, res[0]), (False, res[1])]
    if len(res) > 2:
        eye = torch.eye(3, dtype=queries.dtype, device=queries.device)
        fields += [(eye, res[2]), (0.0, res[3])]
    out = scatter_back(queries.shape[0], qidx, *fields)
    ok = out[1][:, None]
    out[0] = torch.where(ok, out[0], queries)
    if len(res) > 2:
        out[3] = torch.where(ok, out[3], queries)
    return tuple(out)


def _voxel_result(queries, qidx, res):
    """A VGICP (cov, mean, ok) or AVGICP (cov [.., 7, 3, 3], ...) result in
    query order; a mean that is not valid is the query (tiles.py:858-866,
    :919-928)."""
    eye = torch.eye(3, dtype=queries.dtype, device=queries.device)
    cov, mean, ok = scatter_back(queries.shape[0], qidx, (eye, res[0]), (0.0, res[1]),
                                 (False, res[2]))
    q = queries if ok.dim() == 1 else queries[:, None, :]
    return cov, torch.where(ok[..., None], mean, q), ok


def query_nearest_point_plain(tmap: TileMap, queries, valid, max_dist,
                              budget: TileQueryBudget, *, with_point_cov: bool = False,
                              chunk: Optional[int] = None):
    """Plain version of :func:`query_nearest_point`: :func:`assign_slots_plain`,
    :func:`nearest_point_slots`, then :func:`scatter_back`."""
    _need(tmap, "query_nearest_point", _POINT_COV_FIELDS if with_point_cov else _POINT_FIELDS)
    asg = assign_slots_plain(tmap, queries, valid, budget)
    res = nearest_point_slots(tmap, asg.slot_tile, asg.qbuf, asg.qvox, asg.qmask,
                              _max_dist(max_dist, queries), _with_chunk(budget, chunk),
                              with_point_cov=with_point_cov)
    return _point_result(queries, asg.qidx, res)


def query_nearest_voxel_cov_plain(tmap: TileMap, queries, valid, max_dist,
                                  budget: TileQueryBudget, chunk: Optional[int] = None):
    """Plain version of :func:`query_nearest_voxel_cov`."""
    _need(tmap, "query_nearest_voxel_cov", _VOXEL_FIELDS)
    asg = assign_slots_plain(tmap, queries, valid, budget)
    res = nearest_voxel_cov_slots(tmap, asg.slot_tile, asg.qbuf, asg.qvox, asg.qmask,
                                  _max_dist(max_dist, queries), _with_chunk(budget, chunk))
    return _voxel_result(queries, asg.qidx, res)


def query_all_voxel_cov_plain(tmap: TileMap, queries, valid, max_dist,
                              budget: TileQueryBudget, chunk: Optional[int] = None):
    """Plain version of :func:`query_all_voxel_cov`."""
    _need(tmap, "query_all_voxel_cov", _VOXEL_FIELDS)
    asg = assign_slots_plain(tmap, queries, valid, budget)
    res = all_voxel_cov_slots(tmap, asg.slot_tile, asg.qbuf, asg.qvox, asg.qmask,
                              _max_dist(max_dist, queries), _with_chunk(budget, chunk))
    return _voxel_result(queries, asg.qidx, res)


def _card_search(tmap: TileMap, queries, valid, max_dist, budget: TileQueryBudget):
    """The card route's set-up: kernel B's assignment, then the arguments
    every search kernel takes after its halo rows: the slots, B's queries
    as the source at the identity pose (the kernels' transform passes them
    through exactly) and ``max_dist``."""
    asg = assign_slots(tmap, queries, valid, budget)
    eye = torch.eye(4, dtype=queries.dtype, device=queries.device)
    return asg, (asg.slot_tile, asg.qbuf, asg.qmask, eye, _max_dist(max_dist, queries))


def query_nearest_point(tmap: TileMap, queries, valid, max_dist, budget: TileQueryBudget,
                        *, with_point_cov: bool = False, chunk: Optional[int] = None):
    """Nearest map point within the exact 27-voxel cube of each query
    [N,3] (world, or a window's local coordinates), gated by ``max_dist``
    (tiles.py:776-800). Returns (target [N,3], valid [N]) plus, with
    ``with_point_cov`` (GICP), (cov [N,3,3], mean [N,3]); a target or mean
    that is not valid is the query, a covariance the identity. On CUDA
    tensors: kernel B, then kernel A's matches (and kernel E's covariance
    and mean with ``with_point_cov``), then :func:`scatter_back`; on CPU
    tensors :func:`query_nearest_point_plain`. ``chunk`` is the plain
    search's slots a step (JAX's API); a kernel takes every slot at once."""
    if queries.device.type == "cpu":
        return query_nearest_point_plain(tmap, queries, valid, max_dist, budget,
                                         with_point_cov=with_point_cov, chunk=chunk)
    _need(tmap, "query_nearest_point", _POINT_COV_FIELDS if with_point_cov else _POINT_FIELDS)
    asg, args = _card_search(tmap, queries, valid, max_dist, budget)
    geo = tmap.search_geometry
    _, tgt, ok = kernels.p2p_correspond(tmap.halo_points, *args, **geo, with_matches=True)
    res = (tgt, ok)
    if with_point_cov:
        # E writes no target: A's, on the same assignment (both first-index
        # argmins of the same exact distances, so E's ok is A's)
        _, cov, mean, _ = kernels.gicp_correspond(
            tmap.halo_points, tmap.halo_point_cov, tmap.halo_point_cov_mean, *args, **geo,
            with_matches=True)
        res += (cov, mean)
    return _point_result(queries, asg.qidx, res)


def query_nearest_voxel_cov(tmap: TileMap, queries, valid, max_dist,
                            budget: TileQueryBudget, chunk: Optional[int] = None):
    """VGICP: the covariance and mean of the 27-cube voxel whose mean is
    nearest (tiles.py:848-866). Returns (cov [N,3,3], mean [N,3],
    valid [N]); a mean that is not valid is the query. Kernel B then kernel
    F's matches on CUDA tensors, :func:`query_nearest_voxel_cov_plain` on
    CPU ones."""
    if queries.device.type == "cpu":
        return query_nearest_voxel_cov_plain(tmap, queries, valid, max_dist, budget, chunk)
    _need(tmap, "query_nearest_voxel_cov", _VOXEL_FIELDS)
    asg, args = _card_search(tmap, queries, valid, max_dist, budget)
    res = kernels.vgicp_correspond(tmap.halo_vox_mean, tmap.halo_vox_cov, tmap.halo_vox_coord,
                                   *args, **tmap.search_geometry, with_matches=True)
    return _voxel_result(queries, asg.qidx, res[1:])


def query_all_voxel_cov(tmap: TileMap, queries, valid, max_dist,
                        budget: TileQueryBudget, chunk: Optional[int] = None):
    """AVGICP: the 7 face-adjacent voxels' covariances and means where they
    exist and pass the distance gate (tiles.py:909-928). Returns
    (cov [N,7,3,3], mean [N,7,3], valid [N,7]); a mean that is not valid is
    the query. Kernel B then kernel G's matches on CUDA tensors,
    :func:`query_all_voxel_cov_plain` on CPU ones."""
    if queries.device.type == "cpu":
        return query_all_voxel_cov_plain(tmap, queries, valid, max_dist, budget, chunk)
    _need(tmap, "query_all_voxel_cov", _VOXEL_FIELDS)
    asg, args = _card_search(tmap, queries, valid, max_dist, budget)
    res = kernels.avgicp_correspond(tmap.halo_vox_mean, tmap.halo_vox_cov,
                                    tmap.halo_vox_coord, *args,
                                    voxel_size=tmap.voxel_size, with_matches=True)
    return _voxel_result(queries, asg.qidx, res[1:])
