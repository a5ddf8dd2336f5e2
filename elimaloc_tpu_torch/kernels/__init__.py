"""Launch wrappers of the hand-written CUDA kernels (csrc/*.cu).

Each wrapper checks device, dtype (float32 only), shape and contiguity,
allocates its outputs, launches on PyTorch's current stream, raises on a
non-zero ``cudaGetLastError`` and adds one to its entry of :data:`launches`.
The callers (deskew.py, map/grid.py, map/tiles.py, register/icp.py) run the
plain PyTorch version for a CPU tensor and one of these for any other; a
non-CUDA tensor that reaches a wrapper raises.

========  ==================  ===================================================
kernel    wrapper             replaces (JAX package)
========  ==================  ===================================================
A         p2p_correspond      map/tiles.py:nearest_point_slots + icp._p2p_tail
B         assign_slots        map/tiles.py:assign_slots
C         voxel_downsample    map/grid.py:voxel_downsample
D         deskew              deskew.py:_find_rotation_batch + deskew_points
========  ==================  ===================================================
"""

from __future__ import annotations

import ctypes

import torch

from .build import library

#: launches per kernel since the last :func:`reset_launches`
launches = {"p2p_correspond": 0, "assign_slots": 0, "voxel_downsample": 0,
            "deskew": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(t, name, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} required, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} required, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")
    return ctypes.c_void_p(t.data_ptr())


def _scalar(v, like, dtype=torch.float32):
    """A device scalar for ``v`` (kept as is when already one)."""
    return torch.as_tensor(v, dtype=dtype, device=like.device).reshape(())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def deskew(points, rel_times, valid, info, bug_compat_z: bool):
    """Kernel D: every point to the scan-end frame (deskew.deskew_points)."""
    n = points.shape[0]
    w = info.imu_time.shape[0]
    f32 = torch.float32
    args = [
        _check(points, "points", f32, (n, 3)),
        _check(rel_times, "rel_times", f32, (n,)),
        _check(valid, "valid", torch.bool, (n,)),
        ctypes.c_int(n),
        _check(info.imu_time, "imu_time", f32, (w,)),
        _check(info.imu_rot, "imu_rot", f32, (w, 3)),
        _check(info.imu_included, "imu_included", torch.bool, (w,)),
        ctypes.c_int(w),
        _check(info.last_idx, "last_idx", torch.int64, ()),
        _check(info.odom_incre, "odom_incre", f32, (3,)),
        _check(info.scan_cur, "scan_cur", f32, ()),
        _check(info.scan_end, "scan_end", f32, ()),
        _check(info.imu_available, "imu_available", torch.bool, ()),
        _check(info.odom_available, "odom_available", torch.bool, ()),
        ctypes.c_int(int(bug_compat_z)),
    ]
    out = torch.empty_like(points)
    rc = library().elm_deskew(*args, ctypes.c_void_p(out.data_ptr()),
                              _stream(points))
    _raise_on(rc, "deskew")
    launches["deskew"] += 1
    return out


def voxel_downsample(points, valid, voxel_size, out_size: int):
    """Kernel C (map.grid.voxel_downsample): (points [out,3], valid [out],
    kept). ``torch.sort(stable=True)`` orders the keys between its two
    launches."""
    n = points.shape[0]
    f32 = torch.float32
    voxel = _scalar(voxel_size, points)
    p_pts = _check(points, "points", f32, (n, 3))
    p_valid = _check(valid, "valid", torch.bool, (n,))
    key = torch.empty(n, dtype=torch.int64, device=points.device)
    coords = torch.empty((n, 3), dtype=torch.int32, device=points.device)
    lib = library()
    stream = _stream(points)
    rc = lib.elm_voxel_keys(p_pts, p_valid, ctypes.c_int(n),
                            _check(voxel, "voxel_size", f32, ()),
                            ctypes.c_void_p(key.data_ptr()),
                            ctypes.c_void_p(coords.data_ptr()), stream)
    _raise_on(rc, "voxel_keys")
    _, perm = torch.sort(key, stable=True)
    out = torch.zeros((out_size, 3), dtype=f32, device=points.device)
    out_valid = torch.empty(out_size, dtype=torch.bool, device=points.device)
    kept = torch.empty((), dtype=torch.int64, device=points.device)
    rc = lib.elm_voxel_compact(
        p_pts, p_valid, ctypes.c_void_p(coords.data_ptr()),
        ctypes.c_void_p(perm.data_ptr()), ctypes.c_int(n), ctypes.c_int(out_size),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(out_valid.data_ptr()),
        ctypes.c_void_p(kept.data_ptr()), stream)
    _raise_on(rc, "voxel_compact")
    launches["voxel_downsample"] += 1
    return out, out_valid, kept


def assign_slots(queries, valid, qb: int, max_slots: int, *, voxel_size,
                 tile_size, tx0, ty0, tx_dim, ty_dim):
    """Kernel B (map.tiles.assign_slots): the SlotAssignment fields as a
    dict. ``torch.sort(stable=True)`` orders the tile keys between its two
    launches."""
    n = queries.shape[0]
    s = max_slots
    dev = queries.device
    t_sent = tx_dim * ty_dim
    p_q = _check(queries, "queries", torch.float32, (n, 3))
    p_valid = _check(valid, "valid", torch.bool, (n,))
    qv = torch.empty((n, 3), dtype=torch.int32, device=dev)
    tile = torch.empty(n, dtype=torch.int64, device=dev)
    lib = library()
    stream = _stream(queries)
    tv = int(round(tile_size / voxel_size))
    rc = lib.elm_tile_keys(
        p_q, p_valid, ctypes.c_int(n), ctypes.c_float(voxel_size),
        ctypes.c_float(tile_size), ctypes.c_int(tv), ctypes.c_int(tx0),
        ctypes.c_int(ty0), ctypes.c_int(tx_dim), ctypes.c_int(ty_dim),
        ctypes.c_void_p(qv.data_ptr()), ctypes.c_void_p(tile.data_ptr()), stream)
    _raise_on(rc, "tile_keys")
    st, perm = torch.sort(tile, stable=True)
    out = dict(
        qbuf=torch.zeros((s, qb, 3), dtype=torch.float32, device=dev),
        qvox=torch.zeros((s, qb, 3), dtype=torch.int32, device=dev),
        qmask=torch.zeros((s, qb), dtype=torch.bool, device=dev),
        qidx=torch.full((s, qb), n, dtype=torch.int32, device=dev),
        slot_tile=torch.full((s,), t_sent, dtype=torch.int32, device=dev),
        dropped=torch.zeros((), dtype=torch.int64, device=dev),
    )
    rc = lib.elm_assign_scatter(
        p_q, ctypes.c_void_p(qv.data_ptr()), ctypes.c_void_p(perm.data_ptr()),
        ctypes.c_void_p(st.data_ptr()), ctypes.c_int(n), ctypes.c_int(qb),
        ctypes.c_int(s), ctypes.c_longlong(t_sent),
        *(ctypes.c_void_p(out[k].data_ptr())
          for k in ("qbuf", "qvox", "qmask", "qidx", "slot_tile", "dropped")),
        stream)
    _raise_on(rc, "assign_scatter")
    launches["assign_slots"] += 1
    return out


#: order of kernel A's sums: sum w, sum w p (3), sum w p p^T (xx xy xz yy yz
#: zz), sum w r (3), sum w p x r (3), fitness numerator, matched count
P2P_SUMS = 18


def p2p_correspond(halo_points, slot_tile, sbuf, qmask, pose, max_dist, *,
                   voxel_size, tile_size, tx0, ty0, ty_dim,
                   with_matches: bool = False):
    """Kernel A (icp.p2p_search_reduce): the [18] P2P sums of one GN
    iteration at ``pose``, plus (tgt [S,QB,3], ok [S,QB]) when
    ``with_matches``."""
    s, qb = qmask.shape
    if qb < 8 or qb > 256 or qb & (qb - 1):
        raise ValueError(f"p2p_correspond: qb must be a power of two in [8, 256], got {qb}")
    t1, mhp = halo_points.shape[:2]
    f32 = torch.float32
    dev = sbuf.device
    args = [
        _check(halo_points, "halo_points", f32, (t1, mhp, 3)),
        ctypes.c_int(mhp),
        _check(slot_tile, "slot_tile", torch.int32, (s,)),
        _check(sbuf, "sbuf", f32, (s, qb, 3)),
        _check(qmask, "qmask", torch.bool, (s, qb)),
        ctypes.c_int(s), ctypes.c_int(qb),
        _check(pose, "pose", f32, (4, 4)),
        _check(max_dist, "max_dist", f32, ()),
        ctypes.c_float(voxel_size), ctypes.c_float(tile_size),
        ctypes.c_int(tx0), ctypes.c_int(ty0), ctypes.c_int(ty_dim),
    ]
    partials = torch.empty((s, P2P_SUMS), dtype=f32, device=dev)
    sums = torch.empty(P2P_SUMS, dtype=f32, device=dev)
    tgt = ok = None
    if with_matches:
        tgt = torch.empty((s, qb, 3), dtype=f32, device=dev)
        ok = torch.empty((s, qb), dtype=torch.bool, device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    rc = library().elm_p2p_search_reduce(
        *args, ptr(partials), ptr(sums), ptr(tgt), ptr(ok), _stream(sbuf))
    _raise_on(rc, "p2p_correspond")
    launches["p2p_correspond"] += 1
    return sums, tgt, ok
