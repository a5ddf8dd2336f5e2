"""Launch wrappers of the hand-written CUDA kernels (csrc/*.cu).

Each wrapper checks device, dtype (float32 only), shape and contiguity,
allocates its outputs, launches on PyTorch's current stream, raises on a
non-zero ``cudaGetLastError`` and adds one to its entry of :data:`launches`.
The callers (deskew.py, map/grid.py, map/tiles.py, register/icp.py,
ekf/filter.py, pipeline/rings.py, pipeline/runtime.py) run the plain
PyTorch version for a CPU tensor and one of these for any other; a
non-CUDA tensor that reaches a wrapper raises. Every kernel runs on every
path of the fused frame (P2P, GICP, VGICP, AVGICP, and any of them with
GPS + CAN) and of the event loop except the method's loop kernel on the
tile backend (p2p_register, gicp_register, vgicp_register,
avgicp_register: one of them a path), N, U, V and X, kernel W, which runs
only for CAN and GPS, the one-iteration entries A, E, F, G, Q and M, which
launch on no replay path (a loop kernel runs their slot code and M's step
every iteration; they stay as the reference each loop is held to), though
A, E, F and G, after B, also serve the tile map's one-shot queries with
their matches (map/tiles.py: query_nearest_point, query_nearest_voxel_cov,
query_all_voxel_cov), L, whose body runs inside S, D and K, whose bodies run
inside T, O and J, which launch on no replay path (U runs O's body and
J's push, V H's IMU intake; they stay as U's and V's reference; J is also
the card form of pipeline.rings.push_ego / push_imu), and I and P,
which launch on no path either (W and X, their redesigns, are held to
them bit for bit). Q's lookup entry, Y and Z serve the grid's own
functions (lookup, the queries, the ground probe) and run on no replay
path; Q's query entry and R, which Y and Z redesign and are held to bit
for bit, launch on none at all.

========  ==================  ===================================================
kernel    wrapper             replaces (JAX package)
========  ==================  ===================================================
A + M     p2p_register        register/icp.py:run_register's lax.while_loop for
                              P2P on the tile backend: A's search and partials,
                              the reduction and M's step every iteration, the
                              termination test; one cooperative launch per
                              registration, no readback
E + M     gicp_register       register/icp.py:run_register's lax.while_loop for
                              GICP on the tile backend (the radar form too):
                              E's search and partials, the reduction and M's
                              step (local_cov exported) every iteration; one
                              cooperative launch per registration, no readback
F + M     vgicp_register      the same for VGICP: F's search and partials, the
                              reduction and M's step every iteration
G + M     avgicp_register     register/icp.py:run_register's lax.while_loop for
                              AVGICP on the tile backend (the radar form too):
                              G's search and partials, the reduction and M's
                              step every iteration; one cooperative launch per
                              registration, no readback
Q + M     hash_register       register/icp.py:run_register's lax.while_loop on
                              the hash backend, every method and radar form:
                              Q's search from the current pose and partials,
                              the reduction and M's step every iteration; one
                              cooperative launch per registration, no readback
A         p2p_correspond      map/tiles.py:nearest_point_slots + icp._p2p_tail,
                              one GN iteration (the loop's reference; its slot
                              code runs inside p2p_register)
B         assign_slots        map/tiles.py:assign_slots
C         voxel_downsample    map/grid.py:voxel_downsample
D         deskew              deskew.py:_find_rotation_batch + deskew_points
                              (kernel T's reference; its body runs inside T)
E         gicp_correspond     tiles.nearest_point_slots(with_point_cov) +
                              icp._gicp_tail, one GN iteration (the loop's
                              reference; its slot code runs inside
                              gicp_register)
F         vgicp_correspond    tiles.nearest_voxel_cov_slots + icp._voxcov_tail,
                              one GN iteration (the loop's reference; its slot
                              code runs inside vgicp_register)
G         avgicp_correspond   tiles.all_voxel_cov_slots + icp._avg_voxcov_tail,
                              one GN iteration (the loop's reference; its slot
                              code runs inside avgicp_register)
H         imu_stage           pipeline/runtime.py:imu_subbatch, the whole IMU stage:
                              frames.imu_to_ego, the predict_imu chain, the
                              ego rows and both rings' batch pushes
I         ekf_update          filter._ekf_measurement_update + update_gnss +
                              update_can (kernel W's reference for the CAN /
                              GPS sub-batches; its PCM leg is kernel S's)
J         ring_push           pipeline/rings.py:_push_arrays_batch into one ring
                              (kernel U's and V's reference; its body runs
                              inside H, U and V); push_ego / push_imu's one
                              row (rings.py:106, 116)
K         scan_ring_query     deskew.py:make_deskew_info + rings.get_interpolated_pose
                              + the initial guess's compose (runtime.py:338)
                              (kernel T's reference; its body runs inside T)
L         pcm_measurement     runtime.shape_icp_covariance +
                              rings.gnss_time_compensation + scan_step's glue
                              (kernel S's reference; its body runs inside S)
M         gn_step             register/icp.py:_solve_step + _step_transform + the
                              GN loop body (compose, so3_log, the gates), one
                              step (the loops' reference); its step
                              (gn_step.cuh) runs inside every loop kernel
N         shift_window        map/tiles.py:_shift_window_impl (shift_window), the
                              incremental move of an active map window
O         ca_tick             ekf/filter.py:predict (the CA tick of use_imu=False)
                              + its ego-ring entry (kernel U's reference; its
                              body runs inside U)
P         radar_cov           register/icp.py:radar_point_cov + the slot packing
                              of run_register (kernel X's reference)
Q         hash_correspond     map/grid.py:lookup + query_* + icp._iteration (the
                              hash backend's search fused with the method's GN
                              reduction, one GN iteration: the loop's
                              reference; its body runs inside hash_register)
Q         hash_query          map/grid.py:query_nearest_point(_cov),
                              query_nearest_voxel_cov, query_all_voxel_cov
                              (kernel Y's reference, one thread a query)
Q         hash_lookup         map/grid.py:lookup
R         ground_height       map/grid.py:find_ground_height (kernel Z's
                              reference: the whole [V, M] plane, two
                              launches)
S         pcm_stage           runtime.pcm_stage_plain: the scan's end, L's PCM
                              measurement, I's PCM update and the fused
                              frame's epilogue (the ego pose, P's asymmetry
                              and smallest diagonal), one launch a scan
T         scan_front          runtime.scan_front_plain: the scan's front, the
                              delayed stamp, the range gate, the scan times,
                              K's ring queries and D's deskew, one host call
                              (two launches) a scan
U         tick_stage          ekf.filter.tick_stage_plain: the tick mode's CA
                              tick (O's body) and the push of its row into the
                              ego ring (J's push), one launch a tick
                              (runtime.tick_step)
V         imu_intake          pipeline.rings.imu_intake_plain: the tick mode's
                              IMU-only intake, the sample rotated and pushed
                              into the IMU ring (H's CTA-1 work), one launch
                              an IMU sample (runtime.imu_ring_step)
W         can_gps_update      ekf.filter.update_chain_plain without a PCM pose:
                              a frame's CAN then GPS sub-batch (or one CAN /
                              GPS event), kernel I's CAN and GPS legs
                              redesigned (m a template parameter, inputs in
                              shared memory, three barriers an update), one
                              launch a call
X         radar_rows          register/icp.py:radar_slots_plain: kernel P
                              redesigned, and the hash backend's rows in query
                              order with no index or mask tensor, one launch
                              a radar registration
Y         grid_query          map/grid.py:query_nearest_point(_cov),
                              query_nearest_voxel_cov, query_all_voxel_cov:
                              Q's query entry redesigned (a warp a query,
                              the 27 probe windows in parallel, the
                              candidates read 32 at a time; AVGICP 8 lanes a
                              query), one launch a query call
Z         ground_probe        map/grid.py:find_ground_height: R redesigned
                              (only the slots below each voxel's count, the
                              CTAs' lists merged by the last CTA), one launch
                              a call
========  ==================  ===================================================

Kernel N runs only on the active-window path (``map_window_radius``), U and
V only in the event loop's tick mode (``use_imu=False``), X once per registration
with ``use_radar_cov``. On the hash backend (``backend="hash"``) Q takes the
place of B and of A, E, F, G (inside hash_register on the registration
path); its lookup entry, Y (the queries) and Z (the
ground probe) serve the grid's own functions. H, I, O, S, U and W take and give the EKF state as one packed
record and read the parameters from one (``ekf.state``): a state whose
fields are not the views of one record is packed first, and counted in
:data:`packs`; they return ``ekf.state.RecordState``, whose fields are
viewed only when read. Flagged forms: H, I, S and W take ``EkfFlags.joseph_form``
(the Joseph-form covariance update), E, F and G a slot-packed ``radar``
(kernel X's output) and Q a ``radar`` in query order, added before their
3x3 inverse.

Lane forms (the fleet frame of ``run_fused_fleet``, JAX
parallel/sharding.py:256-281): H, T, C, B, S, W, X and every loop kernel
(the P2P, GICP, VGICP and AVGICP loops and the hash loop, with and without
a radar term) take a leading lane axis on their per-frame inputs (B frames
of one fleet, one launch of each for all lanes; T's two launches once
each; a loop's launch takes at most :data:`MAX_LANES` lanes), the EKF
state as B records of one buffer and the rings with a lane axis; their
outputs carry it too. One lane is the single launch's form, bit for bit;
the wrappers tell the forms apart by the inputs' rank.
"""

from __future__ import annotations

import ctypes
import dataclasses
import operator

import torch

from ..ekf import state as ekf_state
from .build import library

#: launches per kernel since the last :func:`reset_launches`
launches = {"p2p_register": 0, "p2p_correspond": 0, "assign_slots": 0,
            "voxel_downsample": 0, "deskew": 0, "gicp_correspond": 0, "vgicp_correspond": 0,
            "avgicp_correspond": 0, "imu_stage": 0, "ekf_update": 0, "ring_push": 0,
            "scan_ring_query": 0, "scan_front": 0, "pcm_measurement": 0, "pcm_stage": 0,
            "gn_step": 0, "shift_window": 0, "ca_tick": 0, "radar_cov": 0,
            "hash_correspond": 0, "hash_query": 0, "hash_lookup": 0, "ground_height": 0,
            "gicp_register": 0, "vgicp_register": 0, "avgicp_register": 0,
            "hash_register": 0, "tick_stage": 0, "imu_intake": 0, "can_gps_update": 0,
            "radar_rows": 0, "grid_query": 0, "ground_probe": 0}


#: EKF states and params packed into a fresh record (``ekf.state.pack_state``,
#: ``pack_params``) since the last :func:`reset_launches`
packs = ekf_state.packs


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for k in packs:
        packs[k] = 0


def _check(t, name, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} required, got {t.dtype}")
    if shape is not None and t.shape != tuple(shape):
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
    if rc == NO_CLUSTER:
        raise RuntimeError(f"{name}: cudaOccupancyMaxActiveClusters finds no room for "
                           f"the sort's {SORT_CTAS}-CTA cluster on this card")
    if rc == NO_COOPERATIVE:
        raise RuntimeError(f"{name}: this card cannot launch a cooperative kernel "
                           "(cudaDevAttrCooperativeLaunch is 0)")
    if rc == NO_ROOM:
        raise RuntimeError(f"{name}: cudaOccupancyMaxActiveBlocksPerMultiprocessor finds "
                           "no room for one CTA of the loop kernel")
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


#: the sort of kernels B and C (csrc/sort.cuh): CTAs of its one cluster, and
#: the most tiles (T + 1) whose per-tile tables kernel B keeps in shared
#: memory (csrc/assign.cu kSharedTiles); beyond, the wrapper gives it a
#: global scratch of 3 tables of T + 1 ints per CTA
SORT_CTAS = 16
SHARED_TILES = 8192
#: what a sorting kernel's entry returns when no such cluster fits the card
#: (csrc/sort.cuh kNoCluster)
NO_CLUSTER = -1
#: what a loop entry (the P2P, AVGICP and hash loops) returns when the card
#: has no cooperative launch, or when no CTA of the loop kernel fits an SM
#: (csrc/gn_loop.cuh kNoCooperative, kNoRoom)
NO_COOPERATIVE = -2
NO_ROOM = -3
#: the most lanes one launch of a loop's lane form takes (csrc/gn_loop.cuh
#: kMaxLanes); ``register.icp.run_register_lanes`` runs a larger fleet
#: frame's registrations in launches of at most this many lanes
MAX_LANES = 128


def voxel_downsample(points, valid, voxel_size, out_size: int):
    """Kernel C (map.grid.voxel_downsample): (points [out,3], valid [out],
    kept), one launch: keys, the cluster's radix sort and the compaction.
    The lane form: points [B, n, 3] and valid [B, n] give [B, out, 3],
    [B, out] and kept [B], one cluster a lane in the one launch."""
    lanes, lead = _lanes(points, 2)
    n = points.shape[-2]
    f32 = torch.float32
    dev = points.device
    voxel = _scalar(voxel_size, points)
    args = [_check(points, "points", f32, lead + (n, 3)),
            _check(valid, "valid", torch.bool, lead + (n,)), ctypes.c_int(n),
            _check(voxel, "voxel_size", f32, ()), ctypes.c_int(out_size),
            ctypes.c_int(lanes or 1)]
    scratch = torch.empty(4 * n * (lanes or 1), dtype=torch.int32, device=dev)
    out = torch.empty(lead + (out_size, 3), dtype=f32, device=dev)
    out_valid = torch.empty(lead + (out_size,), dtype=torch.bool, device=dev)
    kept = torch.empty(lead, dtype=torch.int64, device=dev)
    rc = library().elm_voxel_downsample(*args, _ptr(scratch), _ptr(out), _ptr(out_valid),
                                        _ptr(kept), _stream(points))
    _raise_on(rc, "voxel_downsample")
    launches["voxel_downsample"] += 1
    return out, out_valid, kept


def assign_slots(queries, valid, qb: int, max_slots: int, *, voxel_size,
                 tile_size, tx0, ty0, tx_dim, ty_dim):
    """Kernel B (map.tiles.assign_slots): the SlotAssignment fields as a
    dict, one launch: tile keys, the cluster's radix sort on them, the
    per-tile slot arithmetic and the scatter (every entry written). The
    lane form: queries [B, n, 3] and valid [B, n] give every field with a
    leading lane axis (``dropped`` [B]), one cluster a lane in the one
    launch, on one tile geometry."""
    lanes, lead = _lanes(queries, 2)
    n = queries.shape[-2]
    s = max_slots
    dev = queries.device
    t_sent = tx_dim * ty_dim
    args = [_check(queries, "queries", torch.float32, lead + (n, 3)),
            _check(valid, "valid", torch.bool, lead + (n,)), ctypes.c_int(n),
            ctypes.c_float(voxel_size), ctypes.c_float(tile_size),
            ctypes.c_int(int(round(tile_size / voxel_size))), ctypes.c_int(tx0),
            ctypes.c_int(ty0), ctypes.c_int(tx_dim), ctypes.c_int(ty_dim),
            ctypes.c_int(qb), ctypes.c_int(s), ctypes.c_int(lanes or 1)]
    scratch = torch.empty(4 * n * (lanes or 1), dtype=torch.int32, device=dev)
    table = (None if t_sent + 1 <= SHARED_TILES else
             torch.empty((lanes or 1) * SORT_CTAS * 3 * (t_sent + 1), dtype=torch.int32,
                         device=dev))
    out = dict(
        qbuf=torch.empty(lead + (s, qb, 3), dtype=torch.float32, device=dev),
        qvox=torch.empty(lead + (s, qb, 3), dtype=torch.int32, device=dev),
        qmask=torch.empty(lead + (s, qb), dtype=torch.bool, device=dev),
        qidx=torch.empty(lead + (s, qb), dtype=torch.int32, device=dev),
        slot_tile=torch.empty(lead + (s,), dtype=torch.int32, device=dev),
        dropped=torch.empty(lead, dtype=torch.int64, device=dev),
    )
    rc = library().elm_assign_slots(*args, _ptr(scratch), _ptr(table),
                                    *(_ptr(v) for v in out.values()), _stream(queries))
    _raise_on(rc, "assign_slots")
    launches["assign_slots"] += 1
    return out


def _qb_of(qmask, name):
    s, qb = qmask.shape
    if qb < 8 or qb > 256 or qb & (qb - 1):
        raise ValueError(f"{name}: qb must be a power of two in [8, 256], got {qb}")
    return s, qb


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _lanes(t, single_dim: int):
    """(lanes, the leading shape) of a wrapper's input ``t``: None and ()
    when it has its single form's rank ``single_dim``, else its first
    extent and (that extent,)."""
    if t.dim() == single_dim:
        return None, ()
    if t.dim() != single_dim + 1 or t.shape[0] < 1:
        raise ValueError(f"rank {single_dim} or a leading lane axis required, got "
                         f"{tuple(t.shape)}")
    return t.shape[0], (t.shape[0],)


def _lane_vec(t, name, dtype, lanes):
    """(pointer, element stride) of a [lanes] vector that may be a strided
    view (kernel T's scalars in its lane outputs); a 0-d tensor for the
    single form."""
    if not t.is_cuda:
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} required, got {t.dtype}")
    want = () if lanes is None else (lanes,)
    if t.shape != want:
        raise ValueError(f"{name}: shape {want} required, got {tuple(t.shape)}")
    return ctypes.c_void_p(t.data_ptr()), ctypes.c_int(t.stride(0) if lanes else 0)


#: order of kernel A's sums: sum w, sum w p (3), sum w p p^T (xx xy xz yy yz
#: zz), sum w r (3), sum w p x r (3), fitness numerator, matched count
P2P_SUMS = 18


def p2p_correspond(halo_points, slot_tile, sbuf, qmask, pose, max_dist, *,
                   voxel_size, tile_size, tx0, ty0, ty_dim,
                   with_matches: bool = False):
    """Kernel A (icp.p2p_search_reduce_plain): the [18] P2P sums of one GN
    iteration at ``pose``, plus (tgt [S,QB,3], ok [S,QB]) when
    ``with_matches``."""
    s, qb = _qb_of(qmask, "p2p_correspond")
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
    rc = library().elm_p2p_search_reduce(
        *args, _ptr(partials), _ptr(sums), _ptr(tgt), _ptr(ok), _stream(sbuf))
    _raise_on(rc, "p2p_correspond")
    launches["p2p_correspond"] += 1
    return sums, tgt, ok


#: order of kernels E/F/G's sums: J^T M J blocks tl, tr, bl, br (3x3
#: row-major each), J^T M r top and bottom, fitness numerator, matched count
GN_SUMS = 44


def _halo_rows(name, rows):
    """The checked halo inputs (``rows``: (name, tensor, dtype, trailing
    shape), one map row each) and the row length, as kernels E, F and G and
    their loops take them."""
    for field, t, _, _ in rows:
        if t is None:
            raise ValueError(f"{name}: the tile map has no {field} "
                             "(build it with the covariances this method needs)")
    t1, m = rows[0][1].shape[:2]
    return [_check(t, n, dt, (t1, m) + tail) for n, t, dt, tail in rows] + [ctypes.c_int(m)]


def _cov_search(name, entry, rows, slot_tile, sbuf, qmask, pose, max_dist,
                geometry, with_matches, pairs, radar):
    """Shared launch of kernels E, F and G: ``rows`` are the (name, tensor,
    dtype, trailing shape) halo inputs of one map row each; ``pairs`` is 7
    for AVGICP's per-offset matches, 0 for one match per query; ``radar``
    the slot-packed radar covariances [S, QB, 3, 3] of the radar form, or
    None."""
    s, qb = _qb_of(qmask, name)
    f32 = torch.float32
    dev = sbuf.device
    args = _halo_rows(name, rows)
    args += [_check(slot_tile, "slot_tile", torch.int32, (s,)),
             _check(sbuf, "sbuf", f32, (s, qb, 3)),
             _check(qmask, "qmask", torch.bool, (s, qb)), ctypes.c_int(s),
             ctypes.c_int(qb), _check(pose, "pose", f32, (4, 4)),
             _check(max_dist, "max_dist", f32, ()), *geometry,
             ctypes.c_void_p(None) if radar is None
             else _check(radar, "radar", f32, (s, qb, 3, 3))]
    partials = torch.empty((s, GN_SUMS), dtype=f32, device=dev)
    sums = torch.empty(GN_SUMS, dtype=f32, device=dev)
    cov = mean = ok = None
    if with_matches:
        lead = (s, qb, pairs) if pairs else (s, qb)
        cov = torch.empty(lead + (3, 3), dtype=f32, device=dev)
        mean = torch.empty(lead + (3,), dtype=f32, device=dev)
        ok = torch.empty(lead, dtype=torch.bool, device=dev)
    rc = getattr(library(), entry)(*args, _ptr(partials), _ptr(sums), _ptr(cov),
                                   _ptr(mean), _ptr(ok), _stream(sbuf))
    _raise_on(rc, name)
    launches[name] += 1
    return sums, cov, mean, ok


def _tile_geometry(voxel_size, tile_size, tx0, ty0, ty_dim):
    return [ctypes.c_float(voxel_size), ctypes.c_float(tile_size), ctypes.c_int(tx0),
            ctypes.c_int(ty0), ctypes.c_int(ty_dim)]


def gicp_correspond(halo_points, halo_point_cov, halo_point_cov_mean, slot_tile,
                    sbuf, qmask, pose, max_dist, *, voxel_size, tile_size, tx0, ty0,
                    ty_dim, with_matches: bool = False, radar=None):
    """Kernel E (icp.gicp_search_reduce_plain): the [44] GICP sums of one GN
    iteration at ``pose`` (the radar form with ``radar`` [S,QB,3,3]), plus
    (cov [S,QB,3,3], mean [S,QB,3], ok [S,QB]) when ``with_matches``."""
    f32 = torch.float32
    return _cov_search(
        "gicp_correspond", "elm_gicp_search_reduce",
        [("halo_points", halo_points, f32, (3,)),
         ("halo_point_cov", halo_point_cov, f32, (3, 3)),
         ("halo_point_cov_mean", halo_point_cov_mean, f32, (3,))],
        slot_tile, sbuf, qmask, pose, max_dist,
        _tile_geometry(voxel_size, tile_size, tx0, ty0, ty_dim), with_matches, 0, radar)


def vgicp_correspond(halo_vox_mean, halo_vox_cov, halo_vox_coord, slot_tile, sbuf,
                     qmask, pose, max_dist, *, voxel_size, tile_size, tx0, ty0,
                     ty_dim, with_matches: bool = False, radar=None):
    """Kernel F (icp.vgicp_search_reduce_plain): the [44] VGICP sums of one GN
    iteration at ``pose`` (the radar form with ``radar`` [S,QB,3,3]), plus
    (cov [S,QB,3,3], mean [S,QB,3], ok [S,QB]) when ``with_matches``."""
    f32 = torch.float32
    return _cov_search(
        "vgicp_correspond", "elm_vgicp_search_reduce",
        [("halo_vox_mean", halo_vox_mean, f32, (3,)),
         ("halo_vox_cov", halo_vox_cov, f32, (3, 3)),
         ("halo_vox_coord", halo_vox_coord, torch.int32, (3,))],
        slot_tile, sbuf, qmask, pose, max_dist,
        _tile_geometry(voxel_size, tile_size, tx0, ty0, ty_dim), with_matches, 0, radar)


def avgicp_correspond(halo_vox_mean, halo_vox_cov, halo_vox_coord, slot_tile, sbuf,
                      qmask, pose, max_dist, *, voxel_size, with_matches: bool = False,
                      radar=None):
    """Kernel G (icp.avgicp_search_reduce_plain): the [44] AVGICP sums of one
    GN iteration at ``pose`` (with ``radar`` [S,QB,3,3] the flattened
    per-pair radar form), plus (cov [S,QB,7,3,3], mean [S,QB,7,3],
    ok [S,QB,7]) when ``with_matches``."""
    f32 = torch.float32
    return _cov_search(
        "avgicp_correspond", "elm_avgicp_search_reduce",
        [("halo_vox_mean", halo_vox_mean, f32, (3,)),
         ("halo_vox_cov", halo_vox_cov, f32, (3, 3)),
         ("halo_vox_coord", halo_vox_coord, torch.int32, (3,))],
        slot_tile, sbuf, qmask, pose, max_dist, [ctypes.c_float(voxel_size)],
        with_matches, 7, radar)


# --------------------------------------------------------------------------- #
# Kernels H, I, O, U and V: the EKF and its rings (csrc/ekf.cuh, rings.cuh),
# the state and the parameters as packed records (ekf/state.py)
# --------------------------------------------------------------------------- #

_F32, _BOOL = torch.float32, torch.bool
_V3, _V4 = (3,), (4,)
_RECORD = ekf_state.record_layout(_F32)
#: EkfState's fields in the dataclass order with their dtype and shape on
#: the card (their place in the record: ekf.state.RECORD_FIELDS)
EKF_FIELDS = tuple((f.name,) + next(r[2:] for r in _RECORD.fields if r[0] == f.name)
                   for f in dataclasses.fields(ekf_state.EkfState))
#: kernel H's flag bits (csrc/imu_chain.cu)
_ZUPT, _RUN_CF, _GRAVITY, _CALIBRATION, _JOSEPH = 1, 2, 4, 8, 16
_PCM = 3  # config.GnssSource.PCM
#: the most IMU samples one launch of kernel H stages in shared memory
IMU_STAGE_MAX_SAMPLES = 1024


def _ptr_array(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


#: the rings the last launch of H made, each with its fields and the
#: pointer list the next launch passes for it: a frame loop hands them back,
#: and they are known by the identity of every field (each one of the views
#: made from the fresh buffer); other rings are checked in full
_made = {}


def _remember(key, obj, ptr):
    _made[key] = (obj, tuple(obj.__dict__.values()), ptr)


def _known(key, obj):
    m = _made.get(key)
    if m is not None and m[0] is obj and all(map(operator.is_, obj.__dict__.values(), m[1])):
        return m[2]
    return None


def _state_in(state, lanes=None):
    """(the pointer of ``state``'s float32 record, the state that holds the
    record): a kernel's output whose fields are untouched goes in as it is;
    a state that is not one record's views is packed into a fresh one first
    (counted in packs), which the caller keeps until the launch is queued.
    ``lanes``: a fleet state, B records of one [B, nbytes] buffer (a lane
    form's output, ``ekf.state.stack_states``), or else packed so."""
    lead = () if lanes is None else (lanes,)
    if isinstance(state, ekf_state.RecordState):
        rec = state.intact_record()
        if rec is not None:
            return (_check(rec, "EKF state record", torch.uint8, lead + (_RECORD.nbytes,)),
                    state)
    _check(state.P, "P", _F32, lead + (27, 27))
    if lanes is not None or ekf_state.state_record(state) is None:
        state = ekf_state.pack_state(state)
    return ctypes.c_void_p(state.P.data_ptr()), state


def _state_out(dev, lanes=None):
    """(a fresh record, its pointer); ``lanes`` records in one buffer."""
    shape = (_RECORD.nbytes,) if lanes is None else (lanes, _RECORD.nbytes)
    rec = torch.empty(shape, dtype=torch.uint8, device=dev)
    return rec, ctypes.c_void_p(rec.data_ptr())


#: the last packed EkfParams given and its record's pointer: a params
#: object is frozen and its fields are views of its record, so it keeps it
_params_cache = [None, None]


def _params(params):
    """(the pointer of ``params``' record, the params that hold it): params
    that are not one record's views are packed per call (counted), never
    cached; the caller keeps them until the launch is queued."""
    if params is _params_cache[0]:
        return _params_cache[1], params
    _check(params.init_pos, "init_pos", _F32, _V3)
    packed = ekf_state.params_record(params) is not None
    if not packed:
        params = ekf_state.pack_params(params)
    ptr = ctypes.c_void_p(params.init_pos.data_ptr())
    if packed:
        _params_cache[:] = [params, ptr]
    return ptr, params


_flag_cache = {}


def _flag_bits(flags):
    if flags not in _flag_cache:
        _flag_cache[flags] = (
            (_ZUPT if flags.use_zupt else 0) | (_RUN_CF if flags.run_cf else 0)
            | (_GRAVITY if flags.imu_estimate_gravity else 0)
            | (_CALIBRATION if flags.imu_estimate_calibration else 0)
            | (_JOSEPH if flags.joseph_form else 0))
    return _flag_cache[flags]


_EGO_FIELDS = ("pos", "rpy", "vel_local", "gyro")
_IMU_FIELDS = ("gyro", "acc")


def _made_ring(cls, name, fields, t, f, count, lanes=None):
    """The ring ``cls`` a kernel wrote: its times ``t`` [cap], its fields
    ``f`` ([cap, 3] each, one after another) and its int32 ``count``, all
    views of the launch's fresh buffer; remembered with the pointer list
    :func:`_ring_in` makes, so the next kernel that takes it skips the
    checks. ``lanes``: a fleet's rings, t [B * cap], each field's
    [B, cap, 3] one after another, count [B]."""
    lead = () if lanes is None else (lanes,)
    t = t.view(lead + (-1,))
    f = f.view((len(fields),) + lead + (t.shape[-1], 3)).unbind()
    ring = cls(t=t, count=count, **dict(zip(fields, f)))
    _remember(name, ring, _ptr_array([v.data_ptr() for v in (t, *f, count)]))
    return ring


def _ring_in(ring, name, fields, lanes=None):
    """The pointer list of a ring going in: t, its [cap, 3] fields, count
    (with ``lanes``, each with a leading lane axis)."""
    ptrs = _known(name, ring)
    if ptrs is not None and ring.count.shape == (() if lanes is None else (lanes,)):
        return ptrs
    cap = ring.capacity
    lead = () if lanes is None else (lanes,)
    ptrs = [_check(ring.t, f"{name}.t", _F32, lead + (cap,)).value]
    ptrs += [_check(getattr(ring, f), f"{name}.{f}", _F32, lead + (cap, 3)).value
             for f in fields]
    ptrs.append(_check(ring.count, f"{name}.count", torch.int32, lead).value)
    return _ptr_array(ptrs)


def imu_stage(state, ego, imu, ts, acc, gyro, valid, rot, trans, params, flags):
    """Kernel H (runtime.imu_subbatch's plain composition: frames.imu_to_ego,
    the PCM intake's rotation, filter.imu_chain_plain + ego_history and
    rings.push_rings_plain): the frame's raw IMU samples (``valid`` None:
    all valid) through the sensor-frame conversion (``rot``, ``trans``: the
    ego-to-IMU calibration), the ``predict_imu`` chain (the updates in the
    Joseph form with ``flags.joseph_form``), the ego rows and the batch
    pushes into the ego and IMU rings, in one launch. Returns (state, ego
    ring, IMU ring), the rings' fields views of one fresh buffer. The lane
    form: ``ts`` [B, n] (``acc``, ``gyro`` [B, n, 3], ``valid`` [B, n]), a
    fleet state (B records) and rings with a lane axis; a CTA pair a lane
    in the one launch."""
    lanes, lead = _lanes(ts, 1)
    n = ts.shape[-1]
    if n > IMU_STAGE_MAX_SAMPLES:
        raise ValueError(f"imu_stage: at most {IMU_STAGE_MAX_SAMPLES} IMU samples a "
                         f"launch, got {n}")
    re, ri = ego.capacity, imu.capacity
    ln = lanes or 1
    dev = ts.device
    (p_state, state), (p_params, params) = _state_in(state, lanes), _params(params)
    args = [p_state, None, p_params, _check(ts, "ts", _F32, lead + (n,)),
            _check(acc, "acc", _F32, lead + (n, 3)), _check(gyro, "gyro", _F32, lead + (n, 3)),
            ctypes.c_void_p(None) if valid is None
            else _check(valid, "valid", _BOOL, lead + (n,)),
            ctypes.c_int(n), _check(rot, "ego_to_imu_rot", _F32, (3, 3)),
            _check(trans, "ego_to_imu_trans", _F32, _V3), ctypes.c_int(_flag_bits(flags)),
            _ring_in(ego, "ego_ring", _EGO_FIELDS, lanes), ctypes.c_int(re),
            _ring_in(imu, "imu_ring", _IMU_FIELDS, lanes), ctypes.c_int(ri),
            ctypes.c_int(ln)]
    out, args[1] = _state_out(dev, lanes)
    buf = torch.empty(ln * (13 * re + 7 * ri + 2), dtype=_F32, device=dev)
    rc = library().elm_imu_stage(*args, ctypes.c_void_p(buf.data_ptr()), _stream(ts))
    _raise_on(rc, "imu_stage")
    launches["imu_stage"] += 1
    t_e, f_e, t_i, f_i, counts = buf.split_with_sizes(
        (ln * re, ln * 12 * re, ln * ri, ln * 6 * ri, 2 * ln))
    c_e, c_i = counts.view(torch.int32).view((2,) + lead).unbind()
    return (ekf_state.RecordState(out),
            _made_ring(type(ego), "ego_ring", _EGO_FIELDS, t_e, f_e, c_e, lanes),
            _made_ring(type(imu), "imu_ring", _IMU_FIELDS, t_i, f_i, c_i, lanes))


def ca_tick(state, t, params):
    """Kernel O (ekf.filter.ca_tick_plain): ``predict`` at the device scalar
    ``t`` (one constant-acceleration tick), then the tick's ego-ring entry.
    Returns (state, (t [1], pos, rpy, vel_local, gyro [1, 3])). Kernel U's
    reference: :func:`tick_stage` runs its body and the push."""
    (p_state, state), (p_params, params) = _state_in(state), _params(params)
    args = [p_state, None, p_params, _check(t, "t", _F32, ())]
    out, args[1] = _state_out(t.device)
    hist = torch.empty(13, dtype=_F32, device=t.device)
    rc = library().elm_ca_tick(*args, *(ctypes.c_void_p(hist.data_ptr() + 4 * k)
                                         for k in (0, 1, 4, 7, 10)), _stream(t))
    _raise_on(rc, "ca_tick")
    launches["ca_tick"] += 1
    return ekf_state.RecordState(out), (hist[:1],) + hist[1:].view(4, 1, 3).unbind()


def tick_stage(state, t, params, ego):
    """Kernel U (ekf.filter.tick_stage_plain): ``predict`` at the device
    scalar ``t`` (one constant-acceleration tick), then the tick's ego row
    pushed into the ego ring ``ego`` (dedupe eps 1e-5), in one launch: kernel
    O's body and kernel J's push. Returns (state, ego ring), the ring's
    fields views of one fresh buffer."""
    re = ego.capacity
    dev = t.device
    (p_state, state), (p_params, params) = _state_in(state), _params(params)
    args = [p_state, None, p_params, _check(t, "t", _F32, ()),
            _ring_in(ego, "ego_ring", _EGO_FIELDS), ctypes.c_int(re)]
    out, args[1] = _state_out(dev)
    buf = torch.empty(13 * re + 1, dtype=_F32, device=dev)
    rc = library().elm_tick_stage(*args, ctypes.c_void_p(buf.data_ptr()), _stream(t))
    _raise_on(rc, "tick_stage")
    launches["tick_stage"] += 1
    t_e, f_e, c_e = buf.split_with_sizes((re, 12 * re, 1))
    return ekf_state.RecordState(out), _made_ring(type(ego), "ego_ring", _EGO_FIELDS, t_e, f_e,
                                                  c_e.view(torch.int32)[0])


def imu_intake(imu, t, acc, gyro, rot):
    """Kernel V (pipeline.rings.imu_intake_plain): one raw IMU sample (the
    device scalar ``t``, ``acc`` [3], ``gyro`` [3]) rotated by ``rot``
    (ego_to_imu_rot [3, 3], no lever arm) and pushed into the IMU ring
    ``imu`` (eps 0), in one launch: kernel H's IMU intake. Returns the IMU
    ring, its fields views of one fresh buffer."""
    ri = imu.capacity
    args = [_ring_in(imu, "imu_ring", _IMU_FIELDS), ctypes.c_int(ri), _check(t, "t", _F32, ()),
            _check(acc, "acc", _F32, _V3), _check(gyro, "gyro", _F32, _V3),
            _check(rot, "ego_to_imu_rot", _F32, (3, 3))]
    buf = torch.empty(7 * ri + 1, dtype=_F32, device=t.device)
    rc = library().elm_imu_intake(*args, ctypes.c_void_p(buf.data_ptr()), _stream(t))
    _raise_on(rc, "imu_intake")
    launches["imu_intake"] += 1
    t_i, f_i, c_i = buf.split_with_sizes((ri, 6 * ri, 1))
    return _made_ring(type(imu), "imu_ring", _IMU_FIELDS, t_i, f_i, c_i.view(torch.int32)[0])


def ekf_update(state, params, flags, *, can=None, gps=None, gps_source=None,
               gnss_uncertainty_max=None, pcm=None):
    """Kernel I (ekf.filter.update_chain_plain): the CAN samples
    ``can = (t, vel_x, yaw_rate, valid)``, then the GPS fixes
    ``gps = (t, pos, cov_diag, valid)`` (as GNSS source ``gps_source``,
    with ``gnss_uncertainty_max``), then the PCM pose
    ``pcm = (GnssMeas, apply)``, in one launch, each update in the Joseph
    form with ``flags.joseph_form``."""
    null = ctypes.c_void_p(None)
    can_args = [ctypes.c_int(0), null, null, null, null]
    if can is not None:
        nc = can[0].shape[0]
        can_args = [ctypes.c_int(nc)] + [
            _check(x, f"can_{k}", dt, (nc,))
            for x, k, dt in zip(can, ("t", "vel", "yaw", "valid"), (_F32,) * 3 + (_BOOL,))]
    gps_args = [ctypes.c_int(0), ctypes.c_int(0), null, null, null, null, null]
    if gps is not None:
        ng = gps[0].shape[0]
        if gps_source is None:
            raise ValueError("ekf_update: GPS fixes need their gps_source")
        gps_args = [ctypes.c_int(ng), ctypes.c_int(gps_source),
                    _check(gnss_uncertainty_max, "gnss_uncertainty_max", _F32, ()),
                    _check(gps[0], "gps_t", _F32, (ng,)),
                    _check(gps[1], "gps_pos", _F32, (ng, 3)),
                    _check(gps[2], "gps_cov", _F32, (ng, 3)),
                    _check(gps[3], "gps_valid", _BOOL, (ng,))]
    pcm_args = [ctypes.c_int(0)] + [null] * 6
    if pcm is not None:
        meas, apply = pcm
        if int(meas.source) != _PCM:
            raise ValueError(f"ekf_update: the pose update takes the PCM source, got "
                             f"{int(meas.source)}")
        pcm_args = [ctypes.c_int(1), _check(meas.timestamp, "pcm_t", _F32, ()),
                    _check(meas.pos, "pcm_pos", _F32, _V3),
                    _check(meas.rot, "pcm_rot", _F32, _V4),
                    _check(meas.pos_cov, "pcm_pos_cov", _F32, (3, 3)),
                    _check(meas.rot_cov, "pcm_rot_cov", _F32, (3, 3)),
                    _check(apply, "pcm_apply", _BOOL, ())]
    (p_state, state), (p_params, params) = _state_in(state), _params(params)
    out, out_ptr = _state_out(params.init_pos.device)
    rc = library().elm_ekf_update(p_state, out_ptr, p_params, *can_args, *gps_args,
                                  *pcm_args, ctypes.c_int(int(flags.joseph_form)),
                                  _stream(params.init_pos))
    _raise_on(rc, "ekf_update")
    launches["ekf_update"] += 1
    return ekf_state.RecordState(out)


#: the last gnss_uncertainty_max given and its pointer: a pipeline passes
#: the same parameter tensor every GPS fix
_gnss_max = [None, None]


def _sub_batch(xs, names, vec, lead=()):
    """The pointers of a CAN or GPS sub-batch (t, a, b, valid): valid None
    (every sample valid) goes in as a null pointer; ``vec`` names the
    fields of three floats a sample; ``lead`` the lane axis of a fleet's
    ([B, n] rows)."""
    n = xs[0].shape[len(lead)]
    ptrs = [_check(x, name, _F32, lead + ((n, 3) if name in vec else (n,)))
            for x, name in zip(xs[:3], names)]
    valid = xs[3]
    ptrs.append(ctypes.c_void_p(None) if valid is None
                else _check(valid, names[3], _BOOL, lead + (n,)))
    return [ctypes.c_int(n)] + ptrs


def can_gps_update(state, params, flags, *, can=None, gps=None, gps_source=None,
                   gnss_uncertainty_max=None):
    """Kernel W (ekf.filter.update_chain_plain without a PCM pose): the CAN
    samples ``can = (t, vel_x, yaw_rate, valid)``, then the GPS fixes
    ``gps = (t, pos, cov_diag, valid)`` (as GNSS source ``gps_source``,
    gated by ``gnss_uncertainty_max``), in one launch, each update in the
    Joseph form with ``flags.joseph_form``; a ``valid`` of None means every
    sample is valid. Kernel I's CAN and GPS legs, bit for bit. The lane
    form: a fleet state (P [B, 27, 27]) and each sub-batch's rows [B, n]
    (``valid`` given), one CTA a lane in the one launch; the GNSS source
    and the gate are the fleet's."""
    first = can if can is not None else gps
    lanes, lead = (None, ()) if first is None else _lanes(first[0], 1)
    null = ctypes.c_void_p(None)
    can_args = [ctypes.c_int(0), null, null, null, null]
    if can is not None:
        can_args = _sub_batch(can, ("can_t", "can_vel", "can_yaw", "can_valid"), (), lead)
    gps_args = [ctypes.c_int(0), ctypes.c_int(0), null, null, null, null, null]
    if gps is not None:
        if gps_source is None or gps_source == _PCM:
            raise ValueError(f"can_gps_update: GPS fixes need a GNSS source other than PCM, "
                             f"got {gps_source}")
        if gnss_uncertainty_max is not _gnss_max[0]:
            _gnss_max[:] = [gnss_uncertainty_max, _check(
                gnss_uncertainty_max, "gnss_uncertainty_max", _F32, ())]
        n, *ptrs = _sub_batch(gps, ("gps_t", "gps_pos", "gps_cov", "gps_valid"),
                              ("gps_pos", "gps_cov"), lead)
        gps_args = [n, ctypes.c_int(gps_source), _gnss_max[1], *ptrs]
    (p_state, state), (p_params, params) = _state_in(state, lanes), _params(params)
    out, out_ptr = _state_out(params.init_pos.device, lanes)
    rc = library().elm_can_gps_update(p_state, out_ptr, p_params, *can_args, *gps_args,
                                      ctypes.c_int(int(flags.joseph_form)),
                                      ctypes.c_int(lanes or 1), _stream(params.init_pos))
    _raise_on(rc, "can_gps_update")
    launches["can_gps_update"] += 1
    return ekf_state.RecordState(out)


# --------------------------------------------------------------------------- #
# Kernels J, K, L, M: the scan-time ring ops and the GN step (one CTA each;
# their outputs are views into one or two fresh buffers, so a launch costs
# a few allocations, not one per field)
# --------------------------------------------------------------------------- #


def _ring_ptrs(name, ring, fields, new_t, new_f, m, buf, count_out):
    """(the C entry's pointer list for one ring, its output views)."""
    cap = ring.capacity
    views = {"t": buf[:cap]}
    for k, f in enumerate(fields):
        views[f] = buf[cap * (1 + 3 * k):cap * (4 + 3 * k)].view(cap, 3)
    ptrs = [_check(ring.t, f"{name}.t", _F32, (cap,)).value]
    ptrs += [_check(getattr(ring, f), f"{name}.{f}", _F32, (cap, 3)).value for f in fields]
    ptrs += [_check(ring.count, f"{name}.count", torch.int32, ()).value,
             views["t"].data_ptr()]
    ptrs += [views[f].data_ptr() for f in fields]
    ptrs += [count_out.data_ptr(), _check(new_t, f"{name} new t", _F32, (m,)).value]
    ptrs += [_check(v, f"{name} new {f}", _F32, (m, 3)).value for f, v in zip(fields, new_f)]
    return _ptr_array(ptrs), views


def ring_push(ego, imu, ego_new, imu_new, valid):
    """Kernel J (pipeline.rings.push_rings_plain): the batch
    ``ego_new = (t, pos, rpy, vel_local, gyro)`` into the ego ring (dedupe
    eps 1e-5) and ``imu_new = (t, gyro, acc)`` into the IMU ring (eps 0),
    both masked by ``valid``, in one launch. A ring given as None (its
    samples None) is left out and comes back None. Kernels H, U and V push
    their rows themselves; this entry is U's and V's reference (O's row into
    the ego ring, the IMU-only intake into the IMU ring) and the card form
    of ``pipeline.rings.push_ego`` / ``push_imu`` (one row into one ring).
    Returns (ego ring, IMU ring)."""
    m = valid.shape[0]
    dev = valid.device
    re = 0 if ego is None else ego.capacity
    ri = 0 if imu is None else imu.capacity
    p_valid = _check(valid, "valid", _BOOL, (m,))
    buf = torch.empty(re * 13 + ri * 7, dtype=_F32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    ego_ptrs = imu_ptrs = None
    if ego is not None:
        ego_ptrs, ego_out = _ring_ptrs("ego_ring", ego, _EGO_FIELDS, ego_new[0], ego_new[1:],
                                       m, buf[:re * 13], counts[0])
    if imu is not None:
        imu_ptrs, imu_out = _ring_ptrs("imu_ring", imu, _IMU_FIELDS, imu_new[0], imu_new[1:],
                                       m, buf[re * 13:], counts[1])
    rc = library().elm_ring_push(ego_ptrs, ctypes.c_int(re), imu_ptrs, ctypes.c_int(ri),
                                 ctypes.c_int(m), p_valid, _stream(valid))
    _raise_on(rc, "ring_push")
    launches["ring_push"] += 1
    return (None if ego is None else ego.replace(count=counts[0], **ego_out),
            None if imu is None else imu.replace(count=counts[1], **imu_out))


def scan_ring_query(imu, ego, scan_cur, scan_end, tf_ego_to_lidar, window: int,
                    run_deskew: bool):
    """Kernel K (deskew.scan_ring_query_plain): the deskew info's tensors
    (imu_time [w], imu_rot [w,3], imu_included [w], first_idx, last_idx,
    odom_incre [3], imu_available, odom_available, imu_covers_start), the
    ICP initial guess [4,4], ``found`` and ``usable``; w = min(window, IMU
    ring capacity)."""
    ri, re = imu.capacity, ego.capacity
    w = min(int(window), ri)
    dev = scan_end.device
    args = [_check(imu.t, "imu_ring.t", _F32, (ri,)),
            _check(imu.gyro, "imu_ring.gyro", _F32, (ri, 3)),
            _check(imu.count, "imu_ring.count", torch.int32, ()), ctypes.c_int(ri)]
    args += [_check(ego.t, "ego_ring.t", _F32, (re,))]
    args += [_check(getattr(ego, f), f"ego_ring.{f}", _F32, (re, 3)) for f in _EGO_FIELDS]
    args += [_check(ego.count, "ego_ring.count", torch.int32, ()), ctypes.c_int(re),
             _check(scan_cur, "scan_cur", _F32, ()), _check(scan_end, "scan_end", _F32, ()),
             _check(tf_ego_to_lidar, "tf_ego_to_lidar", _F32, (4, 4)), ctypes.c_int(w),
             ctypes.c_int(int(run_deskew))]
    f = torch.empty(4 * w + 19, dtype=_F32, device=dev)
    i = torch.empty(2, dtype=torch.int64, device=dev)
    b = torch.empty(w + 5, dtype=_BOOL, device=dev)
    rc = library().elm_scan_ring_query(*args, _ptr(f), _ptr(i), _ptr(b), _stream(scan_end))
    _raise_on(rc, "scan_ring_query")
    launches["scan_ring_query"] += 1
    return (f[:w], f[w:4 * w].view(w, 3), b[:w], i[0], i[1], f[4 * w:4 * w + 3], b[w],
            b[w + 1], b[w + 2], f[4 * w + 3:].view(4, 4), b[w + 3], b[w + 4])


#: kernel T's flag bits and the float scalars after kernel K's outputs (the
#: delayed stamp, scan_cur, scan_end, front_t), csrc/scan_front.cu
_SCAN_TIME_END, _RUN_DESKEW, _BUG_COMPAT_Z = 1, 2, 4
FRONT_SCALARS = 4
#: kernel T's workspace on each (device, stream): three ints a lane (the
#: done counter, the first and the last valid index: 0, INT_MAX, -1 between
#: calls; each lane's last CTA resets its own), as many lanes as the widest
#: call on that stream took; calls on one stream use it in turn
_front_work = {}
#: the last (delay, max_dist, tf_ego_to_lidar) given and their pointers: a
#: pipeline passes the same parameter tensors every scan
_front_params = [None, None]


def _front_in(delay, max_dist, tf):
    key = _front_params[0]
    if key is not None and key[0] is delay and key[1] is max_dist and key[2] is tf:
        return _front_params[1]
    ptrs = [_check(delay, "lidar_time_delay", _F32, ()),
            _check(max_dist, "input_max_dist", _F32, ()),
            _check(tf, "tf_ego_to_lidar", _F32, (4, 4))]
    _front_params[:] = [(delay, max_dist, tf), ptrs]
    return ptrs


def scan_front(points, times, valid, stamp, delay, max_dist, imu, ego, tf_ego_to_lidar,
               scan_time_end: bool, run_deskew: bool, bug_compat_z: bool, window: int = 64):
    """Kernel T (runtime.scan_front_plain): the delayed stamp, the range
    gate, the scan times, kernel K's ring queries and, with ``run_deskew``,
    kernel D's deskew, one host call (two launches). Returns (valid' [n],
    points' [n,3] (``points`` itself without ``run_deskew``), scan_cur,
    scan_end, init_guess [4,4], found, usable, deskew_ok, then the deskew
    info's imu_time [w], imu_rot [w,3], imu_included [w], first_idx,
    last_idx, odom_incre [3], imu_available, odom_available,
    imu_covers_start); all but points' are views of one fresh buffer; w =
    min(window, IMU ring capacity). The lane form: points [B, n, 3],
    ``times`` and ``valid`` [B, n], ``stamp`` [B] and rings with a lane axis
    give every output with a leading lane axis (the scalars as strided
    views); both launches run the lanes as blockIdx.y."""
    lanes, lead = _lanes(points, 2)
    ln = lanes or 1
    n = points.shape[-2]
    if n == 0:
        raise ValueError("scan_front: a scan of at least one point required")
    ri, re = imu.capacity, ego.capacity
    w = min(int(window), ri)
    dev = points.device
    p_delay, p_dist, p_tf = _front_in(delay, max_dist, tf_ego_to_lidar)
    args = [_check(points, "points", _F32, lead + (n, 3)),
            _check(times, "times", _F32, lead + (n,)),
            _check(valid, "valid", _BOOL, lead + (n,)), ctypes.c_int(n),
            _check(stamp, "stamp", _F32, lead), p_delay, p_dist,
            _ring_in(imu, "imu_ring", _IMU_FIELDS, lanes), ctypes.c_int(ri),
            _ring_in(ego, "ego_ring", _EGO_FIELDS, lanes), ctypes.c_int(re), p_tf]
    # kernels launch on one stream at a time: each call's last CTA of a lane
    # leaves that lane's workspace clean for the next
    stream = _stream(points)
    work = _front_work.get((dev, stream.value))
    if work is None or work.numel() < 3 * ln:
        work = _front_work[(dev, stream.value)] = torch.tensor(
            [0, 2 ** 31 - 1, -1] * ln, dtype=torch.int32, device=dev)
    flags = ((_SCAN_TIME_END if scan_time_end else 0) | (_RUN_DESKEW if run_deskew else 0)
             | (_BUG_COMPAT_Z if bug_compat_z else 0))
    nf = 4 * (4 * w + 19 + FRONT_SCALARS)
    buf = torch.empty(ln * (16 + nf + w + 6 + n), dtype=torch.uint8, device=dev)
    pts = torch.empty_like(points) if run_deskew else points
    rc = library().elm_scan_front(*args, ctypes.c_int(w), ctypes.c_int(flags), ctypes.c_int(ln),
                                  _ptr(work), _ptr(buf), _ptr(pts) if run_deskew else _ptr(None),
                                  stream)
    _raise_on(rc, "scan_front")
    launches["scan_front"] += 1
    i, f, b, v = buf.split_with_sizes((16 * ln, nf * ln, (w + 6) * ln, n * ln))
    i = i.view(torch.int64).view(ln, 2)
    f = f.view(_F32).view(ln, -1)
    b = b.view(_BOOL).view(ln, w + 6)
    v = v.view(_BOOL).view(ln, n)
    out = (v, f[:, 4 * w + 20], f[:, 4 * w + 21], f[:, 4 * w + 3:4 * w + 19].unflatten(-1, (4, 4)),
           b[:, w + 3], b[:, w + 4], b[:, w + 5], f[:, :w], f[:, w:4 * w].unflatten(-1, (w, 3)),
           b[:, :w], i[:, 0], i[:, 1], f[:, 4 * w:4 * w + 3], b[:, w], b[:, w + 1], b[:, w + 2])
    if lanes is None:
        out = tuple(x[0] for x in out)
    return out[:1] + (pts,) + out[1:]


def pcm_measurement(icp_pose, tf_lidar_to_ego, local_cov, fitness, success, usable, ego,
                    scan_end, use_pcm: bool):
    """Kernel L (runtime.pcm_measurement_plain): (icp_pose [4,4] in the ego
    frame, the PCM GnssMeas fields t, pos [3], quat [4], pos_cov [3,3],
    rot_cov [3,3], apply)."""
    re = ego.capacity
    dev = scan_end.device
    args = [_check(icp_pose, "icp_pose", _F32, (4, 4)),
            _check(tf_lidar_to_ego, "tf_lidar_to_ego", _F32, (4, 4)),
            _check(local_cov, "local_cov", _F32, (6, 6)), _check(fitness, "fitness", _F32, ()),
            _check(success, "success", _BOOL, ()), _check(usable, "usable", _BOOL, ()),
            _check(ego.t, "ego_ring.t", _F32, (re,)),
            _check(ego.pos, "ego_ring.pos", _F32, (re, 3)),
            _check(ego.rpy, "ego_ring.rpy", _F32, (re, 3)),
            _check(ego.count, "ego_ring.count", torch.int32, ()), ctypes.c_int(re),
            _check(scan_end, "scan_end", _F32, ()), ctypes.c_int(int(use_pcm))]
    out = torch.empty(42, dtype=_F32, device=dev)
    apply = torch.empty((), dtype=_BOOL, device=dev)
    rc = library().elm_pcm_measurement(*args, _ptr(out), _ptr(apply), _stream(scan_end))
    _raise_on(rc, "pcm_measurement")
    launches["pcm_measurement"] += 1
    return (out[:16].view(4, 4), out[16], out[17:20], out[20:24], out[24:33].view(3, 3),
            out[33:42].view(3, 3), apply)


#: kernel S's output buffer: the measurement in kernel L's layout (42
#: floats), the ego pos [3], rpy [3] and t, p_asym and p_min_diag, in
#: floats; ``applied`` one byte after them (csrc/pcm_stage.cu)
PCM_STAGE_FLOATS = 51


def pcm_stage(state, params, flags, icp_pose, tf_lidar_to_ego, local_cov, fitness, success,
              usable, ego, scan_end, use_pcm: bool):
    """Kernel S (runtime.pcm_stage_plain): kernel L's PCM measurement, kernel
    I's PCM update (in the Joseph form with ``flags.joseph_form``) and the
    frame's published outputs, in one launch. Returns (state, (icp_pose
    [4,4] in the ego frame, the PCM GnssMeas fields t, pos [3], quat [4],
    pos_cov [3,3], rot_cov [3,3], applied, ego_pos [3], ego_rpy [3], ego_t,
    p_asym, p_min_diag)): the outputs are views of one fresh buffer. The
    lane form: ``scan_end`` [B] (with ``usable`` [B], both maybe strided
    views of kernel T's lane outputs), a fleet state, the registration's
    outputs and the ego ring with a lane axis; a CTA a lane in the one
    launch, every output with a leading lane axis."""
    lanes, lead = _lanes(scan_end, 0)
    ln = lanes or 1
    re = ego.capacity
    dev = scan_end.device
    p_usable, usable_stride = _lane_vec(usable, "usable", _BOOL, lanes)
    p_end, end_stride = _lane_vec(scan_end, "scan_end", _F32, lanes)
    args = [_check(icp_pose, "icp_pose", _F32, lead + (4, 4)),
            _check(tf_lidar_to_ego, "tf_lidar_to_ego", _F32, (4, 4)),
            _check(local_cov, "local_cov", _F32, lead + (6, 6)),
            _check(fitness, "fitness", _F32, lead), _check(success, "success", _BOOL, lead),
            p_usable, _check(ego.t, "ego_ring.t", _F32, lead + (re,)),
            _check(ego.pos, "ego_ring.pos", _F32, lead + (re, 3)),
            _check(ego.rpy, "ego_ring.rpy", _F32, lead + (re, 3)),
            _check(ego.count, "ego_ring.count", torch.int32, lead), ctypes.c_int(re),
            p_end, ctypes.c_int(int(use_pcm)), ctypes.c_int(int(flags.joseph_form))]
    (p_state, state), (p_params, params) = _state_in(state, lanes), _params(params)
    out, out_ptr = _state_out(dev, lanes)
    nf = 4 * PCM_STAGE_FLOATS
    buf = torch.empty(ln * (nf + 4), dtype=torch.uint8, device=dev)
    rc = library().elm_pcm_stage(p_state, out_ptr, p_params, *args, _ptr(buf),
                                 ctypes.c_void_p(buf.data_ptr() + nf * ln), ctypes.c_int(ln),
                                 usable_stride, end_stride, _stream(scan_end))
    _raise_on(rc, "pcm_stage")
    launches["pcm_stage"] += 1
    f = buf[:nf * ln].view(_F32).view(ln, PCM_STAGE_FLOATS)
    res = (f[:, :16].unflatten(-1, (4, 4)), f[:, 16], f[:, 17:20], f[:, 20:24],
           f[:, 24:33].unflatten(-1, (3, 3)), f[:, 33:42].unflatten(-1, (3, 3)),
           buf[nf * ln:nf * ln + ln].view(_BOOL), f[:, 42:45], f[:, 45:48], f[:, 48], f[:, 49],
           f[:, 50])
    if lanes is None:
        res = tuple(x[0] for x in res)
    return ekf_state.RecordState(out), res


def gn_step(sums, pose, fitness, local_cov, total, params, gicp: bool):
    """Kernel M (register.icp.gn_update_plain on assemble_p2p / assemble_gn
    of ``sums``): one LM step after kernel A, E, F or G. Returns (pose
    [4,4], local_cov [6,6], fitness, overlap, stop, failed)."""
    n = sums.shape[0]
    if n not in (P2P_SUMS, GN_SUMS):
        raise ValueError(f"gn_step: {P2P_SUMS} or {GN_SUMS} sums required, got {n}")
    dev = sums.device
    args = [_check(sums, "sums", _F32, (n,)), ctypes.c_int(n), _check(pose, "pose", _F32, (4, 4)),
            _check(fitness, "fitness", _F32, ()), _check(local_cov, "local_cov", _F32, (6, 6)),
            _check(total, "total", _F32, ()),
            _check(params.min_overlap_ratio, "min_overlap_ratio", _F32, ()),
            _check(params.lm_lambda, "lm_lambda", _F32, ()),
            _check(params.termination_threshold, "termination_threshold", _F32, ()),
            ctypes.c_int(int(gicp))]
    out = torch.empty(54, dtype=_F32, device=dev)
    flags = torch.empty(2, dtype=_BOOL, device=dev)
    rc = library().elm_gn_step(*args, _ptr(out), _ptr(flags), _stream(sums))
    _raise_on(rc, "gn_step")
    launches["gn_step"] += 1
    return (out[:16].view(4, 4), out[16:52].view(6, 6), out[52], out[53], flags[0], flags[1])


def p2p_register_capacity() -> int:
    """The CTAs of the P2P loop kernel that the current card holds at once
    (its grid is the smaller of this and the slot count)."""
    ctas = ctypes.c_int(0)
    _raise_on(library().elm_p2p_register_capacity(ctypes.byref(ctas)), "p2p_register")
    return ctas.value


def _carry_in(pose, fitness, local_cov, total, params, max_iteration: int, lead=()):
    """The loop entries' carry in, constants and trip limit (csrc/gn_loop.cuh
    ``GnLoop``): pose [4,4], fitness, local_cov [6,6], total (each with the
    leading shape ``lead``: a lane axis for the lane form), the search
    distance, the overlap ratio, lambda, the termination threshold,
    ``max_iteration``."""
    return [_check(pose, "pose", _F32, lead + (4, 4)),
            _check(fitness, "fitness", _F32, lead),
            _check(local_cov, "local_cov", _F32, lead + (6, 6)),
            _check(total, "total", _F32, lead),
            _check(params.max_search_dist, "max_search_dist", _F32, ()),
            _check(params.min_overlap_ratio, "min_overlap_ratio", _F32, ()),
            _check(params.lm_lambda, "lm_lambda", _F32, ()),
            _check(params.termination_threshold, "termination_threshold", _F32, ()),
            ctypes.c_int(max_iteration)]


def _gn_loop(name, entry, args, rows: int, n_sums: int, like, lanes=None):
    """One launch of a loop entry (``args``: its arguments before the
    scratch) over ``rows`` slot rows of ``n_sums`` partials (``lanes``: the
    lane form's, each lane ``rows`` of them). Returns (pose [4,4], local_cov
    [6,6], fitness, overlap, failed, iterations int32), views of the
    launch's carry (with a leading lane axis in the lane form, the carry
    field-major): nothing is read back."""
    dev = like.device
    ln = lanes or 1
    # carry (pose, local_cov, fitness, overlap), sums, partials; counters and
    # the iteration counts; the flags (stop, failed)
    f = torch.empty(ln * (54 + n_sums * (1 + max(rows, 1))), dtype=_F32, device=dev)
    i = torch.empty(2 + ln, dtype=torch.int32, device=dev)  # the counters: zeroed by the kernel
    flags = torch.empty(2 * ln, dtype=_BOOL, device=dev)
    carry, sums, partials = f[:54 * ln], f[54 * ln:(54 + n_sums) * ln], f[(54 + n_sums) * ln:]
    rc = getattr(library(), entry)(*args, _ptr(partials), _ptr(sums), _ptr(i), _ptr(carry),
                                   _ptr(flags), ctypes.c_void_p(i.data_ptr() + 8),
                                   _stream(like))
    _raise_on(rc, name)
    launches[name] += 1
    if lanes is None:
        return (carry[:16].view(4, 4), carry[16:52].view(6, 6), carry[52], carry[53], flags[1],
                i[2])
    return (carry[:16 * ln].view(ln, 4, 4), carry[16 * ln:52 * ln].view(ln, 6, 6),
            carry[52 * ln:53 * ln], carry[53 * ln:], flags[ln:], i[2:])


def p2p_register(halo_points, slot_tile, sbuf, qmask, pose, fitness, local_cov, total,
                 params, max_iteration: int, *, voxel_size, tile_size, tx0, ty0, ty_dim):
    """Kernels A and M as one loop (icp.p2p_register_plain): the whole P2P
    GN/LM loop of one registration on the tile backend, from the carry
    (``pose`` [4,4], ``fitness``, ``local_cov`` [6,6]) for at most
    ``max_iteration`` iterations, in one cooperative launch; nothing is read
    back. Returns (pose [4,4], local_cov [6,6], fitness, overlap, failed,
    iterations int32). The lane form: ``slot_tile`` [B, S], ``sbuf``
    [B, S, QB, 3], ``qmask`` [B, S, QB], the carry and ``total`` with a
    lane axis: B registrations in the one launch (csrc/gn_loop.cuh
    gn_loop_lanes), each output with a leading lane axis, a stopped lane
    keeping its carry and its count while the others iterate."""
    lanes, lead = _lanes(sbuf, 3)
    if lanes is not None and lanes > MAX_LANES:
        raise ValueError(f"p2p_register: at most {MAX_LANES} lanes a launch, got {lanes}")
    s, qb = _qb_of(qmask[0] if lanes else qmask, "p2p_register")
    t1, mhp = halo_points.shape[:2]
    args = [
        _check(halo_points, "halo_points", _F32, (t1, mhp, 3)), ctypes.c_int(mhp),
        _check(slot_tile, "slot_tile", torch.int32, lead + (s,)),
        _check(sbuf, "sbuf", _F32, lead + (s, qb, 3)),
        _check(qmask, "qmask", torch.bool, lead + (s, qb)), ctypes.c_int(s), ctypes.c_int(qb),
        *_carry_in(pose, fitness, local_cov, total, params, max_iteration, lead),
        ctypes.c_float(voxel_size), ctypes.c_float(tile_size), ctypes.c_int(tx0),
        ctypes.c_int(ty0), ctypes.c_int(ty_dim), ctypes.c_int(lanes or 1)]
    return _gn_loop("p2p_register", "elm_p2p_register", args, s, P2P_SUMS, sbuf, lanes)


def _loop_capacity(name, qb: int, radar: bool, lanes: int) -> int:
    ctas = ctypes.c_int(0)
    _raise_on(getattr(library(), f"elm_{name}_capacity")(
        ctypes.c_int(qb), ctypes.c_int(int(radar)), ctypes.c_int(lanes), ctypes.byref(ctas)),
        name)
    return ctas.value


def gicp_register_capacity(qb: int, radar: bool = False, lanes: int = 1) -> int:
    """The CTAs of the GICP loop kernel (its radar form with ``radar``, its
    lane form with ``lanes`` > 1) that the current card holds at once with
    slot blocks of ``qb`` queries (its grid is the smaller of this and the
    slot count, over every lane)."""
    return _loop_capacity("gicp_register", qb, radar, lanes)


def vgicp_register_capacity(qb: int, radar: bool = False, lanes: int = 1) -> int:
    """The CTAs of the VGICP loop kernel (its radar or lane form), as
    :func:`gicp_register_capacity`."""
    return _loop_capacity("vgicp_register", qb, radar, lanes)


def avgicp_register_capacity(qb: int, radar: bool = False, lanes: int = 1) -> int:
    """The CTAs of the AVGICP loop kernel (its radar or lane form), as
    :func:`gicp_register_capacity`."""
    return _loop_capacity("avgicp_register", qb, radar, lanes)


def _cov_loop(name, rows, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params,
              max_iteration, geometry, radar):
    """One launch of the tile loop of kernel E, F or G (``rows`` as
    :func:`_cov_search`'s, ``geometry`` the tile geometry the search
    takes). The lane form, as :func:`p2p_register`'s: ``slot_tile``
    [B, S], ``sbuf`` [B, S, QB, 3], ``qmask`` [B, S, QB], the carry and
    ``radar`` ([B, S, QB, 3, 3]: the radar form's lane form) with a lane
    axis."""
    lanes, lead = _lanes(sbuf, 3)
    if lanes is not None and lanes > MAX_LANES:
        raise ValueError(f"{name}: at most {MAX_LANES} lanes a launch, got {lanes}")
    s, qb = _qb_of(qmask[0] if lanes else qmask, name)
    args = _halo_rows(name, rows) + [
        _check(slot_tile, "slot_tile", torch.int32, lead + (s,)),
        _check(sbuf, "sbuf", _F32, lead + (s, qb, 3)),
        _check(qmask, "qmask", torch.bool, lead + (s, qb)), ctypes.c_int(s), ctypes.c_int(qb),
        *_carry_in(pose, fitness, local_cov, total, params, max_iteration, lead), *geometry,
        ctypes.c_void_p(None) if radar is None
        else _check(radar, "radar", _F32, lead + (s, qb, 3, 3)),
        ctypes.c_int(lanes or 1)]
    return _gn_loop(name, f"elm_{name}", args, s, GN_SUMS, sbuf, lanes)


def gicp_register(halo_points, halo_point_cov, halo_point_cov_mean, slot_tile, sbuf, qmask,
                  pose, fitness, local_cov, total, params, max_iteration: int, *, voxel_size,
                  tile_size, tx0, ty0, ty_dim, radar=None):
    """Kernels E and M as one loop (icp.gicp_register_plain): the whole GICP
    GN/LM loop of one registration on the tile backend (the radar form with
    the slot-packed ``radar`` [S,QB,3,3]), from the carry (``pose`` [4,4],
    ``fitness``, ``local_cov`` [6,6]) for at most ``max_iteration``
    iterations, in one cooperative launch; nothing is read back. Returns
    (pose [4,4], local_cov [6,6] = (JTJ + lambda diag)^-1, fitness,
    overlap, failed, iterations int32). The lane form, as
    :func:`p2p_register`'s (``radar`` [B,S,QB,3,3] for the radar form's):
    B registrations in the one launch, local_cov exported per lane."""
    return _cov_loop(
        "gicp_register",
        [("halo_points", halo_points, _F32, (3,)),
         ("halo_point_cov", halo_point_cov, _F32, (3, 3)),
         ("halo_point_cov_mean", halo_point_cov_mean, _F32, (3,))],
        slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params, max_iteration,
        _tile_geometry(voxel_size, tile_size, tx0, ty0, ty_dim), radar)


def vgicp_register(halo_vox_mean, halo_vox_cov, halo_vox_coord, slot_tile, sbuf, qmask, pose,
                   fitness, local_cov, total, params, max_iteration: int, *, voxel_size,
                   tile_size, tx0, ty0, ty_dim, radar=None):
    """Kernels F and M as one loop (icp.vgicp_register_plain): the whole
    VGICP GN/LM loop of one registration on the tile backend, as
    :func:`gicp_register` (local_cov comes back as given)."""
    return _cov_loop(
        "vgicp_register",
        [("halo_vox_mean", halo_vox_mean, _F32, (3,)),
         ("halo_vox_cov", halo_vox_cov, _F32, (3, 3)),
         ("halo_vox_coord", halo_vox_coord, torch.int32, (3,))],
        slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params, max_iteration,
        _tile_geometry(voxel_size, tile_size, tx0, ty0, ty_dim), radar)


def avgicp_register(halo_vox_mean, halo_vox_cov, halo_vox_coord, slot_tile, sbuf, qmask, pose,
                    fitness, local_cov, total, params, max_iteration: int, *, voxel_size,
                    radar=None):
    """Kernels G and M as one loop (icp.avgicp_register_plain): the whole
    AVGICP GN/LM loop of one registration on the tile backend, as
    :func:`gicp_register` (local_cov comes back as given; G's gate runs in
    world coordinates: no tile geometry)."""
    return _cov_loop(
        "avgicp_register",
        [("halo_vox_mean", halo_vox_mean, _F32, (3,)),
         ("halo_vox_cov", halo_vox_cov, _F32, (3, 3)),
         ("halo_vox_coord", halo_vox_coord, torch.int32, (3,))],
        slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params, max_iteration,
        [ctypes.c_float(voxel_size)], radar)


# --------------------------------------------------------------------------- #
# Kernel N: the window shift (a pointer table over the halo tensors)
# --------------------------------------------------------------------------- #

def shift_window(base, nx: int, ny: int, dx: int, dy: int, dst_rows, payload):
    """Kernel N (map.tiles.shift_window_plain): ``base`` and ``payload`` map
    each halo field name to its tensor, [T+1, M, ...] and [r_pad, M, ...]
    (None for a field the map lacks, in both); returns the shifted window's
    tensors by field, new tensors written out of place."""
    t1 = nx * ny + 1
    r_pad = dst_rows.shape[0]
    names = [f for f, a in base.items() if a is not None]
    ptrs = {"base": [], "out": [], "payload": []}
    words = []
    out = {f: None for f in base}
    for f in names:
        a, p = base[f], payload[f]
        if p is None:
            raise ValueError(f"shift_window: no payload for {f}")
        dt = torch.int32 if f == "halo_vox_coord" else _F32
        ptrs["base"].append(_check(a, f, dt, (t1,) + tuple(a.shape[1:])).value)
        ptrs["payload"].append(_check(p, f"{f} payload", dt, (r_pad,) + tuple(a.shape[1:])).value)
        out[f] = torch.empty_like(a)
        ptrs["out"].append(out[f].data_ptr())
        words.append(a[0].numel())  # 4-byte elements
    p_dst = _check(dst_rows, "dst_rows", torch.int32, (r_pad,))
    rc = library().elm_shift_window(
        _ptr_array(ptrs["base"]), _ptr_array(ptrs["out"]), _ptr_array(ptrs["payload"]),
        (ctypes.c_int * len(words))(*words), ctypes.c_int(len(names)), ctypes.c_int(nx),
        ctypes.c_int(ny), ctypes.c_int(dx), ctypes.c_int(dy), p_dst, ctypes.c_int(r_pad),
        _stream(dst_rows))
    _raise_on(rc, "shift_window")
    launches["shift_window"] += 1
    return out


# --------------------------------------------------------------------------- #
# Kernel P: the slot-packed radar covariances of a registration
# --------------------------------------------------------------------------- #

def radar_cov(src_local, qidx, qmask, pose, params):
    """Kernel P (register.icp.radar_slots_plain): ``radar_point_cov`` of the
    scan [N, 3] at the world pose [4, 4], on the rows of the slot assignment
    (``qidx``, ``qmask`` [S, QB]), zero where ``qmask`` is false. Returns
    [S, QB, 3, 3]."""
    n = src_local.shape[0]
    s, qb = qmask.shape
    args = [_check(src_local, "src_local", _F32, (n, 3)), ctypes.c_int(n),
            _check(qidx, "qidx", torch.int32, (s, qb)), _check(qmask, "qmask", _BOOL, (s, qb)),
            ctypes.c_int(s * qb), _check(pose, "pose", _F32, (4, 4)),
            _check(params.range_variance_m, "range_variance_m", _F32, ()),
            _check(params.azimuth_variance_deg, "azimuth_variance_deg", _F32, ()),
            _check(params.elevation_variance_deg, "elevation_variance_deg", _F32, ())]
    out = torch.empty((s, qb, 3, 3), dtype=_F32, device=src_local.device)
    rc = library().elm_radar_cov(*args, _ptr(out), _stream(src_local))
    _raise_on(rc, "radar_cov")
    launches["radar_cov"] += 1
    return out


#: the last IcpParams given, its three variance tensors and their pointer
#: record: a pipeline passes the same params object every registration
_radar_params = [None, (), None]


def _variances(params):
    fields = (params.range_variance_m, params.azimuth_variance_deg,
              params.elevation_variance_deg)
    if params is not _radar_params[0] or not all(map(operator.is_, fields, _radar_params[1])):
        names = ("range_variance_m", "azimuth_variance_deg", "elevation_variance_deg")
        ptrs = _ptr_array([_check(f, n, _F32, ()).value for f, n in zip(fields, names)])
        _radar_params[:] = [params, fields, ptrs]
    return _radar_params[2]


def radar_rows(src_local, qidx, qmask, pose, params):
    """Kernel X (register.icp.radar_slots_plain): ``radar_point_cov`` of the
    scan [N, 3] at the world pose [4, 4] on the rows of the slot assignment
    (``qidx``, ``qmask`` [S, QB]), zero where ``qmask`` is false: [S, QB,
    3, 3]; with ``qidx`` and ``qmask`` None on the rows 0..N-1 in order: [N,
    3, 3]. Kernel P's rows, bit for bit. The lane form: the scans
    [B, N, 3], ``qidx`` / ``qmask`` [B, S, QB] (or None) and the poses
    [B, 4, 4] give [B, S, QB, 3, 3] (or [B, N, 3, 3]) in one launch, each
    lane its single launch's rows."""
    lanes, lead = _lanes(src_local, 2)
    n = src_local.shape[-2]
    shape = (n,) if qidx is None else tuple(qmask.shape[len(lead):])
    rows = n if qidx is None else qmask[0].numel() if lanes else qmask.numel()
    args = [_check(src_local, "src_local", _F32, lead + (n, 3)), ctypes.c_int(n),
            _ptr(None) if qidx is None else _check(qidx, "qidx", torch.int32, lead + shape),
            _ptr(None) if qidx is None else _check(qmask, "qmask", _BOOL, lead + shape),
            ctypes.c_int(rows), _check(pose, "pose", _F32, lead + (4, 4)), _variances(params),
            ctypes.c_int(lanes or 1)]
    out = torch.empty(lead + shape + (3, 3), dtype=_F32, device=src_local.device)
    rc = library().elm_radar_rows(*args, _ptr(out), _stream(src_local))
    _raise_on(rc, "radar_rows")
    launches["radar_rows"] += 1
    return out


# --------------------------------------------------------------------------- #
# Kernels Q, R, Y and Z: the hash grid (csrc/hash_correspond.cu, csrc/hash.cuh,
# csrc/ground_height.cu, csrc/grid_query.cu, csrc/ground_probe.cu)
# --------------------------------------------------------------------------- #

#: kernel Q's method codes (csrc/hash_correspond.cu ``Method``)
HASH_METHODS = {"P2P": 0, "GICP": 1, "VGICP": 2, "AVGICP": 3}
_HASH_THREADS = 128


def _grid_table(grid):
    t = grid.table.shape[0]
    return [_check(grid.table, "table", torch.int32, (t,)),
            _check(grid.table_fp, "table_fp", torch.int32, (t,)),
            ctypes.c_int(grid.table_size), ctypes.c_int(grid.max_probe),
            ctypes.c_int(grid.sentinel)]


def _grid_args(grid, method):
    """The C entries' map arguments: the table, then the geometry; the
    per-point covariances only for GICP (null otherwise)."""
    v1, m = grid.points.shape[:2]
    gicp = method == "GICP"
    if gicp and grid.point_cov is None:
        raise ValueError("hash GICP: the grid has no per-point covariances "
                         "(build the map with compute_point_cov=True)")
    null = ctypes.c_void_p(None)
    return _grid_table(grid) + [
        _check(grid.points, "points", _F32, (v1, m, 3)), ctypes.c_int(m),
        _check(grid.counts, "counts", torch.int32, (v1,)),
        _check(grid.point_cov, "point_cov", _F32, (v1, m, 3, 3)) if gicp else null,
        _check(grid.point_cov_mean, "point_cov_mean", _F32, (v1, m, 3)) if gicp else null,
        _check(grid.vox_mean, "vox_mean", _F32, (v1, 3)),
        _check(grid.vox_cov, "vox_cov", _F32, (v1, 3, 3)),
        ctypes.c_float(grid.voxel_size)]


def hash_correspond(grid, src, valid, pose, max_dist, method: str, radar=None):
    """Kernel Q (icp.hash_search_reduce_plain): the sums of one GN iteration
    of ``method`` at ``pose`` over the scan ``src`` [N, 3] (mask ``valid``),
    [18] for P2P (:func:`gn_step`'s P2P layout) or [44]; ``radar`` [N, 3, 3]
    (query order) selects the radar form of GICP, VGICP and AVGICP."""
    n = src.shape[0]
    code = HASH_METHODS[method]
    np_ = P2P_SUMS if method == "P2P" else GN_SUMS
    args = _grid_args(grid, method) + [
        _check(src, "src", _F32, (n, 3)), _check(valid, "valid", _BOOL, (n,)), ctypes.c_int(n),
        _check(pose, "pose", _F32, (4, 4)), _check(max_dist, "max_dist", _F32, ()),
        ctypes.c_void_p(None) if radar is None or method == "P2P"
        else _check(radar, "radar", _F32, (n, 3, 3)), ctypes.c_int(code)]
    blocks = max((n + _HASH_THREADS - 1) // _HASH_THREADS, 1)
    partials = torch.empty((blocks, np_), dtype=_F32, device=src.device)
    sums = torch.empty(np_, dtype=_F32, device=src.device)
    rc = library().elm_hash_search_reduce(*args, _ptr(partials), _ptr(sums), _stream(src))
    _raise_on(rc, "hash_correspond")
    launches["hash_correspond"] += 1
    return sums


def hash_register_capacity(method: str, radar: bool = False, lanes: int = 1) -> int:
    """The CTAs of the hash loop kernel of ``method`` (its radar form with
    ``radar``, its lane form with ``lanes`` > 1) that the current card holds
    at once (its grid is the smaller of this and the scan's blocks of 128
    points, over every lane)."""
    ctas = ctypes.c_int(0)
    _raise_on(library().elm_hash_register_capacity(
        ctypes.c_int(HASH_METHODS[method]), ctypes.c_int(int(radar)), ctypes.c_int(lanes),
        ctypes.byref(ctas)), "hash_register")
    return ctas.value


def hash_register(grid, src, valid, pose, fitness, local_cov, total, params,
                  max_iteration: int, method: str, radar=None):
    """Kernels Q and M as one loop (icp.hash_register_plain): the whole GN/LM
    loop of one registration of ``method`` on the hash grid, the scan
    ``src`` [N, 3] (mask ``valid``) looked up from the current pose every
    iteration (the radar form of GICP, VGICP and AVGICP with ``radar``
    [N, 3, 3] in query order), from the carry (``pose`` [4,4], ``fitness``,
    ``local_cov`` [6,6]) for at most ``max_iteration`` iterations, in one
    cooperative launch; nothing is read back. Returns (pose [4,4],
    local_cov [6,6], fitness, overlap, failed, iterations int32). The lane
    form: ``src`` [B, N, 3], ``valid`` [B, N], the carry, ``total`` and
    ``radar`` ([B, N, 3, 3]) with a lane axis: B registrations in the one
    launch (csrc/gn_loop.cuh gn_loop_lanes), each output with a leading
    lane axis, as :func:`p2p_register`'s."""
    lanes, lead = _lanes(src, 2)
    if lanes is not None and lanes > MAX_LANES:
        raise ValueError(f"hash_register: at most {MAX_LANES} lanes a launch, got {lanes}")
    n = src.shape[-2]
    args = _grid_args(grid, method) + [
        _check(src, "src", _F32, lead + (n, 3)), _check(valid, "valid", _BOOL, lead + (n,)),
        ctypes.c_int(n), *_carry_in(pose, fitness, local_cov, total, params, max_iteration, lead),
        ctypes.c_void_p(None) if radar is None or method == "P2P"
        else _check(radar, "radar", _F32, lead + (n, 3, 3)), ctypes.c_int(HASH_METHODS[method]),
        ctypes.c_int(lanes or 1)]
    return _gn_loop("hash_register", "elm_hash_register", args,
                    (n + _HASH_THREADS - 1) // _HASH_THREADS,
                    P2P_SUMS if method == "P2P" else GN_SUMS, src, lanes)


def _query(entry, name, grid, queries, max_dist, method):
    """One launch of ``entry`` (kernel Y's or Q's query entry, the same C
    arguments) on the world queries [N, 3]; counted under ``name``."""
    n = queries.shape[0]
    dev = queries.device
    lead = (n, 7) if method == "AVGICP" else (n,)
    out = {"rows": torch.empty(lead, dtype=torch.int32, device=dev),
           "slots": torch.empty(lead, dtype=torch.int32, device=dev),
           "valid": torch.empty(lead, dtype=_BOOL, device=dev)}
    if method in ("P2P", "GICP"):
        out["target"] = torch.empty((n, 3), dtype=_F32, device=dev)
    if method != "P2P":
        out["mean"] = torch.empty(lead + (3,), dtype=_F32, device=dev)
        out["cov"] = torch.empty(lead + (3, 3), dtype=_F32, device=dev)
    md = _scalar(max_dist, queries)
    args = _grid_args(grid, method) + [
        _check(queries, "queries", _F32, (n, 3)), ctypes.c_int(n),
        _check(md, "max_dist", _F32, ()), ctypes.c_int(HASH_METHODS[method])]
    args += [_ptr(out.get(k)) for k in ("rows", "slots", "valid", "target", "mean", "cov")]
    rc = getattr(library(), entry)(*args, _stream(queries))
    _raise_on(rc, name)
    launches[name] += 1
    return out


def grid_query(grid, queries, max_dist, method: str):
    """Kernel Y (map.grid.query_*_plain): per world query [N, 3], a dict of
    ``rows``, ``slots`` (int32), ``valid`` and the method's ``target``
    [N, 3] (P2P, GICP), ``mean``, ``cov`` (GICP, VGICP: [N, 3] /
    [N, 3, 3]; AVGICP: [N, 7, 3] / [N, 7, 3, 3], and rows, slots, valid
    [N, 7]); a warp a query (AVGICP: 8 lanes)."""
    return _query("elm_grid_query", "grid_query", grid, queries, max_dist, method)


def hash_query(grid, queries, max_dist, method: str):
    """Kernel Q's query entry, one thread a query: :func:`grid_query`'s
    outputs, bit for bit. Kernel Y's reference; no path launches it."""
    return _query("elm_hash_query", "hash_query", grid, queries, max_dist, method)


def hash_lookup(grid, coords):
    """Kernel Q's lookup entry (map.grid.lookup_plain): voxel coords
    [..., 3] int32 -> rows [...] int32, misses the sentinel row."""
    flat = coords.reshape(-1, 3)
    n = flat.shape[0]
    args = _grid_table(grid) + [_check(flat, "coords", torch.int32, (n, 3)), ctypes.c_int(n)]
    rows = torch.empty(n, dtype=torch.int32, device=coords.device)
    rc = library().elm_hash_lookup(*args, _ptr(rows), _stream(coords))
    _raise_on(rc, "hash_lookup")
    launches["hash_lookup"] += 1
    return rows.reshape(coords.shape[:-1])


#: kernel R's first pass: CTAs of 256 threads, at most this many
_GROUND_BLOCKS = 264


def ground_height(points, position_xy, search_range: float, k: int):
    """Kernel R (map.grid.find_ground_height_plain) over the grid's points
    [V+1, M, 3] without the sentinel row: (found, ground_z) device scalars.
    Kernel Z's reference; no path launches it."""
    v1, m = points.shape[:2]
    if not 1 <= k <= 8:
        raise ValueError(f"ground_height: k in [1, 8] required, got {k}")
    n = (v1 - 1) * m
    x, y = (float(v) for v in position_xy)
    blocks = max(min((n + 255) // 256, _GROUND_BLOCKS), 1)
    args = [_check(points, "points", _F32, (v1, m, 3)), ctypes.c_longlong(n), ctypes.c_float(x),
            ctypes.c_float(y), ctypes.c_float(search_range * search_range), ctypes.c_int(k),
            ctypes.c_int(blocks)]
    dev = points.device
    block_top = torch.empty((blocks, 8), dtype=_F32, device=dev)
    block_count = torch.empty(blocks, dtype=torch.int32, device=dev)
    found = torch.empty((), dtype=_BOOL, device=dev)
    ground_z = torch.empty((), dtype=_F32, device=dev)
    rc = library().elm_ground_height(*args, _ptr(block_top), _ptr(block_count), _ptr(found),
                                     _ptr(ground_z), _stream(points))
    _raise_on(rc, "ground_height")
    launches["ground_height"] += 1
    return found, ground_z


#: kernel Z's workspace words (csrc/ground_probe.cu: the done counter, then
#: a count and 8 floats for each of at most 2,048 CTAs)
_PROBE_WORDS = 1 + 9 * 2048
#: kernel Z's workspace on each (device, stream): the done counter is 0
#: between calls (the last CTA resets it), so calls on one stream share it
#: in turn and calls on two streams never share one
_probe_work = {}


def ground_probe(grid, position_xy, search_range: float, k: int):
    """Kernel Z (map.grid.find_ground_height_plain) over the grid's voxels
    without the sentinel row, reading only the slots below each count:
    (found, ground_z) device scalars, kernel R's bits, in one launch; the
    two outputs are the call's only allocations."""
    v1, m = grid.points.shape[:2]
    if not 1 <= k <= 8:
        raise ValueError(f"ground_probe: k in [1, 8] required, got {k}")
    args = [_check(grid.points, "points", _F32, (v1, m, 3)),
            _check(grid.counts, "counts", torch.int32, (v1,)), ctypes.c_int(v1 - 1),
            ctypes.c_int(m)]
    x, y = (float(v) for v in position_xy)
    dev = grid.points.device
    stream = _stream(grid.points)
    work = _probe_work.get((dev, stream.value))
    if work is None:
        work = _probe_work[(dev, stream.value)] = torch.zeros(_PROBE_WORDS, dtype=torch.int32,
                                                              device=dev)
    found = torch.empty((), dtype=_BOOL, device=dev)
    ground_z = torch.empty((), dtype=_F32, device=dev)
    rc = library().elm_ground_probe(
        *args, ctypes.c_float(x), ctypes.c_float(y), ctypes.c_float(search_range * search_range),
        ctypes.c_int(k), _ptr(work), _ptr(found), _ptr(ground_z), stream)
    _raise_on(rc, "ground_probe")
    launches["ground_probe"] += 1
    return found, ground_z


def launch_floor():
    """One launch of an empty kernel on the current stream (csrc/grid_query.cu
    launch_floor_kernel): the device time under any launch, a yardstick of
    the timing tools; no path launches it, and it is not counted."""
    rc = library().elm_launch_floor(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(rc, "launch_floor")
