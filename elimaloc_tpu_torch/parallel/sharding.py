"""Multi-device modes — port of ``elimaloc_tpu/parallel/sharding.py``.

JAX's modes are SPMD under ``jax.shard_map``: every device runs one
program on its block of the inputs and ``psum`` is an all-reduce over a
mesh axis. Here every device is one process of a ``torch.distributed``
world, arranged in a :class:`~torch.distributed.device_mesh.DeviceMesh`
with the named dimensions ("dp", "sp") (:func:`make_mesh`). Each rank is
called with the full inputs on its device (:func:`replicate`), takes its
block by its coordinate on the axis, and returns what JAX's global array
holds: a replicated output (``P()``) is the same on every rank, a
dp-sharded one (``P(dp)``) is all-gathered over the dp group, so that
every rank returns the whole ``[B, ...]`` result.

* ``sp`` (point-sharded, :func:`register_sharded`; the sp half of
  :func:`register_batch_2d`): one registration's scan split over the
  axis, ``IcpStatic.psum_axis``. Each rank assigns and searches its own
  points, and the GN sums of every iteration are all-reduced, so every
  rank runs the identical LM step and termination test.
* slot-sharded (:func:`replay_fused_sp`, :func:`replay_fused_2d`):
  ``IcpStatic.slot_shard_axis``, the inputs replicated, every rank runs
  the whole fused frame but searches only its range of the tile slots.
* ``dp`` (:func:`register_batch_dp`, :func:`replay_fused_dp`): each rank
  runs its lanes as a fleet (``register.icp.run_register_lanes``,
  :func:`replay_fused_fleet`), no collective until the all-gather.

The sharded registration itself is ``register/icp.py``'s: one host loop of
one sharded iteration (the local search + reduction, an all-reduce of the
sums, the step), one host sync an iteration. The axis names stay strings
in ``IcpStatic``, as in JAX; an entry point makes its mesh the active one
for the call (:func:`use_mesh`), and the registration resolves a name
through it (:func:`axis_group`, :func:`axis_index`, :func:`axis_size`). A
name with no active mesh raises NameError, as JAX's unbound axis does.

The process group is the caller's: NCCL with one card a rank (``torchrun
--nproc-per-node N``), gloo for several ranks on one card or on the CPU.
:data:`collectives` counts the all-reduces, all-gathers and broadcasts.

The single-device fleet (:func:`stack_streams`, :func:`replay_fused_fleet`,
JAX sharding.py:256-281) is JAX's ``jax.vmap(replay_fused)``: B vehicles'
logs localized against one shared map in one program. Here it is
:func:`pipeline.runtime.replay_fused` on the lanes' frames, the lane axis a
batch dimension of every stage of ``fused_frame``: on the card each frame
launches each kernel's lane form once for all B lanes (kernels H, C, S, on
the tile backend B, with radar covariances X, with CAN or GPS fusion W,
and the loop kernel of the method and backend, once for every 128 lanes;
T's two kernels once each), on CPU tensors each stage runs its plain lane
form. Per-lane trajectories equal single-stream replays: every lane's
inputs go through the single frame's arithmetic, and the batched
registration iterates until every lane's gates release, a stopped lane
keeping its carry and its count.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..ekf.state import EkfState, RecordState, stack_states

#: collectives since the last :func:`reset_collectives`: the GN sums'
#: all-reduces (one a sharded GN iteration), the valid counts' (one a
#: point-sharded registration or lane set), all-gathers (one a tensor) and
#: broadcasts (one a tensor)
collectives = {"gn_sums": 0, "valid_count": 0, "all_gather": 0, "broadcast": 0}

_ACTIVE = contextvars.ContextVar("elimaloc_tpu_torch_mesh", default=None)


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              axis_names=("dp", "sp"), device_type: str = "cuda"):
    """A (dp, sp) ``DeviceMesh`` over the world (JAX sharding.py:33-47).

    Needs an initialised process group, or the environment variables that
    ``init_process_group`` reads (``torchrun`` sets them); its backend is
    the caller's. ``n_devices`` (default: the world size) must equal the
    world size. The default ``dp`` is JAX's: the largest divisor of n not
    above sqrt(n). Each rank's device is ``cuda:(rank % device_count)``;
    the CPU only with ``device_type="cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group()
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: n_devices={n}, but the world has {world} ranks "
                         "(one rank a device)")
    if dp is None:
        dp = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    if n % dp:
        raise ValueError(f"make_mesh: dp={dp} does not divide {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (dp, n // dp), mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, dist.get_rank() % torch.cuda.device_count())


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` is the active mesh inside the block: the registration
    resolves ``IcpStatic.psum_axis`` and ``slot_shard_axis`` through it."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def _bound(axis: str):
    mesh = _ACTIVE.get()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise NameError(f"unbound axis name: {axis} (a sharded registration runs inside "
                        "an entry point of parallel/sharding.py, which activates its mesh)")
    return mesh


def axis_group(axis: str):
    """The process group of the active mesh's dimension ``axis``."""
    return _bound(axis).get_group(axis)


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis`` (JAX ``lax.axis_index``)."""
    return _bound(axis).get_local_rank(axis)


def axis_size(axis: str) -> int:
    """The size of ``axis`` (JAX ``lax.axis_size``)."""
    mesh = _bound(axis)
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def psum(t: torch.Tensor, axis: str, count: str = "gn_sums") -> torch.Tensor:
    """``t`` all-reduced (summed) in place over ``axis`` (JAX ``lax.psum``),
    counted under ``count``. A ring or tree all-reduce gives every rank the
    same bits."""
    dist.all_reduce(t, group=axis_group(axis))
    collectives[count] += 1
    return t


# --------------------------------------------------------------------------- #
# Blocks, gathers and broadcasts of records
# --------------------------------------------------------------------------- #

def _map(fn, tree, record=None):
    """``fn`` on every tensor (or NumPy array) of a record, dict or tensor;
    an EKF state held as one record goes through ``record(root, dtype)``
    when given; other leaves pass through."""
    if record is not None and isinstance(tree, RecordState):
        root = tree.intact_record()
        if root is not None:
            return record(root, tree.P.dtype)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name), record)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v, record) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _block(tree, axis: str, dim: int = 0):
    """This rank's block of every array of ``tree`` along ``dim``, by its
    coordinate on ``axis`` (a ``P(axis)`` in_spec), contiguous."""
    n, i = axis_size(axis), axis_index(axis)

    def take(x):
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"a dimension of {size} does not split over the {axis!r} "
                             f"axis of {n} devices")
        b = size // n
        block = x[(slice(None),) * dim + (slice(i * b, (i + 1) * b),)]
        # the kernels take contiguous rows: a block of an inner axis is copied
        if isinstance(block, torch.Tensor):
            return block.contiguous()
        return np.ascontiguousarray(block)

    return _map(take, tree, lambda root, dtype: RecordState(take(root), dtype))


def _gather_tensor(t, group, n):
    x = t.contiguous()
    flag = x.dtype == torch.bool
    if flag:  # the collectives move bytes, the flags as uint8
        x = x.view(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    collectives["all_gather"] += 1
    out = torch.cat(parts)
    return out.view(torch.bool) if flag else out


def _gather(tree, axis: str):
    """Every tensor of ``tree`` all-gathered along its leading axis over
    ``axis`` (a ``P(axis)`` out_spec): each rank returns the whole result.
    A fleet EKF state goes as its records, one [B, nbytes] buffer."""
    group, n = axis_group(axis), axis_size(axis)

    def gather(x):
        return _gather_tensor(x, group, n)

    return _map(gather, tree, lambda root, dtype: RecordState(gather(root), dtype))


def replicate(tree, mesh):
    """Every tensor of ``tree`` on this rank's device, with rank 0's values
    on every rank (a broadcast from rank 0; JAX sharding.py:209-215).
    NumPy arrays become tensors; an EKF state held as one record stays
    one."""
    dev = mesh_device(mesh)

    def bcast(x):
        t = torch.as_tensor(x).to(dev, copy=True).contiguous()
        flag = t.dtype == torch.bool
        dist.broadcast(t.view(torch.uint8) if flag else t, src=0)
        collectives["broadcast"] += 1
        return t

    return _map(bcast, tree, lambda root, dtype: RecordState(bcast(root), dtype))


# --------------------------------------------------------------------------- #
# Registration (JAX sharding.py:50-138)
# --------------------------------------------------------------------------- #

def _point_static(static, axis: str):
    """JAX's point-sharded static: the method, the trip limit, the radar
    switch, the backend and the budget, with ``psum_axis`` (sharding.py:55-62)."""
    return type(static)(method=static.method, max_iteration=static.max_iteration,
                     use_radar_cov=static.use_radar_cov, backend=static.backend,
                     tile_budget=static.tile_budget, psum_axis=axis)


def register_sharded(scan, valid, grid, init_pose, params, static, mesh,
                     axis: str = "sp"):
    """One registration with the point axis sharded over ``axis`` (JAX
    sharding.py:50-80): this rank registers its block of ``scan`` [N, 3] /
    ``valid`` [N] against the replicated map from the replicated initial
    pose, the valid count and every iteration's GN sums all-reduced.
    Returns the replicated ``IcpResult`` (``dropped``: this rank's own, as
    JAX's unchecked ``P()`` output)."""
    from ..register.icp import run_register  # deferred: map.tiles imports this package

    with use_mesh(mesh):
        scan_l, valid_l = _block(scan, axis), _block(valid, axis)
        return run_register(scan_l, valid_l, grid, init_pose, params,
                            _point_static(static, axis))


def register_batch_dp(scans, valids, grid, init_poses, params, static, mesh,
                      axis: str = "dp"):
    """A batch of independent registrations sharded over ``axis`` (JAX
    sharding.py:83-104): this rank's B/dp lanes of ``scans`` [B, N, 3],
    ``valids`` [B, N], ``init_poses`` [B, 4, 4] as a fleet frame
    (``run_register_lanes``: on the card one launch of the loop kernel's
    lane form), then every field all-gathered to [B, ...]."""
    from ..register.icp import run_register_lanes

    with use_mesh(mesh):
        res = run_register_lanes(_block(scans, axis), _block(valids, axis), grid,
                                 _block(init_poses, axis), params, static)
        return _gather(res, axis)


def register_batch_2d(scans, valids, grid, init_poses, params, static, mesh,
                      dp_axis: str = "dp", sp_axis: str = "sp"):
    """The 2D decomposition (JAX sharding.py:107-138): this rank's
    [B/dp, N/sp] block, each of its lanes point-sharded over ``sp_axis``
    (the GN sums all-reduced over sp only), then the results all-gathered
    over ``dp_axis``."""
    from ..register.icp import run_register_lanes

    with use_mesh(mesh):
        scans_l = _block(_block(scans, dp_axis), sp_axis, dim=1)
        valids_l = _block(_block(valids, dp_axis), sp_axis, dim=1)
        res = run_register_lanes(scans_l, valids_l, grid, _block(init_poses, dp_axis),
                                 params, _point_static(static, sp_axis))
        return _gather(res, dp_axis)


# --------------------------------------------------------------------------- #
# Fused replay (JAX sharding.py:141-236)
# --------------------------------------------------------------------------- #

def _slot_shard_static(ps, axis: str):
    """The PipelineStatic with the ICP slot axis sharded over ``axis``."""
    return dataclasses.replace(
        ps, icp_static=dataclasses.replace(ps.icp_static, slot_shard_axis=axis))


def replay_fused_sp(state, batches, tmap, pp, ps, mesh, axis: str = "sp"):
    """The fused replay of ONE stream over ``axis`` (JAX sharding.py:151-176):
    every stage runs replicated on every rank except the registration's
    search, which takes this rank's range of the tile slots, its GN sums
    all-reduced every iteration. Returns ``runtime.replay_fused``'s
    (state, outs), the same on every rank."""
    from ..pipeline.runtime import replay_fused  # deferred: runtime imports this package

    with use_mesh(mesh):
        return replay_fused(state, batches, tmap, pp, _slot_shard_static(ps, axis))


def replay_fused_2d(states, batches, tmap, pp, ps, mesh, dp_axis: str = "dp",
                    sp_axis: str = "sp"):
    """The 2D fused replay (JAX sharding.py:179-206): this rank's B/dp lanes
    of a fleet (``states`` and ``batches`` with a leading lane axis) through
    :func:`replay_fused_fleet` with each registration slot-sharded over
    ``sp_axis`` (lane by lane), then the states and outputs all-gathered over
    ``dp_axis``."""
    with use_mesh(mesh):
        st, outs = replay_fused_fleet(_block(states, dp_axis),
                                      _block(batches, dp_axis), tmap, pp,
                                      _slot_shard_static(ps, sp_axis))
        return _gather(st, dp_axis), _gather(outs, dp_axis)


def replay_fused_dp(states, batches, tmap, pp, ps, mesh, axis: str = "dp"):
    """The data-parallel fused replay (JAX sharding.py:218-236): this rank's
    B/dp lanes through :func:`replay_fused_fleet` (one launch of each lane
    form a frame on the card), then the states and outputs all-gathered."""
    with use_mesh(mesh):
        st, outs = replay_fused_fleet(_block(states, axis), _block(batches, axis),
                                      tmap, pp, ps)
        return _gather(st, axis), _gather(outs, axis)


# --------------------------------------------------------------------------- #
# The single-device fleet (JAX sharding.py:256-281)
# --------------------------------------------------------------------------- #

def stack_streams(trees):
    """Stack a list of identically-shaped records (pipeline states) or
    batch dicts along a new leading lane axis (JAX sharding.py:256-261):
    NumPy arrays with ``np.stack``, tensors with ``torch.stack``; EKF states
    become one fleet state (``ekf.state.stack_states``: B records in one
    buffer, stacked without packing when they are intact records)."""
    first = trees[0]
    if isinstance(first, EkfState):
        return stack_states(trees)
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: stack_streams([getattr(t, f.name) for t in trees])
                              for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: stack_streams([t[k] for t in trees]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, np.ndarray):
        return np.stack(trees)
    return first


def _no_mark(name):
    return None


def replay_fused_fleet(states, batches, tmap, pp, ps, mark=_no_mark):
    """Multi-stream fused replay on the current device without a mesh
    (JAX sharding.py:264-281, ``vmap(replay_fused)``): ``B`` lanes, one
    shared map. ``states`` carries the leading lane axis
    (:func:`stack_streams`), ``batches`` is a dict of [B, F, ...] NumPy
    arrays (``runtime.fleet_batches``; moved once to ``pp``'s device and
    dtype) or tensors. The batches are made frame-major ([F, B, ...]) and
    go through ``runtime.replay_fused``: each frame is ``fused_frame`` on
    the lanes' frame ([B, ...] per key). Returns (states, outs), ``outs`` a
    dict of [B, F, ...] device tensors (views of the frame-major stack)
    with ``fused_frame``'s keys."""
    from ..pipeline.runtime import _device_batches, replay_fused

    frames = {k: v.transpose(0, 1).contiguous()
              for k, v in _device_batches(batches, pp).items()}
    states, outs = replay_fused(states, frames, tmap, pp, ps, mark=mark)
    return states, {k: v.transpose(0, 1) for k, v in outs.items()}
