"""The single-device fleet mode — port of ``elimaloc_tpu/parallel/
sharding.py:256-281`` (:func:`stack_streams`, :func:`replay_fused_fleet`).

JAX vmaps its fused replay over a leading lane axis: B vehicles' logs
localized against one shared map in one program. Here the lane axis is a
batch dimension of every stage of :func:`pipeline.runtime.fused_frame`: on
the card each frame launches each kernel's lane form once for all B lanes
(kernels H, C, S, on the tile backend B, with radar covariances X, with
CAN or GPS fusion W, and the loop kernel of the method and backend, once
for every 128 lanes; T's two kernels once each), on CPU tensors each stage
runs its plain lane form. Per-lane trajectories equal
single-stream replays: every lane's inputs go through the single frame's
arithmetic, and the batched registration iterates until every lane's gates
release, a stopped lane keeping its carry and its count.

The sharded modes (``replay_fused_dp`` over a device mesh, the meshes, the
sharded registration) are not ported: ROADMAP Queue 1,
"`parallel/sharding.py`".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ekf.state import EkfState, stack_states


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
    (JAX sharding.py:264-281): ``B`` lanes, one shared map. ``states``
    carries the leading lane axis (:func:`stack_streams`), ``batches`` is
    a dict of [B, F, ...] arrays or tensors (``runtime.fleet_batches``),
    moved to the map's device once, frame-major. Each frame is
    ``runtime.fused_frame`` on the lanes' frame ([B, ...] per key), the
    outputs stacked on the device. Returns (states, outs), ``outs`` a dict
    of [B, F, ...] device tensors with ``fused_frame``'s keys."""
    from ..pipeline.runtime import batches_to_device, fused_frame

    dtype = pp.tf_ego_to_lidar.dtype
    device = pp.tf_ego_to_lidar.device
    frames = {k: v.transpose(0, 1).contiguous()
              for k, v in batches_to_device(batches, device, dtype).items()}
    outs = []
    for k in range(frames["scan_t"].shape[0]):
        states, out = fused_frame(states, {key: v[k] for key, v in frames.items()}, tmap, pp,
                                  ps, mark=mark)
        outs.append(out)
    return states, {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}
