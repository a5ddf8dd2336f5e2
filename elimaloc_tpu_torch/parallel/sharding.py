"""The single-device fleet mode — port of ``elimaloc_tpu/parallel/
sharding.py:256-281`` (:func:`stack_streams`, :func:`replay_fused_fleet`).

JAX's fleet is ``jax.vmap(replay_fused)``: B vehicles' logs localized
against one shared map in one program. Here it is
:func:`pipeline.runtime.replay_fused` on the lanes' frames, the lane axis
a batch dimension of every stage of ``fused_frame``: on the card each
frame launches each kernel's lane form once for all B lanes (kernels H,
C, S, on the tile backend B, with radar covariances X, with CAN or GPS
fusion W, and the loop kernel of the method and backend, once for every
128 lanes; T's two kernels once each), on CPU tensors each stage runs its
plain lane form. Per-lane trajectories equal single-stream replays: every
lane's inputs go through the single frame's arithmetic, and the batched
registration iterates until every lane's gates release, a stopped lane
keeping its carry and its count.

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
