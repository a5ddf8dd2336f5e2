"""NumPy -> port converters.

The JAX package's state and parameter records, flattened to NumPy arrays
keyed by field name (nested records as nested dicts), become the port's
records here: float arrays take the requested dtype, integer and bool arrays
keep theirs, and non-array fields (a tile map's grid geometry) pass through.
This module never imports JAX; the caller flattens.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Optional

import numpy as np
import torch

from .ekf.state import EkfParams, EkfState
from .map.grid import MapGrid
from .map.tiles import TileMap
from .parallel import stack_streams
from .pipeline.runtime import PipelineParams, PipelineState
from .register.icp import IcpParams


def _tensor(v, dtype, device):
    a = np.asarray(v)  # may be a read-only view: torch.tensor copies it
    return torch.tensor(a, dtype=dtype if a.dtype.kind == "f" else None,
                        device=device)


def to_struct(cls, fields: dict, *, dtype=torch.float32, device=None):
    """Build dataclass ``cls`` from ``fields`` (keys may be a superset)."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            kwargs[f.name] = to_struct(t, v, dtype=dtype, device=device)
        elif t is torch.Tensor or (t == Optional[torch.Tensor] and v is not None):
            kwargs[f.name] = _tensor(v, dtype, device)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def ekf_params(fields, *, dtype=torch.float32, device=None) -> EkfParams:
    return to_struct(EkfParams, fields, dtype=dtype, device=device)


def ekf_state(fields, *, dtype=torch.float32, device=None) -> EkfState:
    return to_struct(EkfState, fields, dtype=dtype, device=device)


def icp_params(fields, *, dtype=torch.float32, device=None) -> IcpParams:
    return to_struct(IcpParams, fields, dtype=dtype, device=device)


def pipeline_params(fields, *, dtype=torch.float32, device=None) -> PipelineParams:
    """``PipelineParams`` with ``EkfParams`` and ``IcpParams`` inside."""
    return to_struct(PipelineParams, fields, dtype=dtype, device=device)


def pipeline_state(fields, *, dtype=torch.float32, device=None) -> PipelineState:
    """``PipelineState``: the EKF state and both rings."""
    return to_struct(PipelineState, fields, dtype=dtype, device=device)


def _lane_fields(fields, i):
    """Lane ``i`` of flattened fields with a leading lane axis."""
    if isinstance(fields, dict):
        return {k: _lane_fields(v, i) for k, v in fields.items()}
    return np.asarray(fields)[i]


def fleet_state(fields, *, dtype=torch.float32, device=None) -> PipelineState:
    """A fleet's ``PipelineState`` (every field with a leading lane axis, the
    EKF states stacked by ``parallel.stack_streams``) from a list of B
    flattened states, or from one flattened state whose arrays carry a
    leading lane axis (the JAX package's lane-stacked states)."""
    if isinstance(fields, dict):
        lanes = np.asarray(fields["ekf"]["P"]).shape[0]
        fields = [_lane_fields(fields, i) for i in range(lanes)]
    return stack_streams([pipeline_state(f, dtype=dtype, device=device) for f in fields])


def tile_map(fields, *, dtype=torch.float32, device=None) -> TileMap:
    """A device ``TileMap`` from a flattened tile map, covariance fields
    included where present; the window anchor (the JAX package's [2] int32
    leaf) becomes the port's host ints."""
    anchor = fields.get("tile_anchor")
    fields = {**fields, "tile_anchor": (0, 0) if anchor is None
              else tuple(int(v) for v in np.asarray(anchor))}
    return to_struct(TileMap, fields, dtype=dtype, device=device)


def map_grid(fields, *, dtype=torch.float32, device=None) -> MapGrid:
    """A device ``MapGrid`` from a flattened hash grid (the JAX package's
    ``map.grid.MapGrid``): the uint32 fingerprints keep their bits as int32."""
    fp = np.ascontiguousarray(np.asarray(fields["table_fp"], np.uint32)).view(np.int32)
    return to_struct(MapGrid, {**fields, "table_fp": fp}, dtype=dtype, device=device)
