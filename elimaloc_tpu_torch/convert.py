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

import numpy as np
import torch

from .ekf.state import EkfParams, EkfState
from .map.tiles import TileMap
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
        elif t is torch.Tensor:
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


def tile_map(fields, *, dtype=torch.float32, device=None) -> TileMap:
    """A device ``TileMap`` from a flattened tile map (point level only; the
    port serves full maps, so a window anchor must be zero)."""
    anchor = fields.get("tile_anchor")
    if anchor is not None and np.any(np.asarray(anchor) != 0):
        raise NotImplementedError(
            "shifted active windows are ROADMAP Queue 1 #14")
    return to_struct(TileMap, fields, dtype=dtype, device=device)
