"""Checkpoint / resume: the built map and the pipeline state on disk (port of
``elimaloc_tpu/utils/checkpoint.py``).

The map build (the minutes-scale precompute, pcm_matching.cpp:86-101) is
cached as the JAX package caches it. A state record is written in the npz
layout JAX's ``save_state`` writes: its arrays in field order, depth first
through nested records (the order ``jax.tree_util.tree_flatten`` gives the
JAX package's records, whose fields are the port's), as ``leaf_0``,
``leaf_1``, ...; ``load_state`` of either package reads only those keys,
so a file saved by one loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ekf.state import EkfState, RecordState
from ..map.builder import BuiltMap


def save_built_map(path: str, built: BuiltMap) -> None:
    data = {
        k: v
        for k, v in dataclasses.asdict(built).items()
        if isinstance(v, np.ndarray)
    }
    data["_meta"] = np.array(
        [built.voxel_size, built.max_points_per_voxel, built.table_size,
         built.max_probe]
    )
    np.savez_compressed(path, **data)


def load_built_map(path: str) -> BuiltMap:
    z = np.load(path)
    voxel_size, max_pts, table_size, max_probe = z["_meta"]
    return BuiltMap(
        voxel_size=float(voxel_size),
        max_points_per_voxel=int(max_pts),
        vox_coords=z["vox_coords"],
        points=z["points"],
        counts=z["counts"],
        vox_mean=z["vox_mean"],
        vox_cov=z["vox_cov"],
        table=z["table"],
        table_fp=z["table_fp"],
        table_size=int(table_size),
        max_probe=int(max_probe),
        point_cov=z["point_cov"] if "point_cov" in z else None,
        point_cov_mean=z["point_cov_mean"] if "point_cov_mean" in z else None,
    )


def _leaves(node):
    """The arrays of a record in field order, depth first; None is no leaf
    (as in a JAX pytree)."""
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _leaves(getattr(node, f.name))
    elif node is not None:
        yield node


def _structure(node) -> str:
    if dataclasses.is_dataclass(node):
        inner = ", ".join(f"{f.name}={_structure(getattr(node, f.name))}"
                          for f in dataclasses.fields(node))
        return f"{type(node).__name__}({inner})"
    return "None" if node is None else "*"


def save_state(path: str, state) -> None:
    """Persist a state record (``PipelineState``, ``EkfState``, a ring; a
    fleet's with its lane axis) as npz, one ``leaf_i`` an array."""
    leaves = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
              for v in _leaves(state)]
    np.savez_compressed(
        path,
        _treedef=np.frombuffer(_structure(state).encode(), dtype=np.uint8),
        **{f"leaf_{i}": v for i, v in enumerate(leaves)},
    )


def load_state(path: str, like):
    """A state saved by :func:`save_state` (or JAX's) in the structure of
    ``like``: each array as a tensor of ``like``'s field's dtype, on its
    device. A packed ``EkfState`` (an EKF kernel's ``RecordState``) comes
    back as a plain ``EkfState``."""
    z = np.load(path)
    n = sum(1 for _ in _leaves(like))
    saved = sum(1 for k in z.files if k.startswith("leaf_"))
    if saved != n:
        raise ValueError(f"{path}: {saved} arrays saved, the record has {n}")
    count = iter(range(n))

    def build(node):
        if dataclasses.is_dataclass(node):
            cls = EkfState if isinstance(node, RecordState) else type(node)
            return cls(**{f.name: build(getattr(node, f.name))
                          for f in dataclasses.fields(node)})
        if node is None:
            return None
        i = next(count)
        arr = z[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(np.shape(node)):
            raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, the record's "
                             f"field {tuple(np.shape(node))}")
        if isinstance(node, torch.Tensor):
            return torch.tensor(arr, device=node.device).to(node.dtype)
        return np.asarray(arr, dtype=np.asarray(node).dtype)

    return build(like)
