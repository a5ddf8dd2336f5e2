"""Plain dataclasses of tensors — the port's stand-in for ``flax.struct``.

State records are ordinary ``@dataclass``es whose fields are tensors (or
nested records); ``Struct.replace`` gives them flax's functional update and
:func:`select` is the field-wise ``where`` the JAX code takes over a pytree.
"""

from __future__ import annotations

import dataclasses

import torch


class Struct:
    """Mixin: ``replace(**changes)`` like a flax struct dataclass."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def select(pred, new, old):
    """Field-wise ``where(pred, new, old)`` for a scalar bool tensor, through
    nested records; fields that are not tensors come from ``new``."""
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: select(pred, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
        })
    if isinstance(new, torch.Tensor):
        return torch.where(pred, new, old)
    return new
