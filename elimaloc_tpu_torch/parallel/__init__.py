"""Multi-device and multi-stream modes — port of ``elimaloc_tpu/parallel``:
JAX's ten names, in ``sharding.py`` as in the JAX package. The meshes
(:func:`make_mesh`, :func:`replicate`) and the sharded modes
(:func:`register_sharded`, :func:`register_batch_dp`,
:func:`register_batch_2d`, :func:`replay_fused_sp`,
:func:`replay_fused_2d`, :func:`replay_fused_dp`) run over
``torch.distributed``, one process a device; the fleet
(:func:`stack_streams`, :func:`replay_fused_fleet`) on one device."""

from .sharding import (
    make_mesh,
    register_batch_2d,
    register_batch_dp,
    register_sharded,
    replay_fused_2d,
    replay_fused_dp,
    replay_fused_fleet,
    replay_fused_sp,
    replicate,
    stack_streams,
)

__all__ = ["make_mesh", "register_batch_2d", "register_batch_dp", "register_sharded",
           "replay_fused_2d", "replay_fused_dp", "replay_fused_fleet", "replay_fused_sp",
           "replicate", "stack_streams"]
