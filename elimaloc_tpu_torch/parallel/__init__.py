"""Multi-stream replay — port of ``elimaloc_tpu/parallel`` (the fleet mode
only: :func:`stack_streams` and :func:`replay_fused_fleet`, in
``sharding.py`` as in the JAX package; the sharded modes are in ROADMAP
Queue 1, "`parallel/sharding.py`")."""

from .sharding import replay_fused_fleet, stack_streams

__all__ = ["replay_fused_fleet", "stack_streams"]
