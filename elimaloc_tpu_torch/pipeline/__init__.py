"""Replay logs, state rings and the localization runtime (port of
elimaloc_tpu.pipeline: the event loop, the frame loop and the fused replay
on a full map)."""

from .log import ReplayLog, ate_rmse, make_world, synthesize_log  # noqa: F401
from .runtime import LocalizationPipeline, build_fused_batches  # noqa: F401
