"""Replay logs, state rings and the fused localization runtime (port of
elimaloc_tpu.pipeline, fused P2P path)."""

from .log import ReplayLog, ate_rmse, make_world, synthesize_log  # noqa: F401
from .runtime import LocalizationPipeline, build_fused_batches  # noqa: F401
