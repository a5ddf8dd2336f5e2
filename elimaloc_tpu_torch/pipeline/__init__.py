"""Replay logs, state rings and the localization runtime (port of
elimaloc_tpu.pipeline: the event loop, the frame loop, the fused replay on
a full map, and the functional replay of a batch dict: ``replay_fused``
here, ``runtime.replay_fused_chunk`` and ``runtime.fused_frame_at``).

From ``runtime`` this exports what JAX's package exports from its own:
the records and their makers, the event steps, ``replay_fused`` and
``shape_icp_covariance``."""

from .log import ReplayLog, ate_rmse, make_world, synthesize_log  # noqa: F401
from .runtime import (  # noqa: F401
    LocalizationPipeline,
    PipelineParams,
    PipelineState,
    PipelineStatic,
    build_fused_batches,
    make_pipeline_params,
    make_pipeline_static,
    replay_fused,
    scan_step,
    imu_step,
    gps_step,
    can_step,
    shape_icp_covariance,
)
