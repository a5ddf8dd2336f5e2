"""Checkpoints, the dashboard and exporters, stage timers, the replay view
(port of elimaloc_tpu.utils; ``roofline`` goes with the port's bench)."""

from .checkpoint import (  # noqa: F401
    load_built_map,
    load_state,
    save_built_map,
    save_state,
)
from .observability import (  # noqa: F401
    cov_ellipsoid_markers,
    export_cloud_ply,
    export_cov_markers_jsonl,
    export_metrics_jsonl,
    export_trajectory_tum,
    scan_metrics,
    state_dashboard,
)
from .timing import StageTimers, device_trace  # noqa: F401
