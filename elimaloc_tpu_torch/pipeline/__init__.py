"""Replay logs, rosbag ingest, state rings and the localization runtime (port
of elimaloc_tpu.pipeline: the event loop, the frame loop, the fused replay on
a full map, and the functional replay of a batch dict: ``replay_fused``
here, ``runtime.replay_fused_chunk`` and ``runtime.fused_frame_at``).

From ``runtime`` this exports what JAX's package exports from its own:
the records and their makers, the event steps, ``replay_fused`` and
``shape_icp_covariance``."""

from .log import ReplayLog, _traj as circle_traj, ate_rmse, make_world, synthesize_log  # noqa: F401
from .pointcloud import (  # noqa: F401
    OUSTER_FIELDS,
    VELODYNE_FIELDS,
    convert_scan,
    decode_cloud,
    ouster_to_xyzit,
    velodyne_to_xyzit,
)
from .rosbag import bag_to_replay_log, read_bag  # noqa: F401
from .rings import (  # noqa: F401
    EgoRing,
    ImuRing,
    get_interpolated_pose,
    gnss_time_compensation,
    make_ego_ring,
    make_imu_ring,
    push_ego,
    push_imu,
)
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
