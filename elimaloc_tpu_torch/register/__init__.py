"""Scan-to-map registration (port of elimaloc_tpu.register: P2P, GICP, VGICP
and AVGICP on the tile and the hash backend, with or without radar
covariances, one registration or a fleet frame's lanes)."""

from .icp import (  # noqa: F401
    IcpParams,
    IcpResult,
    IcpStatic,
    calculate_velocity,
    make_icp_params,
    make_icp_static,
    radar_point_cov,
    run_register,
    separate_points_z,
)
