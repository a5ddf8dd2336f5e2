"""Scan-to-map registration (port of elimaloc_tpu.register, P2P on tiles)."""

from .icp import (  # noqa: F401
    IcpParams,
    IcpResult,
    IcpStatic,
    make_icp_params,
    make_icp_static,
    run_register,
)
