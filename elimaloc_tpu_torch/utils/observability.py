"""Runtime observability: the EKF dashboard and trajectory export (port of
``elimaloc_tpu/utils/observability.py``, the same text formats).

Replaces the reference's rviz/plot-topic observability surface (SURVEY.md
§5.5): the 1 Hz PrintState dashboard (ekf_algorithm.hpp:211-260), the
Float32 plot topics (ekf_localization.cpp:613-640), and the pose/covariance
outputs become a text dashboard, a metrics dict, and file exporters. Each
reads its tensors back to the host (one read a call).
"""

from __future__ import annotations

import json
import math
from typing import Dict

import numpy as np
import torch

from ..ekf import EkfState
from ..ekf.state import S_PITCH, S_ROLL, S_X, S_Y, S_YAW, S_Z


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def state_dashboard(state: EkfState, cfg=None) -> str:
    """PrintState equivalent (ekf_algorithm.hpp:211-260)."""
    P = _host(state.P)
    r2d = 180.0 / math.pi
    lines = ["-" * 40]
    # GNSS staleness warning (ekf_algorithm.hpp:215-217)
    if float(state.prev_timestamp) - float(state.prev_gnss_timestamp) > 1.0:
        lines.append("GNSS Not Updated!")
    if cfg is not None:
        gps = {0: "NavSatFix", 1: "BESTPOS", 2: "Odometry"}.get(int(cfg.gps_type), "?")
        lines.append(
            f"GPS: {gps if cfg.use_gps else 'X'}, "
            f"CAN: {'O' if cfg.use_can else 'X'}, "
            f"PCM: {'O' if cfg.use_pcm_matching else 'X'}"
        )
    init = "Init" if bool(state.state_initialized) else "Not Initialized!"
    stab = "Stabilized" if bool(state.state_stabilized) else "Unstabilized!"
    lines.append(f"State {init}, State {stab}")
    lines.append(
        "State Std  "
        f"X: {math.sqrt(max(P[S_X, S_X], 0)):.3f} "
        f"Y: {math.sqrt(max(P[S_Y, S_Y], 0)):.3f} "
        f"Z: {math.sqrt(max(P[S_Z, S_Z], 0)):.3f} m"
    )
    lines.append(
        "           "
        f"Roll: {math.sqrt(max(P[S_ROLL, S_ROLL], 0)) * r2d:.3f} "
        f"Pitch: {math.sqrt(max(P[S_PITCH, S_PITCH], 0)) * r2d:.3f} "
        f"Yaw: {math.sqrt(max(P[S_YAW, S_YAW], 0)) * r2d:.3f} deg"
    )
    if bool(state.pcm_init_on_going):
        lines.append(f"PCM warm-up: {int(state.pcm_update_count)} updates")
    lines.append("-" * 40)
    return "\n".join(lines)


def scan_metrics(out: Dict) -> Dict[str, float]:
    """Per-scan diagnostics dict (the Float32 plot-topic analog)."""
    pose = _host(out["icp_pose"])
    return {
        "scan_end": float(out["scan_end"]),
        "x": float(pose[0, 3]),
        "y": float(pose[1, 3]),
        "z": float(pose[2, 3]),
        "applied": bool(out["applied"]),
        "icp_success": bool(out["icp_success"]),
        "deskew_ok": bool(out["deskew_ok"]),
        "pose_sync_ok": bool(out["pose_sync_ok"]),
        "fitness": float(out["fitness"]),
        "overlap": float(out["overlap"]),
        "iterations": int(out["iterations"]),
    }


def export_trajectory_tum(path: str, t, pos, quat_wxyz) -> None:
    """TUM trajectory format (t x y z qx qy qz qw) for evo/rpg evaluation."""
    with open(path, "w") as f:
        for i in range(len(t)):
            q = quat_wxyz[i]
            f.write(
                f"{t[i]:.6f} {pos[i][0]:.6f} {pos[i][1]:.6f} {pos[i][2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def export_metrics_jsonl(path: str, scans) -> None:
    with open(path, "w") as f:
        for s in scans:
            f.write(json.dumps(scan_metrics(s)) + "\n")


def cov_ellipsoid_markers(means: np.ndarray, covs: np.ndarray):
    """Voxel-covariance visualization glyphs — the VisualizeCovMap marker
    parameters (reference: pcm_matching.cpp:826-898) as arrays.

    Per covariance: eigendecomposition sorted DESCENDING with a determinant
    flip of the first eigenvector when improper (SortEigenvaluesAndEigenvectors
    cpp:826-845), orientation as a (w,x,y,z) quaternion (``lie.rot_to_quat``
    in float64), per-axis scale 3*sqrt(lambda + 0.01) (cpp:883-885), and RGB =
    |components| of the LAST sorted eigenvector — the smallest one, i.e. the
    plane normal of plane-regularized voxel covs (cpp:888-892).

    Returns (pos [N,3], quat_wxyz [N,4], scale [N,3], rgb [N,3]).
    """
    from ..ops import lie

    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    w, v = np.linalg.eigh(covs)             # ascending
    w = w[:, ::-1]                          # descending eigenvalues
    v = v[:, :, ::-1]                       # matching eigenvectors (columns)
    dets = np.linalg.det(v)
    v[dets < 0, :, 0] *= -1.0               # make proper rotations
    quat = lie.rot_to_quat(torch.from_numpy(np.ascontiguousarray(v))).numpy()
    scale = 3.0 * np.sqrt(w + 0.01)
    rgb = np.abs(v[:, :, 2])
    return means, quat, scale, rgb


def export_cov_markers_jsonl(path: str, means, covs) -> None:
    """File-export equivalent of the /pcm/cov_map MarkerArray topic."""
    pos, quat, scale, rgb = cov_ellipsoid_markers(means, covs)
    with open(path, "w") as f:
        for i in range(len(pos)):
            f.write(json.dumps({
                "id": i,
                "pos": [round(float(x), 6) for x in pos[i]],
                "quat_wxyz": [round(float(x), 6) for x in quat[i]],
                "scale": [round(float(x), 6) for x in scale[i]],
                "rgb": [round(float(x), 4) for x in rgb[i]],
                "alpha": 0.5,
            }) + "\n")


def export_cloud_ply(path: str, points: np.ndarray) -> None:
    """Minimal ASCII PLY export (the undistorted/aligned-cloud topics)."""
    pts = _host(points)
    pts = pts[np.isfinite(pts).all(axis=1)]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
