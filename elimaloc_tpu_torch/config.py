"""Configuration for the PyTorch port — a behaviour-identical copy of
``elimaloc_tpu.config`` (stdlib only). It is copied, not imported: importing
anything under ``elimaloc_tpu`` runs that package's ``__init__``, which
imports jax, and the GPU host has no jax. Defaults and INI round-trips are
held bit-identical to the original by tests/test_torch_guards.py.

Original module notes follow.

Mirrors every key of the reference's hot-reloadable INI config (reference:
config/localization.ini:1-109 and config/calibration.ini) as typed dataclasses,
plus an INI loader for drop-in parity (reference parser: src/bsw/system/
ini_parser/ini_parser.{h,cpp}). Hot-reload (mtime polling, ini_parser.cpp:33-38)
is provided by :meth:`ConfigWatcher.poll`.

Unlike the reference, the runtime config that reaches jitted code is split off
into small hashable dataclasses so config values are compile-time constants —
the XLA-friendly equivalent of the reference's branch-per-call flags.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Tuple


class IcpMethod(IntEnum):
    """reference: registration.hpp:60"""

    P2P = 0
    GICP = 1
    VGICP = 2
    AVGICP = 3


class GpsType(IntEnum):
    """reference: ekf_localization_config.hpp:18 — note the header enum
    ordering (NAVSATFIX=0) contradicts the ini comment ("0: INSPVAX,
    1: BESTPOS, 2: NavSatFix", localization.ini:30); the code uses the
    header, so the shipped ini value 2 actually selects ODOMETRY."""

    NAVSATFIX = 0
    BESTPOS = 1
    ODOMETRY = 2


class GnssSource(IntEnum):
    """reference: localization_struct.hpp:28"""

    NOVATEL = 0
    NAVSATFIX = 1
    BESTPOS = 2
    PCM = 3
    PCM_INIT = 4


@dataclass
class CalibConfig:
    """reference: config/calibration.ini"""

    ego_to_imu_trans: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ego_to_imu_rot_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ego_to_gps_trans: Tuple[float, float, float] = (0.0, 0.0, 0.5)
    ego_to_gps_rot_deg: Tuple[float, float, float] = (0.0, 0.0, 1.3)
    ego_to_lidar_trans: Tuple[float, float, float] = (0.0961, -0.1338, 0.3032)
    ego_to_lidar_rot_deg: Tuple[float, float, float] = (-1.26, -0.876, 0.287)


@dataclass
class EkfConfig:
    """reference: [ekf_localization] block, config/localization.ini:16-77"""

    debug_print: bool = False
    debug_imu_print: bool = False

    imu_gravity: float = 9.81
    imu_estimate_gravity: bool = True
    imu_estimate_calibration: bool = False
    use_zupt: bool = False
    use_complementary_filter: bool = True

    gps_type: GpsType = GpsType.NAVSATFIX
    gnss_uncertainty_max_m: float = 1.0

    use_gps: bool = False
    use_imu: bool = True
    use_can: bool = False
    use_pcm_matching: bool = True

    can_vel_scale_factor: float = 1.0

    ekf_init_x_m: float = 0.0
    ekf_init_y_m: float = 0.0
    ekf_init_z_m: float = 0.0
    ekf_init_roll_deg: float = 0.0
    ekf_init_pitch_deg: float = 0.0
    ekf_init_yaw_deg: float = 0.0

    state_std_pos_m: float = 0.02
    state_std_rot_deg: float = 0.2
    state_std_vel_mps: float = 2.0
    state_std_gyro_dps: float = 5.0
    state_std_acc_mps: float = 100.0

    imu_std_gyro_dps: float = 0.01
    imu_std_acc_mps: float = 0.001

    imu_bias_cov_gyro: float = 0.0001
    imu_bias_cov_acc: float = 0.0001

    gnss_min_cov_x_m: float = 0.2
    gnss_min_cov_y_m: float = 0.2
    gnss_min_cov_z_m: float = 0.7
    gnss_min_cov_roll_deg: float = 0.0
    gnss_min_cov_pitch_deg: float = 0.0
    gnss_min_cov_yaw_deg: float = 0.0

    can_meas_uncertainty_vel_mps: float = 2.0
    can_meas_uncertainty_yaw_rate_deg: float = 10.0
    bestvel_meas_uncertainty_vel_mps: float = 1.0

    # geodetic origin (reference: launch params, ekf_localization.launch:6-38)
    ref_latitude: float = 37.5583664
    ref_longitude: float = 127.0454771
    ref_height: float = 0.0


@dataclass
class PcmConfig:
    """reference: [pcm_matching] + [common_variable] blocks,
    config/localization.ini:1-13, 79-109"""

    lidar_type: str = "velodyne"
    lidar_scan_time_end: bool = True
    lidar_time_delay: float = 0.03
    lidar_topic_name: str = "/velodyne_points"
    can_topic_name: str = "/kusv_CanInfo_geo_msg"
    imu_topic_name: str = "/imu/data"
    navsatfix_topic_name: str = "/gps/fix"
    projection_mode: str = "Cartesian"

    debug_print: bool = False

    pcm_voxel_size: float = 1.0
    pcm_voxel_max_point: int = 30
    run_deskew: bool = True
    input_max_dist: float = 100.0
    input_index_sampling: int = 5
    input_voxel_ds_m: float = 1.5

    icp_method: IcpMethod = IcpMethod.GICP
    voxel_search_method: int = 2
    gicp_cov_search_dist: float = 0.4
    max_thread: int = 10  # kept for config parity; TPU path ignores it
    max_iteration: int = 10
    max_search_dist: float = 5.0
    lm_lambda: float = 0.5
    icp_termination_threshold_m: float = 0.02
    # TPU extension (no reference analog — the reference re-searches every
    # GN iteration, registration.cpp:310-347): when > 0, correspondences
    # found at one iteration are REUSED until the accumulated pose motion
    # (translation + rotation x scan radius) exceeds this bound, then
    # refreshed. 0 preserves exact reference behavior. At the default 0.02 m
    # termination the 27-voxel winners are nearly static after iteration 1,
    # so 0.5 (half the default pcm voxel) trades ~zero trajectory change for
    # ~2x fewer correspondence passes (A/B in docs/BENCH_NOTES.md).
    corr_refresh_dist_m: float = 0.0
    min_overlap_ratio: float = 0.4
    max_fitness_score: float = 0.5

    use_radar_cov: bool = False
    doppler_trans_lambda: float = 0.5
    range_variance_m: float = 1.0
    azimuth_variance_deg: float = 0.4
    elevation_variance_deg: float = 0.4

    map_path: str = ""


@dataclass
class ShapeBudget:
    """Static shape capacities — the TPU-native replacement for the reference's
    dynamic containers (SURVEY.md §5.7). All padded tensors carry validity
    masks; these bounds pick the compiled shapes."""

    max_scan_points: int = 32768      # post range-gate / index-subsample budget
    max_ds_points: int = 8192         # post voxel-downsample ICP problem size
    max_imu_window: int = 512         # IMU samples spanning one scan (deskew)
    state_ring: int = 1024            # EgoState ring for latency compensation
    avgicp_fanout: int = 7            # face-adjacent voxels (voxel_hash_map.cpp:224-231)
    hash_probe_limit: int = 16        # open-addressing probe bound


@dataclass
class ElimalocConfig:
    ekf: EkfConfig = field(default_factory=EkfConfig)
    pcm: PcmConfig = field(default_factory=PcmConfig)
    calib: CalibConfig = field(default_factory=CalibConfig)
    shapes: ShapeBudget = field(default_factory=ShapeBudget)


# --------------------------------------------------------------------------- #
# INI loading (drop-in parity with the reference's SimpleIni-based parser)
# --------------------------------------------------------------------------- #

def _read_ini(path: str) -> configparser.ConfigParser:
    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"), strict=False)
    cp.optionxform = str  # keep key case
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        cp.read_string(f.read())
    return cp


def _get(cp, section, key, cast, default):
    try:
        raw = cp.get(section, key).strip()
    except (configparser.NoSectionError, configparser.NoOptionError):
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if cast is tuple:  # whitespace-separated float array (ini_parser.cpp array keys)
        return tuple(float(tok) for tok in raw.split())
    return cast(raw)


def load_localization_ini(path: str, cfg: Optional[ElimalocConfig] = None) -> ElimalocConfig:
    """Parse a reference-format localization.ini into ElimalocConfig."""
    cfg = cfg or ElimalocConfig()
    cp = _read_ini(path)
    e, p = cfg.ekf, cfg.pcm

    # [common_variable]
    p.lidar_type = _get(cp, "common_variable", "lidar_type", str, p.lidar_type)
    p.lidar_scan_time_end = _get(cp, "common_variable", "lidar_scan_time_end", bool, p.lidar_scan_time_end)
    p.lidar_time_delay = _get(cp, "common_variable", "lidar_time_delay", float, p.lidar_time_delay)
    p.lidar_topic_name = _get(cp, "common_variable", "lidar_topic_name", str, p.lidar_topic_name)
    p.can_topic_name = _get(cp, "common_variable", "can_topic_name", str, p.can_topic_name)
    p.imu_topic_name = _get(cp, "common_variable", "imu_topic_name", str, p.imu_topic_name)
    p.navsatfix_topic_name = _get(cp, "common_variable", "navsatfix_topic_name", str, p.navsatfix_topic_name)
    p.projection_mode = _get(cp, "common_variable", "projection_mode", str, p.projection_mode)

    # [ekf_localization]
    e.debug_print = _get(cp, "ekf_localization", "debug_print", bool, e.debug_print)
    e.debug_imu_print = _get(cp, "ekf_localization", "debug_imu_print", bool, e.debug_imu_print)
    e.imu_gravity = _get(cp, "ekf_localization", "imu_gravity", float, e.imu_gravity)
    e.imu_estimate_gravity = _get(cp, "ekf_localization", "imu_estimate_gravity", bool, e.imu_estimate_gravity)
    e.imu_estimate_calibration = _get(cp, "ekf_localization", "imu_estimate_calibration", bool, e.imu_estimate_calibration)
    e.use_zupt = _get(cp, "ekf_localization", "use_zupt", bool, e.use_zupt)
    e.use_complementary_filter = _get(cp, "ekf_localization", "use_complementary_filter", bool, e.use_complementary_filter)
    e.gps_type = GpsType(_get(cp, "ekf_localization", "gps_type", int, int(e.gps_type)))
    e.gnss_uncertainty_max_m = _get(cp, "ekf_localization", "gnss_uncertainy_max_m", float, e.gnss_uncertainty_max_m)
    e.use_gps = _get(cp, "ekf_localization", "use_gps", bool, e.use_gps)
    e.use_imu = _get(cp, "ekf_localization", "use_imu", bool, e.use_imu)
    e.use_can = _get(cp, "ekf_localization", "use_can", bool, e.use_can)
    e.use_pcm_matching = _get(cp, "ekf_localization", "use_pcm_matching", bool, e.use_pcm_matching)
    e.can_vel_scale_factor = _get(cp, "ekf_localization", "can_vel_scale_factor", float, e.can_vel_scale_factor)
    for k in ("x_m", "y_m", "z_m", "roll_deg", "pitch_deg", "yaw_deg"):
        setattr(e, f"ekf_init_{k}", _get(cp, "ekf_localization", f"ekf_init_{k}", float, getattr(e, f"ekf_init_{k}")))
    e.state_std_pos_m = _get(cp, "ekf_localization", "ekf_state_uncertainty_pos_m", float, e.state_std_pos_m)
    e.state_std_rot_deg = _get(cp, "ekf_localization", "ekf_state_uncertainty_rot_deg", float, e.state_std_rot_deg)
    e.state_std_vel_mps = _get(cp, "ekf_localization", "ekf_state_uncertainty_vel_mps", float, e.state_std_vel_mps)
    e.state_std_gyro_dps = _get(cp, "ekf_localization", "ekf_state_uncertainty_gyro_dps", float, e.state_std_gyro_dps)
    e.state_std_acc_mps = _get(cp, "ekf_localization", "ekf_state_uncertainty_acc_mps", float, e.state_std_acc_mps)
    e.imu_std_gyro_dps = _get(cp, "ekf_localization", "ekf_imu_uncertainty_gyro_dps", float, e.imu_std_gyro_dps)
    e.imu_std_acc_mps = _get(cp, "ekf_localization", "ekf_imu_uncertainty_acc_mps", float, e.imu_std_acc_mps)
    e.imu_bias_cov_gyro = _get(cp, "ekf_localization", "ekf_imu_bias_cov_gyro", float, e.imu_bias_cov_gyro)
    e.imu_bias_cov_acc = _get(cp, "ekf_localization", "ekf_imu_bias_cov_acc", float, e.imu_bias_cov_acc)
    e.gnss_min_cov_x_m = _get(cp, "ekf_localization", "ekf_gnss_min_cov_x_m", float, e.gnss_min_cov_x_m)
    e.gnss_min_cov_y_m = _get(cp, "ekf_localization", "ekf_gnss_min_cov_y_m", float, e.gnss_min_cov_y_m)
    e.gnss_min_cov_z_m = _get(cp, "ekf_localization", "ekf_gnss_min_cov_z_m", float, e.gnss_min_cov_z_m)
    e.gnss_min_cov_roll_deg = _get(cp, "ekf_localization", "ekf_gnss_min_cov_roll_deg", float, e.gnss_min_cov_roll_deg)
    e.gnss_min_cov_pitch_deg = _get(cp, "ekf_localization", "ekf_gnss_min_cov_pitch_deg", float, e.gnss_min_cov_pitch_deg)
    e.gnss_min_cov_yaw_deg = _get(cp, "ekf_localization", "ekf_gnss_min_cov_yaw_deg", float, e.gnss_min_cov_yaw_deg)
    e.can_meas_uncertainty_vel_mps = _get(cp, "ekf_localization", "ekf_can_meas_uncertainty_vel_mps", float, e.can_meas_uncertainty_vel_mps)
    e.can_meas_uncertainty_yaw_rate_deg = _get(cp, "ekf_localization", "ekf_can_meas_uncertainty_yaw_rate_deg", float, e.can_meas_uncertainty_yaw_rate_deg)
    e.bestvel_meas_uncertainty_vel_mps = _get(cp, "ekf_localization", "ekf_bestvel_meas_uncertainty_vel_mps", float, e.bestvel_meas_uncertainty_vel_mps)

    # [pcm_matching]
    p.debug_print = _get(cp, "pcm_matching", "debug_print", bool, p.debug_print)
    p.pcm_voxel_size = _get(cp, "pcm_matching", "pcm_voxel_size", float, p.pcm_voxel_size)
    p.pcm_voxel_max_point = _get(cp, "pcm_matching", "pcm_voxel_max_point", int, p.pcm_voxel_max_point)
    p.run_deskew = _get(cp, "pcm_matching", "run_deskew", bool, p.run_deskew)
    p.input_max_dist = _get(cp, "pcm_matching", "input_max_dist", float, p.input_max_dist)
    p.input_index_sampling = _get(cp, "pcm_matching", "input_index_sampling", int, p.input_index_sampling)
    p.input_voxel_ds_m = _get(cp, "pcm_matching", "input_voxel_ds_m", float, p.input_voxel_ds_m)
    p.icp_method = IcpMethod(_get(cp, "pcm_matching", "icp_method", int, int(p.icp_method)))
    p.voxel_search_method = _get(cp, "pcm_matching", "voxel_search_method", int, p.voxel_search_method)
    p.gicp_cov_search_dist = _get(cp, "pcm_matching", "gicp_cov_search_dist", float, p.gicp_cov_search_dist)
    p.max_thread = _get(cp, "pcm_matching", "max_thread", int, p.max_thread)
    p.max_iteration = _get(cp, "pcm_matching", "max_iteration", int, p.max_iteration)
    p.max_search_dist = _get(cp, "pcm_matching", "max_search_dist", float, p.max_search_dist)
    p.lm_lambda = _get(cp, "pcm_matching", "lm_lambda", float, p.lm_lambda)
    p.icp_termination_threshold_m = _get(cp, "pcm_matching", "icp_termination_threshold_m", float, p.icp_termination_threshold_m)
    p.corr_refresh_dist_m = _get(cp, "pcm_matching", "corr_refresh_dist_m", float, p.corr_refresh_dist_m)
    p.min_overlap_ratio = _get(cp, "pcm_matching", "min_overlap_ratio", float, p.min_overlap_ratio)
    p.max_fitness_score = _get(cp, "pcm_matching", "max_fitness_score", float, p.max_fitness_score)
    p.use_radar_cov = _get(cp, "pcm_matching", "use_radar_cov", bool, p.use_radar_cov)
    p.doppler_trans_lambda = _get(cp, "pcm_matching", "doppler_trans_lambda", float, p.doppler_trans_lambda)
    p.range_variance_m = _get(cp, "pcm_matching", "range_variance_m", float, p.range_variance_m)
    p.azimuth_variance_deg = _get(cp, "pcm_matching", "azimuth_variance_deg", float, p.azimuth_variance_deg)
    p.elevation_variance_deg = _get(cp, "pcm_matching", "elevation_variance_deg", float, p.elevation_variance_deg)
    return cfg


def load_calibration_ini(path: str, cfg: Optional[ElimalocConfig] = None) -> ElimalocConfig:
    """Parse a reference-format calibration.ini. Raises on malformed vectors,
    mirroring the reference's shutdown-on-invalid (ekf_localization.cpp:244-247)."""
    cfg = cfg or ElimalocConfig()
    cp = _read_ini(path)
    c = cfg.calib

    def vec(section, key, default):
        v = _get(cp, section, key, tuple, default)
        if len(v) != 3:
            raise ValueError(f"Invalid calibration: [{section}] {key} = {v!r}")
        return v

    c.ego_to_imu_trans = vec("Rear To Imu", "transform_xyz_m", c.ego_to_imu_trans)
    c.ego_to_imu_rot_deg = vec("Rear To Imu", "rotation_rpy_deg", c.ego_to_imu_rot_deg)
    c.ego_to_gps_trans = vec("Rear To Gps", "transform_xyz_m", c.ego_to_gps_trans)
    c.ego_to_gps_rot_deg = vec("Rear To Gps", "rotation_rpy_deg", c.ego_to_gps_rot_deg)
    c.ego_to_lidar_trans = vec("Rear To Main LiDAR", "transform_xyz_m", c.ego_to_lidar_trans)
    c.ego_to_lidar_rot_deg = vec("Rear To Main LiDAR", "rotation_rpy_deg", c.ego_to_lidar_rot_deg)
    return cfg


class ConfigWatcher:
    """Hot-reload by mtime polling, the reference's IsFileUpdated semantics
    (ini_parser.cpp:33-38). The dynamic-parameter subset that may change at
    runtime mirrors UpdateDynamicConfig (ekf_algorithm.cpp:68-79)."""

    def __init__(self, localization_ini: str, calibration_ini: Optional[str] = None):
        self.localization_ini = localization_ini
        self.calibration_ini = calibration_ini
        self._mtimes = {}
        self.cfg = ElimalocConfig()
        self.poll(force=True)

    def _mtime(self, path):
        try:
            return os.stat(path).st_mtime_ns
        except OSError:
            return None

    def poll(self, force: bool = False) -> bool:
        """Re-read any file whose mtime changed; returns True if reloaded."""
        updated = False
        for path, loader in (
            (self.localization_ini, load_localization_ini),
            (self.calibration_ini, load_calibration_ini),
        ):
            if not path:
                continue
            m = self._mtime(path)
            if m is not None and (force or m != self._mtimes.get(path)):
                loader(path, self.cfg)
                self._mtimes[path] = m
                updated = True
        return updated


def export_ini(cfg: ElimalocConfig, path: str) -> None:
    """Write the config back out as INI (reference: IniExporter, ini_parser.h:33-47)."""
    cp = configparser.ConfigParser()
    cp.optionxform = str
    p, e = cfg.pcm, cfg.ekf
    cp["common_variable"] = {
        "lidar_type": p.lidar_type,
        "lidar_scan_time_end": str(int(p.lidar_scan_time_end)),
        "lidar_time_delay": repr(p.lidar_time_delay),
        "lidar_topic_name": p.lidar_topic_name,
        "can_topic_name": p.can_topic_name,
        "imu_topic_name": p.imu_topic_name,
        "navsatfix_topic_name": p.navsatfix_topic_name,
        "projection_mode": p.projection_mode,
    }
    ekf_items = {
        "debug_print": str(int(e.debug_print)),
        "debug_imu_print": str(int(e.debug_imu_print)),
        "imu_gravity": repr(e.imu_gravity),
        "imu_estimate_gravity": str(int(e.imu_estimate_gravity)),
        "imu_estimate_calibration": str(int(e.imu_estimate_calibration)),
        "use_zupt": str(int(e.use_zupt)),
        "use_complementary_filter": str(int(e.use_complementary_filter)),
        "gps_type": str(int(e.gps_type)),
        "gnss_uncertainy_max_m": repr(e.gnss_uncertainty_max_m),
        "use_gps": str(int(e.use_gps)),
        "use_imu": str(int(e.use_imu)),
        "use_can": str(int(e.use_can)),
        "use_pcm_matching": str(int(e.use_pcm_matching)),
        "can_vel_scale_factor": repr(e.can_vel_scale_factor),
        "ekf_init_x_m": repr(e.ekf_init_x_m),
        "ekf_init_y_m": repr(e.ekf_init_y_m),
        "ekf_init_z_m": repr(e.ekf_init_z_m),
        "ekf_init_roll_deg": repr(e.ekf_init_roll_deg),
        "ekf_init_pitch_deg": repr(e.ekf_init_pitch_deg),
        "ekf_init_yaw_deg": repr(e.ekf_init_yaw_deg),
        "ekf_state_uncertainty_pos_m": repr(e.state_std_pos_m),
        "ekf_state_uncertainty_rot_deg": repr(e.state_std_rot_deg),
        "ekf_state_uncertainty_vel_mps": repr(e.state_std_vel_mps),
        "ekf_state_uncertainty_gyro_dps": repr(e.state_std_gyro_dps),
        "ekf_state_uncertainty_acc_mps": repr(e.state_std_acc_mps),
        "ekf_imu_uncertainty_gyro_dps": repr(e.imu_std_gyro_dps),
        "ekf_imu_uncertainty_acc_mps": repr(e.imu_std_acc_mps),
        "ekf_imu_bias_cov_gyro": repr(e.imu_bias_cov_gyro),
        "ekf_imu_bias_cov_acc": repr(e.imu_bias_cov_acc),
        "ekf_gnss_min_cov_x_m": repr(e.gnss_min_cov_x_m),
        "ekf_gnss_min_cov_y_m": repr(e.gnss_min_cov_y_m),
        "ekf_gnss_min_cov_z_m": repr(e.gnss_min_cov_z_m),
        "ekf_gnss_min_cov_roll_deg": repr(e.gnss_min_cov_roll_deg),
        "ekf_gnss_min_cov_pitch_deg": repr(e.gnss_min_cov_pitch_deg),
        "ekf_gnss_min_cov_yaw_deg": repr(e.gnss_min_cov_yaw_deg),
        "ekf_can_meas_uncertainty_vel_mps": repr(e.can_meas_uncertainty_vel_mps),
        "ekf_can_meas_uncertainty_yaw_rate_deg": repr(e.can_meas_uncertainty_yaw_rate_deg),
        "ekf_bestvel_meas_uncertainty_vel_mps": repr(e.bestvel_meas_uncertainty_vel_mps),
    }
    cp["ekf_localization"] = ekf_items
    cp["pcm_matching"] = {
        "debug_print": str(int(p.debug_print)),
        "pcm_voxel_size": repr(p.pcm_voxel_size),
        "pcm_voxel_max_point": str(p.pcm_voxel_max_point),
        "run_deskew": str(int(p.run_deskew)),
        "input_max_dist": repr(p.input_max_dist),
        "input_index_sampling": str(p.input_index_sampling),
        "input_voxel_ds_m": repr(p.input_voxel_ds_m),
        "icp_method": str(int(p.icp_method)),
        "voxel_search_method": str(p.voxel_search_method),
        "gicp_cov_search_dist": repr(p.gicp_cov_search_dist),
        "max_thread": str(p.max_thread),
        "max_iteration": str(p.max_iteration),
        "max_search_dist": repr(p.max_search_dist),
        "lm_lambda": repr(p.lm_lambda),
        "icp_termination_threshold_m": repr(p.icp_termination_threshold_m),
        "corr_refresh_dist_m": repr(p.corr_refresh_dist_m),
        "min_overlap_ratio": repr(p.min_overlap_ratio),
        "max_fitness_score": repr(p.max_fitness_score),
        "use_radar_cov": str(int(p.use_radar_cov)),
        "doppler_trans_lambda": repr(p.doppler_trans_lambda),
        "range_variance_m": repr(p.range_variance_m),
        "azimuth_variance_deg": repr(p.azimuth_variance_deg),
        "elevation_variance_deg": repr(p.elevation_variance_deg),
    }
    with open(path, "w", encoding="utf-8") as f:
        cp.write(f)
