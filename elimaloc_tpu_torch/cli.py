"""Command-line driver — the launch-file equivalent (port of
``elimaloc_tpu/cli.py``, the same subcommands, arguments and printed lines).

    python -m elimaloc_tpu_torch.cli synth   --out drive.npz --map-out map.npz
    python -m elimaloc_tpu_torch.cli build-map --points map_points.npy --out map.npz
    python -m elimaloc_tpu_torch.cli replay  --log drive.npz --map map.npz \\
        [--ini config/localization.ini] [--calib config/calibration.ini] \\
        [--fused] [--traj traj.tum] [--metrics metrics.jsonl] [--device cuda]
    python -m elimaloc_tpu_torch.cli bag-import --bag drive.bag --scan-topic ... \\
        --imu-topic ...

``replay`` runs on the card unless ``--device`` names another device.
Maps load from .npz (saved by build-map / utils.checkpoint), a raw [N,3]
.npy point array or a .pcd file. Configs load from reference-format INI
files with the same keys as the reference's config/localization.ini.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _load_map_points(path):
    if path.endswith(".pcd"):
        from .map import read_pcd_points

        return read_pcd_points(path)
    if path.endswith(".npy"):
        return np.load(path)
    z = np.load(path)
    if "points" in z and "counts" in z:  # BuiltMap checkpoint
        from .utils import load_built_map

        return load_built_map(path)
    return z[list(z.keys())[0]]


def _make_config(args):
    from .config import ElimalocConfig, load_calibration_ini, load_localization_ini

    cfg = ElimalocConfig()
    if args.ini:
        load_localization_ini(args.ini, cfg)
    if getattr(args, "calib", None):
        load_calibration_ini(args.calib, cfg)
    if getattr(args, "site", None):
        from .sites import apply_site

        apply_site(cfg, args.site)
    return cfg


def cmd_synth(args):
    from .pipeline import make_world, synthesize_log

    world = make_world(seed=args.seed)
    log = synthesize_log(
        world, duration=args.duration, points_per_scan=args.points,
        seed=args.seed + 1,
    )
    log.save(args.out)
    if args.map_out:
        np.save(args.map_out if args.map_out.endswith(".npy")
                else args.map_out + ".npy", world)
    print(f"wrote {args.out}: {len(log.scan_t)} scans, "
          f"{len(log.imu_t)} imu samples")


def cmd_build_map(args):
    from .config import IcpMethod
    from .map import build_voxel_map
    from .utils import save_built_map

    pts = _load_map_points(args.points)
    method = IcpMethod(args.icp_method)
    t0 = time.time()
    built = build_voxel_map(
        pts, args.voxel_size, args.max_points,
        compute_voxel_cov=method in (IcpMethod.VGICP, IcpMethod.AVGICP),
        compute_point_cov=method == IcpMethod.GICP,
        gicp_cov_search_dist=args.gicp_cov_search_dist,
    )
    save_built_map(args.out, built)
    print(f"built {built.num_voxels} voxels from {len(pts)} points "
          f"in {time.time() - t0:.1f}s -> {args.out}")


def replay_pipeline(args, log, map_obj, cfg=None):
    """The pipeline ``replay`` runs for parsed ``args``: the configuration
    of --ini / --calib / --site (``cfg`` when the caller made it), the
    geodetic origin a .pcd map's filename carries and, for a log with
    ground truth and no INI, the EKF started at its first true pose with no
    sensor delay (and no lever arm without --calib); qb 32, on --device."""
    from .map import TileQueryBudget
    from .pipeline import LocalizationPipeline

    cfg = _make_config(args) if cfg is None else cfg
    # reference map filenames encode the geodetic origin (launch files)
    if args.map.endswith(".pcd"):
        from .map import parse_origin_from_filename

        origin = parse_origin_from_filename(args.map)
        if origin is not None:
            cfg.ekf.ref_latitude, cfg.ekf.ref_longitude, cfg.ekf.ref_height = origin

    # Synthetic logs carry ground truth and are generated in the ego frame
    # with no sensor delay; without explicit INI/calib, adopt those
    # conventions and start the EKF at the true initial pose (the reference
    # likewise requires a hand-set init pose per site, README.md:157-225).
    if log.truth_t is not None and not args.ini:
        cfg.ekf.ekf_init_x_m = float(log.truth_pos[0][0])
        cfg.ekf.ekf_init_y_m = float(log.truth_pos[0][1])
        cfg.ekf.ekf_init_z_m = float(log.truth_pos[0][2])
        cfg.ekf.ekf_init_roll_deg = float(np.degrees(log.truth_rpy[0][0]))
        cfg.ekf.ekf_init_pitch_deg = float(np.degrees(log.truth_rpy[0][1]))
        cfg.ekf.ekf_init_yaw_deg = float(np.degrees(log.truth_rpy[0][2]))
        cfg.pcm.lidar_time_delay = 0.0
        if not args.calib:
            cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
            cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)

    return LocalizationPipeline(
        cfg, map_obj, device=args.device, ds_points=args.ds_points,
        tile_budget=TileQueryBudget(qb=32, max_slots=args.max_slots))


def cmd_replay(args):
    import torch

    from .map.builder import BuiltMap
    from .ops import lie
    from .pipeline import ReplayLog, ate_rmse
    from .utils import export_metrics_jsonl, export_trajectory_tum, state_dashboard

    cfg = _make_config(args)
    log = ReplayLog.load(args.log)
    map_path = args.map
    if map_path is None and getattr(args, "site", None):
        from .sites import SITES

        map_path = SITES[args.site].map_path
        if map_path is None or not os.path.exists(map_path):
            raise SystemExit(
                f"--map not given and the {args.site!r} preset's default map "
                f"({map_path}) does not exist here; pass --map explicitly"
            )
    if map_path is None:
        raise SystemExit("--map is required (or --site with its map present)")
    args.map = map_path
    map_obj = _load_map_points(map_path)
    pipe = replay_pipeline(args, log, map_obj, cfg)

    live = None
    if getattr(args, "viz_live", None):
        if args.fused:
            raise SystemExit(
                "--viz-live needs per-scan dispatch; drop --fused "
                "(the whole-log fused program has no mid-run hook)"
            )
        from .utils.viz import LiveViz

        live = LiveViz(
            args.viz_live,
            map_points=(map_obj.all_points()
                        if isinstance(map_obj, BuiltMap) else map_obj),
            truth_pos=log.truth_pos,
        )
        print(f"live view: open {args.viz_live} in a browser "
              "(auto-refreshes during the run)")

    t0 = time.time()
    if args.fused:
        state, outs = pipe.run_fused(log)   # one readback, at the end
        t_arr = np.asarray(outs["ego_t_abs"])
        pos = np.asarray(outs["ego_pos"])
        n = len(log.scan_t)
        print(f"fused replay: {n} scans in {time.time() - t0:.2f}s "
              f"({n / (time.time() - t0):.1f} scans/s)")
        print(f"applied: {np.asarray(outs['applied']).mean() * 100:.1f}%")
    else:
        state, traj = pipe.run(log, on_scan=live.on_scan if live else None)
        t_arr, pos = traj["t"], traj["pos"]
        if live is not None:
            live.finish()
        if args.metrics:
            export_metrics_jsonl(args.metrics, traj["scans"])
        print(f"replay: {len(traj['scans'])} scans in {time.time() - t0:.2f}s")
    if log.truth_t is not None:
        print(f"ATE RMSE: {ate_rmse(t_arr, pos, log.truth_t, log.truth_pos):.4f} m")
    print(state_dashboard(state.ekf, cfg.ekf))
    if args.viz:
        from .utils.viz import export_viz_html

        scans = None if args.fused else traj["scans"]
        export_viz_html(
            args.viz, pos,
            map_points=(map_obj.all_points()
                        if isinstance(map_obj, BuiltMap) else map_obj),
            truth_pos=log.truth_pos, scans=scans,
        )
        print(f"wrote {args.viz} (open in a browser)")
    if args.traj:
        rpys = np.asarray(traj["rpy"]) if not args.fused else np.asarray(outs["ego_rpy"])
        quats = lie.rot_to_quat(lie.euler_to_rot(torch.as_tensor(rpys))).numpy()
        export_trajectory_tum(args.traj, t_arr, pos, quats)
        print(f"wrote {args.traj}")


def cmd_bag_import(args):
    from .pipeline.rosbag import bag_to_replay_log

    origin = None
    if args.ref_lat is not None or args.ref_lon is not None:
        if args.ref_lat is None or args.ref_lon is None:
            raise SystemExit(
                "--ref-lat and --ref-lon must be given together "
                "(--ref-hgt defaults to 0)"
            )
        origin = (args.ref_lat, args.ref_lon, args.ref_hgt)
    log = bag_to_replay_log(
        args.bag, args.scan_topic, args.imu_topic,
        gps_topic=args.gps_topic, can_topic=args.can_topic,
        lidar_type=args.lidar_type, index_sampling=args.index_sampling,
        ref_origin=origin, projection_mode=args.projection_mode,
    )
    log.save(args.out)
    extras = [s for s, on in (("gps", log.gps_t is not None),
                              ("can", log.can_t is not None)) if on]
    print(f"wrote {args.out}: {len(log.scan_t)} scans, "
          f"{len(log.imu_t)} imu samples"
          + (f", +{'/'.join(extras)}" if extras else ""))


def parser():
    """The command line's argument parser (``main``'s)."""
    ap = argparse.ArgumentParser(prog="elimaloc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser(
        "bag-import",
        help="convert a reference-style rosbag to the .npz replay log",
    )
    p.add_argument("--bag", required=True)
    p.add_argument("--out", default="drive.npz")
    p.add_argument("--scan-topic", required=True)
    p.add_argument("--imu-topic", required=True)
    p.add_argument("--gps-topic", default=None)
    p.add_argument("--can-topic", default=None)
    p.add_argument("--lidar-type", default="velodyne",
                   help='"ouster" applies --index-sampling (reference '
                        "pcm_matching.cpp:218-224)")
    p.add_argument("--index-sampling", type=int, default=1)
    p.add_argument("--ref-lat", type=float, default=None,
                   help="geodetic origin (default: first GPS fix)")
    p.add_argument("--ref-lon", type=float, default=None)
    p.add_argument("--ref-hgt", type=float, default=0.0)
    p.add_argument("--projection-mode", default="Cartesian",
                   choices=["Cartesian", "UTM"])
    p.set_defaults(fn=cmd_bag_import)

    p = sub.add_parser("synth", help="generate a synthetic world + drive log")
    p.add_argument("--out", default="drive.npz")
    p.add_argument("--map-out", default="world.npy")
    p.add_argument("--duration", type=float, default=20.0)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("build-map", help="build + cache the packed voxel map")
    p.add_argument("--points", required=True, help="[N,3] .npy or .pcd")
    p.add_argument("--out", default="map.npz")
    p.add_argument("--voxel-size", type=float, default=1.0)
    p.add_argument("--max-points", type=int, default=30)
    p.add_argument("--icp-method", type=int, default=1)
    p.add_argument("--gicp-cov-search-dist", type=float, default=0.4)
    p.set_defaults(fn=cmd_build_map)

    p = sub.add_parser("replay", help="replay a log against a map")
    p.add_argument("--log", required=True)
    p.add_argument("--map", default=None,
                   help="map points/PCD/BuiltMap (defaults to the --site "
                        "preset's map path when present)")
    p.add_argument("--ini", default=None)
    p.add_argument("--calib", default=None)
    p.add_argument("--fused", action="store_true")
    p.add_argument("--ds-points", type=int, default=8192)
    p.add_argument("--max-slots", type=int, default=1536)
    p.add_argument("--traj", default=None, help="write TUM trajectory")
    p.add_argument("--metrics", default=None, help="write per-scan jsonl")
    p.add_argument("--viz", default=None,
                   help="write an interactive HTML replay view")
    p.add_argument("--viz-live", default=None, metavar="HTML",
                   help="LIVE HTML view updated during the run (open in a "
                        "browser; auto-refreshes ~1 Hz; event-loop mode "
                        "only)")
    p.add_argument("--site", default=None,
                   help="site preset (kcity/katri/pangyo/hanyang/stairs): "
                        "geodetic origin per the reference launch files")
    p.add_argument("--device", default="cuda",
                   help="the pipeline's device: the card (default) or cpu")
    p.set_defaults(fn=cmd_replay)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
