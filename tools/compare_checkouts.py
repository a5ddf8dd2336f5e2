#!/usr/bin/env python3
"""Bit-for-bit comparison of two checkouts' main paths on one card.

Run once from the root of each checkout (the package is imported from the
working directory), both on one card, then compare:

    python3 tools/compare_checkouts.py --cache MAP.npz --out /tmp/parent.npz   # in the parent
    python3 tools/compare_checkouts.py --cache MAP.npz --out /tmp/change.npz   # in the change
    python3 tools/compare_checkouts.py --compare /tmp/parent.npz /tmp/change.npz

Each run replays, on the card, the bench.py headline log (make_world
seed 3, 131,072 raw points a scan sampled 1/5, 21 scans; one map with
voxel and point covariances, packed at halo margins 1 and 2 and as the
hash grid) through the paths of ``chip_smoke.py``: ``run_fused`` on the
tile P2P, GICP, VGICP and AVGICP pipelines, AVGICP with GPS + CAN in the
reference and the Joseph form, GICP, VGICP and AVGICP with radar
covariances, the four methods and GICP's radar form on the hash grid;
``run_frames`` on GICP ("GICP frames"); ``run`` on the fusion pipeline
("FUSION events") and in the tick mode ("P2P tick events"); the windowed
``run_fused(window_chunk=8)`` (48 m window, 40 m sensor gate, the 40-scan
log, prefetch off: every swap synchronous, so the run is deterministic);
and a small P2P log whose IMU stream leads its first scan by 12 s (kernel
H twice a frame). It saves every output of every frame. ``--compare``
lists every array that is not identical (NaN equal to NaN) and exits 1 if
any is, so a change that must leave these paths' results alone is held to
them bit for bit. ``--cache``: an .npz for the map's build (~2 minutes of
NumPy), made by the first run that finds none. Needs one CUDA card;
prints the card's name and power limit.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np

#: path -> (ICP method, entry point, flags); every run is on the card
PATHS = {
    "P2P": ("P2P", "run_fused", ()),
    "GICP": ("GICP", "run_fused", ()),
    "VGICP": ("VGICP", "run_fused", ()),
    "AVGICP": ("AVGICP", "run_fused", ()),
    "AVGICP+GPS+CAN": ("AVGICP", "run_fused", ("fusion",)),
    "AVGICP+GPS+CAN joseph": ("AVGICP", "run_fused", ("fusion", "joseph")),
    "GICP+radar": ("GICP", "run_fused", ("radar",)),
    "VGICP+radar": ("VGICP", "run_fused", ("radar",)),
    "AVGICP+radar": ("AVGICP", "run_fused", ("radar",)),
    "P2P hash": ("P2P", "run_fused", ("hash",)),
    "GICP hash": ("GICP", "run_fused", ("hash",)),
    "VGICP hash": ("VGICP", "run_fused", ("hash",)),
    "AVGICP hash": ("AVGICP", "run_fused", ("hash",)),
    "GICP hash+radar": ("GICP", "run_fused", ("hash", "radar")),
    "GICP frames": ("GICP", "run_frames", ()),
    "FUSION events": ("AVGICP", "run", ("fusion",)),
    "P2P tick events": ("P2P", "run", ("tick",)),
    "P2P windowed": ("P2P", "run_fused", ("window",)),
    "P2P long lead": ("P2P", "run_fused", ("lead",)),
}


def cfg_for(cfg_mod, method, flags):
    """bench.py:_cfg(method) as chip_smoke.method_cfg builds it."""
    cfg = cfg_mod.ElimalocConfig()
    cfg.pcm.icp_method = cfg_mod.IcpMethod[method]
    cfg.ekf.use_gps = cfg.ekf.use_can = "fusion" in flags
    cfg.pcm.use_radar_cov = "radar" in flags
    cfg.ekf.use_imu = "tick" not in flags
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    if method in ("VGICP", "AVGICP"):
        cfg.pcm.max_fitness_score = 2.0
    if "window" in flags:
        cfg.pcm.input_max_dist = 40.0
    return cfg


def headline_log(log_mod, world, scans, seed=4):
    log = log_mod.synthesize_log(world, duration=(scans + 3) * 0.1, points_per_scan=131072,
                                 max_range=100.0, seed=seed)
    sl = slice(None, None, 5)
    return dataclasses.replace(log, scan_points=np.ascontiguousarray(log.scan_points[:, sl]),
                               scan_times=np.ascontiguousarray(log.scan_times[:, sl]),
                               scan_valid=np.ascontiguousarray(log.scan_valid[:, sl]))


def lead_log(log_mod):
    """A small P2P log whose IMU stream leads its first scan by 12 s (the
    vehicle at rest), and its world."""
    small = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = log_mod.synthesize_log(small, duration=0.7, points_per_scan=1024, max_range=50.0,
                                 seed=10, gps_hz=1.0)
    rng = np.random.default_rng(11)
    k = 1200
    t = log.imu_t[0] - 0.01 * np.arange(k, 0, -1)
    acc = np.array([0.02, -0.01, 9.825]) + rng.normal(0, 0.02, (k, 3))
    gyro = np.array([0.002, -0.001, 0.003]) + rng.normal(0, 0.002, (k, 3))
    return small, dataclasses.replace(log, imu_t=np.r_[t, log.imu_t],
                                      imu_acc=np.r_[acc, log.imu_acc],
                                      imu_gyro=np.r_[gyro, log.imu_gyro])


def built_map(builder, world, pcm, cache):
    """The headline map with both covariances, from ``cache`` when it holds
    it (else built and kept there)."""
    if cache and os.path.exists(cache):
        with np.load(cache) as z:
            fields = {k: z[k] for k in z.files}
        for f in dataclasses.fields(builder.BuiltMap):
            if fields[f.name].ndim == 0:
                fields[f.name] = fields[f.name].item()
        return builder.BuiltMap(**fields)
    built = builder.build_voxel_map(
        world, pcm.pcm_voxel_size, pcm.pcm_voxel_max_point, compute_voxel_cov=True,
        compute_point_cov=True, gicp_cov_search_dist=pcm.gicp_cov_search_dist)
    if cache:
        os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
        np.savez(cache, **{f.name: np.asarray(getattr(built, f.name))
                           for f in dataclasses.fields(built)})
    return built


def outputs(result):
    """A run's outputs as flat NumPy arrays: run_fused's / run_frames' dict,
    or run's trajectory with its per-scan dicts stacked."""
    if "scans" not in result:
        return {k: np.asarray(v) for k, v in result.items()}
    out = {k: np.asarray(result[k]) for k in ("t", "pos", "rpy")}
    for k in (result["scans"][0] if result["scans"] else {}):
        out[f"scans.{k}"] = np.stack([s[k] for s in result["scans"]])
    return out


def run(out, cache):
    import torch

    sys.path.insert(0, os.getcwd())
    import elimaloc_tpu_torch  # noqa: F401  (pins full-f32 matmuls)
    from elimaloc_tpu_torch import config as cfg_mod
    from elimaloc_tpu_torch.map import builder, tiles
    from elimaloc_tpu_torch.pipeline import log as log_mod
    from elimaloc_tpu_torch.pipeline import runtime

    if not torch.cuda.is_available():
        raise SystemExit("compare_checkouts: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
          .strip(), flush=True)
    world = log_mod.make_world(seed=3, extent=120.0, n_ground=400_000, n_wall=200_000)
    log = headline_log(log_mod, world, 20)
    window_log = headline_log(log_mod, world, 40)
    pcm = cfg_mod.ElimalocConfig().pcm
    built = built_map(builder, world, pcm, cache)
    packed = {m: tiles.build_tile_map(built, tile_voxels=4, halo_margin=m) for m in (1, 2)}
    ds_points, max_slots = runtime.autosize_budgets(
        log, float(pcm.input_voxel_ds_m), 4.0 * pcm.pcm_voxel_size, qb=16)
    saved = {}
    for path, (method, entry, flags) in PATHS.items():
        cfg = cfg_for(cfg_mod, method, flags)
        lg = window_log if "window" in flags else log
        kw = dict(device="cuda", ds_points=ds_points, ego_ring_size=512, imu_ring_size=256)
        if "lead" in flags:
            cfg.pcm.input_voxel_ds_m = 1.0
            small, lg = lead_log(log_mod)
            pipe = runtime.LocalizationPipeline(
                cfg, builder.build_voxel_map(small, 1.0, 30), device="cuda", ds_points=1024,
                tile_budget=tiles.TileQueryBudget(qb=8, max_slots=1024), ego_ring_size=2048,
                imu_ring_size=2048)
        elif "hash" in flags:
            pipe = runtime.LocalizationPipeline(cfg, built, backend="hash", **kw)
        else:
            budget = tiles.TileQueryBudget(qb=16, max_slots=max_slots)
            if "window" in flags:
                kw.update(map_window_radius=48.0, map_window_prefetch=False)
            pipe = runtime.LocalizationPipeline(
                cfg, packed[2 if method == "AVGICP" else 1], tile_budget=budget, **kw)
        if "joseph" in flags:
            ekf_flags = dataclasses.replace(pipe.static.ekf_flags, joseph_form=True)
            pipe.static = dataclasses.replace(pipe.static, ekf_flags=ekf_flags)
        result = getattr(pipe, entry)(lg)[1]
        for k, v in outputs(result).items():
            saved[f"{path}/{k}"] = v
        print(f"{path}: {entry}, {len(lg.scan_t)} scans", flush=True)
        del pipe
        torch.cuda.empty_cache()
    np.savez(out, **saved)


def compare(a, b):
    x, y = np.load(a), np.load(b)
    diff = sorted(set(x.files) ^ set(y.files))
    for k in sorted(set(x.files) & set(y.files)):
        u, v = x[k], y[k]
        same = u.shape == v.shape and (np.array_equal(u, v, equal_nan=True)
                                       if u.dtype.kind == "f" else np.array_equal(u, v))
        if not same:
            diff.append(k)
    paths = sorted({k.split("/")[0] for k in x.files})
    print(f"compare_checkouts: {len(paths)} paths, {len(x.files)} arrays, {len(diff)} differ: "
          f"{diff[:20]}")
    return 1 if diff else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--cache", default=None, help="an .npz for the headline map's build")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    run(args.out, args.cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
