#!/usr/bin/env python3
"""Time the GN loop of the tile GICP, VGICP and AVGICP (and their radar
forms) and the hash-backend registrations on one GPU: the "gn" stage of
each frame, the frame, the GN kernels' device time and the
relocalization.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent). It drives only entry
points both designs have (``run_fused``, ``initialize_at``) and sums the
device time of every GN kernel name either runs (the one-iteration search
kernels ``gicp_search_kernel``, ``vgicp_search_kernel``,
``avgicp_search_kernel`` and ``hash_search_kernel``,
``reduce_partials_kernel``, kernel M's ``gn_step_kernel``, the loop kernels
``gicp_register_kernel``, ``vgicp_register_kernel``,
``avgicp_register_kernel`` and ``hash_register_kernel``).

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5, the budgets of
``autosize_budgets`` (qb = 16), one map with both covariances packed at
halo margin 1 (GICP, VGICP) and 2 (AVGICP) and put on the card as the hash
grid, rings of 512 and 256 rows, chip_smoke.py's configurations (the radar
forms with ``use_radar_cov``). The map's build is kept in
``--cache`` (an .npz, made by the first run that finds none) for the runs
after it.

1. ``run_fused`` on tile GICP, VGICP, GICP+radar, VGICP+radar, AVGICP,
   AVGICP+GPS+CAN and the hash backend's P2P, GICP, VGICP and AVGICP (or
   the ``--paths`` given): a warm-up replay, then REPLAYS replays with a
   CUDA event at every stage boundary: ms a frame of each stage (frames 1..
   of each; "gn" is the registration's loop), the frame time p50 and p95
   over all of their frames, the median scans per second, the mean GN
   iterations a frame.
2. One more replay of each under torch.profiler: the device time a frame of
   the GN kernels, by name and summed, of all kernels, and the device's
   busy share.
3. ``initialize_at`` (relocalization, ``max_iteration`` 10) on the tile
   GICP, AVGICP and the hash P2P pipelines from a click 0.7 m and 1 deg off the
   truth at scan 0: wall-clock ms, median of RELOC_CALLS calls after 2
   warm-ups (it reads the registration's success back, so the wall clock is
   its latency).

    python3 tools/time_register_loops.py [--label NAME] [--cache PATH] [--paths P ...]

Prints one JSON line, with the card's name and power limit. Exits 1
without a CUDA device.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_SCANS = 20
REPLAYS = 3
RELOC_CALLS = 20
PATHS = ("GICP", "VGICP", "GICP+radar", "VGICP+radar", "AVGICP", "AVGICP+GPS+CAN", "P2P hash",
         "GICP hash", "VGICP hash", "AVGICP hash")
GN_KERNELS = ("gicp_search_kernel", "vgicp_search_kernel", "avgicp_search_kernel",
              "hash_search_kernel", "reduce_partials_kernel", "gn_step_kernel",
              "gicp_register_kernel", "vgicp_register_kernel", "avgicp_register_kernel",
              "hash_register_kernel")
RELOC_PATHS = ("GICP", "AVGICP", "P2P hash")


class Marks:
    """``mark`` callback of the pipeline: one CUDA event per stage boundary."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def split(self):
        """({stage: ms a frame}, frame times), frames 1..: frame 0 also waits
        for the batch upload. Each interval counts for the mark that ends
        it."""
        torch.cuda.synchronize()
        tot, frames = {}, 0
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            frames += name == "imu"
            if frames >= 1:
                tot[name] = tot.get(name, 0.0) + a.elapsed_time(b)
        ends = [e for name, e in self.events if name == "outputs"]
        per_frame = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        return {k: v / max(frames, 1) for k, v in tot.items()}, per_frame


def device_kernels(fn):
    """({device kernel name: us}, wall ms) of fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    return per, wall


def path_cfg(config, path):
    """chip_smoke.py's ``method_cfg`` (bench.py's ``_cfg``)."""
    method = path.split("+")[0].split(" ")[0]
    cfg = config.ElimalocConfig()
    cfg.pcm.icp_method = config.IcpMethod[method]
    cfg.ekf.use_gps = cfg.ekf.use_can = "+GPS+CAN" in path
    cfg.pcm.use_radar_cov = path.endswith("+radar")
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    if method in ("VGICP", "AVGICP"):
        cfg.pcm.max_fitness_score = 2.0
    return cfg


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--cache", default=None, help="an .npz for the headline map's build")
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_register_loops: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from elimaloc_tpu_torch import config, kernels
    from elimaloc_tpu_torch.map import builder, tiles
    from elimaloc_tpu_torch.pipeline import log as log_mod
    from elimaloc_tpu_torch.pipeline import runtime

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    world = log_mod.make_world(seed=3, extent=120.0, n_ground=400_000, n_wall=200_000)
    log = log_mod.synthesize_log(world, duration=(N_SCANS + 3) * 0.1, points_per_scan=131072,
                                 max_range=100.0, seed=4)
    sl = slice(None, None, 5)
    log.scan_points = np.ascontiguousarray(log.scan_points[:, sl])
    log.scan_times = np.ascontiguousarray(log.scan_times[:, sl])
    log.scan_valid = np.ascontiguousarray(log.scan_valid[:, sl])
    pcm = config.ElimalocConfig().pcm
    ds_points, max_slots = runtime.autosize_budgets(
        log, float(pcm.input_voxel_ds_m), 4.0 * pcm.pcm_voxel_size, qb=16)
    t0 = time.time()
    built = built_map(builder, world, pcm, args.cache)
    map_s = time.time() - t0
    packed = {m: tiles.build_tile_map(built, tile_voxels=4, halo_margin=m) for m in (1, 2)}
    kernels.library()
    n = len(log.scan_t)
    out = {"label": args.label, "card": smi, "map_s": map_s}
    x, y = log.truth_pos[0][:2] + 0.7
    yaw = log.truth_rpy[0][2] + np.deg2rad(1.0)
    for path in args.paths:
        cfg = path_cfg(config, path)
        if path.endswith(" hash"):
            pipe = runtime.LocalizationPipeline(
                cfg, built, backend="hash", device="cuda", ds_points=ds_points,
                ego_ring_size=512, imu_ring_size=256)
        else:
            pipe = runtime.LocalizationPipeline(
                cfg, packed[2 if path.startswith("AVGICP") else 1], device="cuda",
                ds_points=ds_points, ego_ring_size=512, imu_ring_size=256,
                tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots))
        _, outs = pipe.run_fused(log)
        splits, frame_ms, rates = [], [], []
        for _ in range(REPLAYS):
            marks = Marks()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_fused(log, mark=marks)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
            stages, per_frame = marks.split()
            splits.append(stages)
            frame_ms += per_frame
        stages = {k: float(np.mean([s.get(k, 0.0) for s in splits]))
                  for k in dict.fromkeys(k for s in splits for k in s)}
        per, wall = device_kernels(lambda: pipe.run_fused(log))
        gn = {k[:60]: v * 1e-3 / n for k, v in per.items() if any(g in k for g in GN_KERNELS)}
        res = {"gn_ms_per_frame": stages.get("gn", 0.0), "stage_ms": stages,
               "frame_ms_p50": float(np.percentile(frame_ms, 50)),
               "frame_ms_p95": float(np.percentile(frame_ms, 95)),
               "scans_per_s": float(np.median(rates)),
               "iterations_mean": float(np.mean(outs["iterations"])),
               "gn_device_ms_per_frame": sum(gn.values()),
               "gn_device_ms_per_frame_by_kernel": gn,
               "device_ms_per_frame": sum(per.values()) * 1e-3 / n,
               "device_busy_share": sum(per.values()) * 1e-3 / wall}
        if path in RELOC_PATHS:
            times = []
            for i in range(RELOC_CALLS + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, ok = pipe.initialize_at(pipe.reset(), x, y, yaw, log.scan_points[0],
                                           log.scan_valid[0], log.scan_t[0])
                torch.cuda.synchronize()
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            res["initialize_at"] = {"ms_p50": float(np.median(times)), "ok": bool(ok)}
        out[path] = res
        del pipe
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
