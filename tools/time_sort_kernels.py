#!/usr/bin/env python3
"""Time kernels B (assign_slots) and C (voxel_downsample) on one GPU.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent).

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5 (26,215 points a scan), the
budgets of ``autosize_budgets`` (qb = 16), and the map without covariances,
packed at halo margin 1 (64 x 64 tiles of 4 m: T = 4096).

1. Kernels C and B on scan 10: C on the raw scan, B on C's kept points
   moved to the scan's truth position. Per kernel: the wrapper's time (CUDA
   events around each of 50 calls after 5 warm-ups, median), its kernels'
   time on the device (torch.profiler over 50 calls, per call, with the
   names of the device kernels one call ran) and its launch count per call.
2. ``run_fused`` of the P2P configuration of chip_smoke.py on the tile map
   and on the hash grid (``backend="hash"``): a warm-up replay, then one
   with a CUDA event at every stage boundary: ms per frame of each stage
   (frames 1..), the frame time p50 and the scans per second.

    python3 tools/time_sort_kernels.py [--label NAME]

Prints one JSON line, with the card's name and power limit. Exits 1
without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CALLS = 50
N_SCANS = 20
STAGES = ("imu", "can_gps", "gate", "scan_times", "ring_query", "deskew", "front",
          "downsample", "assign", "gn", "measurement", "pcm_update", "pcm_stage", "outputs")


def event_ms(fn):
    for _ in range(5):
        fn()
    times = []
    for _ in range(CALLS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn):
    """(device ms per call, the device kernels of one call) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    return sum(per.values()) / CALLS * 1e-3, sorted(per)


class Marks:
    """``mark`` callback of the pipeline: one CUDA event per stage boundary."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def split(self):
        """(ms per frame of each stage, frame p50), frames 1..: frame 0 also
        waits for the batch upload."""
        torch.cuda.synchronize()
        tot = dict.fromkeys(STAGES, 0.0)
        frames = 0
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            frames += name == "imu"
            if frames >= 1:
                tot[name] += a.elapsed_time(b)
        ends = [e for name, e in self.events if name == "outputs"]
        per_frame = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        return {k: v / max(frames, 1) for k, v in tot.items()}, float(np.median(per_frame))


def p2p_cfg(config):
    """chip_smoke.py's ``method_cfg(P2P)`` (bench.py's ``_cfg``)."""
    cfg = config.ElimalocConfig()
    cfg.pcm.icp_method = config.IcpMethod.P2P
    cfg.ekf.use_gps = cfg.ekf.use_can = False
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    label = ap.parse_args().label
    if not torch.cuda.is_available():
        print("time_sort_kernels: no CUDA device", file=sys.stderr)
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
    built = builder.build_voxel_map(world, pcm.pcm_voxel_size, pcm.pcm_voxel_max_point)
    packed = tiles.build_tile_map(built, tile_voxels=4, halo_margin=1)
    dev = torch.device("cuda")
    scan = N_SCANS // 2
    pts = torch.as_tensor(log.scan_points[scan], dtype=torch.float32, device=dev)
    valid = torch.as_tensor(log.scan_valid[scan], device=dev)
    voxel = torch.tensor(float(pcm.input_voxel_ds_m), device=dev)
    kernels.library()

    def down():
        return kernels.voxel_downsample(pts, valid, voxel, ds_points)

    ds, ds_valid, kept = down()
    k = int(np.searchsorted(log.truth_t, log.scan_t[scan]))
    queries = (ds + torch.as_tensor(log.truth_pos[k], dtype=torch.float32, device=dev)
               ).contiguous()
    geo = dict(voxel_size=float(packed.voxel_size), tile_size=float(packed.tile_size),
               tx0=packed.tx0, ty0=packed.ty0, tx_dim=packed.tx_dim, ty_dim=packed.ty_dim)

    def assign():
        return kernels.assign_slots(queries, ds_valid, 16, max_slots, **geo)

    out = {"label": label, "card": smi, "points": int(pts.shape[0]), "ds_points": ds_points,
           "kept": int(kept), "queries": int(queries.shape[0]), "max_slots": max_slots,
           "used_slots": int(assign()["qmask"].any(dim=1).sum())}
    for name, fn in (("voxel_downsample", down), ("assign_slots", assign)):
        kernels.reset_launches()
        fn()
        torch.cuda.synchronize()
        launches = kernels.launches[name]
        ev = event_ms(fn)
        dv, names = device_ms(fn)
        out[name] = {"event_ms": ev, "device_ms": dv, "launches_per_call": launches,
                     "device_kernels": names}
    for backend in ("tile", "hash"):
        pipe = runtime.LocalizationPipeline(
            p2p_cfg(config), packed if backend == "tile" else built, backend=backend,
            device="cuda", ds_points=ds_points, ego_ring_size=512, imu_ring_size=256,
            **({"tile_budget": tiles.TileQueryBudget(qb=16, max_slots=max_slots)}
               if backend == "tile" else {}))
        pipe.run_fused(log)
        marks = Marks()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_fused(log, mark=marks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages, p50 = marks.split()
        out[f"P2P {backend}"] = {"stage_ms": stages, "frame_ms_p50": p50,
                                 "scans_per_s": len(log.scan_t) / wall}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
