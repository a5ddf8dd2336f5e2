#!/usr/bin/env python3
"""Time the scan's front of the fused frame on one GPU: the range gate, the
scan times, the ring queries and the deskew, with kernels T, K and D alone.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent). It drives only entry
points both designs have (``run_fused``, ``scan_step``'s arguments) and
takes each kernel wrapper it finds: where the front is the eager gate and
scan times, kernel K and kernel D, its "front" stage is the sum of the
frame's "gate", "scan_times", "ring_query" and "deskew" stages; where it is
kernel T, the "front" stage itself.

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5, the budgets of
``autosize_budgets`` (qb = 16), one map with both covariances packed at
halo margin 1 (P2P, GICP) and 2 (AVGICP), rings of 512 and 256 rows,
chip_smoke.py's configurations. The map's build is kept in ``--cache`` (an
.npz, made by the first run that finds none) for the runs after it.

1. ``run_fused`` on tile P2P, GICP and AVGICP+GPS+CAN: a warm-up replay
   (P2P: recording frame 10's ``scan_step`` arguments), then REPLAYS replays
   with a CUDA event at every stage boundary: the front and every stage in
   ms a frame (frames 1.. of each), the frame time p50 and p95 over all of
   their frames, the median scans per second.
2. One more replay of each under torch.profiler: the front's device time
   and device kernels a frame (every device kernel from the frame's kernel
   H to its voxel downsample, kernel C, but kernel I's CAN + GPS update),
   the device time of all kernels a frame, the device kernels a frame and
   the device's busy share.
3. Frame 10's front alone, on its recorded inputs: the chain (the gate and
   the scan times in torch, then ``deskew.scan_ring_query`` and
   ``deskew.deskew_points``: kernels K and D), K and D alone (their
   wrappers, on the chain's inputs), and kernel
   T (``runtime.scan_front``) where the checkout has it: each one's time
   (CUDA events around each of CALLS calls after 5 warm-ups, median), its
   time on the device (torch.profiler over CALLS calls, per call) and its
   device kernels.

    python3 tools/time_scan_front.py [--label NAME] [--cache PATH]

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
FRAME = 10
CALLS = 50
REPLAYS = 3
#: the front's stages, before and after kernel T
FRONT = ("gate", "scan_times", "ring_query", "deskew", "front")
PATHS = ("P2P", "GICP", "AVGICP+GPS+CAN")


class Marks:
    """``mark`` callback of the pipeline: one CUDA event per stage boundary."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def split(self):
        """({stage: ms per frame}, frame times), frames 1..: frame 0 also waits
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


def profiled(fn, repeat=1):
    """(the device kernel events in start order, wall ms) of fn() run
    ``repeat`` times under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeat):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(evs, key=lambda e: e.time_range.start), wall


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


def timed(fn):
    evs, _ = profiled(fn, CALLS)
    kernels = sorted({e.name[:60] for e in evs})
    return {"event_ms": event_ms(fn),
            "device_ms": sum(e.time_range.elapsed_us() for e in evs) * 1e-3 / CALLS,
            "device_kernels_per_call": len(evs) / CALLS, "device_kernels": kernels}


def front_of_replay(evs, n):
    """(device ms, device kernels) a frame of the front in a replay's trace:
    every kernel from each frame's kernel H to its kernel C, without kernel
    I's CAN + GPS update."""
    kern = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
    us, count, inside = 0.0, 0, False
    for e in kern:
        if "imu_stage_kernel" in e.name:
            inside = True
            continue
        if "voxel_downsample_kernel" in e.name:
            inside = False
        if inside and "ekf_update_kernel" not in e.name:
            us += e.time_range.elapsed_us()
            count += 1
    return us * 1e-3 / n, count / n


def path_cfg(config, path):
    """chip_smoke.py's ``method_cfg`` (bench.py's ``_cfg``)."""
    method = path.split("+")[0]
    cfg = config.ElimalocConfig()
    cfg.pcm.icp_method = config.IcpMethod[method]
    cfg.ekf.use_gps = cfg.ekf.use_can = "+GPS+CAN" in path
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


def front_calls(runtime, deskew, kernels, lie, a):
    """{name: zero-argument call} of frame 10's front on its recorded
    ``scan_step`` arguments ``a``: the chain (the gate and the scan times in
    torch, ``deskew.scan_ring_query``, ``deskew.deskew_points``), kernel K
    and kernel D alone on the chain's inputs, and kernel T
    (``runtime.scan_front``) where the checkout has it."""
    state, stamp, points, rel_raw, valid, _, pp, ps = a

    def chain():
        s = stamp - pp.lidar_time_delay
        v = valid & (lie.norm(points) <= pp.input_max_dist)
        rel, cur, end = deskew.normalize_scan_times(rel_raw, v, s, ps.scan_time_end)
        info, guess, found, usable = deskew.scan_ring_query(
            state.imu_ring, state.ego_ring, cur, end, pp.tf_ego_to_lidar,
            run_deskew=ps.run_deskew)
        pts, ok = deskew.deskew_points(points, rel, v, info, run_deskew=ps.run_deskew,
                                       bug_compat_z=ps.bug_compat_deskew_z)
        return rel, v, cur, end, info, pts

    rel, v, cur, end, info, _ = chain()
    out = {"gate + scan times + K + D": chain,
           "K": lambda: kernels.scan_ring_query(state.imu_ring, state.ego_ring, cur, end,
                                                pp.tf_ego_to_lidar, 64, ps.run_deskew),
           "D": lambda: kernels.deskew(points, rel, v, info, ps.bug_compat_deskew_z)}
    if hasattr(runtime, "scan_front"):
        out["T"] = lambda: runtime.scan_front(state, stamp, points, rel_raw, valid, pp, ps)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--cache", default=None, help="an .npz for the headline map's build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_scan_front: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from elimaloc_tpu_torch import config, deskew, kernels
    from elimaloc_tpu_torch.map import builder, tiles
    from elimaloc_tpu_torch.ops import lie
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
    recorded = None
    for path in PATHS:
        pipe = runtime.LocalizationPipeline(
            path_cfg(config, path), packed[2 if path.startswith("AVGICP") else 1],
            device="cuda", ds_points=ds_points, ego_ring_size=512, imu_ring_size=256,
            tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots))
        if path == "P2P":
            orig, seen = runtime.scan_step, []

            def scan_step(*a, **k):
                seen.append(a)
                return orig(*a, **k)

            runtime.scan_step = scan_step
            try:
                pipe.run_fused(log)
            finally:
                runtime.scan_step = orig
            recorded = seen[FRAME]
        else:
            pipe.run_fused(log)
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
        evs, wall = profiled(lambda: pipe.run_fused(log))
        front_ms, front_kernels = front_of_replay(evs, n)
        kern = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
        device_ms = sum(e.time_range.elapsed_us() for e in evs) * 1e-3
        out[path] = {"front_ms": sum(stages.get(k, 0.0) for k in FRONT),
                     "stage_ms": stages, "frame_ms_p50": float(np.percentile(frame_ms, 50)),
                     "frame_ms_p95": float(np.percentile(frame_ms, 95)),
                     "scans_per_s": float(np.median(rates)),
                     "front_device_ms_per_frame": front_ms,
                     "front_device_kernels_per_frame": front_kernels,
                     "device_ms_per_frame": device_ms / n,
                     "device_kernels_per_frame": len(kern) / n,
                     "device_busy_share": device_ms / wall}
        del pipe
        torch.cuda.empty_cache()
    for name, fn in front_calls(runtime, deskew, kernels, lie, recorded).items():
        out[name] = timed(fn)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
