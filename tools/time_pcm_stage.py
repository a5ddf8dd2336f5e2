#!/usr/bin/env python3
"""Time the scan's end of the fused frame on one GPU: the PCM measurement,
the PCM update and the frame's published outputs, with kernels D, K, L, I
and S alone.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent). It drives only entry
points both designs have (``run_fused``) and takes each kernel wrapper it
finds: where the scan's end is kernel L, kernel I and the eager epilogue,
its "merged stage" is the sum of the frame's "measurement", "pcm_update"
and "outputs" stages; where it is kernel S, of "pcm_stage" and "outputs".

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5, the budgets of
``autosize_budgets`` (qb = 16), one map with both covariances packed at
halo margin 1 (P2P, GICP) and 2 (AVGICP), rings of 512 and 256 rows,
chip_smoke.py's configurations. The map's build is kept in ``--cache`` (an
.npz, made by the first run that finds none) for the runs after it.

1. ``run_fused`` on tile P2P, GICP and AVGICP+GPS+CAN: a warm-up replay
   (P2P: recording frame 10's kernel calls), then REPLAYS replays with a
   CUDA event at every stage boundary: the merged stage and every stage in
   ms a frame (frames 1.. of each), the frame time p50 and p95 over all of
   their frames, the median scans per second.
2. One more replay of each under torch.profiler: the device time a frame
   of the scan's end (kernel S, or kernel L and kernel I's PCM launch), of
   all kernels, the device kernels a frame and the device's busy share.
3. Frame 10's calls of kernels D (deskew), K (scan_ring_query), L
   (pcm_measurement) and I (ekf_update with the PCM pose) alone, and S
   (pcm_stage) where the checkout has it (L's and I's inputs then come from
   S's call: its measurement, by L, into I): each one's time (CUDA events
   around each of CALLS calls after 5 warm-ups, median) and its time on
   the device (torch.profiler over CALLS calls, per call).

    python3 tools/time_pcm_stage.py [--label NAME] [--cache PATH]

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
#: the stages of the scan's end, before and after kernel S
SCAN_END = ("measurement", "pcm_update", "pcm_stage", "outputs")
PATHS = ("P2P", "GICP", "AVGICP+GPS+CAN")
END_KERNELS = ("pcm_stage_kernel", "pcm_measurement_kernel", "ekf_update_kernel")


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


def device_kernels(fn, repeat=1):
    """({device kernel name: us per call}, wall ms) of fn() under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeat):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / repeat
            count += not e.name.startswith(("Memcpy", "Memset"))
    return per, wall, count / repeat


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
    per, _, _ = device_kernels(fn, CALLS)
    return {"event_ms": event_ms(fn), "device_ms": sum(per.values()) * 1e-3,
            "device_kernels": sorted(k[:60] for k in per)}


def record(kernels, names, at):
    """Wraps the kernel wrappers the checkout has to keep call number ``at``
    of each (kernel I's: its first with a PCM pose from there on)."""
    names = [n for n in names if hasattr(kernels, n)]
    orig = {n: getattr(kernels, n) for n in names}
    calls, seen = {}, dict.fromkeys(names, 0)

    def wrap(name):
        def fn(*a, **k):
            seen[name] += 1
            if (name not in calls and seen[name] > at
                    and (name != "ekf_update" or k.get("pcm") is not None)):
                calls[name] = (a, k)
            return orig[name](*a, **k)
        return fn

    for n in names:
        setattr(kernels, n, wrap(n))
    return calls, lambda: [setattr(kernels, n, f) for n, f in orig.items()]


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


def scan_end_calls(kernels, calls, gnss_meas, pcm_source):
    """{name: zero-argument call} of frame 10's kernels D, K, L, I (its PCM
    launch) and S. Where the checkout has kernel S, L takes S's inputs and I
    S's state with L's measurement."""
    out = {}
    for name in ("deskew", "scan_ring_query"):
        a, k = calls[name]
        out[name] = lambda a=a, k=k, f=getattr(kernels, name): f(*a, **k)
    if "pcm_stage" in calls:
        a, _ = calls["pcm_stage"]
        out["pcm_stage"] = lambda: kernels.pcm_stage(*a)
        meas = kernels.pcm_measurement(*a[3:])
        pcm = gnss_meas(timestamp=meas[1], source=pcm_source, pos=meas[2], rot=meas[3],
                        pos_cov=meas[4], rot_cov=meas[5])
        l_args, i_args = (a[3:], {}), (a[:3], {"pcm": (pcm, meas[6])})
    else:
        l_args, i_args = calls["pcm_measurement"], calls["ekf_update"]
    out["pcm_measurement"] = lambda: kernels.pcm_measurement(*l_args[0], **l_args[1])
    out["ekf_update[PCM]"] = lambda: kernels.ekf_update(*i_args[0], **i_args[1])
    out["pcm_measurement + ekf_update[PCM]"] = lambda: (out["pcm_measurement"](),
                                                        out["ekf_update[PCM]"]())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--cache", default=None, help="an .npz for the headline map's build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_pcm_stage: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from elimaloc_tpu_torch import config, kernels
    from elimaloc_tpu_torch.ekf import GnssMeas
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
    calls = {}
    for path in PATHS:
        pipe = runtime.LocalizationPipeline(
            path_cfg(config, path), packed[2 if path.startswith("AVGICP") else 1],
            device="cuda", ds_points=ds_points, ego_ring_size=512, imu_ring_size=256,
            tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots))
        if path == "P2P":
            calls, restore = record(kernels, ("deskew", "scan_ring_query", "pcm_measurement",
                                              "ekf_update", "pcm_stage"), FRAME)
            try:
                pipe.run_fused(log)
            finally:
                restore()
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
        per, wall, count = device_kernels(lambda: pipe.run_fused(log))
        end = {k[:60]: v * 1e-3 / n for k, v in per.items() if any(s in k for s in END_KERNELS)}
        out[path] = {"merged_stage_ms": sum(stages.get(k, 0.0) for k in SCAN_END),
                     "stage_ms": stages, "frame_ms_p50": float(np.percentile(frame_ms, 50)),
                     "frame_ms_p95": float(np.percentile(frame_ms, 95)),
                     "scans_per_s": float(np.median(rates)),
                     "scan_end_device_ms_per_frame": sum(end.values()),
                     "scan_end_device_ms_per_frame_by_kernel": end,
                     "device_ms_per_frame": sum(per.values()) * 1e-3 / n,
                     "device_kernels_per_frame": count / n,
                     "device_busy_share": sum(per.values()) * 1e-3 / wall}
        del pipe
        torch.cuda.empty_cache()
    for name, fn in scan_end_calls(kernels, calls, GnssMeas, int(config.GnssSource.PCM)).items():
        out[name] = timed(fn)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
