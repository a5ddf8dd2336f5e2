#!/usr/bin/env python3
"""Time the frame's IMU stage and the EKF kernels H, J, I, O on one GPU.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent). It takes each kernel
wrapper it finds (``imu_stage``, or ``imu_chain`` and ``ring_push`` where
the IMU stage is two kernels), so a checkout from before the one-launch
stage times too.

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5, the budgets of
``autosize_budgets`` (qb = 16), the map without covariances packed at halo
margin 1, rings of 512 and 256 rows, chip_smoke.py's P2P configuration.

1. ``run_fused`` (P2P): a warm-up replay that records frame 10's call of
   ``runtime.imu_subbatch`` and of every EKF and ring kernel wrapper, then
   one replay with a CUDA event at every stage boundary: ms per frame of
   each stage (frames 1..), the frame time p50 and the scans per second.
2. The "imu" stage alone on frame 10's inputs (``runtime.imu_subbatch``),
   and each recorded kernel call (H, J, I's PCM launch): its time (CUDA
   events around each of 50 calls after 5 warm-ups, median), its time on
   the device (torch.profiler over 50 calls, per call) and the names of the
   device kernels one call ran.
3. ``run`` (the event loop) with GPS and CAN on (P2P+GPS+CAN events): a
   warm-up, then one with CUDA events around every IMU and scan event: the
   scans per second and each kind's p50.
4. ``run`` with ``use_imu=False`` (the tick mode): kernel O's call at the
   100th tick and J's one-ring push after it, timed as in 2.

    python3 tools/time_imu_stage.py [--label NAME]

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
FRAME = 10
STAGES = ("imu", "can_gps", "gate", "scan_times", "ring_query", "deskew", "front",
          "downsample", "assign", "gn", "measurement", "pcm_update", "pcm_stage", "outputs")
WRAPPERS = ("imu_stage", "imu_chain", "ring_push", "ekf_update", "ca_tick")


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


def timed(fn):
    dv, names = device_ms(fn)
    return {"event_ms": event_ms(fn), "device_ms": dv, "device_kernels": names}


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


class Record:
    """Wraps module functions to keep the arguments of their call number
    ``at`` (or the first call that ``pick`` accepts from there on)."""

    def __init__(self, mod, names, at, pick=None):
        self.mod, self.at, self.pick = mod, at, pick or (lambda name, a, k: True)
        self.orig = {n: getattr(mod, n) for n in names if hasattr(mod, n)}
        self.calls, self.seen = {}, {}

    def __enter__(self):
        for name, fn in self.orig.items():
            def wrapped(*a, _n=name, _f=fn, **k):
                i = self.seen.get(_n, 0)
                self.seen[_n] = i + 1
                if _n not in self.calls and i >= self.at and self.pick(_n, a, k):
                    self.calls[_n] = (a, k)
                return _f(*a, **k)
            setattr(self.mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def p2p_cfg(config, gps_can=False):
    """chip_smoke.py's ``method_cfg(P2P)`` (bench.py's ``_cfg``), with GPS
    and CAN fused when ``gps_can``."""
    cfg = config.ElimalocConfig()
    cfg.pcm.icp_method = config.IcpMethod.P2P
    cfg.ekf.use_gps = cfg.ekf.use_can = gps_can
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
        print("time_imu_stage: no CUDA device", file=sys.stderr)
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
    kernels.library()

    def pipeline(cfg):
        return runtime.LocalizationPipeline(
            cfg, packed, device="cuda", ds_points=ds_points, ego_ring_size=512,
            imu_ring_size=256, tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots))

    out = {"label": label, "card": smi}
    # 1. run_fused, recording frame 10's stage and kernel calls
    pipe = pipeline(p2p_cfg(config))
    pcm_call = (lambda name, a, k: name != "ekf_update" or k.get("pcm") is not None)
    with Record(runtime, ("imu_subbatch",), FRAME) as stage, \
            Record(kernels, WRAPPERS, FRAME, pcm_call) as rec:
        pipe.run_fused(log)
    marks = Marks()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run_fused(log, mark=marks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages, p50 = marks.split()
    out["P2P run_fused"] = {"stage_ms": stages, "frame_ms_p50": p50,
                            "scans_per_s": len(log.scan_t) / wall}
    # 2. the stage and the kernels alone
    a, k = stage.calls["imu_subbatch"]
    out["imu stage"] = timed(lambda: runtime.imu_subbatch(*a, **k))
    for name, (a, k) in rec.calls.items():
        kernels.reset_launches()
        getattr(kernels, name)(*a, **k)
        torch.cuda.synchronize()
        out[name] = {"launches_per_call": sum(kernels.launches.values()),
                     **timed(lambda a=a, k=k, f=getattr(kernels, name): f(*a, **k))}
    # 3. the event loop with GPS and CAN
    pipe = pipeline(p2p_cfg(config, gps_can=True))
    pipe.run(log)
    spans = {"imu_step": [], "scan_step": []}
    orig = {n: getattr(runtime, n) for n in spans}

    def timed_step(name, fn):
        def step(*a, **k):
            b, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            b.record()
            res = fn(*a, **k)
            e.record()
            spans[name].append((b, e))
            return res
        return step

    for n, fn in orig.items():
        setattr(runtime, n, timed_step(n, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run(log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, fn in orig.items():
            setattr(runtime, n, fn)
    out["P2P+GPS+CAN events"] = {
        "scans_per_s": len(log.scan_t) / wall,
        **{f"{n.replace('_step', '')}_event_ms_p50": float(np.median(
            [b.elapsed_time(e) for b, e in v])) for n, v in spans.items()},
        "imu_events": len(spans["imu_step"])}
    # 4. the tick mode: O and J's one-ring push after it
    cfg = p2p_cfg(config)
    cfg.ekf.use_imu = False
    pipe = pipeline(cfg)
    tick_push = (lambda name, a, k: name != "ring_push" or a[1] is None)
    with Record(kernels, ("ca_tick", "ring_push"), 100, tick_push) as rec:
        pipe.run(log)
    for name, (a, k) in rec.calls.items():
        out[f"{name}[tick]"] = timed(lambda a=a, k=k, f=getattr(kernels, name): f(*a, **k))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
