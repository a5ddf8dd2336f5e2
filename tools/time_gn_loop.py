#!/usr/bin/env python3
"""Time the P2P registration's GN loop on one GPU: the "gn" stage of the
tile P2P frame, its device kernels, the frame and relocalization.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent). It drives only entry
points both designs have (``run_fused``, ``initialize_at``) and sums the
device time of every GN kernel name either runs (kernel A's
``p2p_search_kernel`` and ``reduce_partials_kernel``, kernel M's
``gn_step_kernel``, the loop's ``p2p_register_kernel``).

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5, the budgets of
``autosize_budgets`` (qb = 16), the map without covariances packed at halo
margin 1, rings of 512 and 256 rows, chip_smoke.py's P2P configuration.

1. ``run_fused`` (P2P, tile): a warm-up replay, then REPLAYS with a CUDA
   event at every stage boundary: ms per frame of each stage (frames 1..
   of each; "gn" is the registration's loop), the frame time p50 over all
   of their frames, the median scans per second; the mean GN iterations a
   frame.
2. One more replay under torch.profiler: the device time a frame of the GN
   kernels (by name) and of all kernels, and the device's busy share.
3. ``initialize_at`` (the relocalization: the same loop with
   ``max_iteration`` 10) from a click 0.7 m and 1 deg off the truth at
   scan 0: wall-clock ms, median of 30 calls after 2 warm-ups (it reads the
   registration's success back, so the wall clock is its latency).
4. One registration near frame 10 on the device alone (torch.profiler, 20
   calls): the loop kernel's us a call and a GN iteration where the
   checkout has it (frame 10's call), and one iteration of the
   three-launch chain (kernel A's search + reduce_partials_kernel, kernel
   M) by kernel, on the loop's inputs at its initial pose, or, in a
   checkout without the loop, on the replay's first A and M calls of frame
   10 or later.

    python3 tools/time_gn_loop.py [--label NAME]

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

N_SCANS = 20
STAGES = ("imu", "can_gps", "gate", "scan_times", "ring_query", "deskew", "front",
          "downsample", "assign", "gn", "measurement", "pcm_update", "pcm_stage", "outputs")
GN_KERNELS = ("p2p_search_kernel", "reduce_partials_kernel", "gn_step_kernel",
              "p2p_register_kernel")
RELOC_CALLS = 30
REPLAYS = 3
FRAME = 10
CALLS = 20


class Marks:
    """``mark`` callback of the pipeline: one CUDA event per stage boundary."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def split(self):
        """(ms per frame of each stage, the frame times), frames 1..: frame 0
        also waits for the batch upload."""
        torch.cuda.synchronize()
        tot = dict.fromkeys(STAGES, 0.0)
        frames = 0
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            frames += name == "imu"
            if frames >= 1:
                tot[name] += a.elapsed_time(b)
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


def per_call_us(fn):
    """{device kernel name: us a call} of fn() over CALLS calls."""
    per, _ = device_kernels(lambda: [fn() for _ in range(CALLS)])
    return {k[:60]: v / CALLS for k, v in per.items()}


def record(kernels, at):
    """Wraps the GN kernel wrappers the checkout has to keep one call each:
    the loop's call number ``at`` (a frame), A's and M's first from
    2 * ``at`` (GN iterations, about two a frame)."""
    names = [n for n in ("p2p_register", "p2p_correspond", "gn_step") if hasattr(kernels, n)]
    orig = {n: getattr(kernels, n) for n in names}
    calls, seen = {}, dict.fromkeys(names, 0)

    def wrap(name):
        def fn(*a, **k):
            seen[name] += 1
            if name not in calls and seen[name] > (at if name == "p2p_register" else 2 * at):
                calls[name] = (a, k)
            return orig[name](*a, **k)
        return fn

    for n in names:
        setattr(kernels, n, wrap(n))
    return calls, lambda: [setattr(kernels, n, f) for n, f in orig.items()]


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
        print("time_gn_loop: no CUDA device", file=sys.stderr)
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
    pipe = runtime.LocalizationPipeline(
        p2p_cfg(config), packed, device="cuda", ds_points=ds_points, ego_ring_size=512,
        imu_ring_size=256, tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots))
    n = len(log.scan_t)
    out = {"label": label, "card": smi}

    # 1. run_fused with a CUDA event at every stage boundary (the warm-up
    # keeps frame 10's GN kernel calls for 4.)
    calls, restore = record(kernels, FRAME)
    try:
        _, outs = pipe.run_fused(log)
    finally:
        restore()
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
    stages = {k: float(np.mean([s[k] for s in splits])) for k in STAGES}
    out["P2P run_fused"] = {"gn_ms_per_frame": stages["gn"], "stage_ms": stages,
                            "frame_ms_p50": float(np.median(frame_ms)),
                            "scans_per_s": float(np.median(rates)),
                            "iterations_mean": float(np.mean(outs["iterations"]))}
    # 2. the GN kernels' device time a frame
    per, prof_wall = device_kernels(lambda: pipe.run_fused(log))
    gn = {k: v for k, v in per.items() if any(s in k for s in GN_KERNELS)}
    out["P2P run_fused"].update(
        gn_device_ms_per_frame=sum(gn.values()) * 1e-3 / n,
        gn_device_ms_per_frame_by_kernel={k[:60]: v * 1e-3 / n for k, v in gn.items()},
        device_ms_per_frame=sum(per.values()) * 1e-3 / n,
        device_busy_share=sum(per.values()) * 1e-3 / prof_wall)
    # 3. initialize_at, wall clock
    x, y = log.truth_pos[0][:2] + 0.7
    yaw = log.truth_rpy[0][2] + np.deg2rad(1.0)

    def reloc():
        return pipe.initialize_at(pipe.reset(), x, y, yaw, log.scan_points[0],
                                  log.scan_valid[0], log.scan_t[0])

    times = []
    for i in range(RELOC_CALLS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ok = reloc()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    out["initialize_at"] = {"ms_p50": float(np.median(times)), "ok": bool(ok)}
    # 4. frame 10's registration on the device alone
    reg = {}
    if "p2p_register" in calls:
        a, k = calls["p2p_register"]
        halo, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params, _ = a
        n_it = int(kernels.p2p_register(*a, **k)[5])
        loop_us = sum(per_call_us(lambda: kernels.p2p_register(*a, **k)).values())
        reg["loop"] = {"iterations": n_it, "device_us": loop_us,
                       "device_us_per_iteration": loop_us / max(n_it, 1)}
        a_call = ((halo, slot_tile, sbuf, qmask, pose, params.max_search_dist), k)
        sums = kernels.p2p_correspond(*a_call[0], **k)[0]
        m_call = ((sums, pose, fitness, local_cov, total, params, False), {})
    else:
        a_call, m_call = calls["p2p_correspond"], calls["gn_step"]
    chain = per_call_us(lambda: (kernels.p2p_correspond(*a_call[0], **a_call[1]),
                                 kernels.gn_step(*m_call[0], **m_call[1])))
    reg["chain_iteration"] = {"device_us_by_kernel": chain,
                              "device_us": sum(chain.values())}
    out["frame 10 registration"] = reg
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
