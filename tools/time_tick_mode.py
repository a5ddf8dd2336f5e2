#!/usr/bin/env python3
"""Time the tick mode (``use_imu=False``) on one GPU: its two event steps,
their device kernels, and the event loop that runs them.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent). It drives only entry
points both designs have (``runtime.tick_step``, ``runtime.imu_ring_step``,
``LocalizationPipeline.run``) and reports the device time of every kernel
name either runs (kernel U's ``tick_stage_kernel`` and V's
``imu_intake_kernel``; kernel O's ``ca_tick_kernel``, J's
``ring_push_kernel`` and the eager fill and cuBLAS kernels around them).

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5, the budgets of
``autosize_budgets`` (qb = 16), the map without covariances packed at halo
margin 1, rings of 512 and 256 rows, chip_smoke.py's P2P configuration with
``use_imu=False`` ("P2P tick events").

1. A warm-up ``run`` that records the 100th call of ``runtime.tick_step``
   and the first call of ``runtime.imu_ring_step`` after it.
2. Each recorded step alone, chained: each call takes the last call's
   state (as the event loop hands it on) at the recorded time plus 10 ms a
   call: its time (CUDA events around each of CALLS calls after 5
   warm-ups, median), its device time per call by kernel name and summed,
   and its device kernels per call (torch.profiler over CALLS calls).
   Where the checkout has kernel U, the chain it replaced (kernel O, then
   kernel J's ego push of O's row) is timed the same way on the recorded
   tick's inputs, and kernel J alone on the recorded IMU event's rotated
   sample, as the reference.
3. REPLAYS timed ``run`` replays: scans per second (wall clock, ended by a
   synchronize), ATE against the log's truth (as chip_smoke.py's tick path
   takes it), the launches of each kernel in one replay.
4. REPLAYS more with the config watcher armed (``watch_config`` on an ini
   written from the pipeline's config into a temporary directory, as a
   deployment polls it before each tick and IMU event): scans per second
   and ``_poll_config``'s share of the replay's wall time.

    python3 tools/time_tick_mode.py [--label NAME]

Prints one JSON line, with the card's name and power limit. Exits 1
without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CALLS = 50
N_SCANS = 20
TICK = 100
REPLAYS = 3


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
    """Event ms, device ms per call (summed and by kernel name, us) and
    device kernels per call of fn."""
    from torch.profiler import ProfilerActivity, profile

    ev = event_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    per, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += 1
    return {"event_ms": ev, "device_ms": sum(per.values()) / CALLS * 1e-3,
            "device_us_by_kernel": {k: v / CALLS for k, v in sorted(per.items())},
            "device_kernels_per_call": count / CALLS}


def chained(step, a, k):
    """fn() for :func:`timed`: one ``step`` from the last call's pipeline
    state, at the recorded time ``a[1]`` plus 10 ms a call (the times made
    beforehand: indexing them launches nothing)."""
    t = a[1]
    ts = t + 0.01 * torch.arange(1, 2 * CALLS + 6, dtype=t.dtype, device=t.device)
    box = [a[0], 0]

    def call():
        box[0] = step(box[0], ts[box[1]], *a[2:], **k)
        box[1] += 1
    return call


class Record:
    """Wraps module functions to keep the arguments of the call number
    ``at`` of the first, and of the first call of each other one after it."""

    def __init__(self, mod, names, at):
        self.mod, self.names, self.at = mod, names, at
        self.orig = {n: getattr(mod, n) for n in names}
        self.calls, self.seen = {}, 0

    def __enter__(self):
        for name, fn in self.orig.items():
            def wrapped(*a, _n=name, _f=fn, **k):
                if _n == self.names[0]:
                    self.seen += 1
                if _n not in self.calls and self.seen >= self.at:
                    self.calls[_n] = (a, k)
                return _f(*a, **k)
            setattr(self.mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def tick_cfg(config):
    """chip_smoke.py's ``method_cfg(P2P)`` (bench.py's ``_cfg``) with
    ``use_imu=False``."""
    cfg = config.ElimalocConfig()
    cfg.pcm.icp_method = config.IcpMethod.P2P
    cfg.ekf.use_gps = cfg.ekf.use_can = False
    cfg.ekf.use_imu = False
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    return cfg


def replays(pipe, log, kernels, ate_rmse, poll=None):
    """REPLAYS timed replays: scans/s each, the last one's ATE and launches,
    and with ``poll`` (a dict) the seconds spent in ``_poll_config``."""
    out = {"scans_per_s": []}
    for _ in range(REPLAYS):
        kernels.reset_launches()
        if poll is not None:
            poll["s"] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = pipe.run(log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["scans_per_s"].append(len(log.scan_t) / wall)
        if poll is not None:
            out.setdefault("poll_share", []).append(poll["s"] / wall)
    out["ate_m"] = float(ate_rmse(traj["t"], traj["pos"], log.truth_t, log.truth_pos))
    out["launches"] = {k: v for k, v in kernels.launches.items() if v}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    label = ap.parse_args().label
    if not torch.cuda.is_available():
        print("time_tick_mode: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from elimaloc_tpu_torch import config, kernels
    from elimaloc_tpu_torch.map import builder, tiles
    from elimaloc_tpu_torch.pipeline import ate_rmse, runtime
    from elimaloc_tpu_torch.pipeline import log as log_mod

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
        tick_cfg(config), packed, device="cuda", ds_points=ds_points, ego_ring_size=512,
        imu_ring_size=256, tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots))

    out = {"label": label, "card": smi}
    # 1. the warm-up replay, recording the steps' calls
    with Record(runtime, ("tick_step", "imu_ring_step"), TICK) as rec:
        pipe.run(log)
    torch.cuda.synchronize()
    # 2. each step alone, and the chain kernel U replaced
    for name, (a, k) in sorted(rec.calls.items()):
        out[name] = timed(chained(getattr(runtime, name), a, k))
    if hasattr(kernels, "tick_stage"):
        st, t, pp = rec.calls["tick_step"][0][:3]
        one = torch.ones(1, dtype=torch.bool, device=t.device)

        def o_then_j():
            _, row = kernels.ca_tick(st.ekf, t, pp.ekf)
            return kernels.ring_push(st.ego_ring, None, row, None, one)

        out["O then J (reference)"] = timed(o_then_j)
        st, t, acc, gyro, pp = rec.calls["imu_ring_step"][0][:5]
        rot = pp.ego_to_imu_rot
        new = (t.reshape(1), gyro[None] @ rot.T, acc[None] @ rot.T)
        out["J alone on the IMU event (reference)"] = timed(
            lambda: kernels.ring_push(None, st.imu_ring, None, new, one))
    # 3. the timed replays
    out["P2P tick events"] = replays(pipe, log, kernels, ate_rmse)
    # 4. with the config watcher armed: _poll_config's share
    poll = {"s": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        ini = os.path.join(tmp, "localization.ini")
        config.export_ini(pipe.cfg, ini)
        pipe.watch_config(ini)
        orig = pipe._poll_config

        def timed_poll():
            t0 = time.perf_counter()
            orig()
            poll["s"] += time.perf_counter() - t0

        pipe._poll_config = timed_poll
        out["P2P tick events, watcher armed"] = replays(pipe, log, kernels, ate_rmse, poll)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
