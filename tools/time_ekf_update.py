#!/usr/bin/env python3
"""Time the CAN and GPS updates and the radar covariances on one GPU: the
fusion frame's CAN + GPS call, a CAN event and a GPS event of ``run``, the
event loop itself, and the radar rows of a registration.

Imports ``elimaloc_tpu_torch`` from the current directory, so the same
script times two checkouts on one card in one call: run it from the root
of each, in turns (parent, change, change, parent). It drives only entry
points both designs have (``ekf.filter.update_chain``, ``runtime.can_step``,
``runtime.gps_step``, ``register.icp.radar_slots`` and ``radar_points``,
``LocalizationPipeline.run``) and reports the device time of every kernel
name they run (kernel W's ``can_gps_update_kernel`` or kernel I's
``ekf_update_kernel`` and the mask fill before it; kernel X's
``radar_rows_kernel`` or kernel P's ``radar_cov_kernel`` and the index and
mask kernels before it).

The headline of chip_smoke.py, made from its seeds: the 21-scan log of
``synthesize_log(make_world(seed=3, extent=120, 400k + 200k),
points_per_scan=131072, seed=4)`` sampled 1/5, the budgets of
``autosize_budgets`` (qb = 16), one map with both covariances packed at
halo margin 1 (GICP) and 2 (AVGICP), and as the hash grid, rings of 512
and 256 rows, chip_smoke.py's configurations. The map's build is kept in
``--cache`` (an .npz, made by the first run that finds none).

1. The config-5 pipeline (AVGICP+GPS+CAN, chip_smoke.py's "FUSION"): a
   warm-up ``run_fused`` recording ``update_chain``'s call of frame FRAME
   (its CAN + GPS sub-batches), and a warm-up ``run`` recording the
   CAN_EVENT-th CAN step and the first GPS step after it.
2. Each recorded call alone, from its recorded state: its time (CUDA
   events around each of CALLS calls after 5 warm-ups, median), its device
   time per call by kernel name and summed, and its device kernels per call
   (torch.profiler over CALLS calls).
3. REPLAYS timed ``run`` replays of the config-5 pipeline ("FUSION events"):
   scans per second (wall clock, ended by a synchronize), ATE, the launches
   of each kernel in one replay.
4. The GICP radar path (``use_radar_cov``) on the tile map and on the hash
   grid: a warm-up ``run_fused`` recording the registration of frame
   FRAME's radar rows (``radar_slots``, ``radar_points``), each timed as in
   2.

    python3 tools/time_ekf_update.py [--label NAME] [--cache PATH]

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
CAN_EVENT = 40
CALLS = 50
REPLAYS = 3
PROFILE_PAD_S = 0.05


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
        # idle at both ends: the profiler loses the device records of a
        # pass's first moments without it
        time.sleep(PROFILE_PAD_S)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    per, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += 1
    return {"event_ms": ev, "device_ms": sum(per.values()) / CALLS * 1e-3,
            "device_us_by_kernel": {k[:80]: v / CALLS for k, v in sorted(per.items())},
            "device_kernels_per_call": count / CALLS}


class Record:
    """Wraps module functions to keep the arguments of each one's call
    number ``at`` (counted from 1)."""

    def __init__(self, mod, names, at, when=lambda a, k: True):
        self.mod, self.at, self.when = mod, at, when
        self.orig = {n: getattr(mod, n) for n in names}
        self.calls, self.seen = {}, dict.fromkeys(names, 0)

    def __enter__(self):
        for name, fn in self.orig.items():
            def wrapped(*a, _n=name, _f=fn, **k):
                if self.when(a, k):
                    self.seen[_n] += 1
                    if self.seen[_n] == self.at:
                        self.calls[_n] = (a, k)
                return _f(*a, **k)
            setattr(self.mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def path_cfg(config, method, fusion=False, radar=False):
    """chip_smoke.py's ``method_cfg``: bench.py's ``_cfg(method)``, with GPS
    and CAN on the fusion path and the radar covariances on a radar one."""
    cfg = config.ElimalocConfig()
    cfg.pcm.icp_method = config.IcpMethod[method]
    cfg.ekf.use_gps = cfg.ekf.use_can = fusion
    cfg.pcm.use_radar_cov = radar
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ekf_update: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from elimaloc_tpu_torch import config, kernels
    from elimaloc_tpu_torch.ekf import filter as efilter
    from elimaloc_tpu_torch.map import builder, tiles
    from elimaloc_tpu_torch.pipeline import ate_rmse, runtime
    from elimaloc_tpu_torch.pipeline import log as log_mod
    from elimaloc_tpu_torch.register import icp

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
    budget = tiles.TileQueryBudget(qb=16, max_slots=max_slots)
    rings = dict(ego_ring_size=512, imu_ring_size=256)
    out = {"label": args.label, "card": smi, "map_s": map_s}

    # 1-3. the config-5 pipeline: the fusion frame's call, a CAN and a GPS
    # event, the event loop
    pipe = runtime.LocalizationPipeline(path_cfg(config, "AVGICP", fusion=True), packed[2],
                                        device="cuda", ds_points=ds_points, tile_budget=budget,
                                        **rings)
    with Record(runtime, ("update_chain",), FRAME + 1,
                lambda a, k: k.get("can") is not None) as rec:
        pipe.run_fused(log)
    st, params, flags = rec.calls["update_chain"][0]
    kw = rec.calls["update_chain"][1]
    out["fusion frame update_chain"] = timed(
        lambda: efilter.update_chain(st, params, flags, **kw))
    with Record(runtime, ("can_step",), CAN_EVENT) as rec_can:
        pipe.run(log)
    with Record(runtime, ("gps_step",), 1,
                lambda a, k: float(a[1]) > float(rec_can.calls["can_step"][0][1])) as rec_gps:
        pipe.run(log)
    for name, r in (("can_step", rec_can), ("gps_step", rec_gps)):
        a, k = r.calls[name]
        out[f"{name} event"] = timed(lambda a=a, k=k, f=getattr(runtime, name): f(*a, **k))
    rates = []
    for _ in range(REPLAYS):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = pipe.run(log)
        torch.cuda.synchronize()
        rates.append(len(log.scan_t) / (time.perf_counter() - t0))
    out["FUSION events"] = {
        "scans_per_s": rates, "ate_m": float(ate_rmse(traj["t"], traj["pos"], log.truth_t,
                                                      log.truth_pos)),
        "launches": {k: v for k, v in kernels.launches.items() if v}}
    del pipe
    torch.cuda.empty_cache()

    # 4. the radar rows of a GICP radar registration, tile and hash
    cfg = path_cfg(config, "GICP", radar=True)
    for backend, name, fn in (("tile", "radar_slots", icp.radar_slots),
                              ("hash", "radar_points", icp.radar_points)):
        extra = {"tile_budget": budget} if backend == "tile" else {}
        pipe = runtime.LocalizationPipeline(
            cfg, packed[1] if backend == "tile" else built, device="cuda", backend=backend,
            ds_points=ds_points, **extra, **rings)
        with Record(icp, (name,), FRAME + 1) as rec:
            pipe.run_fused(log)
        a, k = rec.calls[name]
        out[f"GICP radar {name} ({backend})"] = timed(lambda a=a, k=k, fn=fn: fn(*a, **k))
        del pipe
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
