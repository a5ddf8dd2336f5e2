#!/usr/bin/env python3
"""Time the hash grid's one-shot queries and ground probe on one GPU:
kernel Q's query entry against kernel Y per method (P2P, GICP, VGICP,
AVGICP), kernel R against kernel Z, Q's lookup entry and an empty kernel
(the launch floor), interleaved in one process.

The headline of chip_smoke.py, made from its seeds: ``make_world(seed=3,
extent=120, 400k + 200k)``, the 21-scan log of ``synthesize_log(
points_per_scan=131072, seed=4)`` sampled 1/5, one map with both
covariances as the hash grid (``backend="hash"``), chip_smoke.py's P2P
configuration. The map's build is kept in ``--cache`` (an .npz, made by the
first run that finds none). A warm-up ``run_fused`` of the P2P hash
pipeline records the registration of frame FRAME; its scan at its initial
pose gives the world queries, their voxels the lookup's coords and the
pose's XY the ground probe's position (5 m, k = 5), as in chip_smoke.py's
"hash grid" phase.

Each of ROUNDS rounds times every variant: its event time (CUDA events
around each of CALLS calls after 5 warm-ups, median), its device time a
call (torch.profiler over CALLS calls back to back, its own kernels
summed) and its device time with the L2 cache flushed before each call (a
FLUSH_MB buffer zeroed between the calls; the fill kernel not counted),
the reference and the redesign in turns (Q then Y, Z then R, ...; the
order flips every round). Printed: per variant the median and the range
over the rounds of the three times, its device kernels a call, and the
``-Xptxas -v`` lines (registers, stack, spills) of kernels Y and Z from the
build's ``nvcc.log``.

    python3 tools/time_grid_queries.py [--cache PATH]

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
ROUNDS = 6
PROFILE_PAD_S = 0.05
FLUSH_MB = 256


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


def device_ms(fn, kernels, flush=None):
    """(device ms a call, device kernels a call, their names) of fn's
    kernels (the names holding one of ``kernels``) under one torch.profiler
    pass of CALLS calls; with ``flush``, that buffer is zeroed before each
    call (its fill kernel not counted)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle at both ends: the profiler loses the device records of a
        # pass's first moments without it
        time.sleep(PROFILE_PAD_S)
        for _ in range(CALLS):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    us, count, names = 0.0, 0, set()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in kernels)):
            us += e.time_range.elapsed_us()
            count += 1
            names.add(e.name[:60])
    return us / CALLS * 1e-3, count / CALLS, sorted(names)


class Record:
    """Wraps a module function to keep the arguments of its call number
    ``at`` (counted from 1)."""

    def __init__(self, mod, name, at):
        self.mod, self.name, self.at, self.seen, self.call = mod, name, at, 0, None
        self.orig = getattr(mod, name)

    def __enter__(self):
        def wrapped(*a, **k):
            self.seen += 1
            if self.seen == self.at:
                self.call = (a, k)
            return self.orig(*a, **k)
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


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


def ptxas_lines(build, names):
    """The ``-Xptxas -v`` lines of the kernels whose mangled name holds one
    of ``names``: {kernel: [lines]}."""
    report = (build.library_path().parent / "nvcc.log").read_text().splitlines()
    out, at = {}, None
    for line in report:
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
            at = next((n for n in names if n in fn), None)
            if at is not None:
                out.setdefault(at, []).append(fn[:90])
        elif "Compiling entry function" in line:
            at = None
        elif at is not None and ("registers" in line or "spill" in line):
            out[at].append(line.split(":", 1)[-1].strip())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=None, help="an .npz for the headline map's build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_grid_queries: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from elimaloc_tpu_torch import config, kernels
    from elimaloc_tpu_torch.kernels import build
    from elimaloc_tpu_torch.map import builder, grid
    from elimaloc_tpu_torch.pipeline import log as log_mod
    from elimaloc_tpu_torch.pipeline import runtime
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
    ds_points, _ = runtime.autosize_budgets(log, float(pcm.input_voxel_ds_m),
                                            4.0 * pcm.pcm_voxel_size, qb=16)
    t0 = time.time()
    built = built_map(builder, world, pcm, args.cache)
    map_s = time.time() - t0
    kernels.library()
    cfg = config.ElimalocConfig()
    cfg.pcm.icp_method = config.IcpMethod.P2P
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m, cfg.ekf.ekf_init_y_m, cfg.ekf.ekf_init_yaw_deg = 60.0, 0.0, 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    pipe = runtime.LocalizationPipeline(cfg, built, device="cuda", backend="hash",
                                        ds_points=ds_points, ego_ring_size=512,
                                        imu_ring_size=256)
    with Record(kernels, "hash_register", FRAME + 1) as rec:
        pipe.run_fused(log)
    g, src, _, pose = rec.call[0][:4]
    q = icp.transform_slots(pose, src)
    md = pipe.params.icp.max_search_dist
    coords = grid.point_to_voxel(q, g.voxel_size)
    xy = tuple(float(v) for v in pose[:2, 3])

    # each variant: (label, call, the names of its device kernels)
    pairs = {}
    for m in ("P2P", "GICP", "VGICP", "AVGICP"):
        pairs[f"query {m}"] = (("Q", lambda m=m: kernels.hash_query(g, q, md, m),
                                ("hash_query_kernel",)),
                               ("Y", lambda m=m: kernels.grid_query(g, q, md, m),
                                ("grid_query",)))
        y, ref = kernels.grid_query(g, q, md, m), kernels.hash_query(g, q, md, m)
        if not all(torch.equal(y[k], ref[k]) for k in y):
            raise AssertionError(f"kernel Y differs from kernel Q's query entry ({m})")
    pairs["ground probe"] = (("R", lambda: kernels.ground_height(g.points, xy, 5.0, 5),
                              ("ground_partial_kernel", "ground_merge_kernel")),
                             ("Z", lambda: kernels.ground_probe(g, xy, 5.0, 5),
                              ("ground_probe_kernel",)))
    if not all(torch.equal(a, b)
               for a, b in zip(*(fn() for _, fn, _ in pairs["ground probe"]))):
        raise AssertionError("kernel Z differs from kernel R")
    pairs["lookup / floor"] = (("lookup", lambda: kernels.hash_lookup(g, coords),
                                ("hash_lookup_kernel",)),
                               ("launch floor", kernels.launch_floor, ("launch_floor_kernel",)))

    flush = torch.empty(FLUSH_MB * 2**20 // 4, dtype=torch.float32, device="cuda")
    samples = {}
    for r in range(ROUNDS):
        for what, variants in pairs.items():
            for label, fn, names in (variants if r % 2 == 0 else variants[::-1]):
                ev = event_ms(fn)
                dev, kern, seen = device_ms(fn, names)
                cold, _, _ = device_ms(fn, names, flush)
                s = samples.setdefault(f"{what}: {label}", {
                    "event_ms": [], "device_ms": [], "device_ms_l2_flushed": [],
                    "kernels_per_call": [], "device_kernels": seen})
                s["event_ms"].append(ev)
                s["device_ms"].append(dev)
                s["device_ms_l2_flushed"].append(cold)
                s["kernels_per_call"].append(kern)
    out = {"card": smi, "map_s": map_s, "queries": int(q.shape[0]),
           "voxels": int(g.num_voxels), "map_points": int(g.counts[:-1].sum()),
           "slots": int(g.points.shape[1]), "position_xy": xy}
    for name, s in samples.items():
        out[name] = {k: {"median": float(np.median(v)), "range": [float(min(v)), float(max(v))]}
                     for k, v in s.items() if k != "device_kernels"}
        out[name]["device_kernels"] = s["device_kernels"]
    out["ptxas"] = ptxas_lines(build, ("grid_query_kernel", "grid_query_pairs_kernel",
                                       "ground_probe_kernel", "hash_query_kernel",
                                       "ground_partial_kernel"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
