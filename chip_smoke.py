#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (elimaloc_tpu_torch) on one GPU.

Drives the port's main path — fused P2P localization replay through
``LocalizationPipeline.run_fused`` — at the headline width of bench.py:
make_world(seed=3, extent=120, 400k ground + 200k wall points), 131,072 raw
points per scan sampled 1/5, P2P with qb=16 and budgets sized from the log.

Phases (each prints a line; any failure raises, so the exit code is not 0):
  1. device: ``nvidia-smi`` name and power limit, the TF32 flags off;
  2. build: the four CUDA kernels from elimaloc_tpu_torch/csrc/;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     inputs the main path gave it (recorded during a warm-up replay), with
     times from CUDA events (median of 20);
  4. the slice: a timed replay, the launch count of every kernel in it,
     applied ratio, ATE against ground truth, slot drops, downsample budget,
     scans/s, a per-stage split and the frame time p50/p95 from CUDA events;
  5. reference: a small log on the card against the same port on the CPU
     (plain versions, held to the JAX package by the CPU tests).
Before the last line come the slice numbers and the kernel table, each a
JSON line, and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Needs no network, no JAX, one card:

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_SCANS = 20
RAW_POINTS = 131072
INDEX_SAMPLING = 5
REPEATS = 20


def log_line(*parts):
    print(*parts, flush=True)


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log_line(smi)
    log_line(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
             f"torch {torch.__version__}, cuda {torch.version.cuda}")
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 is on: the port must pin full-f32 matmuls")
    return smi


def build_phase(build):
    t0 = time.time()
    build.library()
    log_line(f"build: {time.time() - t0:.1f} s -> {build.library_path()}")
    report = (build.library_path().parent / "nvcc.log").read_text()
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log_line("  ptxas:", line.strip())


def make_slice(cfg_mod, runtime, tiles, log_mod):
    """The bench.py:140-169 configuration, rebuilt from the port's copies."""
    world = log_mod.make_world(seed=3, extent=120.0, n_ground=400_000, n_wall=200_000)
    log = log_mod.synthesize_log(world, duration=(N_SCANS + 3) * 0.1,
                                 points_per_scan=RAW_POINTS, max_range=100.0, seed=4)
    sl = slice(None, None, INDEX_SAMPLING)  # reference ingest, pcm_matching.cpp:908-921
    log.scan_points = np.ascontiguousarray(log.scan_points[:, sl])
    log.scan_times = np.ascontiguousarray(log.scan_times[:, sl])
    log.scan_valid = np.ascontiguousarray(log.scan_valid[:, sl])
    cfg = cfg_mod.ElimalocConfig()
    cfg.pcm.icp_method = cfg_mod.IcpMethod.P2P
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    ds_points, max_slots = runtime.autosize_budgets(
        log, float(cfg.pcm.input_voxel_ds_m), 4.0 * cfg.pcm.pcm_voxel_size, qb=16)
    t0 = time.time()
    pipe = runtime.LocalizationPipeline(
        cfg, world, device="cuda", ds_points=ds_points,
        tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots),
        ego_ring_size=512, imu_ring_size=256)
    log_line(f"slice: {len(log.scan_t)} scans x {log.scan_points.shape[1]} points, "
             f"map halo {tuple(pipe.map.halo_points.shape)}, ds_points {ds_points}, "
             f"max_slots {max_slots}, map build {time.time() - t0:.1f} s")
    return pipe, log


class Recorder:
    """Wraps the kernel launchers to keep the arguments of one main-path call
    each (taken at frame ``at``), so phase 3 runs on real inputs."""

    def __init__(self, kernels, at):
        self.kernels, self.at, self.calls, self.seen = kernels, at, {}, {}
        self.orig = {n: getattr(kernels, n) for n in
                     ("deskew", "voxel_downsample", "assign_slots", "p2p_correspond")}

    def __enter__(self):
        for name, fn in self.orig.items():
            def wrapped(*a, _n=name, _f=fn, **k):
                i = self.seen.get(_n, 0)
                self.seen[_n] = i + 1
                if _n not in self.calls and i >= self.at:
                    self.calls[_n] = (a, k)
                return _f(*a, **k)
            setattr(self.kernels, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.kernels, name, fn)


def time_ms(fn):
    """Median of REPEATS CUDA-event timings of fn() after two warm calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPEATS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_phase(pipe, calls, mods):
    kernels, deskew, grid, tiles, icp = mods
    tmap, params = pipe.map, pipe.params.icp
    budget = pipe.static.icp_static.tile_budget
    rows = []

    a, k = calls["deskew"]
    got = kernels.deskew(*a, **k)
    ref = deskew.deskew_points_plain(*a)
    err = float((got - ref).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"deskew kernel vs plain: max abs err {err} > 1e-4")
    rows.append(dict(name="deskew", source="elimaloc_tpu_torch/csrc/deskew.cu",
                     replaces="elimaloc_tpu/deskew.py:196 (+ deskew_points :229)",
                     max_abs_err=err, ms=time_ms(lambda: kernels.deskew(*a, **k)),
                     plain_ms=time_ms(lambda: deskew.deskew_points_plain(*a))))

    a, k = calls["voxel_downsample"]
    got = kernels.voxel_downsample(*a, **k)
    ref = grid.voxel_downsample_plain(*a, **k)
    if not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError("voxel_downsample kernel differs from its plain version")
    rows.append(dict(name="voxel_downsample", source="elimaloc_tpu_torch/csrc/downsample.cu",
                     replaces="elimaloc_tpu/map/grid.py:271", max_abs_err=0.0,
                     ms=time_ms(lambda: kernels.voxel_downsample(*a, **k)),
                     plain_ms=time_ms(lambda: grid.voxel_downsample_plain(*a, **k))))

    a, k = calls["assign_slots"]
    queries, valid = a[0], a[1]
    got = kernels.assign_slots(*a, **k)
    ref = tiles.assign_slots_plain(tmap, queries, valid, budget)
    for name in got:
        if not torch.equal(got[name], getattr(ref, name)):
            raise AssertionError(f"assign_slots kernel differs from plain in {name}")
    rows.append(dict(name="assign_slots", source="elimaloc_tpu_torch/csrc/assign.cu",
                     replaces="elimaloc_tpu/map/tiles.py:577", max_abs_err=0.0,
                     ms=time_ms(lambda: kernels.assign_slots(*a, **k)),
                     plain_ms=time_ms(lambda: tiles.assign_slots_plain(
                         tmap, queries, valid, budget))))

    a, k = calls["p2p_correspond"]
    _, slot_tile, sbuf, qmask, pose, _ = a
    sums, tgt, ok = kernels.p2p_correspond(*a, **k, with_matches=True)
    matched, JTJ, JTr, fit, rtgt, rok = icp.p2p_search_reduce_plain(
        tmap, slot_tile, sbuf, qmask, pose, params, budget)
    if not (torch.equal(ok, rok) and torch.equal(tgt, rtgt)):
        raise AssertionError("p2p_correspond search differs from its plain version")
    k_matched, k_JTJ, k_JTr, _ = icp.assemble_p2p(sums)
    if int(k_matched) != int(matched):
        raise AssertionError(f"matched {int(k_matched)} != {int(matched)}")
    err = 0.0
    for x, y in ((k_JTJ, JTJ), (k_JTr, JTr)):
        rel = float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
        if not rel <= 1e-4:
            raise AssertionError(f"p2p_correspond JTJ/JTr rel err {rel} > 1e-4")
        err = max(err, float((x - y).abs().max()))
    rows.append(dict(name="p2p_correspond", source="elimaloc_tpu_torch/csrc/correspond.cu",
                     replaces="elimaloc_tpu/map/tiles.py:712 + elimaloc_tpu/register/icp.py:283",
                     max_abs_err=err, ms=time_ms(lambda: kernels.p2p_correspond(*a, **k)),
                     plain_ms=time_ms(lambda: icp.p2p_search_reduce_plain(
                         tmap, slot_tile, sbuf, qmask, pose, params, budget))))
    for r in rows:
        log_line(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g}, "
                 f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms")
    log_line(f"  shapes: scan {tuple(calls['deskew'][0][0].shape)}, "
             f"queries {tuple(queries.shape)}, slots {tuple(qmask.shape)}, "
             f"halo {tuple(tmap.halo_points.shape)}")
    return rows


def reference_phase(cfg_mod, runtime, tiles, log_mod):
    """The small ``tiny_pipe`` configuration of tests/test_pipeline_modes.py
    on the card (kernels) against the same port on the CPU (plain versions,
    which tests/test_torch_slice.py holds to the JAX package), under the
    repo's closed-loop contract: max < 3 cm, median < 5 mm, last 3 < 5 mm."""
    world = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = log_mod.synthesize_log(world, duration=3.0, points_per_scan=1024,
                                 max_range=50.0, seed=10, gps_hz=1.0)
    cfg = cfg_mod.ElimalocConfig()
    cfg.pcm.icp_method = cfg_mod.IcpMethod.P2P
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    pos = {}
    for device in ("cuda", "cpu"):
        pipe = runtime.LocalizationPipeline(
            cfg, world, device=device, ds_points=1024,
            tile_budget=tiles.TileQueryBudget(qb=8, max_slots=1024),
            ego_ring_size=128, imu_ring_size=128)
        pos[device] = pipe.run_fused(log)[1]["ego_pos"]
    err = np.linalg.norm(pos["cuda"] - pos["cpu"], axis=1)
    log_line(f"reference: card vs CPU port over {len(err)} frames: max {err.max():.2e} m, "
             f"median {np.median(err):.2e} m, last 3 max {err[-3:].max():.2e} m")
    if not (err.max() < 0.03 and np.median(err) < 0.005 and err[-3:].max() < 0.005):
        raise AssertionError("the card's trajectory left the closed-loop contract")


class StageTimer:
    """``mark`` callback of the pipeline: one CUDA event per stage boundary."""

    ORDER = ("imu", "deskew", "downsample", "assign", "gn", "ekf_update")

    def __init__(self):
        self.events = []

    def __call__(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def split(self):
        """(mean ms per stage, frame count, per-frame ms), frames 1.. only:
        frame 0 also waits for the batch upload."""
        torch.cuda.synchronize()
        tot = dict.fromkeys(self.ORDER, 0.0)
        frames = 0
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            if name == "imu":
                frames += 1
            if frames >= 1:
                tot[name] += a.elapsed_time(b)
        ends = [e for name, e in self.events if name == "ekf_update"]
        per_frame = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        return {k: v / max(frames, 1) for k, v in tot.items()}, frames, per_frame


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    import elimaloc_tpu_torch  # noqa: F401  (pins full-f32 matmuls)
    from elimaloc_tpu_torch import config as cfg_mod
    from elimaloc_tpu_torch import deskew, kernels
    from elimaloc_tpu_torch.kernels import build
    from elimaloc_tpu_torch.map import grid, tiles
    from elimaloc_tpu_torch.pipeline import ate_rmse, runtime
    from elimaloc_tpu_torch.pipeline import log as log_mod
    from elimaloc_tpu_torch.register import icp

    smi = device_phase()
    build_phase(build)
    pipe, log = make_slice(cfg_mod, runtime, tiles, log_mod)

    # warm-up replay; it also records one main-path call of each kernel
    with Recorder(kernels, at=N_SCANS // 2) as rec:
        pipe.run_fused(log)
    torch.cuda.synchronize()
    rows = kernel_phase(pipe, rec.calls, (kernels, deskew, grid, tiles, icp))

    # the timed main-path run: counts from zero, then read back
    stages = StageTimer()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = pipe.run_fused(log, mark=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    split, frames, per_frame = stages.split()
    p50, p95 = (float(np.percentile(per_frame, q)) for q in (50, 95))
    n = len(log.scan_t)
    log_line(f"slice: {n / wall:.2f} scans/s ({wall:.3f} s for {n} scans, "
             f"host batch prep + upload included), launches {launches}")
    log_line("stage ms/frame (frames 1..%d): " % frames
             + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
             + f", total {sum(split.values()):.3f}; frame ms p50 {p50:.3f} "
             f"p95 {p95:.3f}")

    ate = ate_rmse(outs["ego_t_abs"], outs["ego_pos"], log.truth_t, log.truth_pos)
    applied = float(outs["applied"].mean())
    dropped = int(outs["slots_dropped"].max())
    ds_max = int(outs["ds_kept"].max())
    log_line(f"slice: applied {applied:.3f}, ATE {ate:.4f} m, slots_dropped {dropped}, "
             f"ds_kept max {ds_max} of {pipe.static.ds_points}, "
             f"iterations mean {outs['iterations'].mean():.2f}")
    if not np.all(np.isfinite(outs["ego_pos"])) or outs["ego_pos"].shape != (n, 3):
        raise AssertionError("non-finite or misshapen trajectory")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if not (applied >= 0.9 and ate < 0.1 and dropped == 0
            and ds_max < pipe.static.ds_points):
        raise AssertionError("slice failed its acceptance bounds")
    reference_phase(cfg_mod, runtime, tiles, log_mod)

    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms")
    log_line(json.dumps({"slice": {"scans_per_s": n / wall, "stage_ms": split,
                                   "frame_ms_p50": p50, "frame_ms_p95": p95,
                                   "ate_m": ate, "applied": applied, "card": smi}}))
    log_line(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log_line(smi)
    log_line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
