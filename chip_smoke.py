#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (elimaloc_tpu_torch) on one GPU.

Drives the port's entry points at the headline width of bench.py:
make_world(seed=3, extent=120, 400k ground + 200k wall points), 131,072 raw
points per scan sampled 1/5, 1 Hz GPS and 50 Hz CAN in the log, qb=16 and
budgets sized from the log, the bench.py ``_cfg(method)`` configuration. One
BuiltMap with both covariances (bench.py:567-571) is packed at halo margin 1
(P2P, GICP, VGICP) and 2 (AVGICP); the hash paths put the same BuiltMap
on the card as the hash grid (``backend="hash"``). Thirty-one paths:
``LocalizationPipeline.run_fused`` for each ICP method (P2P, GICP, VGICP,
AVGICP), for AVGICP with GPS and CAN fusion (BASELINE config 5,
bench.py:573-582) and for GICP, VGICP and AVGICP with the radar
covariances (``use_radar_cov``: kernel X and the radar forms of E, F, G);
``run_frames`` (the online mode) on the GICP pipeline ("GICP frames");
``run`` (the per-event loop) on the config-5 pipeline ("FUSION events"); the
config-5 replay with the Joseph-form updates (kernels H, I and S with
``joseph_form``); ``run`` with ``use_imu=False`` on the P2P configuration
("P2P tick events": a CA tick with its ego push at 100 Hz, kernel U, and
the IMU ring intake, kernel V). Then ``initialize_at`` (relocalization) on the P2P
pipeline, and "P2P windowed": active-window serving, the bench.py:327-346
row (``_cfg(P2P)`` with a 40 m sensor gate, ``map_window_radius=48``) over
the margin-1 map written with ``build_tile_map(storage_dir=)`` and reopened
disk-backed with ``load_tile_map(mmap=True)``, on the bench.py headline log
length (40 scans, bench.py:86, 140-146: the 20-scan log moves 7 m, too
little for a 48 m window to swap), run three ways: ``run_fused
(window_chunk=8)``, ``run_frames`` per frame, and per frame with each
prefetch finished before any swap ("forced"). Then the hash backend
(K13: the hash loop kernel, kernels Q and M as one cooperative launch a
registration, in place of B and A, E, F, G):
``run_fused`` as "P2P hash", "GICP hash", "VGICP hash", "AVGICP hash" and
the radar forms "GICP / VGICP / AVGICP hash+radar"; "GICP hash frames"
(``run_frames``); "reloc hash" (``initialize_at`` on the P2P hash
pipeline); "hash grid": the grid's own lookup (Q's lookup entry), four
queries (kernel Y, Q's query entry redesigned) and ground probe (kernel Z,
R redesigned) on the card; "functional replay": ``runtime.replay_fused``,
``replay_fused_chunk`` and ``fused_frame_at`` on four of the pipelines
above; and "P2P long lead": a
small log whose IMU stream leads its first scan by 12 s (kernel H twice a
frame), through ``run_fused`` and ``run_frames``; and the fleet paths
"P2P fleet", "GICP fleet", "VGICP fleet", "AVGICP fleet", "AVG+GPS+CAN
fleet", "GICP hash fleet", "GICP radar fleet" and "AVGICP radar hash
fleet" (the run_fused configurations of P2P, GICP, VGICP, AVGICP, AVGICP
with GPS + CAN, GICP on the hash grid, GICP with radar covariances and
AVGICP with them on the hash grid; the radar ones on the same BuiltMap
moved 1 km off the origin, where the reference's world-frame radar model
is well-posed): ``run_fused_fleet`` on 8 lanes at the headline width (the
headline log and a second log of the same world and duration, seed 5,
alternating), each fleet frame one launch of the lane form of kernels H,
C, B (tiles), X (radar), S, the loop kernel and, with fusion, W for all
lanes and T's two kernels once each; every lane instantiation of the loop
kernels that no fleet path launches on one recorded fleet frame; and two
small fleets of 4,096-point scans: "tick-mode fleet" (hash GICP with
radar, ``use_imu=False``, 2 lanes) and "130-lane fleet" (tile GICP with
radar, GPS and CAN: two loop launches a frame, every other lane form
one).

Phases (each prints a line; any failure raises, so the exit code is not 0):
  1. device: ``nvidia-smi`` name and power limit, the TF32 flags off;
  2. build: the CUDA kernels from elimaloc_tpu_torch/csrc/ (one nvcc per
     source, all started together), then the map and its two packings;
  3. per run_fused path:
     a. a warm-up replay that records main-path calls of the kernels;
     b. kernel vs plain on those inputs, with times from CUDA events
        (median of 20) and each kernel's bound (the least time the H100
        could take: bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
        counted from these inputs): on the tile P2P path the loop kernel
        (``p2p_register``: kernels A and M as one cooperative launch a
        registration) on every frame's recorded call, bit for bit against
        the three-launch chain it replaces (kernel A's search +
        reduce_partials_kernel, kernel M, the stop flag read back each
        iteration) and within A's and M's tolerances of its plain version,
        then kernel A and kernel M alone on frame 10's first iteration; on
        the tile GICP, VGICP and AVGICP paths (their radar forms, AVGICP's
        fusion path) the method's loop kernel (``gicp_register``,
        ``vgicp_register``, ``avgicp_register``: kernel E, F or G and M as
        one cooperative launch) and on every hash path the hash loop kernel
        (``hash_register``: kernels Q and M) the same way, bit for bit
        against their chains on every registration (in the radar forms the
        distance from the plain loop is recorded, not gated: the search
        kernels' radar rows are held to a float64 tail), then E, F, G or Q
        and M alone on frame 10's first iteration (the radar rows on an
        iteration with a finite pose and a match); on the
        P2P path (the main path) kernels B, C, D, H (the frame's whole IMU
        stage: the sensor-frame conversion, the EKF chain and both ring
        pushes, against its plain composition; twenty profiled calls of the
        stage must show H alone on the device), S (the scan's end in one
        launch: the PCM measurement, the PCM update and the frame's
        outputs) bit for bit against kernel L then kernel I on every
        frame's call and against its plain composition on one (twenty profiled
        calls of the stage must show S alone on the device), T (the scan's
        front in one host call: the range gate, the scan times, K's ring
        queries and D's deskew) bit for bit against the chain it replaced
        (the gate and the scan times in torch, kernel K, then kernel D) on
        every frame's call and on one frame with each of scan_time_end off,
        run_deskew off and bug_compat_z, its valid' point for point the
        torch gate's, and against its plain composition on one (five
        profiled calls of the stage must show T's two kernels alone on the
        device), D and K (T's reference entries, on the chain's inputs) and
        L (S's reference entry, on S's inputs), B and C beside
        ``torch.sort(stable=True)`` of their keys alone (a partial
        yardstick) and on the sort's edge inputs (tests/sort_edges.py, bit
        for bit, one launch a call); on the fusion
        path kernel W's launch a frame (the CAN + GPS sub-batches) and
        kernel I (W's reference) on the same calls, W bit for bit against
        I on every frame's call and on a 6-DOF (NOVATEL) fix and a 3-DOF
        fix with yaw not yet initialised; on every radar path kernel X bit
        for bit against kernel P (X's reference) on every registration; on
        the radar paths the method's kernel in its radar form (rtol 1e-3)
        and, on GICP's, kernels X and P (twenty profiled calls of
        ``icp.radar_slots`` must show X alone on the device); on the hash
        paths kernel Q (its radar form against a float64 tail, as E, F,
        G's) and M;
     c. the timed replay: the launch counts set to 0 just before it and
        read just after (every kernel of the path must have launched; H once
        a frame, J never, no EKF state or params packed: the same on every
        replay with IMU below, H once an IMU event in ``run``; on every path
        below that runs scan_step, T once a scan, K and D never, S once a
        scan, L never, W once a fusion frame or CAN / GPS event and never
        without them, I never; X once a radar registration, P never; on
        every tile
        P2P path, the replays, the tick mode, the relocalizations and the
        windowed runs below, the loop kernel once a registration and kernels
        A and M never; on every tile GICP and VGICP path (with "GICP
        frames") the method's loop once a registration, E, F and M never;
        on every tile AVGICP path (with the event loop and the
        Joseph replay) the AVGICP loop once a registration, G and M never;
        on every hash path (with its frames and relocalization) the hash
        loop once a registration, Q and M never), on the P2P path the GN
        stage a frame and the scans/s beside the three-launch GN loop's (CHAIN_P2P), the scan's end
        (kernel S's stage) beside L, I and the eager epilogue's
        (CHAIN_SCAN_END),
        applied ratio, ATE against ground truth, slot drops, downsample
        budget, scans/s, a per-stage split and the frame time p50/p95, and
        on the fusion path the CAN and GPS samples the filter's gates
        admitted; a radar path is held to its method's ATE gate where it
        converges (applied >= 0.9) and otherwise recorded with the reason;
  4. "GICP frames" and "FUSION events", each with its launch counts: the
     frame loop must equal run_fused to 1e-6 m; the event loop (after a
     warm-up replay holding kernel W bit for bit to kernel I on every CAN
     and GPS event; twenty profiled CAN events and twenty GPS events, each a
     single device kernel, W's) must hold
     applied >= 0.9, ATE < 0.3 m, its last pose within 0.15 m of run_fused's
     and admit CAN and GPS; the Joseph form: H, W (and I) and S with ``joseph_form``
     against their plain versions on the fusion path's inputs, then its
     replay (applied >= 0.9, under the closed-loop contract against the
     reference form's, P asymmetry no larger, P diagonal positive); the
     tick mode: every tick and IMU event of a warm-up replay under
     ``set_sync_debug_mode("error")``, kernel U bit for bit against kernel
     O then kernel J's ego push and V bit for bit against kernel H's IMU
     ring (within the rotation's rounding bound of the cuBLAS rotation + J
     it replaced), each against its plain version, O and J's one-ring form
     (their reference) against theirs; U launched once a tick, V once an
     IMU sample, O, J and H never; twenty profiled ticks and twenty profiled IMU
     event each a single device kernel; ATE under JAX's 2.0 m tick-mode
     bound; then relocalization from a click 1 m and 1 deg off the truth;
  5. "P2P windowed" (after the relocalization above): a warm-up windowed
     replay that records kernel N's first call, N against
     ``shift_window_plain`` on it (bit for bit) with its bound (bytes read
     and written over 3.35 TB/s) and the time of ``index_select`` on the
     row roll alone; a chain of 1-, 2- and 3-tile
     shifts on both axes into the map corner against fresh crops at the
     same origin (bit for bit); then the timed windowed replays, launch
     counts from 0 around the first, each gated: swaps and incremental
     crops occur, N launched, applied >= 0.9, no dropped slots, the forced
     run with no synchronous swap and a prefetch hit per swap, and every
     windowed trajectory against a full-map pipeline of the same
     configuration under the closed-loop contract; ``window_stats`` and the
     device bytes of the window against the full map; then ``initialize_at``
     on a windowed pipeline whose window lies ~100 m from the click, given
     the log's scan as it is (the card held to the CPU port) and the scan
     gated to the sensor range (within 1.5 m of the truth);
  5b. the hash backend: each hash path held to its method's gates (as its
     tile path) with the hash loop launched once a registration, Q and M
     never, and no tile kernel; "GICP hash frames" = its run_fused to 1e-6 m; "reloc hash"
     within 1.5 m; "hash grid": the public calls launch Y four times and Z
     once (Q's query entry and R never), the lookup and Y's queries bit for
     bit against their plain versions and Y against Q's query entry, Z's
     (found, z) bit for bit against R's and z within one ulp of the plain
     version, the launch floor (an empty kernel) beside the lookup; each hash
     path's trajectory against its method's tile path (P2P, GICP, VGICP
     under the closed-loop contract; AVGICP's ATE beside the tile path's);
     "tile queries" (``tile_query_phase``): the tile map's one-shot
     queries (``map.tiles``: the nearest point, with GICP's covariance, the
     nearest voxel, the 7 voxels) on the headline map at the "hash grid"
     queries, some off the map and 5% not valid: the counts from 0 around
     the four calls, kernel B 4, A 2, E, F, G once each and nothing else,
     each call under set_sync_debug_mode("error"), each output bit for bit
     its plain version, no slot dropped, kernel Y's answers on the same
     queries (valid equal, distances, means and covariances within 1e-5),
     and (``window_query_check``, run inside "P2P windowed") the replay's
     window against the full map (ok equal, targets and means within 1e-5
     m); "functional replay" (``functional_replay_phase``) on the P2P,
     GICP, AVGICP+GPS+CAN and P2P hash pipelines: ``runtime.replay_fused``
     from ``reset()`` on the log's batches moved to the card first, against
     the path's timed run_fused (ego_pos within 1e-6 m, applied equal,
     whether every output is bit for bit printed, the launch counts from 0
     equal to the timed replay's), then ``replay_fused_chunk`` with chunks
     of 8 (the last with 3 clamped rows): the first 21 rows and the final
     state bit for bit replay_fused's, each clamped row bit for bit
     ``fused_frame_at(20)`` on that state; every call under
     set_sync_debug_mode("error") on the tile paths, "warn" (recorded) on
     the hash path; replay_fused's scans/s beside run_fused's (the median
     of five of each, in turns) and the path's timed one;
  5c. "P2P long lead" (``long_lead_phase``): a small P2P log whose IMU
     stream leads its first scan by 12 s, every frame padded past one
     launch of kernel H: run_fused and run_frames on the card with H
     ceil(cap / 1024) times a frame, run_frames = run_fused to 1e-6 m, the
     card against the CPU port under the closed-loop contract;
  5d. the fleet paths (``fleet_phase``), each: a warm-up fleet replay
     recording one fleet frame's stage calls (the fusion path: a frame
     with a GPS fix); its lane forms' rows ("P2P fleet": ``imu_stage``,
     ``scan_front``, ``voxel_downsample``, ``assign_slots``,
     ``p2p_register`` and ``pcm_stage``; the GICP, VGICP and AVGICP fleets
     their loop's, ``gicp_register`` etc.; "AVG+GPS+CAN fleet" W's,
     ``can_gps_update``; each as ``[fleet]``), each bit for bit against 8
     single-lane launches on its lanes' inputs and against its plain lane
     form (H, T, S, W and the loops within 1e-4 x max(1, |plain|) on every
     float output, C and B exactly; integers and flags equal), with its
     event time, the single launches', the plain lane form's and its
     bound; the timed fleet replay (launch counts from 0: each lane form
     21 times, T's host call 21, nothing else, no pack) with its stage
     marks, the single-stream run_fused of the same configuration in the
     same call, the fleet's scans/s (8 x 21 / wall); each lane bit for bit
     its log's ``run_frames`` on a fresh pipeline with the lane's padded
     batches, every output of every frame; each lane's ATE within its
     method's ATE_GATE, applied >= 0.9; with the profiler passes, one fleet
     replay traced with every frame under set_sync_debug_mode("error"):
     each lane-form kernel once a frame, no chain kernel, no synchronizing
     call, the device's busy share. The hash fleet's rows: the hash loop's
     lane form (``hash_register[GICP fleet]``); the GICP radar fleet's:
     ``gicp_register[radar fleet]`` and X's lane form (``radar_rows[fleet]``);
     the AVGICP radar hash fleet's: ``hash_register[AVGICP radar fleet]`` and
     ``radar_rows[hash fleet]`` (X in query order). Then each lane
     instantiation no path launches (``other_lane_rows``: the hash loop's
     P2P, VGICP and AVGICP and GICP / VGICP radar forms, the VGICP and
     AVGICP tile loops' radar forms) on a recorded fleet frame, as a row
     with 0 launches; then the small fleets (``small_fleet_phase``): launch
     counts (the loop ceil(lanes / 128) times a frame), each lane bit for bit
     its log's run_fused; then "ring pushes" (``ring_push_phase``):
     ``rings.push_ego`` / ``push_imu`` on card rings of the pipeline's
     capacities over ``ring_push_sequence`` (accepts, an equal time, a time
     inside the ego ring's dedupe eps, a one-ulp step, a regression that
     clears, a roll, a regression of the full ring), each call one launch of
     kernel J (its launches counted per ring around each call) and every
     ring after every call bit for bit the plain version's, then J's one-row
     push into a full ring timed beside U's and V's pushes; then "cli"
     (``cli_phase``): ``elimaloc_tpu_torch.cli.main`` in process, ``synth``
     (bit for bit the headline world and its log at the CLI's arguments),
     ``build-map`` at its defaults (GICP) on every 16th world point (bit
     for bit ``build_voxel_map`` of them), a binary PCD round trip of the
     world, ``replay --fused --traj`` on the headline BuiltMap (the TUM file
     line for line ``run_fused``'s on ``cli.replay_pipeline``'s pipeline,
     GICP's gates) and the event-loop ``replay --metrics --viz --traj``,
     each subcommand's wall clock;
  5e. "[sharding]" (``sharding_phase``): the sharded modes of
     ``parallel/sharding.py`` over ``torch.distributed``, ranks spawned
     from this script on the one card, the inputs (frame 10's registration
     on the P2P, GICP, VGICP, AVGICP and P2P hash pipelines, four lanes of
     P2P frames 9-12, the P2P replay, the P2P fleet's first four lanes)
     through one file: a one-rank NCCL world, every entry point at its
     mesh of one bit for bit the unsharded path; a four-rank gloo world,
     the ranks bit for bit each other, the dp lanes bit for bit the fleet,
     sp, slot and 2D within the bounds SHARD_TOL / SHARD_OVERLAP_TOL and
     the closed-loop contract, the first iteration's all-reduced sums
     within 4 eps of their float64 sum, per rank and GN iteration one
     launch of A, E, F, G or Q, one of M and one all-reduce and no loop
     kernel; each case's wall clock beside the card;
  6. torch.profiler, after every timed replay: kernels B-D, H-Z and the
     loop kernel alone on the device (and kernel L then kernel I beside S,
     the gate, scan times, K and D beside T, O and J beside U, the cuBLAS
     rotation and J beside V),
     and one more replay per run_fused
     path and of the windowed run_fused for the device's busy share and
     its top kernels; no kernel of a run_fused replay may be a library sort
     (a name with "sort" or "Radix"): B and C sort on the card themselves;
     on the P2P path one more replay, each frame under
     ``torch.cuda.set_sync_debug_mode("error")``: one loop kernel a frame
     and no kernel A, reduce_partials_kernel or M on the device, no
     synchronizing or copying runtime call between the first frame's start
     and the last frame's end, no device-to-host copy before the last loop
     kernel ends; the device kernels a frame counted, each frame ending in
     one kernel S after its loop kernel with no kernel L, I or eager
     epilogue kernel after the loop, and running kernel T's two kernels
     once, K and D never, with no eager range-gate or scan-times kernel
     between kernel H and T (the kernels there are listed); the same traced
     replay on the tile GICP and AVGICP paths (the loop kernel, no kernel
     E or G, reduce_partials_kernel or M); on "AVGICP hash" one more replay with
     each registration (the "assign" mark to the "gn" mark) under
     set_sync_debug_mode("error") and the rest of each frame under "warn":
     no synchronizing call inside a registration, any other listed by its
     Python location;
  7. reference, per run_fused path: a small log on the card against the
     same port on the CPU (plain versions, held to the JAX package by the
     CPU tests) under the repo's closed-loop contract, and "P2P hash" on
     P2P's log; on the fusion log also
     the event loop ``run``; the radar paths on small logs in a map frame
     1 km off the origin (where the reference's world-frame radar model is
     well-posed; outside the contract, held to twice the CPU port's own
     float32-vs-float64 spread); the tick-mode ``run`` on
     tiny_pipe(use_imu=False); and the
     windowed ``run`` on the small windowed drive of
     tests/test_torch_window_replay.py.
Each phase ends with its wall clock (``[clock] <phase>: <s> s``, kept in
the slices line under "clock"). Before the last line come the slice numbers and the kernel table, each a
JSON line, and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Needs no network, no JAX, one card:

    python3 chip_smoke.py
"""

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

N_SCANS = 20
RAW_POINTS = 131072
INDEX_SAMPLING = 5
REPEATS = 20
#: calls of a stage's runtime entry under one torch.profiler pass when its
#: device kernels are listed: as many as a kernel's timed pass makes. On an
#: H100, passes of five calls came back with no device record 34 times in
#: four runs of thirty-one paths (up to 8 in a row), passes of REPEATS
#: calls never
STAGE_CALLS = REPEATS
#: timings of a plain lane form (a loop of eager plain versions over the
#: lanes: seconds a call, hundreds of thousands of small kernels)
PLAIN_LANE_REPEATS = 5
#: host idle (s) at each end of a profiler pass: unpadded, a short pass
#: now and then comes back with no device record at all (the profiled
#: events and stages below failed so; tools/probe_profiler_drops.py counts
#: such passes)
PROFILE_PAD_S = 0.05
FUSION = "AVGICP+GPS+CAN"
PATHS = ("P2P", "GICP", "VGICP", "AVGICP", FUSION)
#: the run_fused paths with the radar covariances (use_radar_cov): kernel X
#: and the radar forms of E, F, G
RADAR_PATHS = ("GICP+radar", "VGICP+radar", "AVGICP+radar")
#: the fusion path's replay with the Joseph-form updates (kernels H, I)
JOSEPH = FUSION + " joseph"
#: the event loop with use_imu=False: CA ticks with their ego push (kernel
#: U) and the IMU ring intake (kernel V)
TICK = "P2P tick events"
#: f32 operations of one CA tick: G = F P and G F^T (39 nonzeros of F per
#: column of P, a multiply and an add each, twice), the nominal step and the
#: ego row (~600)
TICK_OPS = 2 * 2 * 39 * 27 + 600
TICK_ATE_GATE = 2.0  # JAX's own tick-mode bound, tests/test_pipeline_modes.py:82-90
#: the map frame of the radar paths' card-vs-CPU references: the same drive
#: with every position 1 km off the map origin, where the reference's
#: world-frame radar covariance is well-posed (tests/test_torch_radar.py)
FAR_X = 1000.0
#: the EKF kernels, launched on every path: wrapper -> (source, replaces)
EKF_KERNELS = {
    "imu_stage": ("imu_chain.cu + rings.cuh",
                  "elimaloc_tpu/pipeline/runtime.py:405 imu_subbatch: elimaloc_tpu/ops/frames.py"
                  ":27 imu_to_ego, elimaloc_tpu/ekf/filter.py:520 predict_imu (+ :344, :306, "
                  ":390, :424, :493), elimaloc_tpu/pipeline/rings.py:126 _push_arrays_batch "
                  "as :183, :192"),
}
#: kernel I, the CAN and GPS updates' reference entry (kernel W's, bit for
#: bit; its PCM leg is kernel S's): its source and what it replaces
EKF_UPDATE = ("elimaloc_tpu_torch/csrc/ekf_update.cu + ekf_update.cuh",
              "elimaloc_tpu/ekf/filter.py:221 _ekf_measurement_update + :616 update_gnss + "
              ":705 update_can as elimaloc_tpu/pipeline/runtime.py:453-480 (the CAN / GPS "
              "sub-batches)")
#: kernel W, launched for the CAN and GPS updates (once a fusion frame for
#: its CAN + GPS sub-batches, once a CAN or GPS event of ``run``)
CAN_GPS = ("elimaloc_tpu_torch/csrc/can_gps_update.cu + ekf_update.cuh + ekf.cuh",
           EKF_UPDATE[1] + " and runtime.py:205, :260 (the event loop's GPS and CAN steps)")
#: kernels X (launched once a radar registration) and P (X's reference)
RADAR_ROWS = ("elimaloc_tpu_torch/csrc/radar_rows.cu",
              "elimaloc_tpu/register/icp.py:251 radar_point_cov + :619-623 and :652-655 (the "
              "slot packing of run_register; the hash backend's query order)")
RADAR_COV = ("elimaloc_tpu_torch/csrc/radar_cov.cu", RADAR_ROWS[1])
#: the long-lead log: its IMU stream starts LEAD_S before the first scan
#: (the vehicle at rest), so every frame is padded past one launch of H
LEAD_S = 12.0
LEAD = "P2P long lead"
#: kernel J, whose one-ring entry is the reference of kernels U and V (H, U
#: and V push their rows themselves): its source and what it replaces
RING_PUSH = ("elimaloc_tpu_torch/csrc/rings.cu + rings.cuh",
             "elimaloc_tpu/pipeline/rings.py:126 _push_arrays_batch (+ :75, :183, :192)")
#: published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s and
#: float32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12
#: per method: its fused search + GN kernel (wrapper), the kernel's source,
#: the JAX hot ops it replaces and the plain version in register/icp.py
KERNEL = {
    "P2P": ("p2p_correspond", "correspond.cu",
            "elimaloc_tpu/map/tiles.py:712 + elimaloc_tpu/register/icp.py:283",
            "p2p_search_reduce_plain"),
    "GICP": ("gicp_correspond", "gicp.cu",
             "elimaloc_tpu/map/tiles.py:712 (with_point_cov) + "
             "elimaloc_tpu/register/icp.py:324", "gicp_search_reduce_plain"),
    "VGICP": ("vgicp_correspond", "vgicp.cu",
              "elimaloc_tpu/map/tiles.py:803 + elimaloc_tpu/register/icp.py:354",
              "vgicp_search_reduce_plain"),
    "AVGICP": ("avgicp_correspond", "avgicp.cu",
               "elimaloc_tpu/map/tiles.py:869 + elimaloc_tpu/register/icp.py:381",
               "avgicp_search_reduce_plain"),
}
#: per method, for the bound: bytes per halo candidate (point, or voxel mean
#: + coord), bytes gathered per match (covariance, mean) and f32 operations
#: per match (P2P's 18 sums; the 3x3 conjugation, inverse and 44 sums)
SEARCH_COST = {"P2P": (12, 0, 40), "GICP": (12, 48, 300), "VGICP": (24, 36, 300),
               "AVGICP": (24, 36, 300)}
SHARED = ("scan_front", "voxel_downsample", "assign_slots")
#: kernel T, the scan's front in one host call, launched once a scan on
#: every path: its source and what it replaces
FRONT = ("elimaloc_tpu_torch/csrc/scan_front.cu + scan_ring.cuh + deskew.cuh",
         "elimaloc_tpu/pipeline/runtime.py:299-338 (the front of scan_step: stamp - "
         "lidar_time_delay, the range gate :305-309, elimaloc_tpu/deskew.py:60 "
         "normalize_scan_times, :157 make_deskew_info (+ :82, :109), :196 + :229 "
         "deskew_points, elimaloc_tpu/pipeline/rings.py:204 get_interpolated_pose, usable, "
         ":338 compose)")
#: kernels K and D, whose bodies run inside kernel T: the reference entries T
#: is held to (the gate and the scan times in torch, then K, then D), their
#: sources and what they replace
RING_QUERY = ("elimaloc_tpu_torch/csrc/scan_ring.cu + scan_ring.cuh",
              "elimaloc_tpu/deskew.py:157 make_deskew_info (+ :82, :109) + "
              "elimaloc_tpu/pipeline/rings.py:204 get_interpolated_pose + runtime.py:338 compose")
DESKEW = ("elimaloc_tpu_torch/csrc/deskew.cu + deskew.cuh",
          "elimaloc_tpu/deskew.py:196 (+ deskew_points :229)")
#: the tile P2P path's scan front before kernel T: the range gate, the scan
#: times, kernel K and kernel D ("gate" + "scan_times" + "ring_query" +
#: "deskew", PERF.md section 5 before kernel T; H100 80GB HBM3, 700 W),
#: printed beside this run's "front" stage
CHAIN_FRONT = {"ms": 0.470, "frame_ms_p50": 1.57}
#: the scan-time kernels, launched on every path: wrapper -> (source, replaces)
SCAN_KERNELS = {
    "pcm_stage": ("pcm_stage.cu + pcm_meas.cuh + ekf_update.cuh",
                  "elimaloc_tpu/pipeline/runtime.py:341-362 (the scan tail: :275 "
                  "shape_icp_covariance, elimaloc_tpu/pipeline/rings.py:251 "
                  "gnss_time_compensation, elimaloc_tpu/ekf/filter.py:616 update_gnss + :221 "
                  "as the PCM update, _select_state) + runtime.py:481-490 (fused_frame's "
                  "epilogue: ego_state's pos, rpy, timestamp, P's asymmetry and smallest "
                  "diagonal)"),
    "gn_step": ("gn_step.cu", "elimaloc_tpu/register/icp.py:202 _solve_step + :209 "
                              "_step_transform + the loop body :761-795"),
}
#: kernel L, whose body runs inside kernel S: the reference entry S is held
#: to (kernel L, then kernel I's PCM leg), its source and what it replaces
PCM_MEAS = ("elimaloc_tpu_torch/csrc/pcm_meas.cu + pcm_meas.cuh",
            "elimaloc_tpu/pipeline/runtime.py:275 shape_icp_covariance + "
            "elimaloc_tpu/pipeline/rings.py:251 gnss_time_compensation + runtime.py:341-358")
#: the tile P2P path's scan end with kernel L, kernel I and the eager
#: epilogue (its "measurement" + "pcm_update" + "outputs" stages, PERF.md
#: section 5 before kernel S; H100 80GB HBM3, 700 W), printed beside this
#: run's kernel S stage
CHAIN_SCAN_END = {"ms": 1.256, "frame_ms_p50": 2.80}
#: the P2P registration on the tile backend: kernels A and M as one
#: cooperative launch a registration (the whole GN loop on the card), its
#: source and the JAX loop it replaces
LOOP = "p2p_register"
#: the GICP, VGICP and AVGICP registrations on the tile backend and every
#: registration on the hash backend: kernels E, F, G and Q with M as one
#: cooperative launch a registration (csrc/gn_loop.cuh around their bodies)
GICP_LOOP, VGICP_LOOP = "gicp_register", "vgicp_register"
AVG_LOOP, HASH_LOOP = "avgicp_register", "hash_register"
#: the tile loop of each covariance method
TILE_LOOPS = {"GICP": GICP_LOOP, "VGICP": VGICP_LOOP, "AVGICP": AVG_LOOP}
#: each loop kernel's source and the JAX loop it replaces
LOOP_SOURCE = {
    LOOP: "elimaloc_tpu_torch/csrc/p2p_register.cu + correspond.cuh + gn_loop.cuh + gn_step.cuh",
    GICP_LOOP: "elimaloc_tpu_torch/csrc/gicp.cu + gicp.cuh + gn_loop.cuh + gn_step.cuh",
    VGICP_LOOP: "elimaloc_tpu_torch/csrc/vgicp.cu + vgicp.cuh + gn_loop.cuh + gn_step.cuh",
    AVG_LOOP: "elimaloc_tpu_torch/csrc/avgicp.cu + avgicp.cuh + gn_loop.cuh + gn_step.cuh",
    HASH_LOOP: ("elimaloc_tpu_torch/csrc/hash_correspond.cu + hash_correspond.cuh + hash.cuh + "
                "gn_loop.cuh + gn_step.cuh")}
LOOP_REPLACES = {
    LOOP: ("elimaloc_tpu/register/icp.py:728-821 run_register's lax.while_loop (P2P, tile): "
           "per iteration elimaloc_tpu/map/tiles.py:712 + register/icp.py:283 + :202 + :209 + "
           "the body :761-795"),
    GICP_LOOP: ("elimaloc_tpu/register/icp.py:588-821 run_register's lax.while_loop (GICP, "
                "tile; the loop :821): per iteration elimaloc_tpu/map/tiles.py:712 "
                "(with_point_cov) + register/icp.py:324 (radar: :331-333) + :202 + :209 + the "
                "body :761-795"),
    VGICP_LOOP: ("elimaloc_tpu/register/icp.py:588-821 run_register's lax.while_loop (VGICP, "
                 "tile; the loop :821): per iteration elimaloc_tpu/map/tiles.py:803 + "
                 "register/icp.py:354 (radar: :361-363) + :202 + :209 + the body :761-795"),
    AVG_LOOP: ("elimaloc_tpu/register/icp.py:728-821 run_register's lax.while_loop (AVGICP, "
               "tile): per iteration elimaloc_tpu/map/tiles.py:869 + register/icp.py:381 (radar: "
               ":551-562) + :202 + :209 + the body :761-795"),
    HASH_LOOP: ("elimaloc_tpu/register/icp.py:588-821 run_register's lax.while_loop (hash): "
                "per iteration :429 _iteration with elimaloc_tpu/map/grid.py:181, :209, :228, "
                ":251 and the tails :283, :324, :354, :381 (radar :331-333, :361-363, :459-467) "
                "+ :202 + :209 + the body :761-795")}
#: each loop kernel's one-iteration search kernel (kernel A, E, F, G or Q),
#: which with kernel M is the chain the loop is held to and launches on no
#: path the loop serves
LOOP_SEARCH = {LOOP: "p2p_correspond", GICP_LOOP: "gicp_correspond",
               VGICP_LOOP: "vgicp_correspond", AVG_LOOP: "avgicp_correspond",
               HASH_LOOP: "hash_correspond"}
#: each loop kernel's device kernel and its chain's (torch.profiler names)
LOOP_DEVICE = {LOOP: "p2p_register_kernel", GICP_LOOP: "gicp_register_kernel",
               VGICP_LOOP: "vgicp_register_kernel", AVG_LOOP: "avgicp_register_kernel",
               HASH_LOOP: "hash_register_kernel"}
CHAIN_DEVICE = {LOOP: "p2p_search_kernel", GICP_LOOP: "gicp_search_kernel",
                VGICP_LOOP: "vgicp_search_kernel", AVG_LOOP: "avgicp_search_kernel",
                HASH_LOOP: "hash_search_kernel"}
#: the tile P2P headline path's GN stage, scans/s and frame p50 with the
#: three-launch GN loop (kernel A's search, reduce_partials_kernel, kernel
#: M; PERF.md section 5 before the loop kernel; H100 80GB HBM3, 700 W),
#: printed beside this run's
CHAIN_P2P = {"gn_ms": 0.412, "scans_per_s": 262.15, "frame_ms_p50": 3.42}
FRAMES, EVENTS = "GICP frames", "FUSION events"
WINDOWED = "P2P windowed"
#: the windowed row's log length (bench.py:86 N_SCANS) and configuration
#: (bench.py:327-346)
WINDOW_SCANS = 40
WINDOW_RADIUS = 48.0
WINDOW_SENSOR = 40.0
#: kernel N: its source and the JAX function it replaces
SHIFT = ("elimaloc_tpu_torch/csrc/window_shift.cu",
         "elimaloc_tpu/map/tiles.py:511 _shift_window_impl + :546 shift_window")
#: the hash backend (K13, kernel Q): run_fused per method on the hash grid
#: of the same BuiltMap, and its radar forms
HASH_PATHS = ("P2P hash", "GICP hash", "VGICP hash", "AVGICP hash")
HASH_RADAR_PATHS = ("GICP hash+radar", "VGICP hash+radar", "AVGICP hash+radar")
HASH_FRAMES = "GICP hash frames"
HASH_GRID = "hash grid"
#: kernels Q and R: their sources and the JAX functions they replace
HASH = ("elimaloc_tpu_torch/csrc/hash_correspond.cu",
        "elimaloc_tpu/map/grid.py:153 lookup (+ :144-150) + :181-268 query_* + "
        "elimaloc_tpu/register/icp.py:429 _iteration (+ the tails :283, :324, :354, :381)")
GROUND = ("elimaloc_tpu_torch/csrc/ground_height.cu",
          "elimaloc_tpu/map/grid.py:320 find_ground_height")
#: kernels Y and Z (Q's query entry and R redesigned)
GRID_QUERY = ("elimaloc_tpu_torch/csrc/grid_query.cu",
              "elimaloc_tpu/map/grid.py:181 query_nearest_point, :211 query_nearest_point_cov, "
              ":233 query_nearest_voxel_cov, :254 query_all_voxel_cov (+ :153 lookup)")
GROUND_PROBE = ("elimaloc_tpu_torch/csrc/ground_probe.cu",
                "elimaloc_tpu/map/grid.py:320 find_ground_height")
#: the tile map's one-shot queries (map/tiles.py), per form: its function and
#: keywords, the search kernels its card route launches after kernel B, the
#: hash grid's function of the same method (kernel Y), the kernels' sources
#: and the JAX function it ports
TILE_QUERIES = "tile queries"
TILE_QUERY = {
    "P2P": ("query_nearest_point", {}, ("p2p_correspond",), "query_nearest_point",
            "assign.cu + correspond.cu",
            "elimaloc_tpu/map/tiles.py:776 query_nearest_point (+ :577 assign_slots, :712 "
            "nearest_point_slots, :696 _scatter_back)"),
    "GICP": ("query_nearest_point", {"with_point_cov": True},
             ("p2p_correspond", "gicp_correspond"), "query_nearest_point_cov",
             "assign.cu + correspond.cu + gicp.cu",
             "elimaloc_tpu/map/tiles.py:776 query_nearest_point(with_point_cov) (+ :577, "
             ":712, :696)"),
    "VGICP": ("query_nearest_voxel_cov", {}, ("vgicp_correspond",), "query_nearest_voxel_cov",
              "assign.cu + vgicp.cu",
              "elimaloc_tpu/map/tiles.py:848 query_nearest_voxel_cov (+ :577, :803, :696)"),
    "AVGICP": ("query_all_voxel_cov", {}, ("avgicp_correspond",), "query_all_voxel_cov",
               "assign.cu + avgicp.cu",
               "elimaloc_tpu/map/tiles.py:909 query_all_voxel_cov (+ :577, :869, :696)"),
}
#: queries of the headline scan moved off the map, and every TILE_NOT_VALID-th
#: one marked not valid (5%)
TILE_OFF_MAP, TILE_NOT_VALID = 8, 20
#: "[functional replay]": runtime.replay_fused, replay_fused_chunk and
#: fused_frame_at on the pipelines of these run_fused paths, chunks of
#: FUNCTIONAL_CHUNK frames
FUNCTIONAL = "functional replay"
FUNCTIONAL_PATHS = ("P2P", "GICP", FUSION, "P2P hash")
FUNCTIONAL_CHUNK = 8
FUNCTIONAL_PAIRS = 5
#: the tile backend's kernels, never launched on a hash path
TILE_ONLY = ("assign_slots", "p2p_correspond", "gicp_correspond", "vgicp_correspond",
             "avgicp_correspond", LOOP, GICP_LOOP, VGICP_LOOP, AVG_LOOP)
#: truth ATE gate per method on the headline log, m. AVGICP does not
#: converge within max_iteration on this sparse map (8 iterations a frame
#: against ~2 for the other methods, 0.19 m on the H100): its gate follows the
#: reference's own looser AVGICP truth bounds (tests/test_icp.py 0.45 m,
#: tests/test_oracle_parity.py:221 0.8 m), not the other methods' 0.15 m.
ATE_GATE = {"P2P": 0.1, "GICP": 0.15, "VGICP": 0.15, "AVGICP": 0.3}
#: AVGICP's radar form on the headline log (1 km off the origin): its
#: objective is flat along the directions the radar variances damp (see
#: radar_reference_phase), and it tracks to ~0.4 m; held to the reference's
#: own AVGICP truth bound (tests/test_icp.py, 0.45 m)
RADAR_AVG_ATE_GATE = 0.45
#: the fleet paths: run_fused_fleet on the tile pipeline of a run_fused
#: path's configuration (label -> that path), FLEET_LANES lanes alternating
#: the headline log (seed 4) and a second log of the same world and duration
#: (seed FLEET_SEED), every frame one launch of each kernel's lane form for
#: all lanes
FLEET = "P2P fleet"
FUSION_FLEET = "AVG+GPS+CAN fleet"
#: the fleets of the hash backend and of the radar forms: GICP (the default
#: method) on the hash grid, GICP's tile radar form, AVGICP's radar form on
#: the hash grid; the radar ones in a map frame FAR_X m off the origin
HASH_FLEET, RADAR_FLEET = "GICP hash fleet", "GICP radar fleet"
RADAR_HASH_FLEET = "AVGICP radar hash fleet"
FLEET_PATHS = {FLEET: "P2P", "GICP fleet": "GICP", "VGICP fleet": "VGICP",
               "AVGICP fleet": "AVGICP", FUSION_FLEET: FUSION, HASH_FLEET: "GICP hash",
               RADAR_FLEET: "GICP+radar", RADAR_HASH_FLEET: "AVGICP hash+radar"}
FLEET_LANES = 8
FLEET_SEED = 5
#: the lane forms every fleet frame launches, besides its loop kernel's
#: and, with CAN and GPS fusion, kernel W's, with radar covariances X's (the
#: hash backend assigns no slots: no kernel B)
FLEET_SHARED = ("imu_stage", "scan_front", "voxel_downsample", "assign_slots", "pcm_stage")
#: the fleet frame's stages: label -> (the module attribute the frame calls
#: it through, the kernel's launch counter, the positional arguments with a
#: lane axis, the kernel's device name(s), |lane form - plain lane form| <=
#: tol * max(1, |plain|) on every float output, integers and flags equal)
FLEET_STAGES = {
    "imu_stage": ("runtime._imu_stage", (0, 1), "imu_stage_kernel", 1e-4),
    "can_gps_update": ("runtime.update_chain", (0,), "can_gps_update_kernel", 1e-4),
    "scan_front": ("runtime.scan_front", (0, 1, 2, 3, 4), "scan_", 1e-4),
    "voxel_downsample": ("runtime.voxel_downsample", (0, 1), "voxel_downsample_kernel", 0.0),
    "assign_slots": ("tiles.assign_slots", (1, 2), "assign_slots_kernel", 0.0),
    **{loop: (f"icp.{loop}", (1, 2, 3, 4, 5, 6, 7, 11), LOOP_DEVICE[loop], 1e-4)
       for loop in (LOOP, *TILE_LOOPS.values())},
    HASH_LOOP: ("icp.hash_register", (2, 3, 4, 5, 6, 7, 10), LOOP_DEVICE[HASH_LOOP], 1e-4),
    "radar_rows": ("icp.radar_slots", (0, 1, 2, 3), "radar_rows_kernel", 1e-5),
    "pcm_stage": ("runtime.pcm_stage", (0, 1, 3, 4, 5), "pcm_stage_kernel", 1e-4),
}
#: the keyword arguments with a lane axis (each a tuple of [B, ...] rows)
FLEET_LANE_KW = {"can_gps_update": ("can", "gps")}
#: each lane form's plain lane form (the same arguments as its dispatcher)
FLEET_PLAIN = {"imu_stage": "runtime.imu_subbatch_lanes_plain",
               "can_gps_update": "efilter.update_chain_lanes_plain",
               "scan_front": "runtime.scan_front_lanes_plain",
               "voxel_downsample": "grid.voxel_downsample_lanes_plain",
               "assign_slots": "tiles.assign_slots_lanes_plain",
               **{loop: f"icp.{loop}_lanes_plain"
                  for loop in (LOOP, *TILE_LOOPS.values(), HASH_LOOP)},
               "radar_rows": "icp.radar_slots_lanes_plain",
               "pcm_stage": "runtime.pcm_stage_lanes_plain"}
#: each lane form's source and what it replaces
FLEET_SOURCE = {
    "imu_stage": ("elimaloc_tpu_torch/csrc/imu_chain.cu + rings.cuh", EKF_KERNELS["imu_stage"][1]),
    "can_gps_update": CAN_GPS,
    "scan_front": FRONT,
    "voxel_downsample": ("elimaloc_tpu_torch/csrc/downsample.cu + sort.cuh",
                         "elimaloc_tpu/map/grid.py:271 (+ the sort :300)"),
    "assign_slots": ("elimaloc_tpu_torch/csrc/assign.cu + sort.cuh",
                     "elimaloc_tpu/map/tiles.py:577 (+ the sort :609)"),
    **{loop: (LOOP_SOURCE[loop], LOOP_REPLACES[loop])
       for loop in (LOOP, *TILE_LOOPS.values(), HASH_LOOP)},
    "radar_rows": RADAR_ROWS,
    "pcm_stage": ("elimaloc_tpu_torch/csrc/" + SCAN_KERNELS["pcm_stage"][0],
                  SCAN_KERNELS["pcm_stage"][1])}
FLEET_VMAP = ", vmapped over the fleet's lanes (elimaloc_tpu/parallel/sharding.py:264-281 " \
    "replay_fused_fleet, elimaloc_tpu/pipeline/runtime.py:1590-1649 run_fused_fleet)"
#: the lane instantiations no fleet path launches, each checked on a fleet
#: frame a path recorded: (row name, the loop, the run_fused configuration
#: it registers in, the path whose frame it takes: the hash fleet's without
#: radar, the tile GICP radar fleet's with it)
OTHER_LANE_FORMS = (
    *((f"{HASH_LOOP}[{m} fleet]", HASH_LOOP, f"{m} hash", HASH_FLEET)
      for m in ("P2P", "VGICP", "AVGICP")),
    *((f"{HASH_LOOP}[{m} radar fleet]", HASH_LOOP, f"{m} hash+radar", RADAR_FLEET)
      for m in ("GICP", "VGICP")),
    *((f"{TILE_LOOPS[m]}[radar fleet]", TILE_LOOPS[m], f"{m}+radar", RADAR_FLEET)
      for m in ("VGICP", "AVGICP")))
#: what a fleet path records besides its rows' lane forms: the tile GICP
#: radar fleet's downsample, for the scans OTHER_LANE_FORMS register
FLEET_RECORDS = {RADAR_FLEET: ("voxel_downsample",)}
#: the small fleets: use_imu=False (the hash GICP radar configuration) on
#: 2 lanes, and a fleet frame of more lanes than one loop launch takes (tile
#: GICP radar with GPS + CAN on SMALL_WIDE_LANES lanes: the loop launched
#: ceil(lanes / MAX_LANES) times a frame, every other lane form once), each
#: on SMALL_SCANS scans of SMALL_POINTS raw points of the headline world,
#: in the FAR_X frame
TICK_FLEET, WIDE_FLEET = "tick-mode fleet", "130-lane fleet"
SMALL_WIDE_LANES = 130
SMALL_POINTS = 4096
SMALL_SCANS = 6


def log_line(*parts):
    print(*parts, flush=True)


class PhaseClock:
    """The wall clock of each phase of :func:`main`: ``lap(name)`` waits for
    the card, prints the seconds since the last lap and keeps them for the
    slices line."""

    def __init__(self):
        self.laps, self.last = {}, time.time()

    def lap(self, name):
        torch.cuda.synchronize()
        now = time.time()
        self.laps[name] = round(now - self.last, 2)
        self.last = now
        log_line(f"[clock] {name}: {self.laps[name]:.2f} s")


def path_method(path):
    return path.split("+")[0].split(" ")[0]


def is_radar(path):
    return path.endswith("+radar")


def is_hash(path):
    return " hash" in path


def path_loop(path):
    """The loop kernel that runs a path's registrations (the method's tile
    loop, the hash loop)."""
    if is_hash(path):
        return HASH_LOOP
    return {"P2P": LOOP, **TILE_LOOPS}[path_method(path)]


def same_bits(x, y):
    """x and y equal, NaN where the other is NaN."""
    if torch.equal(x, y):
        return True
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(torch.where(nx, 0.0, x), torch.where(ny, 0.0, y))


def same_array(x, y):
    """Two NumPy arrays (or scalars, or both None) of one dtype and shape,
    equal bit for bit."""
    if x is None or y is None:
        return x is None and y is None
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the bytes over HBM_BPS and the
    operations over F32_OPS."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(t):
    """The largest |entry| of ``t``, 0 when it is empty."""
    return float(t.abs().max()) if t.numel() else 0.0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def device_phase():
    smi = card()
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
    name = "?"
    for line in report.splitlines():
        if "Function properties for" in line:
            name = _kernel_name(line)
        elif "registers" in line or "spill" in line:
            log_line(f"  ptxas {name}:", line.split(":", 1)[-1].strip())


def _kernel_name(line):
    """The ``*_kernel`` identifier inside a mangled name: a length-prefixed
    segment (``18gicp_search_kernel``)."""
    for m in re.finditer(r"\d+", line):
        for i in range(len(m.group())):  # the run may end a hash: "c322reduce_..."
            seg = line[m.end():m.end() + int(m.group()[i:])]
            if seg.endswith("_kernel"):
                return seg
    return "?"


def method_cfg(cfg_mod, path):
    """bench.py:_cfg(method), rebuilt from the port's config copy; the
    fusion path adds ``use_gps = use_can = True`` (bench.py:579-582)."""
    method = path_method(path)
    cfg = cfg_mod.ElimalocConfig()
    cfg.pcm.icp_method = cfg_mod.IcpMethod[method]
    cfg.ekf.use_gps = cfg.ekf.use_can = path == FUSION
    cfg.pcm.use_radar_cov = is_radar(path)
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    if method in ("VGICP", "AVGICP"):
        cfg.pcm.max_fitness_score = 2.0  # voxel-mean fitness floor
    return cfg


def headline_log(world, log_mod, seed=4):
    """The bench.py:140-146 log (``seed`` 4) on ``world``: N_SCANS + 3
    tenths of a second, RAW_POINTS points a scan sampled 1/INDEX_SAMPLING."""
    log = log_mod.synthesize_log(world, duration=(N_SCANS + 3) * 0.1,
                                 points_per_scan=RAW_POINTS, max_range=100.0, seed=seed)
    sl = slice(None, None, INDEX_SAMPLING)  # reference ingest, pcm_matching.cpp:908-921
    log.scan_points = np.ascontiguousarray(log.scan_points[:, sl])
    log.scan_times = np.ascontiguousarray(log.scan_times[:, sl])
    log.scan_valid = np.ascontiguousarray(log.scan_valid[:, sl])
    return log


def make_headline(cfg_mod, runtime, builder, tiles, log_mod):
    """The bench.py:140-169 world and log, one map built with both
    covariances and packed at halo margins 1 and 2, and the budgets."""
    world = log_mod.make_world(seed=3, extent=120.0, n_ground=400_000, n_wall=200_000)
    log = headline_log(world, log_mod)
    pcm = cfg_mod.ElimalocConfig().pcm
    t0 = time.time()
    built = builder.build_voxel_map(
        world, pcm.pcm_voxel_size, pcm.pcm_voxel_max_point, compute_voxel_cov=True,
        compute_point_cov=True, gicp_cov_search_dist=pcm.gicp_cov_search_dist)
    log_line(f"map: {len(world)} points -> {built.counts.shape[0]} voxels, build with "
             f"voxel and point covariances {time.time() - t0:.1f} s")
    packed = {}
    for margin in (1, 2):
        t0 = time.time()
        packed[margin] = tiles.build_tile_map(built, tile_voxels=4, halo_margin=margin)
        log_line(f"map: packed at halo margin {margin} in {time.time() - t0:.2f} s: "
                 f"points {packed[margin].halo_points.shape}, "
                 f"voxels {packed[margin].halo_vox_mean.shape}")
    ds_points, max_slots = runtime.autosize_budgets(
        log, float(pcm.input_voxel_ds_m), 4.0 * pcm.pcm_voxel_size, qb=16)
    return world, built, log, packed, ds_points, max_slots


class Recorder:
    """Wraps the kernel launchers to keep the arguments of one main-path call
    each (taken at call ``at``), so the kernel phase runs on real inputs;
    ``ekf_update``'s calls are all kept (``every``): the rows pick a CAN, a
    GPS and a PCM call among them."""

    def __init__(self, kernels, names, at, every=("ekf_update",)):
        self.kernels, self.at, self.calls, self.seen = kernels, at, {}, {}
        self.every = {n: [] for n in every}
        self.orig = {n: getattr(kernels, n) for n in names}

    def __enter__(self):
        for name, fn in self.orig.items():
            def wrapped(*a, _n=name, _f=fn, **k):
                i = self.seen.get(_n, 0)
                self.seen[_n] = i + 1
                if _n not in self.calls and i >= self.at:
                    self.calls[_n] = (a, k)
                if _n in self.every:
                    self.every[_n].append((a, k))
                return _f(*a, **k)
            setattr(self.kernels, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.kernels, name, fn)


def time_ms(fn, repeats=REPEATS):
    """Median of ``repeats`` CUDA-event timings of fn() after two warm
    calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def shared_kernel_rows(pipe, calls, mods):
    """Kernels B, C, D against their plain versions (the P2P path's calls;
    D's from the chain on kernel T's call, ``front_chain``)."""
    kernels, deskew, grid, tiles, _ = mods
    tmap = pipe.map
    budget = pipe.static.icp_static.tile_budget
    rows = []

    a, k = calls["deskew"]
    got = kernels.deskew(*a, **k)
    ref = deskew.deskew_points_plain(*a)
    err = float((got - ref).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"deskew kernel vs plain: max abs err {err} > 1e-4")
    points, rel, valid, info = a[:4]
    # per valid point: ~10 operations per IMU interval of the rotation sum,
    # ~60 for the rotation and the transform
    ops = int(valid.sum()) * (10 * info.imu_time.shape[0] + 60)
    rows.append(dict(name="deskew", source=DESKEW[0], replaces=DESKEW[1],
                     max_abs_err=err, ms=time_ms(lambda: kernels.deskew(*a, **k)),
                     plain_ms=time_ms(lambda: deskew.deskew_points_plain(*a)),
                     device_fn=(lambda a=a, k=k: kernels.deskew(*a, **k), "deskew_kernel"),
                     bound=bound(ops, nbytes(points, rel, valid, info.imu_time, info.imu_rot,
                                             info.imu_included, got))))

    a, k = calls["voxel_downsample"]
    got = kernels.voxel_downsample(*a, **k)
    ref = grid.voxel_downsample_plain(*a, **k)
    if not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError("voxel_downsample kernel differs from its plain version")
    points, valid, voxel = a[0], a[1], a[2]
    n = points.shape[0]
    # per point: voxel key (~17 operations) and 4 radix passes (~6 each);
    # per kept point its copy (3)
    ops = n * (17 + 6 * 4) + int(got[2]) * 3
    key = torch.where(valid, torch.clamp(grid._mix(grid.point_to_voxel(points, voxel)),
                                         max=0xFFFFFFFE), 0xFFFFFFFF)
    sort_ms = time_ms(lambda: torch.sort(key, stable=True))
    rows.append(dict(name="voxel_downsample", source="elimaloc_tpu_torch/csrc/downsample.cu "
                     "+ sort.cuh", replaces="elimaloc_tpu/map/grid.py:271 (+ the sort :300)",
                     max_abs_err=0.0, ms=time_ms(lambda: kernels.voxel_downsample(*a, **k)),
                     plain_ms=time_ms(lambda: grid.voxel_downsample_plain(*a, **k)),
                     device_fn=(lambda a=a, k=k: kernels.voxel_downsample(*a, **k),
                                "voxel_downsample_kernel"),
                     partial_library_ms=sort_ms,
                     partial_library_call=f"torch.sort(stable=True) of the {n} int64 keys "
                                          "alone: part of the function only",
                     bound=bound(ops, nbytes(points, valid, *got))))

    a, k = calls["assign_slots"]
    queries, valid = a[0], a[1]
    got = kernels.assign_slots(*a, **k)
    ref = tiles.assign_slots_plain(tmap, queries, valid, budget)
    for name in got:
        if not torch.equal(got[name], getattr(ref, name)):
            raise AssertionError(f"assign_slots kernel differs from plain in {name}")
    n = queries.shape[0]
    passes = max(1, -(-tmap.sentinel.bit_length() // 8))
    # per query: voxel and tile keys (~14) and the radix passes (~6 each);
    # per tile its count, start and base (~6)
    ops = n * (14 + 6 * passes) + (tmap.sentinel + 1) * 6
    _, tile = tiles.query_tiles(tmap, queries, valid)
    sort_ms = time_ms(lambda: torch.sort(tile, stable=True))
    rows.append(dict(name="assign_slots", source="elimaloc_tpu_torch/csrc/assign.cu + sort.cuh",
                     replaces="elimaloc_tpu/map/tiles.py:577 (+ the sort :609)", max_abs_err=0.0,
                     ms=time_ms(lambda: kernels.assign_slots(*a, **k)),
                     plain_ms=time_ms(lambda: tiles.assign_slots_plain(
                         tmap, queries, valid, budget)),
                     device_fn=(lambda a=a, k=k: kernels.assign_slots(*a, **k),
                                "assign_slots_kernel"),
                     partial_library_ms=sort_ms,
                     partial_library_call=f"torch.sort(stable=True) of the {n} int32 tile "
                                          "ids alone: part of the function only",
                     bound=bound(ops, nbytes(queries, valid, *got.values()))))
    log_line(f"  voxel_downsample / assign_slots: torch.sort(stable=True) of their keys "
             f"alone {rows[-2]['partial_library_ms']:.4f} / {sort_ms:.4f} ms; {passes} "
             f"radix passes on the {tmap.sentinel.bit_length()}-bit tile id")
    sort_edge_phase(kernels, grid, tiles)
    log_line(f"  shapes: scan {tuple(calls['deskew'][0][0].shape)}, "
             f"queries {tuple(queries.shape)}, halo {tuple(tmap.halo_points.shape)}")
    return rows


def sort_edge_phase(kernels, grid, tiles):
    """Kernels B and C against their plain versions, bit for bit and one
    launch a call, on the sort's edge inputs (tests/sort_edges.py: every row
    invalid, n = 1 / 31 / 1025 / 131,072, all queries in one tile, a
    257 x 257 tile grid with its tables in global scratch and 3 passes, an
    interleaved hash collision)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import sort_edges

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for case, (p, valid, voxel, out_size) in sort_edges.downsample_cases().items():
        pts = torch.as_tensor(p, dtype=torch.float32, device=dev)
        ok = torch.as_tensor(valid, device=dev)
        kernels.reset_launches()
        got = kernels.voxel_downsample(pts, ok, voxel, out_size)
        torch.cuda.synchronize()
        ref = grid.voxel_downsample_plain(pts, ok, voxel, out_size)
        if kernels.launches["voxel_downsample"] != 1 or not all(
                torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"voxel_downsample kernel vs plain on the edge case {case}")
    for case, (q, valid, geo, qb, slots) in sort_edges.assign_cases().items():
        tm = tiles.TileMap(halo_points=torch.zeros((1, 1, 3), device=dev),
                           voxel_size=sort_edges.VOXEL, tile_size=sort_edges.TILE,
                           origin=torch.zeros(2, device=dev), **geo)
        qs = torch.as_tensor(q, dtype=torch.float32, device=dev)
        ok = torch.as_tensor(valid, device=dev)
        budget = tiles.TileQueryBudget(qb=qb, max_slots=slots)
        kernels.reset_launches()
        got = tiles.assign_slots(tm, qs, ok, budget)
        torch.cuda.synchronize()
        ref = tiles.assign_slots_plain(tm, qs, ok, budget)
        if kernels.launches["assign_slots"] != 1 or not all(
                torch.equal(getattr(got, f.name), getattr(ref, f.name))
                for f in dataclasses.fields(ref)):
            raise AssertionError(f"assign_slots kernel vs plain on the edge case {case}")
    log_line(f"  sort edge cases: voxel_downsample {len(sort_edges.DOWNSAMPLE_CASES)}, "
             f"assign_slots {len(sort_edges.ASSIGN_CASES)}, each bit for bit and one launch "
             f"({time.perf_counter() - t0:.1f} s, the inputs' NumPy set-up included)")


#: the radar forms (use_radar_cov) of kernels E, F, G and the JAX code they
#: also replace
RADAR_REPLACES = {"GICP": " + :331-333 (radar)", "VGICP": " + :361-363 (radar)",
                  "AVGICP": " + :551-562 (radar: the flattened pairs of _voxcov_tail :354)"}


def _rel(x, y):
    """(rel err of x against y on y's finite entries, whether the non-finite
    entries agree): a non-finite sum (the radar form's singular rows) must
    be so on both sides."""
    fin = torch.isfinite(y)
    same = torch.equal(torch.isfinite(x), fin)
    if not bool(fin.any()):
        return 0.0, same
    x, y = x[fin].double(), y[fin].double()
    ny = float(torch.linalg.norm(y))
    return (float(torch.linalg.norm(x - y)) / ny if ny else float(torch.linalg.norm(x))), same


def radar_tail64(method, icp, pipe, sbuf, pose, radar, ref):
    """The radar tail in float64 on the plain version's own matches (the
    reference math without float32 rounding): (JTJ, JTr, fit_num)."""
    f64 = torch.float64
    p64 = icp.make_icp_params(pipe.cfg.pcm, dtype=f64, device=sbuf.device)
    src, rad = sbuf.reshape(-1, 3).to(f64), radar.reshape(-1, 3, 3).to(f64)
    cov, mean, ok = ref[4].reshape(-1, 3, 3).to(f64), ref[5].reshape(-1, 3).to(f64), ref[6]
    if method == "GICP":
        out = icp._gicp_tail(pose.to(f64), src, cov, mean, ok.reshape(-1), p64, rad)
    elif method == "VGICP":
        out = icp._voxcov_tail(pose.to(f64), src, cov, mean, ok.reshape(-1), p64, rad)
    else:
        out = icp._voxcov_tail(pose.to(f64), torch.repeat_interleave(src, 7, dim=0), cov, mean,
                               ok.reshape(-1), p64, torch.repeat_interleave(rad, 7, dim=0))
    return out[1:]


def compare_sums(name, got, ref, ref64, spread=0.0):
    """A search + GN kernel's (matched, JTJ, JTr, fit_num) against its plain
    version's: matched equal; JTJ / JTr / fitness numerator within rtol 1e-4
    on the norms, or, with the float64 tail ``ref64`` of the radar form, no
    farther from it than twice the larger of the plain float32 version's
    largest relative error and ``spread`` (kernel Q: that of the plain
    float32 version with the radar input moved by one ulp) plus 1e-4;
    non-finite sums on both sides alike. Returns (max abs err, worst rel
    err, [(kernel, plain) rel err against float64])."""
    if int(got[0]) != int(ref[0]):
        raise AssertionError(f"{name}: matched {int(got[0])} != {int(ref[0])}")
    err = worst = 0.0
    acc = [] if ref64 is None else [(_rel(x, r)[0], _rel(y, r)[0])
                                    for x, y, r in zip(got[1:], ref[1:4], ref64)]
    for i, (x, y) in enumerate(zip(got[1:], ref[1:4])):
        rel, same = _rel(x, y)
        if not same:
            raise AssertionError(f"{name}: the kernel's non-finite sums differ from the "
                                 "plain version's")
        if ref64 is None:
            if not rel <= 1e-4:
                raise AssertionError(f"{name}: JTJ/JTr/fitness rel err {rel} > 1e-4")
        elif not acc[i][0] <= 2.0 * max(max(p for _, p in acc), spread) + 1e-4:
            raise AssertionError(f"{name}: rel err against float64 {acc[i][0]:.3e}, plain "
                                 f"float32's largest {max(p for _, p in acc):.3e}, one-ulp "
                                 f"spread {spread:.3e}")
        fin = torch.isfinite(y)
        if bool(fin.any()):
            err = max(err, float((x[fin] - y[fin]).abs().max()))
        worst = max(worst, rel)
    return err, worst, acc


def method_kernel_row(method, pipe, calls, mods):
    """The method's fused search + GN kernel against its plain version: the
    matches exactly equal, ``matched`` equal, JTJ / JTr / fitness numerator
    within rtol 1e-4 on the norms (per-row products with FMAs, sums in
    another order). In its radar form (the recorded call carries kernel X's
    ``radar``) R^T C R + radar is not symmetric and rows can be near-
    singular, so the float32 sums carry the rows' condition numbers: both
    the kernel and its plain version are held to the same tail evaluated in
    float64 on the same matches, and on each of JTJ, JTr and the fitness
    numerator the kernel must lie no farther from it than twice the plain
    float32 version's largest relative error on them, plus 1e-4 (the rows'
    conditioning, measured on this input; non-finite sums equal on both
    sides)."""
    kernels, icp = mods[0], mods[4]
    wrapper, src, replaces, plain_name = KERNEL[method]
    tmap, params = pipe.map, pipe.params.icp
    budget = pipe.static.icp_static.tile_budget
    a, k = calls[wrapper]
    radar = k.get("radar")
    extra = () if radar is None else (radar,)
    if method == "P2P":
        slot_tile, sbuf, qmask, pose = a[1:5]
    else:
        slot_tile, sbuf, qmask, pose = a[3:7]
    plain = getattr(icp, plain_name)
    ref = plain(tmap, slot_tile, sbuf, qmask, pose, params, budget, *extra)
    out = getattr(kernels, wrapper)(*a, **k, with_matches=True)
    if method == "P2P":
        got = icp.assemble_p2p(out[0])
    else:
        got = icp.assemble_gn(out[0])
    for i, (x, y) in enumerate(zip(out[1:], ref[4:])):
        if not torch.equal(x, y):
            raise AssertionError(f"{wrapper}: match output {i} differs from its plain "
                                 "version")
    ref64 = None if radar is None else radar_tail64(method, icp, pipe, sbuf, pose, radar, ref)
    err, worst, acc = compare_sums(wrapper, got, ref, ref64)
    live = int(qmask.sum())
    n_tiles = int(torch.unique(slot_tile[qmask.any(1)]).numel())
    matched, row = int(ref[0]), a[0].shape[1]
    cand_b, match_b, match_ops = SEARCH_COST[method]
    # the halo rows of the tiles in use, the live queries, the masks, the
    # matched rows' covariance gathers and the sums; 6 operations per
    # candidate (the 27-voxel cube test) and the per-match GN arithmetic
    moved = (n_tiles * row * cand_b + live * 12 + nbytes(qmask, slot_tile, pose, out[0])
             + matched * match_b + live * 36 * (radar is not None))
    name = wrapper if radar is None else f"{wrapper}[radar]"
    log_line(f"  {name}: slots {tuple(qmask.shape)}, halo {tuple(a[0].shape)}, "
             f"live queries {live}, tiles {n_tiles}, matched {matched}, "
             f"|JTJ| {float(torch.linalg.norm(ref[1])):.3e}, worst rel err {worst:.2e}"
             + ("" if not acc else ", against float64 (JTJ, JTr, fit) kernel / plain: "
                + ", ".join(f"{k:.2e} / {p:.2e}" for k, p in acc)))
    return dict(name=name, source=f"elimaloc_tpu_torch/csrc/{src}",
                replaces=replaces + (RADAR_REPLACES[method] if radar is not None else ""),
                max_abs_err=err, ms=time_ms(lambda: getattr(kernels, wrapper)(*a, **k)),
                plain_ms=time_ms(lambda: plain(tmap, slot_tile, sbuf, qmask, pose,
                                               params, budget, *extra)),
                launches_key=wrapper,
                bound=bound(live * row * 6 + matched * (match_ops + 9 * (radar is not None)),
                            moved))


def hash_tail64(method, icp, grid_mod, pipe, grid, src, valid, pose, radar):
    """Kernel Q's radar tail in float64 on the plain version's own matches
    (the grid queries at the float32 queries): (JTJ, JTr, fit_num)."""
    f64 = torch.float64
    q = icp.transform_slots(pose, src)
    md = pipe.params.icp.max_search_dist
    p64 = icp.make_icp_params(pipe.cfg.pcm, dtype=f64, device=src.device)
    pose64, src64, rad = pose.to(f64), src.to(f64), radar.to(f64)
    if method == "GICP":
        _, cov, mean, ok = grid_mod.query_nearest_point_cov_plain(grid, q, md)
        return icp._gicp_tail(pose64, src64, cov.to(f64), mean.to(f64), ok & valid, p64,
                              rad)[1:]
    if method == "VGICP":
        cov, mean, ok = grid_mod.query_nearest_voxel_cov_plain(grid, q, md)
        return icp._voxcov_tail(pose64, src64, cov.to(f64), mean.to(f64), ok & valid, p64,
                                rad)[1:]
    cov, mean, ok = grid_mod.query_all_voxel_cov_plain(grid, q, md)
    return icp._voxcov_tail(pose64, torch.repeat_interleave(src64, 7, dim=0),
                            cov.reshape(-1, 3, 3).to(f64), mean.reshape(-1, 3).to(f64),
                            (ok & valid[:, None]).reshape(-1), p64,
                            torch.repeat_interleave(rad, 7, dim=0))[1:]


def hash_search_bytes_ops(method, grid_mod, grid, queries, matched):
    """(bytes, operations) the hash search needs on these queries: each
    neighbour voxel it touches read once (its probe slot, 8 B, its count, 4
    B, and its points, 12 B each, or its mean), the matched payloads
    (``matched`` distinct rows x the method's match bytes); ~9 operations a
    candidate (3 sub, 3 mul, 2 add, 1 compare) and ~40 a lookup (the two
    hashes)."""
    offsets = grid_mod.OFFSETS_7 if method == "AVGICP" else grid_mod.OFFSETS_27
    rows = grid_mod._neighbour_rows(grid, queries, offsets).long()
    uniq = torch.unique(rows)
    counts = grid.counts[uniq]
    per_voxel = counts.sum() * 12 if method in ("P2P", "GICP") else (counts > 0).sum() * 12
    cand_all = grid.counts[rows]
    cands = cand_all.sum() if method in ("P2P", "GICP") else (cand_all > 0).sum()
    match_b = SEARCH_COST[method][1]
    return (int(uniq.numel()) * 12 + int(per_voxel) + matched * match_b,
            int(cands) * 9 + rows.numel() * 40)


def hash_kernel_row(path, pipe, calls, mods):
    """Kernel Q's fused entry on a GN iteration of the hash path against
    ``hash_search_reduce_plain`` on the same inputs (``compare_sums``: rtol
    1e-4; the radar form against its float64 tail)."""
    kernels, grid_mod, icp, cfg_mod = mods[0], mods[2], mods[4], mods[5]
    method = path_method(path)
    a, k = calls["hash_correspond"]
    grid, src, valid, pose, max_dist, _, radar = a
    params = pipe.params.icp
    code = int(cfg_mod.IcpMethod[method])

    def plain():
        return icp.hash_search_reduce_plain(grid, src, valid, pose, params, code, radar)

    ref = plain()
    sums = kernels.hash_correspond(*a, **k)
    got = icp.assemble_p2p(sums) if method == "P2P" else icp.assemble_gn(sums)
    ref64 = spread = None
    if radar is not None:
        # near the map origin the radar rows are near-singular (PERF.md): the
        # float32 tail is then as sensitive as moving the radar input by one
        # ulp, which the kernel's other (equally valid) rounding may do
        ref64 = hash_tail64(method, icp, grid_mod, pipe, grid, src, valid, pose, radar)
        spread = max(_rel(x, r)[0] for f in (1 + 2 ** -23, 1 - 2 ** -23)
                     for x, r in zip(icp.hash_search_reduce_plain(
                         grid, src, valid, pose, params, code, radar * f)[1:4], ref64))
    name = f"hash_correspond[{method}{' radar' if radar is not None else ''}]"
    err, worst, acc = compare_sums(name, got, ref, ref64, spread or 0.0)
    n, matched = src.shape[0], int(ref[0])
    moved, ops = hash_search_bytes_ops(method, grid_mod, grid, icp.transform_slots(pose, src),
                                       matched)
    moved += nbytes(src, valid, pose, max_dist, sums, radar)
    ops += matched * (SEARCH_COST[method][2] + 9 * (radar is not None))
    log_line(f"  {name}: queries {n}, valid {int(valid.sum())}, matched {matched}, grid "
             f"{tuple(grid.points.shape)}, max_probe {grid.max_probe}, |JTJ| "
             f"{float(torch.linalg.norm(ref[1])):.3e}, worst rel err {worst:.2e}"
             + ("" if not acc else ", against float64 (JTJ, JTr, fit) kernel / plain: "
                + ", ".join(f"{x:.2e} / {p:.2e}" for x, p in acc)
                + f"; plain with the radar input one ulp off: {spread:.2e}"))
    return dict(name=name, source=HASH[0], replaces=HASH[1], max_abs_err=err,
                ms=time_ms(lambda: kernels.hash_correspond(*a, **k)), plain_ms=time_ms(plain),
                device_fn=(lambda: kernels.hash_correspond(*a, **k), "hash_search_kernel"),
                launches_key="hash_correspond", bound=bound(ops, moved))


def hash_grid_phase(pipe, calls, mods):
    """The grid's own functions on the card at the P2P hash path's last
    recorded GN iteration (its world queries, their voxels, the scan's
    position): the four queries (kernel Y), ``lookup`` (kernel Q's lookup
    entry) and ``find_ground_height`` (kernel Z), the counts set to 0 just
    before and read just after: Y four times, Z once, their references (Q's
    query entry, R) never. Then each against its plain version and its
    reference: Y against the plain queries and against Q's query entry bit
    for bit (the same exact search, then copies), the lookup bit for bit,
    Z's (found, z) against R's bit for bit and z within one float32 ulp of
    the plain version. The launch floor (an empty kernel) is measured
    beside the lookup."""
    kernels, grid_mod, icp = mods[0], mods[2], mods[4]
    g = pipe.map
    a, _ = calls["hash_correspond"]
    src, valid, pose = a[1], a[2], a[3]
    md = pipe.params.icp.max_search_dist
    q = icp.transform_slots(pose, src)
    coords = grid_mod.point_to_voxel(q, g.voxel_size)
    xy = tuple(float(v) for v in pose[:2, 3])
    queries = {"P2P": (grid_mod.query_nearest_point, grid_mod.query_nearest_point_plain),
               "GICP": (grid_mod.query_nearest_point_cov,
                        grid_mod.query_nearest_point_cov_plain),
               "VGICP": (grid_mod.query_nearest_voxel_cov,
                         grid_mod.query_nearest_voxel_cov_plain),
               "AVGICP": (grid_mod.query_all_voxel_cov, grid_mod.query_all_voxel_cov_plain)}
    kernels.reset_launches()
    got = {m: fn(g, q, md) for m, (fn, _) in queries.items()}
    rows = grid_mod.lookup(g, coords)
    found, z = grid_mod.find_ground_height(g, xy)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    if not (launches["grid_query"] == 4 and launches["hash_lookup"] == 1
            and launches["ground_probe"] == 1 and launches["hash_query"] == 0
            and launches["ground_height"] == 0):
        raise AssertionError(f"[{HASH_GRID}] launches {launches}")
    out = []
    n = q.shape[0]
    for m, (fn, plain) in queries.items():
        ref = plain(g, q, md)
        for i, (x, y) in enumerate(zip(got[m], ref)):
            if not torch.equal(x, y.to(x.dtype)):
                raise AssertionError(f"[{HASH_GRID}] query {m} output {i} differs from plain")
        y_out, q_out = kernels.grid_query(g, q, md, m), kernels.hash_query(g, q, md, m)
        for k in y_out:
            if not torch.equal(y_out[k], q_out[k]):
                raise AssertionError(f"[{HASH_GRID}] kernel Y {m} {k} differs from kernel Q's "
                                     "query entry")
        valid_q = ref[1] if m == "P2P" else ref[-1]
        moved, ops = hash_search_bytes_ops(m, grid_mod, g, q, int(valid_q.sum()))
        moved += nbytes(q, md, *got[m])
        plain_ms = time_ms(lambda: plain(g, q, md))
        out.append(dict(name=f"grid_query[{m}]", source=GRID_QUERY[0],
                        replaces=GRID_QUERY[1], max_abs_err=0.0,
                        ms=time_ms(lambda: fn(g, q, md)), plain_ms=plain_ms, launches=1,
                        device_fn=(lambda fn=fn: fn(g, q, md), "grid_query"),
                        bound=bound(ops, moved)))
        out.append(dict(name=f"hash_query[{m}]", source=HASH[0], replaces=HASH[1],
                        max_abs_err=0.0, ms=time_ms(lambda: kernels.hash_query(g, q, md, m)),
                        plain_ms=plain_ms, launches=launches["hash_query"],
                        device_fn=(lambda m=m: kernels.hash_query(g, q, md, m),
                                   "hash_query_kernel"), bound=bound(ops, moved)))
        log_line(f"  grid_query[{m}]: {n} queries, {int(valid_q.sum())} valid, bit for bit "
                 "= plain = kernel Q's query entry")
    ref_rows = grid_mod.lookup_plain(g, coords)
    if not torch.equal(rows, ref_rows):
        raise AssertionError(f"[{HASH_GRID}] lookup differs from its plain version")
    probes = torch.unique(grid_mod._hash(coords, g.table_size)).numel()
    out.append(dict(name="hash_lookup", source=HASH[0], replaces=HASH[1], max_abs_err=0.0,
                    ms=time_ms(lambda: grid_mod.lookup(g, coords)),
                    plain_ms=time_ms(lambda: grid_mod.lookup_plain(g, coords)), launches=1,
                    device_fn=(lambda: grid_mod.lookup(g, coords), "hash_lookup_kernel"),
                    bound=bound(n * 40, nbytes(coords, rows) + probes * 8)))
    floor = {"device_ms": kernel_device_ms(kernels.launch_floor, "launch_floor_kernel"),
             "event_ms": time_ms(kernels.launch_floor)}
    log_line(f"  launch floor (an empty kernel, beside hash_lookup): on the device "
             + (f"{floor['device_ms']:.4f} ms" if floor["device_ms"] else "not measured")
             + f" (torch.profiler), event {floor['event_ms']:.4f} ms")
    rf, rz = grid_mod.find_ground_height_plain(g, xy)
    r_found, r_z = kernels.ground_height(g.points, xy, 5.0, 5)
    if not (torch.equal(found, r_found) and torch.equal(z, r_z)):
        raise AssertionError(f"[{HASH_GRID}] kernel Z ({bool(found)}, {float(z)}) differs from "
                             f"kernel R ({bool(r_found)}, {float(r_z)})")
    ulp = float(torch.finfo(torch.float32).eps) * max(abs(float(rz)), 1e-30)
    z_err = abs(float(z) - float(rz)) if torch.isfinite(rz) else float(z != rz)
    if not (bool(found) == bool(rf) and z_err <= ulp):
        raise AssertionError(f"[{HASH_GRID}] ground height ({bool(found)}, {float(z)}) vs "
                             f"plain ({bool(rf)}, {float(rz)})")
    v, m_pts = g.points.shape[0] - 1, g.points.shape[1]
    real = int(g.counts[:-1].sum())
    plain_ms = time_ms(lambda: grid_mod.find_ground_height_plain(g, xy))
    # Z: each count and each point below its count read once, the outputs
    out.append(dict(name="ground_probe", source=GROUND_PROBE[0], replaces=GROUND_PROBE[1],
                    max_abs_err=z_err, ms=time_ms(lambda: grid_mod.find_ground_height(g, xy)),
                    plain_ms=plain_ms, launches=1,
                    device_fn=(lambda: grid_mod.find_ground_height(g, xy),
                               "ground_probe_kernel"),
                    bound=bound(real * 8, v * 4 + real * 12 + 5)))
    # R: the dense plane it streams
    out.append(dict(name="ground_height", source=GROUND[0], replaces=GROUND[1],
                    max_abs_err=z_err, ms=time_ms(lambda: kernels.ground_height(g.points, xy,
                                                                                5.0, 5)),
                    plain_ms=plain_ms, launches=launches["ground_height"],
                    device_fn=(lambda: kernels.ground_height(g.points, xy, 5.0, 5), "ground_"),
                    bound=bound(v * m_pts * 6, v * m_pts * 12 + 8)))
    log_line(f"[{HASH_GRID}] lookup of {n} voxels bit for bit; ground height at "
             f"({xy[0]:.2f}, {xy[1]:.2f}): found {bool(found)}, z {float(z):.6f} (plain "
             f"{float(rz):.6f}; kernel R bit for bit); {real} map points in {v} voxels "
             f"of {m_pts} slots; launches {launches}")
    for r in out:
        r["route"] = "cuda"
    return out, {"launches": {k: launches[k] for k in ("grid_query", "hash_lookup",
                                                         "ground_probe", "hash_query",
                                                         "ground_height")},
                 "ground": {"found": bool(found), "z": float(z)}, "launch_floor": floor}


def tile_query_phase(pipe, grid_pipe, calls, mods, windowed, deferred):
    """The tile map's one-shot queries on the card (``map.tiles``), on the
    headline tile map with both covariances (the tile P2P pipeline's, halo
    margin 1) and the P2P hash path's last recorded GN iteration's world
    queries (those of the "hash grid" phase), TILE_OFF_MAP of them moved off
    the map, every TILE_NOT_VALID-th one and the downsample's padding not
    valid, at the pipeline's budget. The counts set to 0 just before the
    four calls and read just after: kernel B 4, A 2, E 1, F 1, G 1, nothing
    else (no loop kernel); each call under set_sync_debug_mode("error").
    Each output bit for bit its plain version on the same tensors; no slot
    dropped. Against kernel Y on the hash grid of the same map on the same
    queries: valid equal (Y's and the input's), the nearest distances within
    1e-5 m (tests/test_tiles.py:42-48), GICP's covariance and mean where the
    same point was chosen, VGICP's and AVGICP's means and covariances within
    1e-5 where valid. ``windowed``: the windowed check's summary
    (``window_query_check``). A row a query form: B + its search kernel(s)
    + the scatter, its event ms, Y's beside it; device ms (the call's
    kernels, and Y's) in the profiler pass; into ``deferred``, a profiled
    pass a form that splits its device time by kernel."""
    kernels, grid_mod, tiles, icp = mods[0], mods[2], mods[3], mods[4]
    tmap, g = pipe.map, grid_pipe.map
    budget = pipe.static.icp_static.tile_budget
    md = pipe.params.icp.max_search_dist
    a, _ = calls["hash_correspond"]
    q = icp.transform_slots(a[3], a[1])
    q[:TILE_OFF_MAP, :2] += 1000.0
    valid = a[2].clone()
    valid[::TILE_NOT_VALID] = False
    n = q.shape[0]

    def call(m):
        name, kw = TILE_QUERY[m][:2]
        return lambda: getattr(tiles, name)(tmap, q, valid, md, budget, **kw)

    got, per_call = {}, {}
    kernels.reset_launches()
    for m in TILE_QUERY:
        before = dict(kernels.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got[m] = call(m)()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        per_call[m] = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    want = {"assign_slots": 4, "p2p_correspond": 2, "gicp_correspond": 1,
            "vgicp_correspond": 1, "avgicp_correspond": 1}
    if launches != want:
        raise AssertionError(f"[{TILE_QUERIES}] launches {launches}, not {want}")
    asg = tiles.assign_slots(tmap, q, valid, budget)
    if int(asg.dropped):
        raise AssertionError(f"[{TILE_QUERIES}] {int(asg.dropped)} queries dropped")
    n_tiles = int(torch.unique(asg.slot_tile[asg.qmask.any(1)]).numel())
    live = int(asg.qmask.sum())
    out, summary = [], {"queries": n, "valid_in": int(valid.sum()), "tiles": n_tiles,
                        "budget": [budget.qb, budget.max_slots], "launches": launches,
                        "per_call": per_call, "windowed": windowed}
    ys = {m: getattr(grid_mod, TILE_QUERY[m][3])(g, q, md) for m in TILE_QUERY}
    ok_at = {"P2P": (1, 1), "GICP": (1, 3), "VGICP": (2, 2), "AVGICP": (2, 2)}
    for m, (name, kw, searches, y_name, src, replaces) in TILE_QUERY.items():
        plain = getattr(tiles, f"{name}_plain")
        ref = plain(tmap, q, valid, md, budget, **kw)
        for i, (x, y) in enumerate(zip(got[m], ref)):
            if not (x.shape == y.shape and torch.equal(x, y)):
                raise AssertionError(f"[{TILE_QUERIES}] {m} output {i} differs from plain")
        t_ok, y_ok = got[m][ok_at[m][0]], ys[m][ok_at[m][1]]
        v_in = valid if y_ok.dim() == 1 else valid[:, None]
        if not torch.equal(t_ok, y_ok & v_in):
            raise AssertionError(f"[{TILE_QUERIES}] {m}: valid differs from kernel Y's in "
                                 f"{int((t_ok != (y_ok & v_in)).sum())} queries")
        errs = {}
        if m in ("P2P", "GICP"):
            q64 = q.double()
            d_t = (got[m][0].double() - q64).norm(dim=1)[t_ok]
            d_y = (ys[m][0].double() - q64).norm(dim=1)[t_ok]
            errs["nearest_distance_m"] = max_abs(d_t - d_y)
            if m == "GICP":
                same = t_ok & torch.isclose(got[m][0], ys[m][0]).all(1)
                errs["same_point"] = int(same.sum())
                errs["cov"] = max_abs((got[m][2] - ys[m][1])[same])
                errs["mean_m"] = max_abs((got[m][3] - ys[m][2])[same])
        else:
            errs["cov"] = max_abs((got[m][0] - ys[m][0])[t_ok])
            errs["mean_m"] = max_abs((got[m][1] - ys[m][1])[t_ok])
        if not all(v <= 1e-5 for k, v in errs.items() if k != "same_point"):
            raise AssertionError(f"[{TILE_QUERIES}] {m} against kernel Y: {errs}")
        matched = int(t_ok.sum())
        row = (tmap.halo_points if m in ("P2P", "GICP") else tmap.halo_vox_mean).shape[1]
        cand_b, match_b, _ = SEARCH_COST[m]
        # the queries and the mask read once, the halo rows of the tiles in
        # use, the matched rows' covariance gathers, the outputs; 6
        # operations per candidate (the 27-voxel cube test)
        moved = nbytes(q, valid, *got[m]) + n_tiles * row * cand_b + matched * match_b
        y_fn = getattr(grid_mod, y_name)
        ms, y_ms = time_ms(call(m)), time_ms(lambda: y_fn(g, q, md))
        summary[m] = {"valid": matched, "against_kernel_y": errs, "ms": ms, "kernel_y_ms": y_ms}
        log_line(f"  {TILE_QUERIES}[{m}]: {n} queries ({live} in slots, {n_tiles} tiles), "
                 f"valid {matched}, launches {per_call[m]}, bit for bit = plain; against "
                 f"kernel Y {errs}; event {ms:.4f} ms, kernel Y {y_ms:.4f} ms")
        out.append(dict(name=f"tile_query[{m}]", route="cuda",
                        source=" + ".join(f"elimaloc_tpu_torch/csrc/{f}"
                                          for f in src.split(" + ")),
                        replaces=replaces, max_abs_err=0.0, ms=ms,
                        plain_ms=time_ms(lambda: plain(tmap, q, valid, md, budget, **kw)),
                        launches=sum(per_call[m].values()), device_fn=(call(m), ""),
                        chain_fn=lambda y_fn=y_fn: y_fn(g, q, md),
                        chain_label=f"kernel Y (grid.{y_name}) on the same queries",
                        bound=bound(live * row * 6, moved)))
    log_line(f"[{TILE_QUERIES}] launches {launches}; no slot dropped; windowed: {windowed}")

    def split():
        summary["device_split_ms"] = {}
        for m in TILE_QUERY:
            per, _ = device_profile(lambda m=m: [call(m)() for _ in range(REPEATS)])
            ms = {k: v / REPEATS * 1e-3 for k, v in sorted(per.items(), key=lambda kv: -kv[1])}
            summary["device_split_ms"][m] = ms
            log_line(f"[{TILE_QUERIES}] {m}: device ms a call by kernel ({REPEATS} calls under "
                     "torch.profiler): " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in ms.items()))
    deferred.append(split)
    return out, summary


def window_query_check(wmap, fmap, built, tiles, budget):
    """The "P2P windowed" pipeline's window ``wmap`` (as the replay left
    it) against the full map ``fmap``: map voxel means inside the window
    (one tile in from its edge) plus noise, on a 2^-10 m grid so that their
    window-local and world coordinates are both exact in float32, through
    the four one-shot queries of each map; each windowed call bit for bit
    its plain version, ``ok`` equal, the targets and means with the origin
    added back within 1e-5 m, the covariances equal."""
    ax0, ay0 = wmap.grid_origin
    ts = wmap.tile_size
    origin = torch.zeros(3, dtype=torch.float64, device=wmap.origin.device)
    origin[:2] = wmap.origin.double()
    o = origin.cpu().numpy()
    lo = np.array([(ax0 + 1) * ts, (ay0 + 1) * ts]) + o[:2]
    hi = np.array([(ax0 + wmap.tx_dim - 1) * ts, (ay0 + wmap.ty_dim - 1) * ts]) + o[:2]
    rng = np.random.default_rng(7)
    means = built.vox_mean[np.all((built.vox_mean[:, :2] >= lo) & (built.vox_mean[:, :2] < hi),
                                  axis=1)]
    pick = means[rng.choice(len(means), min(8192, len(means)), replace=False)]
    pts = np.round((pick + rng.normal(0.0, 0.3, pick.shape)) * 1024.0) / 1024.0
    q_world = torch.as_tensor(pts, dtype=torch.float32, device=wmap.origin.device)
    q_local = (q_world.double() - origin).float()
    if not torch.equal((q_local.double() + origin).float(), q_world):
        raise AssertionError(f"[{TILE_QUERIES}] windowed: local queries not exact")
    valid = torch.ones(len(pts), dtype=torch.bool, device=q_world.device)
    res = {"queries": len(pts), "tile_anchor": list(wmap.tile_anchor)}
    world_at = {"P2P": (0,), "GICP": (0, 3), "VGICP": (1,), "AVGICP": (1,)}
    cov_at = {"GICP": (2,), "VGICP": (0,), "AVGICP": (0,)}
    for m, (name, kw) in ((m, v[:2]) for m, v in TILE_QUERY.items()):
        fn = getattr(tiles, name)
        got = fn(wmap, q_local, valid, 5.0, budget, **kw)
        ref = getattr(tiles, f"{name}_plain")(wmap, q_local, valid, 5.0, budget, **kw)
        full = fn(fmap, q_world, valid, 5.0, budget, **kw)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"[{TILE_QUERIES}] windowed {m} differs from its plain version")
        k = -1 if m in ("VGICP", "AVGICP") else 1
        if not torch.equal(got[k], full[k]):
            raise AssertionError(f"[{TILE_QUERIES}] windowed {m}: ok differs from the full "
                                 f"map's in {int((got[k] != full[k]).sum())} queries")
        shape = (1,) * (got[world_at[m][0]].dim() - 1) + (3,)
        err = max(float((got[i].double() + origin.view(shape) - full[i].double()).abs().max())
                  for i in world_at[m])
        covs = all(torch.equal(got[i], full[i]) for i in cov_at.get(m, ()))
        if not (err <= 1e-5 and covs):
            raise AssertionError(f"[{TILE_QUERIES}] windowed {m}: {err} m from the full map, "
                                 f"covariances equal: {covs}")
        res[m] = {"valid": int(got[k].sum()), "max_err_m": err}
    for tmap in (wmap, fmap):
        if int(tiles.assign_slots(tmap, q_local if tmap is wmap else q_world, valid,
                                  budget).dropped):
            raise AssertionError(f"[{TILE_QUERIES}] windowed: slots dropped")
    log_line(f"[{TILE_QUERIES}] windowed: the window at tile anchor {wmap.tile_anchor} against "
             f"the full map on {len(pts)} queries: ok equal, bit for bit = plain, {res}")
    return res


def p_args(a):
    """Kernel P's arguments for a recorded call of kernel X: rows 0..N-1
    (no index, no mask) as an arange index and an all-true mask."""
    src, qidx, qmask, pose, params = a
    if qidx is None:
        n = src.shape[0]
        qidx = torch.arange(n, dtype=torch.int32, device=src.device).view(1, n)
        qmask = torch.ones((1, n), dtype=torch.bool, device=src.device)
    return src, qidx, qmask, pose, params


def x_against_p(kernels, calls, what):
    """Kernel X bit for bit against kernel P on every recorded call of X."""
    bad = [i for i, (a, _) in enumerate(calls)
           if not torch.equal(kernels.radar_rows(*a).flatten(),
                              kernels.radar_cov(*p_args(a)).flatten())]
    log_line(f"[{what}] kernel X bit for bit = kernel P on {len(calls) - len(bad)} of "
             f"{len(calls)} registrations")
    if bad or not calls:
        raise AssertionError(f"[{what}] kernel X differs from kernel P on calls {bad[:10]}")


def radar_row(calls, mods, wrapper):
    """Kernel X (``wrapper`` "radar_rows", once a radar registration) or
    kernel P ("radar_cov", X's reference: 0 launches on every path)
    against ``radar_slots_plain`` on the GICP radar path's registration:
    atol 1e-5 on entries up to ~1 m^2 (the plain transform is a cuBLAS
    product with FMAs, the trigonometry the same libm), dead rows exactly
    zero. X's row also holds profiled calls of ``icp.radar_slots`` to
    one device kernel, X's."""
    kernels, icp = mods[0], mods[4]
    a, _ = calls["radar_rows"]
    fn = getattr(kernels, wrapper)
    aa = a if wrapper == "radar_rows" else p_args(a)
    src, qidx, qmask, pose, params = aa
    got = fn(*aa)
    ref = icp.radar_slots_plain(*a)
    err = float((got - ref).abs().max())
    live = int(qmask.sum())
    if not (err <= 1e-5 and bool((got[~qmask] == 0).all())):
        raise AssertionError(f"{wrapper} kernel vs plain: max abs err {err} > 1e-5")
    log_line(f"  {wrapper}: slots {tuple(qmask.shape)}, live rows {live} of {qmask.numel()}, "
             f"scan {tuple(src.shape)}, max |R S| {float(ref.abs().max()):.3f}, "
             f"max abs err {err:.2e}")
    # per row its index and mask, per live row its point and ~40 operations
    # with four transcendentals (~20 each); the [S, QB, 9] output
    moved = nbytes(qidx, qmask, pose, params.range_variance_m, params.azimuth_variance_deg,
                   params.elevation_variance_deg, got) + live * 12
    row = dict(name=wrapper, source=(RADAR_ROWS if wrapper == "radar_rows" else RADAR_COV)[0],
               replaces=RADAR_ROWS[1], max_abs_err=err, ms=time_ms(lambda: fn(*aa)),
               plain_ms=time_ms(lambda: icp.radar_slots_plain(*a)),
               device_fn=(lambda: fn(*aa), f"{wrapper}_kernel"),
               bound=bound(live * 120, moved))
    if wrapper == "radar_rows":
        row["stage_fn"] = (lambda: icp.radar_slots(*a), "radar_rows_kernel")
    return row


#: torch.profiler passes a measurement takes at most when a pass comes back
#: with no device record at all (the profiler lost them; fn ran again)
PROFILE_TRIES = 8


def device_profile(fn):
    """({kernel name: device us summed}, wall ms) of fn() under one
    torch.profiler pass; the dict is empty where the profiler saw no device
    activity. The pass idles PROFILE_PAD_S on the host before fn and after
    its last kernel: without it the profiler now and then loses the device
    records of the pass's first moments, all of a short pass's. A pass with
    no device record at all is taken again, up to PROFILE_TRIES passes, each
    padded longer than the one before, with the allocator's cached blocks
    released first, and said so with the card's free memory (the pads make
    such a pass rare, not impossible)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        pad = PROFILE_PAD_S * (1 + attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            time.sleep(pad)
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
        if per:
            break
        free, total = torch.cuda.mem_get_info()
        log_line(f"  torch.profiler: pass {attempt + 1} of {PROFILE_TRIES} came back with no "
                 f"device record (pads {pad:.2f} s; card memory free {free / 2**30:.1f} of "
                 f"{total / 2**30:.1f} GiB, PyTorch reserved "
                 f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB)")
        torch.cuda.empty_cache()
    return per, wall


def kernel_device_ms(fn, kernel):
    """Device time of one call of fn (ms, from REPEATS calls under the
    profiler) in the kernels whose name holds ``kernel``, or None."""
    per, _ = device_profile(lambda: [fn() for _ in range(REPEATS)])
    us = sum(v for k, v in per.items() if kernel in k)
    return us / REPEATS * 1e-3 if us else None


def kalman_ops(m, joseph=False):
    """f32 operations of one Kalman update of size m on the 27x27 P: H P,
    the m x m solve, the gain rows, K Y, P -= K H P and the injection; in
    the Joseph form also K R and the two m-term passes over P."""
    return (m * 27 + m ** 3 + 27 * 2 * m * m + 27 * 2 * m + 729 * 2 * m + 60
            + (27 * 2 * m * m + 729 * 4 * m + 729 if joseph else 0))


def state_bytes(kernels, state):
    """The packed state record a kernel reads or writes whole."""
    return kernels.ekf_state.record_layout(torch.float32).nbytes


def params_bytes(kernels, params):
    return kernels.ekf_state.PARAM_WORDS * 4


def ekf_field_errors(kernels, got, ref):
    """{field: max |got - ref| / max |ref|} over the float fields; the flags
    and counters must be equal."""
    rel = {}
    for f, dtype, _ in kernels.EKF_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if dtype != torch.float32:
            if not torch.equal(a, b):
                raise AssertionError(f"EKF kernel vs plain: field {f} differs")
            continue
        scale = float(b.abs().max()) or 1.0
        rel[f] = float((a - b).abs().max()) / scale
    return rel


def p_entry_err(got, ref, prior, tol):
    """P's error as a share of its limit (at most 1 passes): max over (i, j)
    of |got_ij - ref_ij| / (tol sqrt(ref_ii ref_jj) + 8 eps sqrt(prior_ii
    prior_jj)), eps the float32 epsilon. Each entry is held to its own
    variances, so the small observed blocks (pos, rot, vel: variances far
    below 1) are held as tightly as the unobserved states near
    INIT_STATE_COV = 100. The second term is the rounding that P -= K H P
    leaves, in any order of operations, on an entry whose variance an
    update collapses (a 6-DOF fix with zero rotation noise): eight ulps of
    the entry's scale before the call."""
    def scale(p):
        d = torch.sqrt(torch.diagonal(p).clamp(min=0.0))
        return d[:, None] * d[None, :]

    limit = tol * scale(ref) + 8 * torch.finfo(torch.float32).eps * scale(prior)
    return float(((got - ref).abs() / limit.clamp(min=1e-30)).max())


def with_joseph(call, at):
    """A recorded (args, kwargs) call with its EkfFlags (argument ``at``)
    switched to the Joseph form."""
    a, k = call
    a = list(a)
    a[at] = dataclasses.replace(a[at], joseph_form=True)
    return tuple(a), k


def stage_of(a, pipe, runtime):
    """(pipeline state, frame batch, params, static) of a recorded
    ``kernels.imu_stage`` call ``a`` on the pipeline ``pipe`` (its flags
    argument taken as given)."""
    st = runtime.PipelineState(ekf=a[0], ego_ring=a[1], imu_ring=a[2])
    b = dict(zip(("imu_t", "imu_acc", "imu_gyro", "imu_valid"), a[3:7]))
    return st, b, pipe.params, dataclasses.replace(pipe.static, ekf_flags=a[10])


def imu_stage_row(calls, pipe, mods, joseph=False):
    """Kernel H, the frame's whole IMU stage in one launch, against its plain
    composition ``runtime.imu_subbatch_plain`` on one frame's raw IMU
    budget: pos / vel within 1e-4 m, the quaternions 1e-6, each P entry
    within 1e-4 sqrt(P_ii P_jj) plus the rounding term (``p_entry_err``;
    the plain version's small products go through cuBLAS, whose order and
    FMAs differ from the kernel's ordered sums), flags and counters equal;
    both rings' t and count exactly, their fields within the ego rows' gates
    (pos, vel_local, gyro, acc 1e-4, rpy 1e-5 rad). One call of the
    stage's entry (``runtime.imu_subbatch``, ``stage_fn``) must show exactly
    one device kernel, H's, under torch.profiler (with the other profiler
    passes, after every timed replay). With ``joseph`` the same call with the
    Joseph-form updates, held the same way."""
    kernels, runtime = mods[0], mods[6]
    a, _ = with_joseph(calls["imu_stage"], 10) if joseph else calls["imu_stage"]
    st, b, pp, ps = stage_of(a, pipe, runtime)
    got = runtime.imu_subbatch(st, b, pp, ps)
    ref = runtime.imu_subbatch_plain(st, b, pp, ps)
    err = {f: float((getattr(got.ekf, f) - getattr(ref.ekf, f)).abs().max())
           for f in ("pos", "vel", "rot", "imu_rot")}
    err["P"] = float((got.ekf.P - ref.ekf.P).abs().max())
    err["P share of its limit"] = p_entry_err(got.ekf.P, ref.ekf.P, st.ekf.P, 1e-4)
    diag = torch.diagonal(ref.ekf.P)
    ekf_field_errors(kernels, got.ekf, ref.ekf)
    gates = [err["pos"] <= 1e-4, err["vel"] <= 1e-4, err["rot"] <= 1e-6,
             err["imu_rot"] <= 1e-6, err["P share of its limit"] <= 1.0]
    ring_err = {}
    for ring, tols in (("ego_ring", dict(pos=1e-4, rpy=1e-5, vel_local=1e-4, gyro=1e-4)),
                       ("imu_ring", dict(gyro=1e-4, acc=1e-4))):
        g, r = getattr(got, ring), getattr(ref, ring)
        gates += [torch.equal(g.t, r.t), torch.equal(g.count, r.count)]
        for f, tol in tols.items():
            ring_err[f"{ring}.{f}"] = float((getattr(g, f) - getattr(r, f)).abs().max())
            gates.append(ring_err[f"{ring}.{f}"] <= tol)
    name = "imu_stage[joseph]" if joseph else "imu_stage"
    valid = b["imu_valid"]
    log_line(f"  {name}: {valid.shape[0]} samples ({int(valid.sum())} valid), rings "
             f"{int(got.ego_ring.count)} / {got.ego_ring.capacity} and "
             f"{int(got.imu_ring.count)} / {got.imu_ring.capacity}, errors "
             + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
             + f" (P_ii {float(diag.min()):.2e} to {float(diag.max()):.2e}), rings "
             + ", ".join(f"{k} {v:.2e}" for k, v in ring_err.items()))
    if not all(gates):
        raise AssertionError(f"{name} kernel vs plain: outside its gates")
    flags = a[10]
    # per valid sample: the conversion (~60), the nominal step (~400), B = A
    # P, C = A B^T and the P update (~7,200), the complementary filter (m =
    # 2), the calibration (m = 3) where on, the ego row (~100); per pushed
    # row its copy (13 + 7)
    per_sample = 7760 + (kalman_ops(2, joseph) + 200 if flags.run_cf else 0) + (
        kalman_ops(3, joseph) + 300 if flags.imu_estimate_calibration else 0)
    moved = (2 * state_bytes(kernels, st.ekf) + params_bytes(kernels, pp.ekf)
             + nbytes(*a[3:9]))
    for ring, out, fields in ((st.ego_ring, got.ego_ring, ("t", "pos", "rpy", "vel_local", "gyro")),
                              (st.imu_ring, got.imu_ring, ("t", "gyro", "acc"))):
        moved += nbytes(ring.count, out.count)
        for n in (int(ring.count), int(out.count)):
            moved += nbytes(*(getattr(ring, f)[:n] for f in fields))
    return dict(name=name, source="elimaloc_tpu_torch/csrc/imu_chain.cu + rings.cuh",
                replaces=EKF_KERNELS["imu_stage"][1] + (
                    " with joseph_form (filter.py:252-259)" if joseph else ""),
                launches_key="imu_stage",
                max_abs_err=max(err["pos"], err["vel"], err["rot"], err["imu_rot"],
                                *ring_err.values()),
                ms=time_ms(lambda: kernels.imu_stage(*a)),
                plain_ms=time_ms(lambda: runtime.imu_subbatch_plain(st, b, pp, ps)),
                device_fn=(lambda: kernels.imu_stage(*a), "imu_stage_kernel"),
                stage_fn=(lambda: runtime.imu_subbatch(st, b, pp, ps), "imu_stage_kernel"),
                bound=bound(int(valid.sum()) * per_sample + 20 * valid.shape[0], moved))


def i_args(k):
    """Kernel I's keyword arguments for a recorded call of kernel W: a
    ``valid`` of None (every sample valid) as an all-true mask."""
    out = dict(k)
    for key in ("can", "gps"):
        v = out.get(key)
        if v is not None and v[3] is None:
            out[key] = v[:3] + (torch.ones(v[0].shape[0], dtype=torch.bool,
                                           device=v[0].device),)
    return out


def same_record(a, b):
    """Two kernel outputs (``ekf.state.RecordState``) hold equal records."""
    return torch.equal(a.intact_record(), b.intact_record())


def w_against_i(kernels, calls, what):
    """Kernel W bit for bit against kernel I (its reference) on every
    recorded call of W: the state records equal. Returns the call count."""
    bad = [i for i, (a, k) in enumerate(calls)
           if not same_record(kernels.can_gps_update(*a, **k),
                              kernels.ekf_update(*a, **i_args(k)))]
    log_line(f"  [{what}] kernel W bit for bit = kernel I on {len(calls) - len(bad)} of "
             f"{len(calls)} recorded calls")
    if bad or not calls:
        raise AssertionError(f"[{what}] kernel W differs from kernel I on calls {bad[:10]}")
    return len(calls)


def extra_fixes(mods, gps_call):
    """Kernel W against kernel I, and against the plain chain within its
    gate, on a GPS fix of the recorded path turned into a 6-DOF one (the
    NOVATEL source, as gps_type ODOMETRY gives) and into a 3-DOF one with
    yaw not yet initialised (yaw std 12.8 deg: the antenna inflation)."""
    kernels, efilter, cfg_mod = mods[0], mods[7], mods[5]
    (st, params, flags), k = gps_call
    p = st.P.clone()
    p[5, 5] = 0.05
    cases = {"6-DOF": (st, dataclasses.replace(flags, gps_type=cfg_mod.GpsType.ODOMETRY)),
             "3-DOF yaw uninitialised": (st.replace(P=p), flags)}
    for what, (s0, fl) in cases.items():
        kw = {"gps": k["gps"], "gnss_uncertainty_max": k["gnss_uncertainty_max"],
              "gps_source": efilter.GPS_SOURCE[fl.gps_type]}
        got = kernels.can_gps_update(s0, params, fl, **kw)
        ref_i = kernels.ekf_update(s0, params, fl, **i_args(kw))
        ref = efilter.update_chain_plain(s0, params, fl, gps=kw["gps"],
                                         gnss_uncertainty_max=kw["gnss_uncertainty_max"])
        rel = ekf_field_errors(kernels, got, ref)
        rel.pop("P")
        p_err = p_entry_err(got.P, ref.P, s0.P, 1e-5)
        log_line(f"  can_gps_update {what} fix: W = I {same_record(got, ref_i)}, P "
                 f"share of its limit vs plain {p_err:.2e}, worst rel err of the rest "
                 f"{max(rel.values()):.2e}, yaw_initialized {bool(got.yaw_initialized)}")
        if not (same_record(got, ref_i) and p_err <= 1.0
                and max(rel.values()) <= 1e-5):
            raise AssertionError(f"can_gps_update on the {what} fix: outside its gates")
        if what.startswith("3") and bool(got.yaw_initialized):
            raise AssertionError("the 3-DOF fix did not run with yaw uninitialised")


def update_row(rec, mods, wrapper, joseph=False):
    """Kernel W (``wrapper`` "can_gps_update", on the CAN and GPS path) or
    kernel I ("ekf_update", W's reference: 0 launches on every path) against
    ``update_chain_plain`` on a CAN sub-batch and a GPS fix the fusion path
    gave kernel W: each P entry within 1e-5 sqrt(P_ii P_jj) plus the
    rounding term (``p_entry_err``), every other float field within rel 1e-5
    of its largest entry, the flags and counters equal. Its time is one
    fusion frame's launch (the CAN + GPS sub-batches, as the path made it at
    the recorded frame; the PCM pose runs in kernel S). W is also held bit
    for bit to kernel I on every recorded call and on the extra fixes
    (``extra_fixes``). With ``joseph`` the same calls with the Joseph-form
    updates, held the same way."""
    kernels, efilter = mods[0], mods[7]
    fn = getattr(kernels, wrapper)
    args_of = (lambda k: k) if wrapper == "can_gps_update" else i_args

    def plain(*a, gps_source=None, **k):  # the plain chain reads it from the flags
        return efilter.update_chain_plain(*a, **k)

    calls = rec.every["can_gps_update"]
    if joseph:
        calls = [with_joseph(c, 2) for c in calls]
    name = f"{wrapper}[{'joseph' if joseph else 'fusion frame'}]"
    frame_can = next(c for c in calls[rec.at:] if c[1].get("can") is not None)
    gps = next(c for c in calls if c[1].get("gps") is not None and bool(c[1]["gps"][3].any()))
    if wrapper == "can_gps_update":
        w_against_i(kernels, calls, name)
        extra_fixes(mods, gps)
    checks = {
        "CAN": (frame_can[0], {"can": frame_can[1]["can"]}),
        "GPS": (gps[0], {k: gps[1][k] for k in ("gps", "gps_source", "gnss_uncertainty_max")}),
    }
    worst = 0.0
    for what, (a, k) in checks.items():
        got = fn(*a, **args_of(k))
        ref = plain(*a, **k)
        rel = ekf_field_errors(kernels, got, ref)
        rel.pop("P")
        p_err = p_entry_err(got.P, ref.P, a[0].P, 1e-5)
        moved = float((ref.P - a[0].P).abs().max())
        log_line(f"  {name} {what}: P moved by {moved:.2e}, P share of its limit "
                 f"{p_err:.2e}, worst rel err of the rest {max(rel.values()):.2e} "
                 f"({max(rel, key=rel.get)})")
        if not (p_err <= 1.0 and max(rel.values()) <= 1e-5 and moved > 0.0):
            raise AssertionError(f"{name} kernel vs plain on {what}: outside its gate")
        worst = max(worst, max(float((getattr(got, f) - getattr(ref, f)).abs().max())
                               for f in (*rel, "P")))
    a, k = frame_can
    kk = args_of(k)
    t, vx, yaw, cvalid = k["can"]
    gt, gpos, gcov, gvalid = k["gps"]
    ops = (int(cvalid.sum()) * (kalman_ops(4, joseph) + 150)
           + int(gvalid.sum()) * (kalman_ops(3, joseph) + 250))
    moved = (2 * state_bytes(kernels, a[0]) + params_bytes(kernels, a[1])
             + nbytes(t, vx, yaw, cvalid, gt, gpos, gcov, gvalid))
    source, replaces = CAN_GPS if wrapper == "can_gps_update" else EKF_UPDATE
    return dict(name=name, source=source,
                replaces=replaces + (" with joseph_form (filter.py:252-259)" if joseph else ""),
                launches_key=wrapper, max_abs_err=worst,
                ms=time_ms(lambda: fn(*a, **kk)),
                plain_ms=time_ms(lambda: plain(*a, **k)),
                device_fn=(lambda: fn(*a, **kk), f"{wrapper}_kernel"),
                bound=bound(ops, moved))


def stage_args(a):
    """``runtime.pcm_stage``'s arguments of a recorded ``kernels.pcm_stage``
    call ``a``."""
    ekf, params, flags, pose, tf, local_cov, fitness, success, usable, ring, end, use_pcm = a
    res = SimpleNamespace(pose=pose, local_cov=local_cov, fitness=fitness, success=success)
    return ekf, res, tf, ring, end, usable, params, flags, use_pcm


def l_then_i(mods, a):
    """The two launches kernel S replaces, on a recorded ``kernels.pcm_stage``
    call ``a``: kernel L's measurement, then kernel I's PCM update. Returns
    (state, L's outputs)."""
    kernels, efilter = mods[0], mods[7]
    meas = kernels.pcm_measurement(*a[3:])
    pcm = efilter.GnssMeas(timestamp=meas[1], source=int(mods[5].GnssSource.PCM),
                           pos=meas[2], rot=meas[3], pos_cov=meas[4], rot_cov=meas[5])
    return kernels.ekf_update(*a[:3], pcm=(pcm, meas[6])), meas


def ring_rows(ego, end):
    """The ego-ring rows the scan's end reads at ``end``: every valid time
    (the search), pos and rpy at the newest entry and at the first one after
    the measurement (pcm_meas.cuh). Returns (valid rows, pos / rpy rows)."""
    n_ego = int(ego.count)
    later = np.flatnonzero(ego.t[:n_ego].cpu().numpy() > np.float32(end.item()))
    return n_ego, len({n_ego - 1, later[0] if later.size else n_ego - 1}) if n_ego else 0


def pcm_stage_row(rec, mods, joseph=False):
    """Kernel S, the scan's end in one launch, on every frame's recorded call
    of the path: bit-equal to kernel L then kernel I (the state record, every
    measurement field, ``applied``); on the run's first applied PCM pose
    against its plain version ``runtime.pcm_stage_plain``: each P entry
    within 1e-5 sqrt(P_ii P_jj) plus the rounding term (``p_entry_err``),
    every other float field of the state within rel 1e-5, flags and
    counters equal, icp_pose within 1e-4 (entries up to ~100 m), ego_rpy
    within 1e-5 rad and p_asym, p_min_diag within 1e-5 of P's largest
    diagonal entry of the plain version's; on S's own state its ego_pos and
    ego_t equal, ego_rpy within 1e-6 rad of the plain conversion and p_asym,
    p_min_diag equal to the plain reductions. One call of the stage's entry
    (``runtime.pcm_stage``, ``stage_fn``) must show exactly one device
    kernel, S's. With ``joseph`` the same calls in the Joseph form."""
    kernels, runtime = mods[0], mods[6]
    calls = rec.every["pcm_stage"]
    if joseph:
        calls = [with_joseph(c, 2) for c in calls]
    name = "pcm_stage[joseph]" if joseph else "pcm_stage"
    applied = []
    for i, (a, _) in enumerate(calls):
        got, out = kernels.pcm_stage(*a)
        ref, meas = l_then_i(mods, a)
        same = [torch.equal(got.intact_record(), ref.intact_record())]
        same += [torch.equal(x, y) for x, y in zip(out[:7], meas)]
        if not all(same):
            raise AssertionError(f"{name}: frame {i} differs from kernel L then kernel I; "
                                 f"equal (state record, icp_pose, t, pos, quat, pos_cov, "
                                 f"rot_cov, applied): {same}")
        applied.append(bool(out[6]))
    # against the plain version on the run's first applied PCM pose, as
    # kernel I's PCM leg was held before: on later frames the 6x6 solve
    # differs from cuSOLVER's by ~3e-4 of a small gyro (PERF.md section 7)
    at = applied.index(True)
    a, _ = calls[at]
    args = stage_args(a)
    got, _, pub = runtime.pcm_stage(*args)
    ref, _, rpub = runtime.pcm_stage_plain(*args)
    rel = ekf_field_errors(kernels, got, ref)
    rel.pop("P")
    p_err = p_entry_err(got.P, ref.P, a[0].P, 1e-5)
    P = got.P
    scale = float(torch.diagonal(ref.P).abs().max())
    err = {k: float((pub[k] - rpub[k]).abs().max()) for k in ("icp_pose", "ego_pos", "ego_rpy",
                                                             "ego_t", "p_asym", "p_min_diag")}
    own_rpy = float((pub["ego_rpy"] - runtime.ego_pose(got)["rpy"]).abs().max())
    gates = [p_err <= 1.0, max(rel.values()) <= 1e-5, bool(pub["applied"]),
             bool(pub["applied"]) == bool(rpub["applied"]), err["icp_pose"] <= 1e-4,
             err["ego_rpy"] <= 1e-5, err["p_asym"] <= 1e-5 * scale,
             err["p_min_diag"] <= 1e-5 * scale, own_rpy <= 1e-6,
             torch.equal(pub["ego_pos"], got.pos), torch.equal(pub["ego_t"], got.prev_timestamp),
             torch.equal(pub["p_asym"], torch.max(torch.abs(P - P.T))),
             torch.equal(pub["p_min_diag"], torch.min(torch.diagonal(P)))]
    log_line(f"  {name}: {len(calls)} frames bit-equal to kernel L then kernel I "
             f"({sum(applied)} applied); frame {at} vs plain: P share of its limit "
             f"{p_err:.2e}, worst rel err of the rest {max(rel.values()):.2e} "
             f"({max(rel, key=rel.get)}), "
             + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
             + f"; ego_rpy vs the plain conversion of its own state {own_rpy:.2e}")
    if not all(gates):
        raise AssertionError(f"{name} kernel vs plain: outside its gates {gates}")
    # the measurement (~700 operations, 2 a valid ring row for the search),
    # the PCM update, the P statistics (2 x 729) and the Euler angles (~60);
    # bytes: both state records, the params, the ring rows it reads, the
    # ICP result and the output buffer
    n_ego, rows = ring_rows(a[9], a[10])
    ops = 2 * n_ego + 700 + (kalman_ops(6, joseph) + 250 if bool(pub["applied"]) else 0) \
        + 2 * 729 + 60
    moved = (2 * state_bytes(kernels, a[0]) + params_bytes(kernels, a[1])
             + nbytes(*a[3:9], a[9].t[:n_ego], a[9].pos[:rows], a[9].rpy[:rows], a[9].count,
                      a[10]) + 4 * kernels.PCM_STAGE_FLOATS + 1)
    log_line(f"  {name}: kernel L then kernel I, their event time "
             f"{time_ms(lambda: l_then_i(mods, a)):.4f} ms")
    return dict(name=name, source="elimaloc_tpu_torch/csrc/" + SCAN_KERNELS["pcm_stage"][0],
                replaces=SCAN_KERNELS["pcm_stage"][1] + (
                    " with joseph_form (filter.py:252-259)" if joseph else ""),
                launches_key="pcm_stage",
                max_abs_err=max(err["icp_pose"], err["ego_pos"], err["ego_rpy"]),
                ms=time_ms(lambda: kernels.pcm_stage(*a)),
                plain_ms=time_ms(lambda: runtime.pcm_stage_plain(*args)),
                device_fn=(lambda: kernels.pcm_stage(*a), "pcm_stage_kernel"),
                stage_fn=(lambda: runtime.pcm_stage(*args), "pcm_stage_kernel"),
                chain_fn=lambda: l_then_i(mods, a), bound=bound(ops, moved))


def ring_query_rows(imu, ego, cur, end, w):
    """The ring rows kernel K's function needs on this input, from its
    searches (scan_ring.cu, float32 as it compares): (IMU time rows: the
    valid ones and the window's; gyro rows integrated; distinct ego rows
    whose pos and rpy it reads; those whose vel_local and gyro it reads to
    extrapolate)."""
    f = np.float32
    cur, end = f(cur.item()), f(end.item())
    n_imu, n_ego = int(imu.count), int(ego.count)
    it = imu.t[:n_imu].cpu().numpy()
    inc = np.flatnonzero((it >= cur - f(0.01)) & (it <= end + f(0.01)))
    first = int(inc[0]) if inc.size else 0
    start = min(max(first, 0), imu.capacity - w)
    imu_t_rows = max(n_imu, start + w) if start <= n_imu else n_imu + w
    gyro_rows = int(((inc > first) & (inc < start + w)).sum())

    et = ego.t[:n_ego].cpu().numpy()
    fresh = np.flatnonzero(et >= cur - f(0.1))
    last_fresh = int(fresh[-1]) if fresh.size else ego.capacity - 1
    ge_cur = fresh[et[fresh] >= cur]
    ge_end = fresh[et[fresh] >= end]
    le, gt = np.flatnonzero(et <= end), np.flatnonzero(et > end)
    pose = {int(ge_cur[0]) if ge_cur.size else last_fresh, int(le[-1]) if le.size else 0}
    rate = set()
    pose.add(int(ge_end[0]) if ge_end.size else last_fresh)
    if not ge_end.size:
        rate.add(last_fresh)
    pose.add(int(gt[0]) if gt.size else n_ego - 1)
    if not gt.size:
        rate.add(n_ego - 1)
    return imu_t_rows, gyro_rows, len(pose), len(rate)


def front_args(a):
    """``runtime.scan_front``'s arguments of a recorded ``kernels.scan_front``
    call ``a``: (state, stamp, points, times, valid, params, static), the
    state, params and static as the fields it reads."""
    points, times, valid, stamp, delay, max_dist, imu, ego, tf, ste, run_deskew, bug_z = a
    return (SimpleNamespace(imu_ring=imu, ego_ring=ego), stamp, points, times, valid,
            SimpleNamespace(lidar_time_delay=delay, input_max_dist=max_dist,
                            tf_ego_to_lidar=tf),
            SimpleNamespace(scan_time_end=ste, run_deskew=run_deskew,
                            bug_compat_deskew_z=bug_z))


def front_chain(mods, a):
    """The launches kernel T replaces, on a recorded ``kernels.scan_front``
    call ``a``: the delayed stamp, the range gate and the scan times in torch
    (``deskew.normalize_scan_times``), kernel K, then kernel D. Returns (the
    outputs in T's wrapper's order, K's arguments, D's arguments)."""
    from elimaloc_tpu_torch.ops import lie

    kernels, deskew = mods[0], mods[1]
    points, times, valid, stamp, delay, max_dist, imu, ego, tf, ste, run_deskew, bug_z = a
    stamp = stamp - delay
    valid = valid & (lie.norm(points) <= max_dist)
    rel, cur, end = deskew.normalize_scan_times(times, valid, stamp, ste)
    k_args = (imu, ego, cur, end, tf, 64, run_deskew)
    (imu_time, imu_rot, included, first_idx, last_idx, incre, imu_ok, odom_ok, covers, guess,
     found, usable) = kernels.scan_ring_query(*k_args)
    info = deskew.DeskewInfo(imu_time=imu_time, imu_rot=imu_rot, imu_included=included,
                             first_idx=first_idx, last_idx=last_idx, odom_incre=incre,
                             scan_cur=cur, scan_end=end, imu_available=imu_ok,
                             odom_available=odom_ok, imu_covers_start=covers)
    d_args = (points, rel, valid, info, bug_z)
    pts = kernels.deskew(*d_args) if run_deskew else points
    return ((valid, pts, cur, end, guess, found, usable, imu_ok & odom_ok, imu_time, imu_rot,
             included, first_idx, last_idx, incre, imu_ok, odom_ok, covers), k_args, d_args)


#: kernel T's outputs, in its wrapper's order
FRONT_OUTPUTS = ("valid", "points", "scan_cur", "scan_end", "init_guess", "found", "usable",
                 "deskew_ok", "imu_time", "imu_rot", "imu_included", "first_idx", "last_idx",
                 "odom_incre", "imu_available", "odom_available", "imu_covers_start")


def front_fields(front):
    """A ``runtime.ScanFront`` as {name: tensor} in :data:`FRONT_OUTPUTS`, the
    deskew info's fields among them."""
    return {k: getattr(front, k) if hasattr(front, k) else getattr(front.info, k)
            for k in FRONT_OUTPUTS}


def front_row(rec, mods):
    """Kernel T, the scan's front in one host call, on every frame's recorded
    call of the P2P path and on frame ``rec.at``'s with each flag flipped
    (``scan_time_end`` False, its raw times moved 0.1 s later into the start
    convention; ``run_deskew`` False; ``bug_compat_z``): bit-equal to the
    chain it replaced (``front_chain``: the gate and the scan times in torch,
    kernel K, then kernel D), valid' point by point equal to the torch
    gate's; on frame ``rec.at`` against its plain version
    ``runtime.scan_front_plain``: masks, indices and flags equal, floats
    within 1e-4 (kernel K's and D's own bounds). One call of the stage's
    entry (``runtime.scan_front``, ``stage_fn``) must show T's two kernels
    and nothing else on the device."""
    kernels, runtime = mods[0], mods[6]
    calls = [a for a, _ in rec.every["scan_front"]]
    at = calls[rec.at]
    start, plain_off, bug_z = list(at), list(at), list(at)
    start[1], start[9] = at[1] + 0.1, False
    plain_off[10] = False
    bug_z[11] = True
    frames = [(f"frame {i}", a) for i, a in enumerate(calls)] + [
        ("scan_time_end=False", tuple(start)), ("run_deskew=False", tuple(plain_off)),
        ("bug_compat_z", tuple(bug_z))]
    gate_diff = 0
    for what, a in frames:
        got = kernels.scan_front(*a)
        ref = front_chain(mods, a)[0]
        differ = int((got[0] != ref[0]).sum())
        gate_diff += differ
        same = [torch.equal(x, y) for x, y in zip(got, ref)]
        if differ or not all(same):
            raise AssertionError(f"scan_front: {what} differs from the gate, scan times, K and D "
                                 f"chain: {differ} points of valid' differ from the torch "
                                 f"gate's; equal {dict(zip(FRONT_OUTPUTS, same))}")
    args = front_args(at)
    got = front_fields(runtime.scan_front(*args))
    ref = front_fields(runtime.scan_front_plain(*args))
    err = 0.0
    for k, v in ref.items():
        if v.dtype == torch.float32:
            err = max(err, float((got[k] - v).abs().max()))
        elif not torch.equal(got[k], v):
            raise AssertionError(f"scan_front kernel vs plain: {k} differs")
    if not err <= 1e-4:
        raise AssertionError(f"scan_front kernel vs plain: max abs err {err} > 1e-4")
    points, valid, n = at[0], got["valid"], at[0].shape[0]
    n_valid, w = int(valid.sum()), got["imu_time"].shape[0]
    imu, ego = at[6], at[7]
    log_line(f"  scan_front: {len(calls)} frames and 3 flag frames bit-equal to the gate, scan "
             f"times, K and D chain ({gate_diff} points of valid' differ from the torch "
             f"gate's); frame {rec.at} vs plain: max abs err {err:.2e}; {n} points, {n_valid} "
             f"valid after the gate, window {w}, usable {bool(got['usable'])}")
    log_line(f"  scan_front: the chain it replaced, event time "
             f"{time_ms(lambda: front_chain(mods, at)):.4f} ms")
    # bytes: per point xyz, time and valid in, valid' and xyz' out; the ring
    # rows kernel K's queries read; the stamp, the parameters and the output
    # buffer. Operations: the gate (~7 a point), the deskew (kernel D's) and
    # kernel K's
    imu_t_rows, gyro_rows, pose_rows, rate_rows = ring_query_rows(
        imu, ego, got["scan_cur"], got["scan_end"], w)
    outs = [v for k, v in got.items() if k != "points"]
    moved = (nbytes(points, at[1], at[2], at[3], at[4], at[5], at[8], got["points"], *outs)
             + nbytes(imu.t[:imu_t_rows], imu.gyro[:gyro_rows], imu.count,
                      ego.t[:int(ego.count)], ego.pos[:pose_rows], ego.rpy[:pose_rows],
                      ego.vel_local[:rate_rows], ego.gyro[:rate_rows], ego.count))
    ops = 7 * n + n_valid * (10 * w + 60) + 10 * (int(imu.count) + int(ego.count)) + 20 * w + 2000
    return dict(name="scan_front", source=FRONT[0], replaces=FRONT[1], max_abs_err=err,
                ms=time_ms(lambda: kernels.scan_front(*at)),
                plain_ms=time_ms(lambda: runtime.scan_front_plain(*args)),
                device_fn=(lambda: kernels.scan_front(*at), "scan_"),
                stage_fn=(lambda: runtime.scan_front(*args),
                          ("scan_gate_query_kernel", "scan_deskew_points_kernel")),
                chain_fn=lambda: front_chain(mods, at),
                chain_label="the gate and scan times in torch, kernel K, kernel D",
                bound=bound(ops, moved))


def query_row(calls, mods):
    """Kernel K, the reference entry of kernel T, against
    ``scan_ring_query_plain`` on the P2P path's frame (its call in the chain
    on kernel T's inputs, ``front_chain``):
    the masks, indices and flags equal, the float outputs within 1e-4 (the
    guess's translation is ~100 m; the plain version's cumsum is a parallel
    scan and its 4x4 products go through cuBLAS)."""
    kernels, deskew = mods[0], mods[1]
    a, _ = calls["scan_ring_query"]
    imu, ego, cur, end, tf, window, run_deskew = a
    got = kernels.scan_ring_query(*a)
    info, guess, found, usable = deskew.scan_ring_query_plain(*a)
    ref = (info.imu_time, info.imu_rot, info.imu_included, info.first_idx, info.last_idx,
           info.odom_incre, info.imu_available, info.odom_available, info.imu_covers_start,
           guess, found, usable)
    err = 0.0
    for g, r in zip(got, ref):
        if g.dtype == torch.float32:
            err = max(err, float((g - r).abs().max()))
        elif not torch.equal(g, r):
            raise AssertionError("scan_ring_query kernel vs plain: a flag or index differs")
    if not err <= 1e-4:
        raise AssertionError(f"scan_ring_query kernel vs plain: max abs err {err} > 1e-4")
    w = info.imu_time.shape[0]
    log_line(f"  scan_ring_query: IMU ring {imu.capacity} ({int(imu.count)} valid), ego ring "
             f"{ego.capacity} ({int(ego.count)}), window {w}, included "
             f"{int(info.imu_included.sum())}, found {bool(found)}, usable {bool(usable)}")
    n_imu, n_ego = int(imu.count), int(ego.count)
    imu_t_rows, gyro_rows, pose_rows, rate_rows = ring_query_rows(imu, ego, cur, end, w)
    moved = nbytes(imu.t[:imu_t_rows], imu.gyro[:gyro_rows], imu.count, ego.t[:n_ego],
                   ego.pos[:pose_rows], ego.rpy[:pose_rows], ego.vel_local[:rate_rows],
                   ego.gyro[:rate_rows], ego.count, cur, end, tf, *got)
    ops = 10 * (n_imu + n_ego) + 20 * w + 2000
    return dict(name="scan_ring_query", source=RING_QUERY[0], replaces=RING_QUERY[1],
                max_abs_err=err,
                ms=time_ms(lambda: kernels.scan_ring_query(*a)),
                plain_ms=time_ms(lambda: deskew.scan_ring_query_plain(*a)),
                device_fn=(lambda: kernels.scan_ring_query(*a), "scan_ring_query_kernel"),
                bound=bound(ops, moved))


def measurement_row(calls, mods):
    """Kernel L, the reference entry of kernel S, against
    ``pcm_measurement_plain`` on the P2P path's frame (the inputs of its
    recorded kernel S call): the pose and position within 1e-4 m (~100 m
    values), the quaternion 1e-6, the covariances rel 1e-5 of their largest
    entry, ``apply`` equal."""
    kernels, runtime = mods[0], mods[6]
    a = calls["pcm_stage"][0][3:]
    pose, tf, local_cov, fitness, success, usable, ego, end, use_pcm = a
    res = SimpleNamespace(pose=pose, local_cov=local_cov, fitness=fitness, success=success)

    def plain():
        return runtime.pcm_measurement_plain(res, tf, ego, end, usable, use_pcm)

    got = kernels.pcm_measurement(*a)
    rpose, meas, apply = plain()
    ref = (rpose, meas.timestamp, meas.pos, meas.rot, meas.pos_cov, meas.rot_cov, apply)
    errs = [float((g - r).abs().max()) for g, r in zip(got[:6], ref[:6])]
    rel = [e / max(float(r.abs().max()), 1e-30) for e, r in zip(errs[4:], ref[4:6])]
    gates = [errs[0] <= 1e-4, errs[1] == 0.0, errs[2] <= 1e-4, errs[3] <= 1e-6,
             max(rel) <= 1e-5, bool(got[6]) == bool(apply)]
    log_line("  pcm_measurement: errors pose, t, pos, quat " + ", ".join(
        f"{e:.2e}" for e in errs[:4]) + f", covariances rel {max(rel):.2e}, apply "
        f"{bool(apply)}")
    if not all(gates):
        raise AssertionError("pcm_measurement kernel vs plain: outside its gates")
    n_ego, rows = ring_rows(ego, end)
    moved = nbytes(pose, tf, local_cov, fitness, success, usable, ego.t[:n_ego],
                   ego.pos[:rows], ego.rpy[:rows], ego.count, end, *got)
    return dict(name="pcm_measurement", source=PCM_MEAS[0], replaces=PCM_MEAS[1],
                max_abs_err=max(errs), ms=time_ms(lambda: kernels.pcm_measurement(*a)),
                plain_ms=time_ms(plain),
                device_fn=(lambda: kernels.pcm_measurement(*a), "pcm_measurement_kernel"),
                bound=bound(2 * n_ego + 700, moved))


def gn_step_row(path, calls, mods):
    """Kernel M against ``gn_update_plain`` on an iteration of the path's
    GN loop (the sums its kernel A, E, F or G reduced): pose within 1e-4
    (entries up to ~100 m), local_cov within rel 1e-3 (reg^-1 from an LU in
    another order than cuSOLVER's), fitness and overlap equal, the stop
    flags equal unless the termination norm sits at its threshold to
    within rounding (reported). Its library reference: torch.linalg.solve_ex
    on the same damped 6x6, part of M's function only."""
    kernels, icp = mods[0], mods[4]
    a, _ = calls["gn_step"]
    sums, pose, fitness, local_cov, total, params, gicp = a
    assemble = icp.assemble_p2p if sums.shape[0] == kernels.P2P_SUMS else icp.assemble_gn
    eq = assemble(sums)

    def plain():
        return icp.gn_update_plain(*eq, pose, fitness, local_cov, total, params, gicp)

    got = kernels.gn_step(*a)
    ref = plain()
    err = float((got[0] - ref[0]).abs().max())
    cov_err = float((got[1] - ref[1]).abs().max())
    cov_rel = cov_err / max(float(ref[1].abs().max()), 1e-30)
    same = [torch.equal(g, r) for g, r in zip(got[2:], ref[2:])]
    if not same[2]:
        # a flipped stop flag: where does the termination norm sit?
        step = torch.linalg.inv(pose.double()) @ ref[0].double()
        w = icp.lie.so3_log(step[:3, :3])
        tn = float(icp.lie.norm(w) + icp.lie.norm(step[:3, 3]))
        thr = float(params.termination_threshold)
        log_line(f"  gn_step[{path}]: the stop flag flipped; termination norm {tn:.9g} vs "
                 f"threshold {thr:.9g}")
        same[2] = abs(tn - thr) <= 1e-5 * max(thr, 1e-3)
    if not (err <= 1e-4 and cov_rel <= 1e-3 and all(same)):
        raise AssertionError(f"gn_step[{path}] kernel vs plain: pose err {err}, local_cov "
                             f"rel {cov_rel}, equal (fitness, overlap, stop, failed) {same}")
    reg = eq[1] + params.lm_lambda * torch.diag(torch.diagonal(eq[1]))
    solve_ms = time_ms(lambda: torch.linalg.solve_ex(reg, eq[2]))
    log_line(f"  gn_step[{path}]: {sums.shape[0]} sums, matched {int(eq[0])}, pose err "
             f"{err:.2e}, local_cov rel {cov_rel:.2e}, stop {bool(got[4])}; "
             f"torch.linalg.solve_ex on the 6x6 alone {solve_ms:.4f} ms")
    ops = 6 * 6 * 6 + (6 * 6 * 6 * 2 if gicp else 0) + 400
    return dict(name=f"gn_step[{path}]", source="elimaloc_tpu_torch/csrc/gn_step.cu",
                replaces=SCAN_KERNELS["gn_step"][1], max_abs_err=max(err, cov_err),
                ms=time_ms(lambda: kernels.gn_step(*a)), plain_ms=time_ms(plain),
                device_fn=(lambda: kernels.gn_step(*a), "gn_step_kernel"),
                solve_ex_ms=solve_ms, launches_key="gn_step",
                bound=bound(ops, nbytes(sums, pose, fitness, local_cov, total, *got)))


def loop_parts(name, pipe, mods, a, k):
    """One recorded call of loop kernel ``name``: the per-iteration search
    call at a pose (``search(pose)`` -> (args, kwargs) of kernel A, E, F, G
    or Q),
    M's gicp flag, the carry, the trip limit and its place in the call's
    arguments, the plain loop (``plain(max_iteration)``) and the plain
    search + reduction at a pose (``eq(pose)`` -> (matched, JTJ, JTr,
    fit_num))."""
    icp, cfg_mod = mods[4], mods[5]
    tmap, budget = pipe.map, pipe.static.icp_static.tile_budget
    if name == LOOP:
        halo, slot_tile, sbuf, qmask, pose, fitness, local_cov, total, params, max_it = a
        carry = (pose, fitness, local_cov, total, params)

        def search(p):
            return (halo, slot_tile, sbuf, qmask, p, params.max_search_dist), k

        def eq(p):
            return icp.p2p_search_reduce_plain(tmap, slot_tile, sbuf, qmask, p, params,
                                               budget)[:4]

        def plain(m=max_it):
            return icp.p2p_register_plain(tmap, *a[1:9], budget, m)
        radar, gicp, it_at = None, False, 9
    elif name in TILE_LOOPS.values():
        halo, (slot_tile, sbuf, qmask), (*carry, max_it) = a[:3], a[3:6], a[6:]
        pose, fitness, local_cov, total, params = carry
        radar = k.get("radar")
        method = next(m for m, n in TILE_LOOPS.items() if n == name)
        search_plain = getattr(icp, KERNEL[method][3])
        extra = () if radar is None else (radar,)

        def search(p):
            # the search kernel takes the loop's keywords: its geometry, radar
            return (*halo, slot_tile, sbuf, qmask, p, params.max_search_dist), dict(k)

        def eq(p):
            return search_plain(tmap, slot_tile, sbuf, qmask, p, params, budget, *extra)[:4]

        def plain(m=max_it):
            return getattr(icp, f"{name}_plain")(tmap, slot_tile, sbuf, qmask, *carry, budget,
                                                 m, radar)
        gicp, it_at = name == GICP_LOOP, 11
    else:
        grid, src, valid, *carry, max_it, method, radar = a
        pose, fitness, local_cov, total, params = carry
        code = int(cfg_mod.IcpMethod[method])

        def search(p):
            return (grid, src, valid, p, params.max_search_dist, method, radar), {}

        def eq(p):
            return icp.hash_search_reduce_plain(grid, src, valid, p, params, code, radar)

        def plain(m=max_it):
            return icp.hash_register_plain(code, grid, src, valid, *carry, m, radar)
        gicp, it_at = method == "GICP", 8
    return SimpleNamespace(search=search, eq=eq, plain=plain, gicp=gicp, carry=tuple(carry),
                           max_it=max_it, it_at=it_at, radar=radar, wrapper=LOOP_SEARCH[name])


def loop_chain(kernels, parts):
    """The three-launch chain a loop kernel replaces, on one recorded call of
    it: per iteration kernel A, G or Q's search + reduce_partials_kernel,
    then kernel M, and the stop flag read back. Returns the loop's outputs
    (the iteration count an int), each iteration's reduced sums and each
    iteration's search call."""
    pose, fitness, local_cov, total, params = parts.carry
    overlap = torch.zeros_like(fitness)
    failed = torch.zeros((), dtype=torch.bool, device=pose.device)
    sums, calls, it = [], [], 0
    while it < parts.max_it:
        calls.append(parts.search(pose))
        sums.append(sums_of(kernels, parts.wrapper, *calls[-1]))
        pose, local_cov, fitness, overlap, stop, failed = kernels.gn_step(
            sums[-1], pose, fitness, local_cov, total, params, parts.gicp)
        it += 1
        if bool(stop):
            break
    return (pose, local_cov, fitness, overlap, failed, it), sums, calls


def flip_norm(icp, parts, at):
    """The plain loop's termination norm at iteration ``at`` (1-based) on a
    recorded call, and the threshold: where the kernel and the plain loop
    stop after different counts, the norm must sit at the threshold."""
    pose, fitness, local_cov, total, params = parts.carry
    prev = pose
    for _ in range(at):
        prev = pose
        pose, local_cov, fitness, _, _, _ = icp.gn_update_plain(
            *parts.eq(pose), pose, fitness, local_cov, total, params, parts.gicp)
    step = torch.linalg.inv(prev.double()) @ pose.double()
    tn = float(icp.lie.norm(icp.lie.so3_log(step[:3, :3])) + icp.lie.norm(step[:3, 3]))
    return tn, float(params.termination_threshold)


def loop_bytes_ops(name, pipe, mods, parts, calls, sums):
    """(bytes, operations) one recorded registration needs: every
    iteration's search (candidate tests, ~6 operations each; the matched
    rows' GN arithmetic, SEARCH_COST) and kernel M's step (~600); each input
    byte read once (the halo rows of the tiles in use or the grid's voxels
    the searches touch, at their largest over the iterations; the live
    queries, the masks, the carry in and out)."""
    kernels, grid_mod, icp = mods[0], mods[2], mods[4]
    pose = parts.carry[0]
    if name == HASH_LOOP:
        grid, src, valid, _, _, method, radar = calls[0][0]
        per = [hash_search_bytes_ops(method, grid_mod, grid, icp.transform_slots(c[0][3], src),
                                     int(x[-1])) for c, x in zip(calls, sums)]
        ops = sum(o + int(x[-1]) * (SEARCH_COST[method][2] + 9 * (radar is not None))
                  for (_, o), x in zip(per, sums)) + 600 * len(sums)
        moved = max(b for b, _ in per) + nbytes(src, valid, radar)
    else:
        a = calls[0][0]
        halo, (slot_tile, sbuf, qmask) = a[0], a[-5:-2]
        method = next(m for m, n in {"P2P": LOOP, **TILE_LOOPS}.items() if n == name)
        radar = parts.radar
        live = int(qmask.sum())
        n_tiles = int(torch.unique(slot_tile[qmask.any(1)]).numel())
        row = halo.shape[1]
        cand_b, match_b, match_ops = SEARCH_COST[method]
        matched = [int(x[-1]) for x in sums]
        ops = sum(live * row * 6 + m * (match_ops + 9 * (radar is not None)) + 600
                  for m in matched)
        moved = (n_tiles * row * cand_b + live * 12 + max(matched, default=0) * match_b
                 + nbytes(qmask, slot_tile, radar))
    moved += nbytes(pose, *parts.carry[1:4]) + 54 * 4 + 2 + 4
    return moved, ops


def loop_capacity(kernels, name, parts):
    """The loop kernel's co-resident CTAs for this call, and its slots (tile)
    or 128-point blocks (hash)."""
    a = parts.search(parts.carry[0])[0]
    if name == LOOP:
        return kernels.p2p_register_capacity(), a[3].shape[0]
    if name in TILE_LOOPS.values():
        qmask = a[5]
        return (getattr(kernels, f"{name}_capacity")(qmask.shape[1], parts.radar is not None),
                qmask.shape[0])
    method = a[5]
    return (kernels.hash_register_capacity(method, parts.radar is not None),
            (a[1].shape[0] + 127) // 128)


def loop_row(name, label, pipe, rec, mods, row=True):
    """Loop kernel ``name`` on every recorded registration of the replay:
    bit-equal to the three-launch chain (pose, local_cov, fitness, overlap,
    failed, iterations; NaN where the chain has NaN in the radar forms),
    and against its plain version (the plain versions' host loop): over
    the loop's first iteration alone (the call
    with max_iteration 1) the pose within 1e-4 (kernel M's row) and fitness
    and overlap within rel 1e-4 (the search kernels' rows: the float32 sums
    in another order), failed equal; over the whole loop iterations and
    failed equal, the pose within 1e-4 and fitness and overlap within rel
    1e-4 (P2P, which converges in 1-3 iterations), or within 1e-4 and rel
    1e-4 a GN iteration run (the other loops: each iteration's
    float32 sums carry their rounding into the next pose, which moves a few
    matches across the distance gate, and AVGICP runs 8-10
    iterations a frame on this map without converging); where the two stop after
    different counts, the plain loop's termination norm there must lie
    within 0.1% of the threshold (the sums' rtol moves the step that much)
    and the poses within the threshold. In the radar forms
    the float32 sums carry the near-singular rows' conditioning (the search
    kernels' radar rows are held to a float64 tail instead): the loop is
    held to its chain there, and its distance from the plain loop is
    recorded, not gated. The chain's search calls of every registration go
    to ``rec.every`` under the search kernel's name, and frame ``rec.at``'s
    first iteration (its search call and M's call) to ``rec.calls``: the
    search kernel's and M's own rows take them. Returns (row or None,
    summary)."""
    kernels, icp = mods[0], mods[4]
    calls = rec.every[name]
    worst, worst1, iters, flips, searched = 0.0, 0.0, [], [], []
    first = None
    for i, (a, k) in enumerate(calls):
        parts = loop_parts(name, pipe, mods, a, k)
        got = getattr(kernels, name)(*a, **k)
        ref, sums, search = loop_chain(kernels, parts)
        searched += search
        if i == rec.at:
            first = (parts, sums, search)
        # a diverging radar registration may carry NaNs through both sides
        eq = torch.equal if parts.radar is None else same_bits
        same = [eq(x, y) for x, y in zip(got[:5], ref[:5])] + [int(got[5]) == ref[5]]
        if not all(same):
            raise AssertionError(f"{label}: frame {i} differs from the three-launch chain; "
                                 "equal (pose, local_cov, fitness, overlap, failed, "
                                 f"iterations): {same}")
        plain = parts.plain()
        err = float((got[0] - plain[0]).abs().max())
        rel = [abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)
               for x, y in ((got[2], plain[2]), (got[3], plain[3]))]
        n_k, n_p = int(got[5]), int(plain[5])
        iters.append(n_k)
        if parts.radar is not None:
            worst = max(worst, err) if np.isfinite(err) else worst
            continue
        one = list(a)
        one[parts.it_at] = 1
        one, one_ref = getattr(kernels, name)(*one, **k), parts.plain(1)
        err1 = float((one[0] - one_ref[0]).abs().max())
        rel1 = [abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)
                for x, y in ((one[2], one_ref[2]), (one[3], one_ref[3]))]
        worst1 = max(worst1, err1)
        if not (err1 <= 1e-4 and max(rel1) <= 1e-4 and bool(one[4]) == bool(one_ref[4])):
            raise AssertionError(f"{label}: frame {i}'s first iteration vs its plain version: "
                                 f"pose err {err1}, fitness / overlap rel {rel1}")
        tol = rtol = 1e-4 if name == LOOP else 1e-4 * max(n_k, 1)
        if n_k != n_p:
            tn, thr = flip_norm(icp, parts, min(n_k, n_p))
            flips.append((i, n_k, n_p, tn, thr))
            log_line(f"  {label}: frame {i} stops after {n_k} iterations, the plain loop after "
                     f"{n_p}; the plain termination norm there {tn:.9g} vs threshold {thr:.9g}")
            if not abs(tn - thr) <= 1e-3 * thr:
                raise AssertionError(f"{label}: frame {i} iteration counts differ away from "
                                     "the termination threshold")
            tol, rel = thr + 1e-4, [0.0, 0.0]
        if not (bool(got[4]) == bool(plain[4]) and err <= tol and max(rel) <= rtol):
            raise AssertionError(f"{label}: frame {i} vs its plain version: pose err {err}, "
                                 f"fitness / overlap rel {rel}, failed {bool(got[4])} / "
                                 f"{bool(plain[4])}")
        worst = max(worst, err)
    parts, sums, search = first
    wrapper = parts.wrapper
    rec.every[wrapper] = searched
    rec.calls[wrapper] = search[0]
    pose, fitness, local_cov, total, params = parts.carry
    rec.calls["gn_step"] = ((sums[0], pose, fitness, local_cov, total, params, parts.gicp), {})
    cap, slots = loop_capacity(kernels, name, parts)
    grid = min(max(slots, 1), cap)
    log_line(f"  {label}: {len(calls)} registrations bit-equal to the three-launch chain, "
             f"iterations {iters}, pose vs plain max {worst:.2e}"
             + (" (radar form: recorded, not gated)" if parts.radar is not None else
                f" (first iteration alone {worst1:.2e})")
             + f", count flips {len(flips)}; frame {rec.at}: "
             f"{'blocks' if name == HASH_LOOP else 'slots'} {slots}, grid {grid} of {cap} "
             f"co-resident CTAs, {len(sums)} iterations, matched {[int(x[-1]) for x in sums]}")
    summary = {"registrations_checked": len(calls), "iterations": iters,
               "count_flips_vs_plain": len(flips), "grid_ctas": grid,
               "co_resident_ctas": cap, "pose_vs_plain_max": worst,
               "first_iteration_pose_vs_plain_max": worst1}
    if not row:
        return None, summary
    a, k = rec.calls[name]
    moved, ops = loop_bytes_ops(name, pipe, mods, parts, search, sums)
    return dict(name=label, source=LOOP_SOURCE[name], replaces=LOOP_REPLACES[name],
                max_abs_err=worst, ms=time_ms(lambda: getattr(kernels, name)(*a, **k)),
                plain_ms=time_ms(parts.plain),
                device_fn=(lambda: getattr(kernels, name)(*a, **k), LOOP_DEVICE[name]),
                bound=bound(ops, moved), launches_key=name), summary


def loop_trace_check(pipe, log, runtime, n, path="P2P", loop=LOOP):
    """One more run_fused replay of a tile path whose registrations a loop
    kernel runs (``path``: P2P, GICP or AVGICP, ``loop``: its loop kernel) under
    torch.profiler, each frame in a record_function range and under
    torch.cuda.set_sync_debug_mode("error") (a synchronizing call inside a
    frame raises): on the device no search kernel of the chain (kernel A's
    p2p_search_kernel, E's gicp_search_kernel, G's avgicp_search_kernel),
    reduce_partials_kernel or gn_step_kernel and one loop kernel a frame;
    between the first frame's start and the last frame's end no runtime
    call that synchronizes; no device-to-host copy issued by an operation
    inside a frame (the copy's linked operation, where the trace
    links them; else no such copy before the last loop kernel ends). Memory
    copies on the device inside a frame (clones, device to device) are
    counted by kind, not refused. The device kernels of each frame (from
    one kernel H, which opens a frame, to the next, in device order) are
    counted (all but the last, which the outputs' stacking follows); each
    such frame's last kernel must be kernel S, one a frame after its loop
    kernel, and no kernel L, kernel I or eager epilogue kernel runs after
    it; each runs kernel T's two kernels once and kernels K and D never,
    and the kernels between kernel H and T's first are listed: no eager
    range-gate or scan-times kernel may be among them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    orig = runtime.fused_frame

    def frame(*a, **k):
        with record_function("chip_smoke.frame"):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    runtime.fused_frame = frame
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            pipe.run_fused(log)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
    finally:
        runtime.fused_frame = orig
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    spans = [e for e in evs if e.device_type == cpu and e.name == "chip_smoke.frame"]
    t0, t1 = min(e.time_range.start for e in spans), max(e.time_range.end for e in spans)

    def in_frames(e):
        return e is not None and t0 <= e.time_range.start <= t1

    inside = [e.name for e in evs if e.device_type == cpu and in_frames(e)]
    runtime_launches = sum(name.startswith("cudaLaunch") for name in inside)
    blocking = sorted({name for name in inside if "Synchronize" in name})
    kern = [e for e in evs if e.device_type == dev]
    old = sorted({e.name for e in kern if any(
        s in e.name for s in (CHAIN_DEVICE[loop], "reduce_partials_kernel", "gn_step_kernel"))})
    loops = [e for e in kern if LOOP_DEVICE[loop] in e.name]
    # each device copy's issuing operation (its linked correlation id)
    ops = {e.id: e for e in evs
           if e.device_type == cpu and getattr(e, "linked_correlation_id", 0) == 0}
    copies = [e for e in kern if e.name.startswith("Memcpy")]
    linked = all(getattr(e, "linked_correlation_id", 0) > 0 for e in copies)
    kinds = {}
    if linked:
        for e in copies:
            if in_frames(ops.get(e.linked_correlation_id)):
                kind = e.name.split(" ")[1]
                kinds[kind] = kinds.get(kind, 0) + 1
        dtoh = kinds.get("DtoH", 0)
    else:
        end = max((e.time_range.end for e in loops), default=0)
        dtoh = sum("DtoH" in e.name and e.time_range.start < end for e in copies)
    # the frames on the device: kernel H opens each; the kernels after the
    # loop kernel up to the frame's end (run_register's pose and success,
    # then the scan's end)
    order = sorted((e for e in kern if not e.name.startswith(("Memcpy", "Memset"))
                    and e.name != "chip_smoke.frame"), key=lambda e: e.time_range.start)
    starts = [i for i, e in enumerate(order) if "imu_stage_kernel" in e.name] + [len(order)]
    frames = [order[a:b] for a, b in zip(starts, starts[1:])]
    per_frame = [len(f) for f in frames[:-1]]
    tails = []
    for f in frames[:-1]:
        at = max((i for i, e in enumerate(f) if LOOP_DEVICE[loop] in e.name), default=-1)
        tails.append([e.name for e in f[at + 1:]])
    bad_tail = [t for t in tails if not t or "pcm_stage_kernel" not in t[-1]
                or sum("pcm_stage_kernel" in k for k in t) != 1
                or any("pcm_measurement_kernel" in k or "ekf_update_kernel" in k for k in t)]
    # the scan's front: kernel T's two kernels once a frame, K and D never,
    # and between kernel H and T's first kernel no eager gate or scan-times
    # kernel (the norm, the argmaxes, the flip, the index_selects)
    fronts, between = [], []
    for f in frames[:-1]:
        names = [e.name for e in f]
        fronts.append((sum("scan_gate_query_kernel" in k for k in names),
                       sum("scan_deskew_points_kernel" in k for k in names),
                       sum("scan_ring_query_kernel" in k or "deskew_kernel" in k for k in names)))
        at = next((i for i, k in enumerate(names) if "scan_gate_query_kernel" in k), 0)
        between.append(names[1:at])
    # every eager kernel the gate and the scan times ran before kernel T
    # (the norm's mul, sum and sqrt, the compare, the casts, the argmaxes,
    # the flip, the index_selects) is one of PyTorch's at::native kernels
    eager = sorted({k for b in between for k in b if "at::native" in k})
    log_line(f"[{path}] traced replay: between kernel H and kernel T's first kernel "
             f"{[len(b) for b in between]} kernels a frame "
             f"({sorted({k[:60] for b in between for k in b})}); kernel T's two kernels and "
             f"K / D a frame {sorted(set(fronts))}")
    if any(f != (1, 1, 0) for f in fronts) or eager:
        raise AssertionError(f"[{path}] the traced replay's scan front is not kernel T's two "
                             f"kernels once a frame with no eager kernel before them: "
                             f"{sorted(set(fronts))}, eager {eager[:4]}")
    log_line(f"[{path}] traced replay: device kernels a frame {per_frame} (median "
             f"{float(np.median(per_frame)) if per_frame else 0:.0f}); after the loop kernel "
             f"{len(tails[0]) if tails else 0} kernels, the frame's last "
             + (repr(tails[0][-1][:60]) if tails and tails[0] else "none"))
    log_line(f"[{path}] traced replay: {len(spans)} frames, {len(loops)} loop kernels, "
             f"{runtime_launches} runtime launch calls inside the frames, synchronizing "
             f"runtime calls inside {blocking}, old GN kernels {old}, device copies issued "
             "inside the frames by kind " + (str(kinds) if linked else "(not linked in this "
                                            "trace; DtoH before the last loop kernel ends: "
                                            f"{dtoh})")
             + "; no synchronizing call inside a frame (sync debug mode: error)")
    if not (len(spans) == n and len(loops) == n and not old and not blocking and not dtoh
            and runtime_launches > 0):
        raise AssertionError(f"[{path}] the traced replay breaks the one-launch GN loop contract")
    if len(frames) != n or bad_tail:
        raise AssertionError(f"[{path}] the traced replay's frames do not end in one kernel S: "
                             f"{len(frames)} frames, tails {bad_tail[:2]}")
    return {"traced_loop_kernels": len(loops), "traced_runtime_launches": runtime_launches,
            "traced_copies_in_frames": kinds if linked else None,
            "traced_device_kernels_per_frame": per_frame,
            "traced_kernels_after_loop": [len(t) for t in tails],
            "traced_kernels_between_h_and_t": [len(b) for b in between]}


def hash_sync_check(pipe, log, runtime, n, path):
    """One more run_fused replay of a hash path, each frame under
    torch.cuda.set_sync_debug_mode("warn") and its registration (from the
    "assign" mark to the "gn" mark: the hash loop's one launch) under
    "error": a synchronizing call inside the registration raises; every
    other synchronizing call inside a frame is recorded by its Python
    location and message, and printed."""
    import warnings

    orig = runtime.fused_frame

    def mark(name):
        if name == "assign":
            torch.cuda.set_sync_debug_mode("error")
        elif name == "gn":
            torch.cuda.set_sync_debug_mode("warn")

    def frame(*a, **k):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return orig(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    runtime.fused_frame = frame
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            pipe.run_fused(log, mark=mark)
            torch.cuda.synchronize()
    finally:
        runtime.fused_frame = orig
        torch.cuda.set_sync_debug_mode("default")
    syncs = {}
    for w in seen:
        if "synchroniz" in str(w.message):
            where = f"{Path(w.filename).name}:{w.lineno}: {str(w.message)[:80]}"
            syncs[where] = syncs.get(where, 0) + 1
    log_line(f"[{path}] sync-checked replay: no synchronizing call inside a registration "
             f"(assign .. gn, sync debug mode error) in {n} frames; elsewhere in the frames "
             + (", ".join(f"{k} x{v}" for k, v in sorted(syncs.items())) if syncs else "none"))
    return {"sync_free_registrations": n, "syncs_elsewhere_in_frame": syncs}


class StageTimer:
    """``mark`` callback of the pipeline: one CUDA event per stage boundary."""

    ORDER = ("imu", "can_gps", "front", "downsample", "assign", "gn", "pcm_stage", "outputs")

    def __init__(self):
        self.events = []

    def __call__(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def split(self):
        """(mean ms per stage, frame count, per-frame ms), frames 1.. only:
        frame 0 also waits for the batch upload. Each interval counts for
        the mark that ends it; a frame starts at its "imu" mark and ends at
        "outputs" (the event loop marks "imu" as a scan starts: its "imu"
        stage is then every event between two scans)."""
        torch.cuda.synchronize()
        tot = dict.fromkeys(self.ORDER, 0.0)
        frames = 0
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            if name == "imu":
                frames += 1
            if frames >= 1:
                tot[name] += a.elapsed_time(b)
        ends = [e for name, e in self.events if name == "outputs"]
        per_frame = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        return {k: v / max(frames, 1) for k, v in tot.items()}, frames, per_frame


class AdmissionProbe:
    """The CAN and GPS legs of the run's ``update_chain`` calls that the
    filter admitted, read from the run's own states (the PCM update runs in
    kernel S, not through ``update_chain``). A CAN leg admitted a sample
    when it moved ``prev_can_timestamp`` (a sample within 0.01 s of it is
    refused). A GPS leg admitted a fix when it moved
    ``prev_gnss_timestamp``, or, in a call with no CAN leg, moved P: in the
    event loop a fix can share its time with the PCM update just before it.
    A leg is a frame's sub-batch in the frame loops, one sample in the event
    loop. The states are compared once, after the run."""

    def __init__(self, runtime):
        self.runtime, self.orig = runtime, runtime.update_chain
        self.calls = []

    def __enter__(self):
        def probe(state, params, flags, **kw):
            out = self.orig(state, params, flags, **kw)
            if kw.get("can") is not None or kw.get("gps") is not None:
                self.calls.append((kw.get("can") is not None, kw.get("gps") is not None,
                                   state, out))
            return out

        self.runtime.update_chain = probe
        return self

    def __exit__(self, *exc):
        self.runtime.update_chain = self.orig

    def admitted(self):
        """{"can" / "gps": (legs run, legs that admitted)}."""
        out = {"can": [0, 0], "gps": [0, 0]}
        for can, gps, a, b in self.calls:
            moved = {f: bool((getattr(a, f) != getattr(b, f)).any())
                     for f in ("prev_can_timestamp", "prev_gnss_timestamp", "P")}
            if can:
                out["can"][0] += 1
                out["can"][1] += moved["prev_can_timestamp"]
            if gps:
                out["gps"][0] += 1
                out["gps"][1] += moved["prev_gnss_timestamp"] or (not can and moved["P"])
        return {k: tuple(v) for k, v in out.items()}


def sums_of(kernels, wrapper, a, k):
    """The reduced sums of one recorded search + GN call (kernel Q returns
    them alone, A, E, F, G first of a tuple)."""
    out = getattr(kernels, wrapper)(*a, **k)
    return out if wrapper == "hash_correspond" else out[0]


def run_path(path, log, packed, built, ds_points, max_slots, mods, ate_rmse, deferred):
    """One path: warm-up replay (recording the kernels' inputs), the
    kernel-vs-plain rows, then the timed replay with its launch counts. Its
    torch.profiler pass goes into ``deferred``: it runs after every path's
    timed replay, so that no timed replay follows a profiler session. A
    hash path registers on the hash grid of ``built`` (the hash loop kernel
    once a registration, no tile kernel)."""
    kernels, cfg_mod, runtime, tiles = mods[0], mods[5], mods[6], mods[3]
    method = path_method(path)
    hashed = is_hash(path)
    t0 = time.time()
    if hashed:
        pipe = runtime.LocalizationPipeline(
            method_cfg(cfg_mod, path), built, backend="hash", device="cuda",
            ds_points=ds_points, ego_ring_size=512, imu_ring_size=256)
    else:
        pipe = runtime.LocalizationPipeline(
            method_cfg(cfg_mod, path), packed[2 if method == "AVGICP" else 1],
            device="cuda", ds_points=ds_points,
            tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots),
            ego_ring_size=512, imu_ring_size=256)
    log_line(f"[{path}] {len(log.scan_t)} scans x {log.scan_points.shape[1]} points, "
             f"ds_points {ds_points}, max_slots {max_slots}, map upload "
             f"{time.time() - t0:.1f} s")
    wrapper = "hash_correspond" if hashed else KERNEL[method][0]
    radar = is_radar(path)
    fusion = path == FUSION
    path_kernels = ((SHARED[:2] if hashed else SHARED) + (wrapper,) + tuple(EKF_KERNELS)
                    + tuple(SCAN_KERNELS) + (("radar_rows",) if radar else ())
                    + (("can_gps_update",) if fusion else ()))
    # every path: the GN loop is one launch of a loop kernel a registration
    loop = path_loop(path)
    path_kernels = loop_kernels(path_kernels, loop)
    with Recorder(kernels, path_kernels, at=N_SCANS // 2,
                  every=("can_gps_update", "pcm_stage", loop)
                  + (("scan_front",) if path == "P2P" else ())
                  + (("radar_rows",) if radar else ())) as rec:
        pipe.run_fused(log)
    torch.cuda.synchronize()
    rows = []
    # the loop kernel against its chain on every registration; the search
    # kernel's and M's rows take frame rec.at's first iteration (the radar
    # rows pick one below among every registration's iterations)
    label = (f"{loop}[{method}{' radar' if radar else ''}]" if hashed
             else f"{loop}[fusion]" if fusion else f"{loop}{'[radar]' if radar else ''}")
    row, loop_summary = loop_row(loop, label, pipe, rec, mods, row=not fusion)
    rows += [row] if row else []
    if radar:
        # the kernel-vs-plain row takes the first iteration from the recorded
        # frame on whose pose is finite and that matched something: a
        # diverging registration can carry a NaN pose into its next
        # iteration, or leave the map (no match, all sums zero), the same on
        # both sides
        calls = rec.every[wrapper]
        finite = [bool(torch.isfinite(a[3 if hashed else 6]).all()) for a, _ in calls]
        matched = [int(sums_of(kernels, wrapper, a, k)[43]) if f else 0
                   for (a, k), f in zip(calls, finite)]
        usable = [f and m > 0 for f, m in zip(finite, matched)]
        pick = next((i for i in range(rec.at, len(calls)) if usable[i]),
                    next(i for i in range(len(calls)) if usable[i]))
        rec.calls[wrapper] = calls[pick]
        log_line(f"[{path}] GN iterations: {len(calls)}, with a non-finite pose "
                 f"{finite.count(False)}, with no match {matched.count(0)}; the row takes "
                 f"iteration {pick} ({matched[pick]} matched)")
    if path == "P2P":
        # kernels K and D, T's reference entries, take their calls in the
        # chain on T's call of frame rec.at
        _, k_args, d_args = front_chain(mods, rec.calls["scan_front"][0])
        rec.calls["scan_ring_query"], rec.calls["deskew"] = (k_args, {}), (d_args, {})
        rows += shared_kernel_rows(pipe, rec.calls, mods[:5])
        rows += [imu_stage_row(rec.calls, pipe, mods), pcm_stage_row(rec, mods),
                 front_row(rec, mods), query_row(rec.calls, mods),
                 measurement_row(rec.calls, mods)]
    if radar:
        x_against_p(kernels, rec.every["radar_rows"], path)
    if fusion:
        rows += [update_row(rec, mods, "can_gps_update"), update_row(rec, mods, "ekf_update")]
    elif hashed:
        rows += [hash_kernel_row(path, pipe, rec.calls, mods)]
        if not radar:
            rows += [gn_step_row(path, rec.calls, mods)]
    elif radar:
        rows += [method_kernel_row(method, pipe, rec.calls, mods[:5])]
        if method == "GICP":
            rows += [radar_row(rec.calls, mods, "radar_rows"),
                     radar_row(rec.calls, mods, "radar_cov")]
    else:
        rows += [method_kernel_row(method, pipe, rec.calls, mods[:5]),
                 gn_step_row(path, rec.calls, mods)]
    for r in rows:
        log_line(f"[{path}] kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g}, "
                 f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")

    # the timed main-path run: counts from zero, then read back
    stages = StageTimer()
    probe = AdmissionProbe(runtime)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with probe:
        _, outs = pipe.run_fused(log, mark=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, packs = dict(kernels.launches), dict(kernels.packs)
    split, frames, per_frame = stages.split()
    p50, p95 = (float(np.percentile(per_frame, q)) for q in (50, 95))
    n = len(log.scan_t)
    log_line(f"[{path}] {n / wall:.2f} scans/s ({wall:.3f} s for {n} scans, "
             f"host batch prep + upload included), launches {launches}, packs {packs}")
    check_imu_stage(path, launches, packs, n)
    check_scan_end(path, launches, n, n if fusion else 0)
    check_loop(path, launches, n, loop)
    check_radar(path, launches, n if radar else 0)
    log_line(f"[{path}] stage ms/frame (frames 1..{frames}): "
             + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
             + f", total {sum(split.values()):.3f}; frame ms p50 {p50:.3f} "
             f"p95 {p95:.3f}")

    ate = ate_rmse(outs["ego_t_abs"], outs["ego_pos"], log.truth_t, log.truth_pos)
    applied = float(outs["applied"].mean())
    dropped = int(outs["slots_dropped"].max())
    ds_max = int(outs["ds_kept"].max())
    iters = float(outs["iterations"].mean())
    log_line(f"[{path}] applied {applied:.3f}, ATE {ate:.4f} m, slots_dropped "
             f"{dropped}, ds_kept max {ds_max} of {ds_points}, iterations mean "
             f"{iters:.2f}")
    summary = {"scans_per_s": n / wall, "stage_ms": split, "frame_ms_p50": p50,
               "frame_ms_p95": p95, "ate_m": ate, "applied": applied,
               "iterations_mean": iters, **loop_summary,
               "launches": {k: v for k, v in launches.items() if v}}
    if path == "P2P":
        log_line(f"[{path}] GN stage {split['gn']:.3f} ms a frame (three-launch loop: "
                 f"{CHAIN_P2P['gn_ms']}), {n / wall:.2f} scans/s (three-launch loop: "
                 f"{CHAIN_P2P['scans_per_s']}), frame p50 {p50:.3f} ms (three-launch "
                 f"loop: {CHAIN_P2P['frame_ms_p50']}); card {card()}")
        log_line(f"[{path}] scan front (kernel T: the range gate, the scan times, the ring "
                 f"queries and the deskew; stage front) {split['front']:.3f} ms a frame (the "
                 f"gate and scan times in torch, kernel K and kernel D: {CHAIN_FRONT['ms']}), "
                 f"frame p50 {p50:.3f} ms (with them: {CHAIN_FRONT['frame_ms_p50']})")
        log_line(f"[{path}] scan end (kernel S: the PCM measurement, update and the frame's "
                 "outputs; stages pcm_stage + outputs) "
                 f"{split['pcm_stage'] + split['outputs']:.3f} ms a frame (kernel L, kernel I "
                 f"and the eager epilogue: "
                 f"{CHAIN_SCAN_END['ms']}), frame p50 {p50:.3f} ms (with them: "
                 f"{CHAIN_SCAN_END['frame_ms_p50']})")
    if hashed:
        # the hash loop once a registration (checked above), and no tile kernel
        summary["gn_iterations"] = int(np.sum(outs["iterations"]))
        if any(launches[k] for k in TILE_ONLY):
            raise AssertionError(f"[{path}] a tile kernel ran on the hash path: "
                                 + str({k: launches[k] for k in TILE_ONLY}))

    def profiled_replay():
        """One more replay under torch.profiler: the device's busy share and
        the kernels that take most of its time."""
        per, prof_wall = device_profile(lambda: pipe.run_fused(log))
        busy = sum(per.values()) * 1e-3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        log_line(f"[{path}] torch.profiler replay: device busy {busy:.1f} ms of "
                 f"{prof_wall:.1f} ms wall ({100 * busy / prof_wall:.1f}%); top: "
                 + "; ".join(f"{k[:48]} {v * 1e-3 / n:.3f} ms/frame" for k, v in top))
        summary["device_busy_share_profiled"] = busy / prof_wall if per else None
        # kernels B and C sort on the card themselves: no library sort runs
        sorts = [k for k in per if "sort" in k.lower() or "Radix" in k]
        if not per or sorts:
            raise AssertionError(f"[{path}] the profiled replay saw no device kernel or a "
                                 f"library sort: {sorts}")
        summary["device_kernels_profiled"] = len(per)
        if path in ("P2P", "GICP", "AVGICP"):
            summary.update(loop_trace_check(pipe, log, runtime, n, path, loop))
        if path == "AVGICP hash":
            summary.update(hash_sync_check(pipe, log, runtime, n, path))

    deferred.append(profiled_replay)
    if fusion:
        adm = probe.admitted()
        summary["can_frames_admitted"], summary["gps_frames_admitted"] = (
            adm["can"][1], adm["gps"][1])
        log_line(f"[{path}] frames whose CAN sub-batch the filter admitted (from its "
                 f"states) {adm['can'][1]} of {adm['can'][0]}, whose GPS sub-batch "
                 f"{adm['gps'][1]} of {adm['gps'][0]} ({len(log.can_t)} CAN samples, "
                 f"{len(log.gps_t)} GPS fixes in the log)")
        if adm["can"][1] == 0 or adm["gps"][1] == 0:
            raise AssertionError(f"[{path}] no CAN or no GPS update was admitted")
    if not np.all(np.isfinite(outs["ego_pos"])) or outs["ego_pos"].shape != (n, 3):
        raise AssertionError(f"[{path}] non-finite or misshapen trajectory")
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"[{path}] kernel {name} was not launched on the path")
    if radar:
        # Radar: the ATE gate holds where the registration converges
        # (applied >= 0.9); otherwise the run is recorded with its reason.
        summary["converged"] = converged = applied >= 0.9
        if not converged:
            log_line(f"[{path}] not converged (applied {applied:.3f}): the reference's "
                     "radar covariance is taken in the world frame, R S without R^T, and "
                     "near the map origin R^T C R + R S is indefinite for points whose "
                     "world azimuth is far from zero; ATE recorded, not gated")
        if converged and not ate < ATE_GATE[method]:
            raise AssertionError(f"[{path}] converged but ATE {ate:.4f} m >= "
                                 f"{ATE_GATE[method]} m")
        if not (dropped == 0 and ds_max < ds_points):
            raise AssertionError(f"[{path}] slice failed its acceptance bounds")
    elif not (applied >= 0.9 and ate < ATE_GATE[method] and dropped == 0
              and ds_max < ds_points):
        raise AssertionError(f"[{path}] slice failed its acceptance bounds")
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches[r.pop("launches_key", r["name"])]
        if "solve_ex_ms" in r:
            summary["gn_step_solve_ex_ms"] = r.pop("solve_ex_ms")
    return rows, summary, pipe, outs, rec


def check_launches(what, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"[{what}] kernel {name} was not launched on the path")


def loop_kernels(names, loop=LOOP):
    """A path's kernels where ``loop`` runs its registrations: ``names`` with
    the per-iteration kernels (A, G or Q, and M) replaced by the loop
    kernel."""
    return tuple(n for n in names if n not in (LOOP_SEARCH[loop], "gn_step")) + (loop,)


def check_loop(what, launches, registrations, loop=LOOP):
    """A path whose registrations ``loop`` runs: one launch of the loop
    kernel a registration, none of its search kernel (A, G or Q) or M."""
    per_iteration = (LOOP_SEARCH[loop], "gn_step")
    if not (launches[loop] == registrations and not any(launches[k] for k in per_iteration)):
        raise AssertionError(f"[{what}] {loop} launched {launches[loop]} times for "
                             f"{registrations} registrations, "
                             + ", ".join(f"{k} {launches[k]}" for k in per_iteration))


def check_scan_end(what, launches, scans, updates):
    """Every scan starts in one call of kernel T, whose reference entries K
    and D never launch, and ends in one launch of kernel S; kernel L never
    launches, kernel W only for the CAN and GPS updates (``updates``
    launches: one a fusion frame, one an event in ``run``, none without GPS
    and CAN), and kernel I (W's and S's reference) never."""
    if not (launches["scan_front"] == scans and launches["scan_ring_query"] == 0
            and launches["deskew"] == 0):
        raise AssertionError(f"[{what}] scan_front launched {launches['scan_front']} times for "
                             f"{scans} scans, scan_ring_query {launches['scan_ring_query']}, "
                             f"deskew {launches['deskew']}")
    if not (launches["pcm_stage"] == scans and launches["pcm_measurement"] == 0
            and launches["can_gps_update"] == updates and launches["ekf_update"] == 0):
        raise AssertionError(f"[{what}] pcm_stage launched {launches['pcm_stage']} times for "
                             f"{scans} scans, pcm_measurement {launches['pcm_measurement']}, "
                             f"can_gps_update {launches['can_gps_update']} (expected "
                             f"{updates}), ekf_update {launches['ekf_update']}")


def check_radar(what, launches, registrations):
    """Kernel X once a radar registration (``registrations``: 0 on a path
    without the radar covariances), kernel P (X's reference) never."""
    if not (launches["radar_rows"] == registrations and launches["radar_cov"] == 0):
        raise AssertionError(f"[{what}] radar_rows launched {launches['radar_rows']} times for "
                             f"{registrations} radar registrations, radar_cov "
                             f"{launches['radar_cov']}")


def check_imu_stage(what, launches, packs, frames):
    """A replay with IMU: the IMU stage is one launch of kernel H a frame
    (an IMU event in ``run``), kernel J never launched, no EKF state or
    params packed."""
    if not (launches["imu_stage"] == frames and launches["ring_push"] == 0
            and not any(packs.values())):
        raise AssertionError(f"[{what}] imu_stage launched {launches['imu_stage']} times for "
                             f"{frames} frames or IMU events, ring_push "
                             f"{launches['ring_push']}, packs {packs}")


def frames_path(pipe, log, fused, kernels, what=FRAMES, names=None):
    """``run_frames`` (the online mode) on the GICP pipeline (``what``: the
    tile or the hash one, whose kernels ``names`` must launch): the launch
    counts from 0 around it, its frames against that pipeline's run_fused
    (ego_pos within 1e-6 m, applied equal: the same kernels in the same
    order), scans/s and the frame time p50/p95."""
    names = names or loop_kernels(SHARED + (KERNEL["GICP"][0],) + tuple(EKF_KERNELS)
                                  + tuple(SCAN_KERNELS), GICP_LOOP)
    stages = StageTimer()
    seen = []
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = pipe.run_frames(log, on_scan=seen.append, mark=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, packs = dict(kernels.launches), dict(kernels.packs)
    split, frames, per_frame = stages.split()
    p50, p95 = (float(np.percentile(per_frame, q)) for q in (50, 95))
    n = len(log.scan_t)
    check_imu_stage(what, launches, packs, n)
    check_scan_end(what, launches, n, 0)
    err = float(np.abs(outs["ego_pos"] - fused["ego_pos"]).max())
    same_applied = bool(np.array_equal(outs["applied"], fused["applied"]))
    log_line(f"[{what}] {n / wall:.2f} scans/s ({wall:.3f} s for {n} scans), frame ms p50 "
             f"{p50:.3f} p95 {p95:.3f}, on_scan calls {len(seen)}, ego_pos vs run_fused max "
             f"{err:.2e} m, applied equal {same_applied}, launches {launches}")
    log_line(f"[{what}] stage ms/frame: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    check_launches(what, launches, names)
    if not (err <= 1e-6 and same_applied and len(seen) == n):
        raise AssertionError(f"[{what}] run_frames differs from run_fused")
    return {"scans_per_s": n / wall, "frame_ms_p50": p50, "frame_ms_p95": p95,
            "stage_ms": split, "ego_pos_vs_fused_m": err}


@contextlib.contextmanager
def sync_watch(strict):
    """torch.cuda.set_sync_debug_mode("error") when ``strict`` (a
    synchronizing call raises), else "warn"; yields a dict that counts each
    synchronizing call by its Python location and message."""
    syncs = {}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("error" if strict else "warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in seen:
        if "synchroniz" in str(w.message):
            where = f"{Path(w.filename).name}:{w.lineno}: {str(w.message)[:80]}"
            syncs[where] = syncs.get(where, 0) + 1


def functional_replay_phase(path, pipe, log, fused, summary, mods):
    """"[functional replay]" on the pipeline of run_fused path ``path``:
    ``runtime.replay_fused`` from ``pipe.reset()`` on the log's batches
    moved to the card first, against the path's timed run_fused ``fused``
    (ego_pos within 1e-6 m, applied equal; whether every output is bit
    for bit is printed), its launch counts from 0 equal to the timed
    replay's (``summary``: the path's slice numbers); then
    ``replay_fused_chunk`` with chunks of FUNCTIONAL_CHUNK from k0 = 0
    (the last one ragged): the first n rows
    and the final state bit for bit replay_fused's, each clamped row bit
    for bit ``fused_frame_at(n - 1)`` from that state, the launches those
    of the chunks' frames. On a tile path every call runs under
    set_sync_debug_mode("error"); on the hash path under "warn", the
    synchronizing calls recorded. Then FUNCTIONAL_PAIRS pairs of a
    run_fused and a replay_fused (the batches already on the card, no
    readback) on the same pipeline, in turns, each to a synchronize: the
    median scans/s of each beside the path's timed run_fused."""
    kernels, runtime = mods[0], mods[6]
    timed = summary["launches"]
    what = f"{FUNCTIONAL}] [{path}"
    strict = not is_hash(path)
    n = len(log.scan_t)
    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    t0 = time.perf_counter()
    batches = runtime.batches_to_device(
        runtime.build_fused_batches(log, time_base=pipe.time_base), pipe.device, pipe.dtype)
    torch.cuda.synchronize()
    prep = time.perf_counter() - t0
    args = (pipe.map, pipe.params, pipe.static)
    kernels.reset_launches()
    with sync_watch(strict) as syncs:
        final, outs = runtime.replay_fused(state, batches, *args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    got = {k: v.cpu().numpy() for k, v in outs.items()}
    err = float(np.abs(got["ego_pos"] - fused["ego_pos"]).max())
    same_applied = bool(np.array_equal(got["applied"], fused["applied"]))
    bits = all(v.dtype == fused[k].dtype
               and np.array_equal(v, fused[k], equal_nan=v.dtype.kind == "f")
               for k, v in got.items())
    log_line(f"[{what}] replay_fused from reset: {n} frames, ego_pos vs run_fused max "
             f"{err:.2e} m, applied equal {same_applied}, every output bit for bit "
             f"{bits}; launches {launches} (the timed run_fused: {timed}); synchronizing "
             "calls " + ("none (sync debug mode: error)" if strict else
                         ", ".join(f"{k} x{v}" for k, v in sorted(syncs.items())) or "none"))
    if not (err <= 1e-6 and same_applied and got["ego_pos"].shape == (n, 3)):
        raise AssertionError(f"[{what}] replay_fused differs from run_fused")
    if launches != timed:
        raise AssertionError(f"[{what}] replay_fused launched {launches}, the timed run_fused "
                             f"{timed}")

    # the chunks: the first n rows and the state as replay_fused's, the
    # clamped rows frame n - 1 on the final state
    rows, chunk_syncs = [], {}
    st = pipe.reset()
    kernels.reset_launches()
    for k0 in range(0, n, FUNCTIONAL_CHUNK):
        with sync_watch(strict) as seen:
            st, out = runtime.replay_fused_chunk(st, batches, k0, *args, FUNCTIONAL_CHUNK)
        rows.append(out)
        for k, v in seen.items():
            chunk_syncs[k] = chunk_syncs.get(k, 0) + v
    torch.cuda.synchronize()
    chunk_launches = {k: v for k, v in kernels.launches.items() if v}
    total = len(rows) * FUNCTIONAL_CHUNK
    cat = {k: torch.cat([o[k] for o in rows]) for k in rows[0]}
    with sync_watch(strict):
        _, last = runtime.fused_frame_at(final, batches, n - 1, *args)
    torch.cuda.synchronize()
    head_bits = same_leaves(leaves({k: v[:n] for k, v in cat.items()}), leaves(outs))
    state_bits = same_leaves(leaves(st), leaves(final))
    tail_bits = all(same_leaves(leaves({k: v[j] for k, v in cat.items()}), leaves(last))
                    for j in range(n, total))
    want = {k: v // n * total for k, v in timed.items()}
    log_line(f"[{what}] replay_fused_chunk x{len(rows)} (chunk {FUNCTIONAL_CHUNK}, "
             f"{total - n} clamped rows): first {n} rows bit for bit {head_bits}, final "
             f"state bit for bit {state_bits}, clamped rows = fused_frame_at({n - 1}) bit for "
             f"bit {tail_bits}; launches {chunk_launches}; synchronizing calls "
             + ("none (sync debug mode: error)" if strict else
                ", ".join(f"{k} x{v}" for k, v in sorted(chunk_syncs.items())) or "none"))
    if not (head_bits and state_bits and tail_bits and total - n > 0):
        raise AssertionError(f"[{what}] the chunks differ from replay_fused")
    if any(v % n for v in timed.values()) or chunk_launches != want:
        raise AssertionError(f"[{what}] the chunks launched {chunk_launches}, not {want}")

    def timed_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    sps = {"run_fused": [], "replay_fused": []}
    for i in range(FUNCTIONAL_PAIRS):
        order = ("run_fused", "replay_fused") if i % 2 == 0 else ("replay_fused", "run_fused")
        for name in order:
            sps[name].append(timed_run(
                (lambda: pipe.run_fused(log)) if name == "run_fused" else
                (lambda: runtime.replay_fused(pipe.reset(), batches, *args))))
    med = {k: float(np.median(v)) for k, v in sps.items()}
    log_line(f"[{what}] scans/s, median of {FUNCTIONAL_PAIRS} in turns (min-max): "
             + ", ".join(f"{k} {med[k]:.2f} ({min(v):.2f}-{max(v):.2f})"
                         for k, v in sps.items())
             + f", ratio {med['replay_fused'] / med['run_fused']:.3f}; the path's timed "
             f"run_fused {summary['scans_per_s']:.2f}; the batches' prep + upload "
             f"{prep:.4f} s; card {card()}")
    return {"replay_fused_scans_per_s": med["replay_fused"],
            "run_fused_scans_per_s": med["run_fused"], "scans_per_s_runs": sps,
            "batch_prep_upload_s": prep, "ego_pos_vs_fused_m": err,
            "outputs_bit_for_bit": bits, "launches": launches,
            "chunk_launches": chunk_launches, "clamped_rows": total - n,
            "syncs": None if strict else {"replay": syncs, "chunks": chunk_syncs}}


def events_path(pipe, log, fused, mods, ate_rmse, deferred):
    """``run`` (the per-event loop) on the config-5 pipeline: a warm-up
    replay recording every launch of kernel W (once a CAN or GPS event),
    each held bit for bit to kernel I; then the launch counts from 0 around
    the timed replay, the events of each kind and their time (CUDA events
    around each step: the enqueue, while the device keeps up), scans/s, and
    the gates applied >= 0.9, ATE < 0.3 m, the last pose within 0.15 m of
    run_fused's (the event order differs within a frame,
    tests/test_pipeline_modes.py:194-203), CAN and GPS admitted. Into
    ``deferred`` (after every timed replay): one CAN event and one GPS event
    (``runtime.can_step`` / ``gps_step`` on recorded inputs) under
    torch.profiler, each one device kernel, W's."""
    kernels, runtime = mods[0], mods[6]
    with Recorder(kernels, ("can_gps_update",), at=0, every=("can_gps_update",)) as rec:
        pipe.run(log)
    torch.cuda.synchronize()
    w_calls = rec.every["can_gps_update"]
    w_against_i(kernels, w_calls, EVENTS)
    steps = ("imu_step", "scan_step", "gps_step", "can_step")
    orig = {n: getattr(runtime, n) for n in steps}
    spans = {n: [] for n in steps}

    def timed(name, fn):
        def step(*a, **k):
            b, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            b.record()
            out = fn(*a, **k)
            e.record()
            spans[name].append((b, e))
            return out
        return step

    stages = StageTimer()

    def scan_step(*a, **k):
        stages("imu")
        return orig["scan_step"](*a, mark=stages, **k)

    for name, fn in orig.items():
        setattr(runtime, name, timed(name, scan_step if name == "scan_step" else fn))
    probe = AdmissionProbe(runtime)
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with probe:
            _, traj = pipe.run(log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in orig.items():
            setattr(runtime, name, fn)
    launches, packs = dict(kernels.launches), dict(kernels.packs)
    split = stages.split()[0]
    split.pop("outputs")
    per_kind = {n.replace("_step", ""): (len(v), float(np.mean([b.elapsed_time(e) for b, e in v]))
                                         if v else 0.0) for n, v in spans.items()}
    n = len(log.scan_t)
    applied = float(np.mean([s["applied"] for s in traj["scans"]]))
    ate = ate_rmse(traj["t"], traj["pos"], log.truth_t, log.truth_pos)
    last = float(np.linalg.norm(traj["pos"][-1] - fused["ego_pos"][-1]))
    # one leg per CAN or GPS event: admitted samples, read from the states
    adm = probe.admitted()
    n_can, n_gps = adm["can"][1], adm["gps"][1]
    log_line(f"[{EVENTS}] {n / wall:.2f} scans/s ({wall:.3f} s), events (count, ms each): "
             + ", ".join(f"{k} {c} {ms:.3f}" for k, (c, ms) in per_kind.items())
             + f"; applied {applied:.3f}, ATE {ate:.4f} m, last pose vs run_fused {last:.4f} m, "
             f"CAN admitted {n_can} of {len(log.can_t)}, GPS {n_gps} of {len(log.gps_t)}, "
             f"launches {launches}")
    log_line(f"[{EVENTS}] stage ms per scan (imu = every event between two scans): "
             + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    check_launches(EVENTS, launches, loop_kernels(
        SHARED + (KERNEL["AVGICP"][0], "can_gps_update") + tuple(EKF_KERNELS)
        + tuple(SCAN_KERNELS), AVG_LOOP))
    check_loop(EVENTS, launches, per_kind["scan"][0], AVG_LOOP)
    check_imu_stage(EVENTS, launches, packs, per_kind["imu"][0])
    check_scan_end(EVENTS, launches, per_kind["scan"][0],
                   per_kind["gps"][0] + per_kind["can"][0])
    if not (applied >= 0.9 and ate < 0.3 and last < 0.15 and n_can > 0 and n_gps > 0
            and np.all(np.isfinite(traj["pos"]))):
        raise AssertionError(f"[{EVENTS}] the event loop failed its acceptance bounds")
    summary = {"scans_per_s": n / wall, "events": {k: c for k, (c, _) in per_kind.items()},
               "event_ms": {k: ms for k, (_, ms) in per_kind.items()}, "applied": applied,
               "ate_m": ate, "last_vs_fused_m": last, "can_admitted": n_can,
               "gps_admitted": n_gps, "stage_ms": split, "w_bit_equal_to_i_calls": len(w_calls)}

    def profiled_events():
        """One CAN and one GPS event of ``run`` on recorded inputs: kernel W
        alone on the device (no mask tensor is made)."""
        can = next((a, k) for a, k in w_calls if k.get("can") is not None)
        gps = next((a, k) for a, k in w_calls if k.get("gps") is not None)
        steps = {"can": lambda: runtime.can_step(
                     runtime.PipelineState(ekf=can[0][0], ego_ring=None, imu_ring=None),
                     *(x[0] for x in can[1]["can"][:3]), pipe.params, pipe.static),
                 "gps": lambda: runtime.gps_step(
                     runtime.PipelineState(ekf=gps[0][0], ego_ring=None, imu_ring=None),
                     *(x[0] for x in gps[1]["gps"][:3]), pipe.params, pipe.static)}
        for kind, fn in steps.items():
            before = dict(kernels.launches)
            per, _ = device_profile(lambda: [fn() for _ in range(STAGE_CALLS)])
            counted = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
            log_line(f"[{EVENTS}] {STAGE_CALLS} {kind} events under torch.profiler: device "
                     f"kernels {per}, launches counted {counted}")
            if (len(per) != 1 or not any("can_gps_update_kernel" in k for k in per)
                    or counted != {"can_gps_update": STAGE_CALLS}):
                raise AssertionError(f"[{EVENTS}] a {kind} event launched {sorted(per)}, not "
                                     "kernel W alone")
            summary[f"device_kernels_a_{kind}_event"] = len(per)

    deferred.append(profiled_events)
    return summary


def reloc_phase(pipe, log, kernels, what="reloc", names=None):
    """``initialize_at`` on the P2P pipeline (a packed tile map: the ground
    probe reads its halo rows; or the hash one: the BuiltMap's) from a click
    ~1 m and 1 deg off the truth at scan 0 (tests/test_pipeline.py:313-327):
    ok, the PCM_INIT warm-up on, the position within 1.5 m of the truth,
    the kernels ``names`` launched (the tile map's: C, B and one launch of
    the loop kernel, neither A nor M)."""
    x, y = log.truth_pos[0][:2] + 0.7
    yaw = log.truth_rpy[0][2] + np.deg2rad(1.0)
    kernels.reset_launches()
    state, ok = pipe.initialize_at(pipe.reset(), x, y, yaw, log.scan_points[0],
                                   log.scan_valid[0], log.scan_t[0])
    launches = dict(kernels.launches)
    err = float(np.linalg.norm(state.ekf.pos.cpu().numpy()[:2] - log.truth_pos[0][:2]))
    packs = dict(kernels.packs)
    log_line(f"[{what}] initialize_at from ({x:.2f}, {y:.2f}, yaw {np.rad2deg(yaw):.2f} deg): "
             f"ok {ok}, pcm_init_on_going {bool(state.ekf.pcm_init_on_going)}, position "
             f"error {err:.3f} m, launches {launches}, packs {packs}")
    check_launches(what, launches, names or ("voxel_downsample", "assign_slots", LOOP))
    if names is None:
        check_loop(what, launches, 1)
    # the PCM_INIT reset's state is packed once, for the EKF kernels after it
    if not (ok and bool(state.ekf.pcm_init_on_going) and err < 1.5
            and packs == {"ekf_state": 1, "ekf_params": 0}):
        raise AssertionError(f"[{what}] relocalization failed")
    return {"ok": ok, "position_error_m": err}


def joseph_path(pipe, log, fused, rec, mods):
    """Kernels H, I and S with ``joseph_form`` against their plain versions on
    the fusion path's recorded inputs, then one run_fused replay of the
    fusion pipeline switched to the Joseph form after construction (as
    tests/test_long_horizon.py:59-66 switches JAX's): launch counts from 0
    around it, applied >= 0.9, its trajectory against the reference form's
    replay under the closed-loop contract (JAX's long-horizon test holds the
    two forms together), its largest P asymmetry no larger than the
    reference form's and every P diagonal positive."""
    kernels = mods[0]
    rows = [imu_stage_row(rec.calls, pipe, mods, joseph=True),
            update_row(rec, mods, "can_gps_update", joseph=True),
            update_row(rec, mods, "ekf_update", joseph=True),
            pcm_stage_row(rec, mods, joseph=True)]
    for r in rows:
        log_line(f"[{JOSEPH}] kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g}, "
                 f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound'][0]:.7f} ms ({r['bound'][1]})")
    plain_static = pipe.static
    pipe.static = dataclasses.replace(plain_static, ekf_flags=dataclasses.replace(
        plain_static.ekf_flags, joseph_form=True))
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = pipe.run_fused(log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipe.static = plain_static
    launches, packs = dict(kernels.launches), dict(kernels.packs)
    check_imu_stage(JOSEPH, launches, packs, len(log.scan_t))
    check_scan_end(JOSEPH, launches, len(log.scan_t), len(log.scan_t))
    err = np.linalg.norm(outs["ego_pos"] - fused["ego_pos"], axis=1)
    applied = float(outs["applied"].mean())
    asym, asym_plain = float(outs["p_asym"].max()), float(fused["p_asym"].max())
    dmin = float(outs["p_min_diag"].min())
    n = len(log.scan_t)
    log_line(f"[{JOSEPH}] {n / wall:.2f} scans/s, applied {applied:.3f}, vs the reference "
             f"form: max {err.max():.2e} m, median {np.median(err):.2e} m, last 3 "
             f"{err[-3:].max():.2e} m; P asymmetry max {asym:.3e} (reference form "
             f"{asym_plain:.3e}), min diagonal {dmin:.3e}, launches {launches}")
    check_launches(JOSEPH, launches, loop_kernels(
        SHARED + (KERNEL["AVGICP"][0], "can_gps_update") + tuple(EKF_KERNELS)
        + tuple(SCAN_KERNELS), AVG_LOOP))
    check_loop(JOSEPH, launches, n, AVG_LOOP)
    if not (applied >= 0.9 and contract(err) and asym <= asym_plain and dmin > 0.0):
        raise AssertionError(f"[{JOSEPH}] the Joseph-form replay failed its gates")
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches[r.pop("launches_key")]
    return rows, {"scans_per_s": n / wall, "applied": applied, "max_m": float(err.max()),
                  "median_m": float(np.median(err)), "last3_m": float(err[-3:].max()),
                  "p_asym_max": asym, "p_asym_max_reference_form": asym_plain,
                  "p_min_diag": dmin}


def ca_tick_row(call, mods):
    """Kernel O (kernel U's reference) against ``ca_tick_plain`` on the
    recorded tick's inputs: pos / vel within 1e-4 m, the quaternion 1e-6,
    each P entry within 1e-5 sqrt(P_ii P_jj) plus the rounding term
    (``p_entry_err``; the plain dense F P F^T goes through cuBLAS), the
    flags equal, the ego-ring row as kernel H's history."""
    kernels, efilter = mods[0], mods[7]
    st, t, params = call
    got, ghist = kernels.ca_tick(*call)
    ref, rhist = efilter.ca_tick_plain(*call)
    err = {f: float((getattr(got, f) - getattr(ref, f)).abs().max())
           for f in ("pos", "vel", "rot")}
    err["P share of its limit"] = p_entry_err(got.P, ref.P, st.P, 1e-5)
    ekf_field_errors(kernels, got, ref)
    hist_err = [float((x - y).abs().max()) for x, y in zip(ghist, rhist)]
    gates = [err["pos"] <= 1e-4, err["vel"] <= 1e-4, err["rot"] <= 1e-6,
             err["P share of its limit"] <= 1.0, not torch.equal(ref.P, st.P)]
    gates += [e <= g for e, g in zip(hist_err, (0.0, 1e-4, 1e-5, 1e-4, 1e-4))]
    log_line("  ca_tick: errors " + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
             + ", ego row " + ", ".join(f"{e:.2e}" for e in hist_err))
    if not all(gates):
        raise AssertionError("ca_tick kernel vs plain: outside its gates")
    moved = 2 * state_bytes(kernels, st) + params_bytes(kernels, params) + nbytes(t, *ghist)
    return dict(name="ca_tick", source="elimaloc_tpu_torch/csrc/ca_tick.cu + ca_tick.cuh",
                replaces="elimaloc_tpu/ekf/filter.py:568 predict + elimaloc_tpu/pipeline/"
                         "runtime.py:249 tick_step (+ :174 _push_ego's ego_state)",
                max_abs_err=max(err["pos"], err["vel"], err["rot"], *hist_err),
                ms=time_ms(lambda: kernels.ca_tick(*call)),
                plain_ms=time_ms(lambda: efilter.ca_tick_plain(*call)),
                device_fn=(lambda: kernels.ca_tick(*call), "ca_tick_kernel"),
                bound=bound(TICK_OPS, moved))


def tick_push_row(call, mods):
    """Kernel J with its IMU ring left out (the tick's ego push, kernel U's
    reference) against ``push_rings_plain``: exactly equal."""
    kernels, rings = mods[0], mods[8]
    got = kernels.ring_push(*call)
    ref = rings.push_rings_plain(*call)
    ego, _, row, _, valid = call
    for f in ("t", "count", "pos", "rpy", "vel_local", "gyro"):
        if not torch.equal(getattr(got[0], f), getattr(ref[0], f)):
            raise AssertionError(f"ring_push[tick] kernel differs from its plain version in {f}")
    if got[1] is not None or ref[1] is not None:
        raise AssertionError("ring_push[tick]: the IMU ring was not left out")
    n0, n1 = int(ego.count), int(got[0].count)
    fields = ("t", "pos", "rpy", "vel_local", "gyro")
    moved = nbytes(*row, valid, ego.count, got[0].count,
                   *(getattr(ego, f)[:n0] for f in fields),
                   *(getattr(got[0], f)[:n1] for f in fields))
    return dict(name="ring_push[tick]", source=RING_PUSH[0],
                replaces=RING_PUSH[1] + " as elimaloc_tpu/pipeline/"
                "runtime.py:174 _push_ego (tick) and :237 imu_ring_step push one ring",
                max_abs_err=0.0, ms=time_ms(lambda: kernels.ring_push(*call)),
                plain_ms=time_ms(lambda: rings.push_rings_plain(*call)),
                device_fn=(lambda: kernels.ring_push(*call), "ring_push_kernel"),
                launches_key="ring_push", bound=bound(8, moved))


def same_ring(a, b):
    """Two rings equal bit for bit, field by field."""
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(b))


def ring_bytes(ring):
    """A ring whole: its times, fields and count."""
    return nbytes(*(getattr(ring, f.name) for f in dataclasses.fields(ring)))


def o_then_j(kernels, st, t, params, ego):
    """The launches kernel U replaced, on U's inputs: kernel O, then kernel J
    pushing O's row into the ego ring alone."""
    ekf, row = kernels.ca_tick(st, t, params)
    one = torch.ones(1, dtype=torch.bool, device=t.device)
    return ekf, kernels.ring_push(ego, None, row, None, one)[0]


def tick_stage_row(call, pipe, mods):
    """Kernel U, the tick with its ego push in one launch, on the recorded
    tick: bit for bit against kernel O then kernel J's ego push (every
    field of the state and of the ring), and against ``tick_stage_plain``
    as kernel O is held (the ring's times and count exactly, its pos /
    vel_local / gyro within 1e-4, rpy 1e-5 rad). One call of
    ``runtime.tick_step`` must show exactly one device kernel, U's, under
    torch.profiler. Bound: the record and the ego ring read and written
    whole, the params, ``t``."""
    kernels, runtime, efilter = mods[0], mods[6], mods[7]
    st, t, params, ego = call
    got, ring = kernels.tick_stage(*call)
    ref, ref_ring = o_then_j(kernels, *call)
    for f, _, _ in kernels.EKF_FIELDS:
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"tick_stage differs from kernel O in {f}")
    if not same_ring(ring, ref_ring):
        raise AssertionError("tick_stage differs from kernel J's ego push")
    plain, plain_ring = efilter.tick_stage_plain(st, ego, t, params)
    err = {f: float((getattr(got, f) - getattr(plain, f)).abs().max())
           for f in ("pos", "vel", "rot")}
    err["P share of its limit"] = p_entry_err(got.P, plain.P, st.P, 1e-5)
    ekf_field_errors(kernels, got, plain)
    tols = dict(pos=1e-4, rpy=1e-5, vel_local=1e-4, gyro=1e-4)
    ring_err = {f: float((getattr(ring, f) - getattr(plain_ring, f)).abs().max()) for f in tols}
    gates = [err["pos"] <= 1e-4, err["vel"] <= 1e-4, err["rot"] <= 1e-6,
             err["P share of its limit"] <= 1.0, not torch.equal(plain.P, st.P),
             torch.equal(ring.t, plain_ring.t), torch.equal(ring.count, plain_ring.count)]
    gates += [ring_err[f] <= tol for f, tol in tols.items()]
    log_line(f"  tick_stage: bit for bit = kernel O then kernel J; ego ring "
             f"{int(ego.count)} -> {int(ring.count)} / {ego.capacity}; against plain "
             + ", ".join(f"{k} {v:.2e}" for k, v in {**err, **ring_err}.items()))
    if not all(gates):
        raise AssertionError("tick_stage kernel vs plain: outside its gates")
    pst = runtime.PipelineState(ekf=st, ego_ring=ego,
                                imu_ring=mods[8].make_imu_ring(8, device=t.device))
    moved = (2 * state_bytes(kernels, st) + params_bytes(kernels, params) + nbytes(t)
             + ring_bytes(ego) + ring_bytes(ring))
    return dict(name="tick_stage", source="elimaloc_tpu_torch/csrc/ca_tick.cu + ca_tick.cuh + "
                "rings.cuh",
                replaces="elimaloc_tpu/ekf/filter.py:568 predict + elimaloc_tpu/pipeline/"
                         "runtime.py:249 tick_step with :172-179 _push_ego (elimaloc_tpu/"
                         "pipeline/rings.py:126 as :183)",
                max_abs_err=max(err["pos"], err["vel"], err["rot"], *ring_err.values()),
                ms=time_ms(lambda: kernels.tick_stage(*call)),
                plain_ms=time_ms(lambda: efilter.tick_stage_plain(st, ego, t, params)),
                device_fn=(lambda: kernels.tick_stage(*call), "tick_stage_kernel"),
                stage_fn=(lambda: runtime.tick_step(pst, t, pipe.params, pipe.static),
                          "tick_stage_kernel"),
                chain_fn=lambda: o_then_j(kernels, *call),
                chain_label="kernel O, the valid flag's fill and kernel J",
                bound=bound(TICK_OPS, moved))


def imu_intake_row(call, tick_call, pipe, mods):
    """Kernel V, the tick mode's IMU intake in one launch, on the recorded
    IMU event: bit for bit against kernel H's IMU ring on the same sample
    (H's CTA-1 work), against the chain it replaced (the rotation as two
    cuBLAS products, then kernel J) within the rotation's rounding bound on
    each side, 3 float32 eps of sum_j |R_ij v_j| (cuBLAS may contract into
    FMAs; where the terms cancel that is more than one ulp of the result;
    the largest difference is printed in ulps of the products' scale), and
    against ``imu_intake_plain`` (times and count exactly,
    gyro and acc within 1e-5). One call of ``runtime.imu_ring_step`` must
    show exactly one device kernel, V's, under torch.profiler. Bound: the
    IMU ring read and written whole, the sample and the rotation."""
    kernels, runtime, rings = mods[0], mods[6], mods[8]
    imu, t, acc, gyro, rot = call
    st, _, params, ego = tick_call
    got = kernels.imu_intake(*call)
    _, _, h_imu = kernels.imu_stage(st, ego, imu, t.reshape(1), acc[None], gyro[None], None,
                                    rot, pipe.params.ego_to_imu_trans, params,
                                    pipe.static.ekf_flags)
    if not same_ring(got, h_imu):
        raise AssertionError("imu_intake differs from kernel H's IMU ring")
    one = torch.ones(1, dtype=torch.bool, device=t.device)

    def chain():
        new = (t.reshape(1), gyro[None] @ rot.T, acc[None] @ rot.T)
        return kernels.ring_push(None, imu, None, new, one)[1]

    old = chain()
    gates = [torch.equal(got.t, old.t), torch.equal(got.count, old.count)]
    eps = torch.finfo(torch.float32).eps
    chain_ulps = {}
    for f, v in (("gyro", gyro), ("acc", acc)):
        scale = (rot.abs() @ v.abs()) * eps
        d = (getattr(got, f) - getattr(old, f)).abs()
        chain_ulps[f] = float((d / scale).max())
        gates.append(chain_ulps[f] <= 3.0)
    plain = rings.imu_intake_plain(*call)
    err = {f: float((getattr(got, f) - getattr(plain, f)).abs().max()) for f in ("gyro", "acc")}
    gates += [torch.equal(got.t, plain.t), torch.equal(got.count, plain.count)]
    gates += [e <= 1e-5 for e in err.values()]
    log_line(f"  imu_intake: bit for bit = kernel H's IMU ring; against the cuBLAS rotation "
             f"+ kernel J, in eps of the products' scale: "
             + ", ".join(f"{k} {v:.2f}" for k, v in chain_ulps.items())
             + f" (at most 3); IMU ring {int(imu.count)} -> "
             f"{int(got.count)} / {imu.capacity}; against plain "
             + ", ".join(f"{k} {v:.2e}" for k, v in err.items()))
    if not all(gates):
        raise AssertionError("imu_intake kernel vs the chain or plain: outside its gates")
    pst = runtime.PipelineState(ekf=st, ego_ring=ego, imu_ring=imu)
    # per sample the two 3x3 rotations (30); the copy is bytes
    moved = nbytes(t, acc, gyro, rot) + ring_bytes(imu) + ring_bytes(got)
    return dict(name="imu_intake", source="elimaloc_tpu_torch/csrc/imu_chain.cu + rings.cuh",
                replaces="elimaloc_tpu/pipeline/runtime.py:237-246 imu_ring_step "
                         "(elimaloc_tpu/pipeline/rings.py:126 as :192)",
                max_abs_err=max(err.values()),
                ms=time_ms(lambda: kernels.imu_intake(*call)),
                plain_ms=time_ms(lambda: rings.imu_intake_plain(*call)),
                device_fn=(lambda: kernels.imu_intake(*call), "imu_intake_kernel"),
                stage_fn=(lambda: runtime.imu_ring_step(pst, t, acc, gyro, pipe.params,
                                                        pipe.static), "imu_intake_kernel"),
                chain_fn=chain, chain_label="the rotation (cuBLAS) and kernel J",
                bound=bound(30, moved))


def tick_count(log):
    """The ticks the event loop makes over the log: np.arange over the
    rebased float64 IMU span at the 100 Hz tick rate (runtime.run)."""
    base = np.floor(min(log.imu_t[0], log.scan_t[0]))
    return len(np.arange(log.imu_t[0] - base, log.imu_t[-1] - base, 0.01))


def sync_free(fn):
    """fn under ``torch.cuda.set_sync_debug_mode("error")``: a host sync
    inside it raises."""
    def step(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return step


def tick_path(packed, log, ds_points, max_slots, mods, ate_rmse):
    """``run`` with use_imu=False (the reference's tick mode) on the P2P
    configuration: a warm-up run with every tick and IMU event under
    ``set_sync_debug_mode("error")``, in which every launch of kernel U is
    held bit for bit to kernel O then kernel J's ego push on its inputs and
    every launch of kernel V to kernel H's IMU ring on its sample, and
    which records the 100th tick's call of U and the first IMU event's call
    of V after it; U and V against their plain versions on those calls, O
    and J's one-ring form (their reference) against their plain versions
    on U's inputs; then the timed run: launch counts from 0 around
    it (U once per tick, V once per IMU sample, O, J and the IMU chain H
    never), the events of each kind and their time, applied, and the truth
    ATE under JAX's own tick-mode bound (2.0 m)."""
    kernels, tiles, cfg_mod, runtime = mods[0], mods[3], mods[5], mods[6]
    cfg = method_cfg(cfg_mod, "P2P")
    cfg.ekf.use_imu = False
    pipe = runtime.LocalizationPipeline(
        cfg, packed[1], device="cuda", ds_points=ds_points,
        tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots),
        ego_ring_size=512, imu_ring_size=256)
    rec = {"n": 0}
    orig_kernels = {n: getattr(kernels, n) for n in ("tick_stage", "imu_intake")}
    orig_steps = {n: getattr(runtime, n) for n in ("tick_step", "imu_ring_step")}
    # (output, reference) of every launch, compared after the replay (a
    # comparison inside a step would be a host sync); H's IMU ring does not
    # read the filter or the ego ring it is given
    pairs = {"tick_stage": [], "imu_intake": []}
    h_state = mods[7].init_state(pipe.params.ekf)
    h_ego = mods[8].make_ego_ring(8, device="cuda")

    def tick(*a):
        rec["n"] += 1
        if rec["n"] == 100:
            rec["tick_stage"] = a
        out = orig_kernels["tick_stage"](*a)
        pairs["tick_stage"].append((out, o_then_j(kernels, *a)))
        return out

    def intake(*a):
        if "tick_stage" in rec and "imu_intake" not in rec:
            rec["imu_intake"] = a
        out = orig_kernels["imu_intake"](*a)
        imu, t, acc, gyro, rot = a
        pairs["imu_intake"].append((out, kernels.imu_stage(
            h_state, h_ego, imu, t.reshape(1), acc[None], gyro[None], None, rot,
            pipe.params.ego_to_imu_trans, pipe.params.ekf, pipe.static.ekf_flags)[2]))
        return out

    kernels.tick_stage, kernels.imu_intake = tick, intake
    for name, fn in orig_steps.items():
        setattr(runtime, name, sync_free(fn))
    try:
        pipe.run(log)
    finally:
        for name, fn in {**orig_kernels, **orig_steps}.items():
            setattr(kernels if name in orig_kernels else runtime, name, fn)
    torch.cuda.synchronize()
    for (state, ring), (ref, ref_ring) in pairs["tick_stage"]:
        if not (all(torch.equal(getattr(state, f), getattr(ref, f))
                    for f, _, _ in kernels.EKF_FIELDS) and same_ring(ring, ref_ring)):
            raise AssertionError(f"[{TICK}] a tick of kernel U differs from kernel O then J")
    if not all(same_ring(v, h) for v, h in pairs["imu_intake"]):
        raise AssertionError(f"[{TICK}] an IMU event of kernel V differs from kernel H's IMU ring")
    log_line(f"[{TICK}] warm-up replay: every tick and IMU event ran under "
             "set_sync_debug_mode('error') (no host sync); U bit for bit = O then J on all "
             f"{len(pairs['tick_stage'])} ticks, V = H's IMU ring on all "
             f"{len(pairs['imu_intake'])} IMU events")
    del pairs
    st, t, params, ego = rec["tick_stage"]
    o_call = (st, t, params)
    _, row = kernels.ca_tick(*o_call)
    j_call = (ego, None, row, None, torch.ones(1, dtype=torch.bool, device=t.device))
    rows = [tick_stage_row(rec["tick_stage"], pipe, mods),
            imu_intake_row(rec["imu_intake"], rec["tick_stage"], pipe, mods),
            ca_tick_row(o_call, mods), tick_push_row(j_call, mods)]
    for r in rows:
        log_line(f"[{TICK}] kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g}, "
                 f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound'][0]:.8f} ms ({r['bound'][1]})")

    steps = ("tick_step", "imu_ring_step", "scan_step")
    orig = {n: getattr(runtime, n) for n in steps}
    spans = {n: [] for n in steps}

    def timed(name, fn):
        def step(*a, **k):
            b, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            b.record()
            out = fn(*a, **k)
            e.record()
            spans[name].append((b, e))
            return out
        return step

    for name, fn in orig.items():
        setattr(runtime, name, timed(name, fn))
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = pipe.run(log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in orig.items():
            setattr(runtime, name, fn)
    launches = dict(kernels.launches)
    per_kind = {n.replace("_step", ""): (len(v), float(np.mean([b.elapsed_time(e) for b, e in v]))
                                         if v else 0.0) for n, v in spans.items()}
    n, n_ticks, n_imu = len(log.scan_t), tick_count(log), len(log.imu_t)
    applied = float(np.mean([s["applied"] for s in traj["scans"]]))
    ate = ate_rmse(traj["t"], traj["pos"], log.truth_t, log.truth_pos)
    log_line(f"[{TICK}] {n / wall:.2f} scans/s ({wall:.3f} s), events (count, ms each): "
             + ", ".join(f"{k} {c} {ms:.3f}" for k, (c, ms) in per_kind.items())
             + f"; ticks expected {n_ticks}, IMU samples {n_imu}; applied {applied:.3f}, "
             f"ATE {ate:.4f} m, launches {launches}")
    check_launches(TICK, launches, loop_kernels(
        SHARED + (KERNEL["P2P"][0], "tick_stage", "imu_intake") + tuple(SCAN_KERNELS)))
    check_loop(TICK, launches, per_kind["scan"][0])
    check_scan_end(TICK, launches, per_kind["scan"][0], 0)
    if not (launches["tick_stage"] == n_ticks and launches["imu_intake"] == n_imu
            and launches["ca_tick"] == 0 and launches["ring_push"] == 0
            and launches["imu_stage"] == 0):
        raise AssertionError(f"[{TICK}] launch counts: {launches}")
    if not (ate < TICK_ATE_GATE and np.all(np.isfinite(traj["pos"]))
            and traj["pos"].shape == (n, 3)):
        raise AssertionError(f"[{TICK}] the tick mode failed its acceptance bounds")
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches[r.pop("launches_key", r["name"])]
    return rows, {"scans_per_s": n / wall, "events": {k: c for k, (c, _) in per_kind.items()},
                  "event_ms": {k: ms for k, (_, ms) in per_kind.items()}, "applied": applied,
                  "ate_m": ate}


def window_log(world, log_mod):
    """The bench.py headline log at its own length (WINDOW_SCANS scans),
    sampled 1/5 like the other paths' log."""
    log = log_mod.synthesize_log(world, duration=(WINDOW_SCANS + 3) * 0.1,
                                 points_per_scan=RAW_POINTS, max_range=100.0, seed=4)
    sl = slice(None, None, INDEX_SAMPLING)
    log.scan_points = np.ascontiguousarray(log.scan_points[:, sl])
    log.scan_times = np.ascontiguousarray(log.scan_times[:, sl])
    log.scan_valid = np.ascontiguousarray(log.scan_valid[:, sl])
    return log


def window_cfg(cfg_mod):
    """bench.py:_cfg(P2P) with the windowed row's 40 m sensor gate
    (bench.py:336-337)."""
    cfg = method_cfg(cfg_mod, "P2P")
    cfg.pcm.input_max_dist = WINDOW_SENSOR
    return cfg


def contract(err):
    """The repo's closed-loop contract (tests/test_pipeline_modes.py:217-236):
    max < 3 cm, median < 5 mm, last 3 frames < 5 mm."""
    return bool(err.max() < 0.03 and np.median(err) < 0.005 and err[-3:].max() < 0.005)


def shift_row(call, pipe, mods):
    """Kernel N against ``shift_window_plain`` on the call the windowed path
    recorded: all six tensors equal bit for bit. Bound: the bytes its
    function must move over 3.35 TB/s: the distinct rows it reads (retained
    old rows, the sentinel, the entering payload rows) and the T + 1 rows it
    writes, plus ``dst_rows``. Beside it, the time of ``index_select`` on
    the row roll alone (one call per tensor), a part of N's work, as a
    library yardstick that the port does not use."""
    kernels, tiles = mods[0], mods[3]
    a, _ = call
    base, nx, ny, dx, dy, dst, payload = a
    got = kernels.shift_window(*a)
    tmap = pipe.map.replace(**base, tile_anchor=(0, 0))

    def plain():
        return tiles.shift_window_plain(tmap, dx, dy, dst, payload)

    ref = plain()
    for f in tiles.HALO_FIELDS:
        g, r = got[f], getattr(ref, f)
        if (g is None) != (r is None) or (g is not None and not torch.equal(g, r)):
            raise AssertionError(f"shift_window kernel differs from its plain version in {f}")
    t = nx * ny
    src_t = tiles.shift_sources(nx, ny, dx, dy, dst.device)
    src = src_t.cpu().numpy()
    d = dst.cpu().numpy()
    over = d[d <= t]
    old_rows = np.unique(src[np.setdiff1d(np.arange(t + 1), over)])
    row_bytes = sum(x[0].numel() * x.element_size() for x in base.values() if x is not None)
    moved = (len(old_rows) + len(over) + t + 1) * row_bytes + nbytes(dst)
    roll_ms = time_ms(lambda: [x.index_select(0, src_t) for x in base.values()
                               if x is not None])
    log_line(f"  shift_window: window {nx}x{ny} + sentinel, shift ({dx}, {dy}), "
             f"{len(over)} entering rows of {len(d)} padded, {row_bytes} B a row over "
             f"{sum(x is not None for x in base.values())} tensors, {moved / 1e6:.2f} MB "
             f"moved; index_select on the row roll alone {roll_ms:.4f} ms")
    return dict(name="shift_window", source=SHIFT[0], replaces=SHIFT[1], max_abs_err=0.0,
                ms=time_ms(lambda: kernels.shift_window(*a)), plain_ms=time_ms(plain),
                device_fn=(lambda: kernels.shift_window(*a), "shift_window_kernel"),
                bound=bound(0, moved)), roll_ms


def shift_chain_check(host, mods):
    """A chain of 1-, 2- and 3-tile shifts on both axes through kernel N,
    into the map's north-east corner and back, against the same rows packed
    fresh at the same origin: every tensor equal bit for bit. Returns the
    shifts run."""
    tiles = mods[3]
    dims = (25, 25)
    ts = host.tile_size
    c = np.array([(host.tx0 + host.tx_dim - 20) * ts, (host.ty0 + host.ty_dim - 20) * ts])
    origin = host.window_anchor(c, dims)
    dev = host.crop_window(c, 12, dims=dims).to_device("cuda")
    anchor, shifts = origin, []
    for step in [(1, 0), (0, 2), (3, 1), (2, 3), (3, 3), (-3, -2), (-1, -3), (0, -1)]:
        new = (int(np.clip(anchor[0] + step[0], host.tx0, host.tx0 + host.tx_dim - dims[0])),
               int(np.clip(anchor[1] + step[1], host.ty0, host.ty0 + host.ty_dim - dims[1])))
        k = max(abs(new[0] - anchor[0]), abs(new[1] - anchor[1]))
        if not k:
            continue
        dst, payload = host.crop_entering_rows(anchor, new, dims, origin, k * sum(dims))
        dev = tiles.shift_window(
            dev, new[0] - anchor[0], new[1] - anchor[1], torch.as_tensor(dst, device="cuda"),
            {f: None if v is None else torch.as_tensor(v, device="cuda")
             for f, v in payload.items()})
        fresh = host._pack_rows(host.window_rows(new, dims), *host._origin_offsets(origin))
        for f in tiles.HALO_FIELDS:
            if fresh[f] is not None and not np.array_equal(getattr(dev, f).cpu().numpy(),
                                                           fresh[f]):
                raise AssertionError(f"shift chain: {f} differs from a fresh crop at {new}")
        shifts.append((new[0] - anchor[0], new[1] - anchor[1]))
        anchor = new
    if sorted({max(abs(a), abs(b)) for a, b in shifts}) != [1, 2, 3]:
        raise AssertionError(f"shift chain: 1-, 2- and 3-tile shifts expected, ran {shifts}")
    log_line(f"[{WINDOWED}] shift chain into the map corner and back, equal to fresh crops "
             f"bit for bit: {shifts}")
    return shifts


def window_reloc(wlog, disk, cfg_mod, runtime, kernels, kw):
    """``initialize_at`` on a windowed pipeline whose first window lies ~100
    m from the click (configured at (-40, -60)), from a click 1 m and 1 deg
    off the truth: each call re-crops around the click (one synchronous
    swap), launching kernels C, B and the P2P loop kernel. Two scans:

    * the log's scan as a caller hands it over (100 m range).
      ``initialize_at`` does not gate it to the sensor range, in the JAX
      package either, and its points beyond the 48 m window find no map, so
      the registration may fail its overlap ratio (0.4). Gate: the card
      returns what the CPU port (the plain versions) returns on the same
      inputs, ``ok`` equal and the position within the contract's 3 cm;
    * the scan gated to the 40 m sensor range, as ``scan_step`` gates it: it
      must relocalize as ``reloc_phase`` does, within 1.5 m of the truth."""
    cfg = window_cfg(cfg_mod)
    cfg.ekf.ekf_init_x_m, cfg.ekf.ekf_init_y_m = -40.0, -60.0
    x, y = wlog.truth_pos[0][:2] + 0.7
    yaw = wlog.truth_rpy[0][2] + np.deg2rad(1.0)
    pts, valid = wlog.scan_points[0], wlog.scan_valid[0]
    rng = np.linalg.norm(pts, axis=1)
    out = {}
    for name, v in (("as given", valid), ("gated", valid & (rng <= WINDOW_SENSOR))):
        pipe = runtime.LocalizationPipeline(cfg, disk, map_window_radius=WINDOW_RADIUS, **kw)
        first = pipe._window_offset_tiles
        kernels.reset_launches()
        state, ok = pipe.initialize_at(pipe.reset(), x, y, yaw, pts, v, wlog.scan_t[0])
        launches = dict(kernels.launches)
        pos = state.ekf.pos.cpu().numpy()
        err = float(np.linalg.norm(pos[:2] - wlog.truth_pos[0][:2]))
        within = float(np.mean(rng[v] <= WINDOW_RADIUS))
        log_line(f"[{WINDOWED}] initialize_at, scan {name} ({100 * within:.1f}% of its valid "
                 f"points within {WINDOW_RADIUS:.0f} m), from ({x:.2f}, {y:.2f}): ok {ok}, "
                 f"window anchor {first} -> {pipe._window_offset_tiles}, window_stats "
                 f"{json.dumps(pipe.window_stats)}, position error {err:.3f} m, "
                 f"launches {launches}")
        check_launches(f"{WINDOWED} reloc", launches, ("voxel_downsample", "assign_slots",
                                                       LOOP))
        check_loop(f"{WINDOWED} reloc", launches, 1)
        if not (pipe._window_offset_tiles != first and pipe.window_stats["sync_swaps"] == 1):
            raise AssertionError(f"[{WINDOWED}] relocalization did not re-window")
        rec = {"ok": ok, "position_error_m": err, "share_within_window_radius": within}
        if name == "as given":
            cpu = runtime.LocalizationPipeline(cfg, disk, map_window_radius=WINDOW_RADIUS,
                                               **dict(kw, device="cpu"))
            cstate, cok = cpu.initialize_at(cpu.reset(), x, y, yaw, pts, v, wlog.scan_t[0])
            gap = float(np.linalg.norm(cstate.ekf.pos.numpy() - pos))
            rec.update(cpu_ok=cok, vs_cpu_m=gap)
            log_line(f"[{WINDOWED}] initialize_at, scan {name}, on the CPU port: ok {cok}, "
                     f"card vs CPU position {gap:.2e} m")
            if cok != ok or gap > 0.03:
                raise AssertionError(f"[{WINDOWED}] relocalization: the card disagrees with "
                                     "the CPU port")
        elif not (ok and bool(state.ekf.pcm_init_on_going) and err < 1.5):
            raise AssertionError(f"[{WINDOWED}] windowed relocalization failed")
        out[name] = rec
    return out


def windowed_path(built, wlog, packed, mods, ate_rmse):
    """"P2P windowed": the bench.py windowed row over a disk-backed map, run
    three ways, each against a full-map pipeline of the same configuration
    on the card (see the module docstring)."""
    kernels, tiles, cfg_mod, runtime = mods[0], mods[3], mods[5], mods[6]
    pcm = cfg_mod.ElimalocConfig().pcm
    ds_points, max_slots = runtime.autosize_budgets(
        wlog, float(pcm.input_voxel_ds_m), 4.0 * pcm.pcm_voxel_size, qb=16)
    kw = dict(device="cuda", ds_points=ds_points, ego_ring_size=512, imu_ring_size=256,
              tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots))
    cfg = window_cfg(cfg_mod)
    n = len(wlog.scan_t)
    path_kernels = loop_kernels(SHARED + (KERNEL["P2P"][0],) + tuple(EKF_KERNELS)
                                    + tuple(SCAN_KERNELS) + ("shift_window",))
    with tempfile.TemporaryDirectory() as store:
        t0 = time.time()
        tiles.build_tile_map(built, tile_voxels=4, halo_margin=1, storage_dir=store)
        disk = tiles.load_tile_map(store, mmap=True)
        log_line(f"[{WINDOWED}] {n} scans, ds_points {ds_points}, max_slots {max_slots}; map "
                 f"packed to {store} and reopened disk-backed in {time.time() - t0:.1f} s")

        def windowed():
            return runtime.LocalizationPipeline(cfg, disk, map_window_radius=WINDOW_RADIUS, **kw)

        full = runtime.LocalizationPipeline(cfg, packed[1], **kw)
        _, fouts = full.run_fused(wlog)
        full_ate = ate_rmse(fouts["ego_t_abs"], fouts["ego_pos"], wlog.truth_t, wlog.truth_pos)
        pipe = windowed()
        with Recorder(kernels, ("shift_window",), at=0) as rec:
            pipe.run_fused(wlog, window_chunk=8)
        torch.cuda.synchronize()
        if "shift_window" not in rec.calls:
            raise AssertionError(f"[{WINDOWED}] the warm-up replay shifted no window "
                                 f"({pipe.window_stats})")
        row, roll_ms = shift_row(rec.calls["shift_window"], pipe, mods)
        log_line(f"[{WINDOWED}] kernel shift_window: max_abs_err 0, {row['ms']:.4f} ms vs plain "
                 f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.6f} ms (bytes)")
        shifts = shift_chain_check(packed[1], mods)
        window_queries = window_query_check(pipe.map, full.map, built, tiles,
                                            tiles.TileQueryBudget(qb=16, max_slots=2048))

        def forced(p):
            orig = p._start_prefetch

            def start_and_wait(pos_xy):
                orig(pos_xy)
                if p._prefetch is not None:
                    p._prefetch["done"].wait()
            p._start_prefetch = start_and_wait
            return p

        runs = {
            "run_fused(window_chunk=8)": (windowed, lambda p, m: p.run_fused(
                wlog, window_chunk=8, mark=m)),
            "run_frames": (windowed, lambda p, m: p.run_frames(wlog, mark=m)),
            "run_frames forced": (lambda: forced(windowed()),
                                  lambda p, m: p.run_frames(wlog, mark=m)),
        }
        summary, launches = {}, None
        for name, (make, drive) in runs.items():
            p = make()
            stages = StageTimer()
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, outs = drive(p, stages)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_imu_stage(f"{WINDOWED} {name}", kernels.launches, kernels.packs, n)
            check_loop(f"{WINDOWED} {name}", kernels.launches, n)
            check_scan_end(f"{WINDOWED} {name}", kernels.launches, n, 0)
            if launches is None:
                launches = dict(kernels.launches)
            split, frames, per_frame = stages.split()
            p50, p95 = (float(np.percentile(per_frame, q)) for q in (50, 95))
            st = dict(p.window_stats)
            err = np.linalg.norm(outs["ego_pos"] - fouts["ego_pos"], axis=1)
            ate = ate_rmse(outs["ego_t_abs"], outs["ego_pos"], wlog.truth_t, wlog.truth_pos)
            applied = float(outs["applied"].mean())
            dropped = int(outs["slots_dropped"].max())
            log_line(f"[{WINDOWED}] {name}: {n / wall:.2f} scans/s ({wall:.3f} s), frame ms p50 "
                     f"{p50:.3f} p95 {p95:.3f}, applied {applied:.3f}, ATE {ate:.4f} m (full map "
                     f"{full_ate:.4f} m), slots_dropped {dropped}, vs full map max "
                     f"{err.max():.2e} median {np.median(err):.2e} last 3 {err[-3:].max():.2e} m, "
                     f"window_stats {json.dumps(st)}")
            log_line(f"[{WINDOWED}] {name} stage ms/frame: "
                     + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
            summary[name] = {"scans_per_s": n / wall, "frame_ms_p50": p50, "frame_ms_p95": p95,
                             "stage_ms": split, "ate_m": ate, "applied": applied,
                             "vs_full_max_m": float(err.max()),
                             "vs_full_median_m": float(np.median(err)),
                             "vs_full_last3_m": float(err[-3:].max()), "window_stats": st}
            if not (np.all(np.isfinite(outs["ego_pos"])) and outs["ego_pos"].shape == (n, 3)):
                raise AssertionError(f"[{WINDOWED}] {name}: non-finite or misshapen trajectory")
            if not (st["swaps"] >= 1 and st["incr_crops"] >= 1 and applied >= 0.9
                    and dropped == 0 and contract(err)):
                raise AssertionError(f"[{WINDOWED}] {name} failed its gates")
            if "forced" in name and not (st["sync_swaps"] == 0
                                         and st["prefetch_hits"] == st["swaps"]):
                raise AssertionError(f"[{WINDOWED}] {name}: a swap was not a prefetch hit")
        log_line(f"[{WINDOWED}] launches (run_fused(window_chunk=8)) {launches}")
        for k in path_kernels:
            if launches[k] <= 0:
                raise AssertionError(f"[{WINDOWED}] kernel {k} was not launched on the path")
        reloc = window_reloc(wlog, disk, cfg_mod, runtime, kernels, kw)
        win_bytes = nbytes(*(getattr(pipe.map, f) for f in tiles.HALO_FIELDS))
        full_bytes = sum(a.nbytes for a in (getattr(packed[1], f) for f in tiles.HALO_FIELDS)
                         if a is not None)
        log_line(f"[{WINDOWED}] device bytes: window {win_bytes / 1e6:.1f} MB "
                 f"({pipe.map.tx_dim}x{pipe.map.ty_dim} tiles + sentinel) against the full "
                 f"map {full_bytes / 1e6:.1f} MB ({packed[1].tx_dim}x{packed[1].ty_dim})")

        # one more replay under torch.profiler (the last timed replay of the
        # script is behind it): the device's busy share and top kernels
        p = windowed()
        per, prof_wall = device_profile(lambda: p.run_fused(wlog, window_chunk=8))
        busy = sum(per.values()) * 1e-3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        log_line(f"[{WINDOWED}] torch.profiler replay (run_fused(window_chunk=8)): device busy "
                 f"{busy:.1f} ms of {prof_wall:.1f} ms wall ({100 * busy / prof_wall:.1f}%); "
                 "top: " + "; ".join(f"{k[:48]} {v * 1e-3 / n:.3f} ms/frame" for k, v in top))
        summary["device_busy_share_profiled"] = busy / prof_wall if per else None
    row["route"] = "cuda"
    row["launches"] = launches["shift_window"]
    summary.update(full_map_ate_m=full_ate, window_mb=win_bytes / 1e6,
                   full_map_mb=full_bytes / 1e6, index_select_roll_ms=roll_ms,
                   shift_chain=shifts, reloc=reloc, tile_queries=window_queries)
    return [row], summary


def window_reference_phase(cfg_mod, runtime, builder, tiles, log_mod):
    """The windowed event loop ``run`` on the small windowed drive of
    tests/test_torch_window_replay.py (29 scans, 40 m gate, 48 m window),
    card against the CPU port, under the closed-loop contract."""
    cfg = window_cfg(cfg_mod)
    cfg.pcm.input_voxel_ds_m = 1.0
    world = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = log_mod.synthesize_log(world, duration=3.05, points_per_scan=1024, max_range=40.0,
                                 seed=10)
    built = builder.build_voxel_map(world, 1.0, 30)
    pos, stats = {}, {}
    for device in ("cuda", "cpu"):
        pipe = runtime.LocalizationPipeline(
            cfg, built, device=device, ds_points=1024, map_window_radius=WINDOW_RADIUS,
            tile_budget=tiles.TileQueryBudget(qb=32, max_slots=512), ego_ring_size=128,
            imu_ring_size=128)
        pos[device] = pipe.run(log)[1]["pos"]
        stats[device] = dict(pipe.window_stats)
    err = np.linalg.norm(pos["cuda"] - pos["cpu"], axis=1)
    log_line(f"[{WINDOWED}] reference (run): card vs CPU port over {len(err)} scans: max "
             f"{err.max():.2e} m, median {np.median(err):.2e} m, last 3 max "
             f"{err[-3:].max():.2e} m; swaps card {stats['cuda']['swaps']}, CPU "
             f"{stats['cpu']['swaps']}")
    if not (contract(err) and stats["cuda"]["swaps"] >= 1):
        raise AssertionError(f"[{WINDOWED}] the card's windowed run left the closed-loop "
                             "contract")
    return {"max_m": float(err.max()), "median_m": float(np.median(err)),
            "last3_m": float(err[-3:].max()), "swaps": stats["cuda"]["swaps"]}


class StageRecorder:
    """Wraps the fleet frame's stage dispatchers ``names`` (FLEET_STAGES:
    module attributes) to keep the arguments of their call ``at`` (one fleet
    frame's), so the lane-form rows run on the main path's inputs."""

    def __init__(self, mods, at, names):
        self.mods, self.at, self.calls, self.seen, self.orig = mods, at, {}, {}, {}
        self.names = names

    def __enter__(self):
        for name in self.names:
            where = FLEET_STAGES[name][0]
            mod, attr = where.split(".")
            fn = getattr(self.mods[mod], attr)
            self.orig[name] = (self.mods[mod], attr, fn)

            def wrapped(*a, _n=name, _f=fn, **k):
                i = self.seen.get(_n, 0)
                self.seen[_n] = i + 1
                if i == self.at:
                    self.calls[_n] = (a, k)
                return _f(*a, **k)
            setattr(self.mods[mod], attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.orig.values():
            setattr(mod, attr, fn)


def leaves(tree):
    """The tensors of a stage's output in a fixed order (records field by
    field, dicts by key)."""
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def lane_bound(name, a, k, got, mods):
    """(operations, bytes) of one lane-form call on its lanes' inputs ``a``,
    ``k`` (the dispatcher's arguments) and outputs ``got``: each lane's
    count as the single kernel's row counts it, summed over the lanes."""
    kernels = mods["kernels"]
    rec_b = state_bytes(kernels, None)
    if name == "imu_stage":
        st, b = a[0], a[1]
        flags = a[3].ekf_flags
        per_sample = 7760 + (kalman_ops(2) + 200 if flags.run_cf else 0) + (
            kalman_ops(3) + 300 if flags.imu_estimate_calibration else 0)
        valid = b["imu_valid"]
        ops = int(valid.sum()) * per_sample + 20 * valid.numel()
        moved = (2 * rec_b * valid.shape[0] + params_bytes(kernels, None)
                 + nbytes(b["imu_t"], b["imu_acc"], b["imu_gyro"], valid))
        for old, new in ((st.ego_ring, got.ego_ring), (st.imu_ring, got.imu_ring)):
            per_row = 4 * (1 + 3 * (len(dataclasses.fields(old)) - 2))
            moved += per_row * int(old.count.sum() + new.count.sum()) + 8 * old.count.numel()
        return ops, moved
    if name == "scan_front":
        st, stamp, points, times, valid = a[:5]
        w = got.info.imu_time.shape[-1]
        n = points.shape[1]
        counts = int(st.imu_ring.count.sum() + st.ego_ring.count.sum())
        ops = (7 * n * points.shape[0] + int(got.valid.sum()) * (10 * w + 60) + 10 * counts
               + (20 * w + 2000) * points.shape[0])
        moved = (nbytes(points, times, valid, stamp, got.points, got.valid) + 52 * counts
                 + nbytes(*leaves(got.info), got.init_guess))
        return ops, moved
    if name == "voxel_downsample":
        points, valid = a[:2]
        ops = points.shape[0] * points.shape[1] * (17 + 6 * 4) + int(got[2].sum()) * 3
        return ops, nbytes(points, valid, *got)
    if name == "assign_slots":
        tmap, queries, valid = a[:3]
        passes = max(1, -(-tmap.sentinel.bit_length() // 8))
        ops = queries.shape[0] * (queries.shape[1] * (14 + 6 * passes) + (tmap.sentinel + 1) * 6)
        return ops, nbytes(queries, valid, *leaves(got))
    if name in (LOOP, *TILE_LOOPS.values()):
        # per lane, its iterations of the search and M's step as
        # loop_bytes_ops counts a registration, the matches its last
        # iteration's (overlap x total)
        tmap, slot_tile, sbuf, qmask = a[:4]
        method = next(m for m, n in {"P2P": LOOP, **TILE_LOOPS}.items() if n == name)
        row = (tmap.halo_points if method in ("P2P", "GICP") else tmap.halo_vox_mean).shape[1]
        cand_b, match_b, match_ops = SEARCH_COST[method]
        ops = moved = 0
        for i in range(sbuf.shape[0]):
            live = int(qmask[i].sum())
            n_tiles = int(torch.unique(slot_tile[i][qmask[i].any(1)]).numel())
            its = int(got[5][i])
            matched = int(round(float(got[3][i]) * float(a[7][i])))
            ops += its * (live * row * 6 + matched * match_ops + 600)
            moved += n_tiles * row * cand_b + live * 12 + matched * match_b
        return ops, moved + nbytes(qmask, slot_tile, *a[4:8], *got)
    if name == HASH_LOOP:
        # per lane, its iterations of the hash search (hash_search_bytes_ops
        # at its initial pose) and of M's step, the matches its last
        # iteration's (overlap x total)
        grid, src, valid, pose = a[1:5]
        method = {v: m for m, v in kernels.HASH_METHODS.items()}[int(a[0])]
        radar = a[10] if len(a) > 10 else k.get("radar")
        ops = moved = 0
        for i in range(src.shape[0]):
            its = int(got[5][i])
            matched = int(round(float(got[3][i]) * float(a[7][i])))
            b, o = hash_search_bytes_ops(method, mods["grid"], grid,
                                         mods["icp"].transform_slots(pose[i], src[i]), matched)
            ops += its * (o + matched * (SEARCH_COST[method][2] + 9 * (radar is not None)) + 600)
            moved += b
        return ops, moved + nbytes(src, valid, radar, *a[4:8], *got)
    if name == "radar_rows":
        # as radar_row counts one registration's, over the lanes
        src, qidx, qmask, pose = a[:4]
        live = int(qmask.sum()) if qmask is not None else src.shape[0] * src.shape[1]
        return live * 120, nbytes(qidx, qmask, pose, got) + live * 12
    if name == "can_gps_update":
        # per lane its valid CAN samples and GPS fixes, as update_row counts
        # one frame's
        can, gps = k.get("can"), k.get("gps")
        ops = moved = 0
        if can is not None:
            ops += int(can[3].sum()) * (kalman_ops(4) + 150)
            moved += nbytes(*can)
        if gps is not None:
            ops += int(gps[3].sum()) * (kalman_ops(3) + 250)
            moved += nbytes(*gps)
        lanes = (can if can is not None else gps)[0].shape[0]
        return ops, moved + 2 * rec_b * lanes + params_bytes(kernels, None)
    ekf, res, ego, end, usable = a[0], a[1], a[3], a[4], a[5]
    lanes = end.shape[0]
    n_ego = int(ego.count.sum())
    applied = int(got[2]["applied"].sum())
    ops = lanes * (700 + 2 * 729 + 60) + 2 * n_ego + applied * (kalman_ops(6) + 250)
    moved = (2 * rec_b * lanes + params_bytes(kernels, None) + 28 * n_ego
             + nbytes(res.pose, res.local_cov, res.fitness, res.success, usable, end)
             + lanes * (4 * kernels.PCM_STAGE_FLOATS + 1))
    return ops, moved


def same_leaves(got, ref):
    """Every tensor of ``got`` equal to ``ref``'s, NaN where the other is."""
    return len(got) == len(ref) and all(
        same_bits(g, r) if g.dtype.is_floating_point else torch.equal(g, r)
        for g, r in zip(got, ref))


def fleet_label(path, name):
    """A lane form's row name: ``name[fleet]`` on the tile fleets without
    radar; the hash loop's with its method and radar form, X's with the
    backend, the tile loops' radar forms as ``[radar fleet]``."""
    cfg_path = FLEET_PATHS[path]
    if name == HASH_LOOP:
        return f"{name}[{path_method(cfg_path)}{' radar' if is_radar(cfg_path) else ''} fleet]"
    if name == "radar_rows":
        return f"{name}[{'hash ' if is_hash(cfg_path) else ''}fleet]"
    return f"{name}[{'radar ' if is_radar(cfg_path) else ''}fleet]"


def lane_capacity(kernels, name, a, k, lanes):
    """The co-resident CTAs of the loop kernel ``name``'s instantiation for
    the recorded call ``a`` on ``lanes`` lanes (its lane form for lanes >
    1), or None for a kernel that is not a loop."""
    if name in TILE_LOOPS.values():
        radar = len(a) > 11 and a[11] is not None
        return getattr(kernels, f"{name}_capacity")(a[3].shape[-1], radar, lanes)
    if name == HASH_LOOP:
        radar = (a[10] if len(a) > 10 else k.get("radar")) is not None
        method = {v: m for m, v in kernels.HASH_METHODS.items()}[int(a[0])]
        return kernels.hash_register_capacity(method, radar and method != "P2P", lanes)
    return None


def lane_form_row(what, label, name, a, k, mods, launches):
    """Lane form ``name`` (FLEET_STAGES) on the call ``a``, ``k`` of a
    fleet frame (FLEET_LANES lanes at the headline widths): one launch, bit
    for bit against FLEET_LANES single-lane launches on the lanes' inputs;
    its event time through its dispatcher, the single launches' and its
    bound. Against its plain lane form on the same inputs within its
    tolerance (``plain_check``) and the plain lane form's time
    (``plain_fn``) come last in the run (main): a profiler pass after the
    plain lane forms' flood of small eager kernels lost device records. The
    row is ``label``, its launches ``launches`` (the main path's count)."""
    kernels, struct = mods["kernels"], mods["struct"]
    where, lane_args, device, tol = FLEET_STAGES[name]
    mod, attr = where.split(".")
    fn = getattr(mods[mod], attr)
    pmod, pattr = FLEET_PLAIN[name].split(".")
    plain = getattr(mods[pmod], pattr)
    first = a[lane_args[0]]  # a tensor, a pipeline state or an EKF state
    lanes = (first if isinstance(first, torch.Tensor)
             else getattr(first, "ekf", first).P).shape[0]
    lane_kw = FLEET_LANE_KW.get(name, ())

    def one(i):
        kw = {key: tuple(x[i] for x in v) if key in lane_kw and v is not None else v
              for key, v in k.items()}
        return fn(*(struct.lane(x, i) if j in lane_args else x for j, x in enumerate(a)), **kw)

    kernels.reset_launches()
    got = fn(*a, **k)
    torch.cuda.synchronize()
    if kernels.launches[name] != 1:
        raise AssertionError(f"[{what}] {label}: the lane form launched "
                             f"{kernels.launches[name]} times for one call")
    g = leaves(got)
    singles = [leaves(one(i)) for i in range(lanes)]
    per_lane = [same_leaves([x[i] for x in g], singles[i]) for i in range(lanes)]
    radar = (name == AVG_LOOP and len(a) > 11 and a[11] is not None) or (
        name == HASH_LOOP and int(a[0]) == kernels.HASH_METHODS["AVGICP"] and a[10] is not None)
    if radar:
        # AVGICP's radar form: its float32 sums' rounding carries from
        # iteration to iteration, 1e-4 a GN iteration as its single loop's
        # row allows
        tol *= max(1, int(got[5].max()))
    ops, moved = lane_bound(name, a, k, got, mods)
    ms = time_ms(lambda: fn(*a, **k))
    singles_ms = time_ms(lambda: [one(i) for i in range(lanes)])
    grid = ""
    cap = lane_capacity(kernels, name, a, k, lanes)
    if cap is not None:  # the lane form's and the single loop's
        grid = (f"; co-resident CTAs {cap} (the single loop's "
                f"{lane_capacity(kernels, name, a, k, 1)})")
    its = ""
    if name in LOOP_DEVICE:
        its = (f"; iterations per lane {got[5].tolist()}, failed {got[4].int().tolist()}, "
               f"overlap {[round(float(x), 3) for x in got[3]]}")
    log_line(f"[{what}] kernel {label}: {lanes} lanes, each lane bit for bit its "
             f"single-lane launch: {per_lane.count(True)} of {lanes}; {ms:.4f} ms (the "
             f"{lanes} single-lane launches {singles_ms:.4f} ms){grid}{its}; card {card()}")
    if not all(per_lane):
        raise AssertionError(f"[{what}] {label}: a lane differs from its single-lane launch")

    def plain_check():
        """The lane form's outputs against its plain lane form's: max abs
        err, after raising where rel err > tol or an integer, flag or NaN
        differs."""
        err, rel, exact = 0.0, 0.0, True
        for x, r in zip(g, leaves(plain(*a, **k))):
            if x.dtype.is_floating_point:
                if not torch.equal(torch.isnan(x), torch.isnan(r)):
                    exact = False
                d = torch.nan_to_num((x - r).abs())
                if d.numel():
                    err = max(err, float(d.max()))
                    rel = max(rel, float((d / torch.clamp(r.abs(), min=1.0)).max()))
            elif not torch.equal(x, r):
                exact = False
        log_line(f"[{what}] kernel {label} against its plain lane form: max abs err "
                 f"{err:.3g}, max rel err {rel:.3g} (tolerance {tol:g} x max(1, |plain|)), "
                 f"integers and flags equal: {exact}")
        if not exact or rel > tol:
            raise AssertionError(f"[{what}] {label}: the lane form misses its plain lane form")
        return err

    src, replaces = FLEET_SOURCE[name]
    return dict(name=label, source=src, replaces=replaces + FLEET_VMAP, route="cuda",
                launches=launches, plain_check=plain_check,
                plain_fn=lambda: plain(*a, **k), ms=ms, singles_ms=singles_ms,
                tolerance=tol, lanes=lanes, device_fn=(lambda: fn(*a, **k), device),
                bound=bound(ops, moved))


def fleet_rows(path, names, rec, mods, launches):
    """Each lane form ``names`` on the recorded fleet frame of ``path``
    (``lane_form_row``), its launches the timed fleet replay's."""
    return [lane_form_row(path, fleet_label(path, name), name, *rec.calls[name], mods,
                          launches[name]) for name in names]


def fleet_trace(path, pipe, logs, runtime, n, launched):
    """One more fleet replay of ``path`` under torch.profiler, every frame
    under set_sync_debug_mode("error") (a synchronizing call inside a frame
    raises): the device's busy share, and each frame's lane forms
    ``launched`` on the device, once each a frame (T's two kernels once
    each), no kernel of the single chain (A, E, F, G, M, K, D, L, I, J) and
    no device-to-host copy or synchronizing runtime call inside the
    frames."""
    from torch.profiler import ProfilerActivity, profile, record_function

    orig = runtime.fused_frame

    def frame(*a, **k):
        with record_function("chip_smoke.fleet_frame"):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    runtime.fused_frame = frame
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            pipe.run_fused_fleet(logs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
    finally:
        runtime.fused_frame = orig
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    spans = [e for e in evs if e.device_type == cpu and e.name == "chip_smoke.fleet_frame"]
    t0, t1 = min(e.time_range.start for e in spans), max(e.time_range.end for e in spans)
    inside = [e.name for e in evs if e.device_type == cpu and t0 <= e.time_range.start <= t1]
    blocking = sorted({x for x in inside if "Synchronize" in x or "DtoH" in x})
    # the frame range's device-side span covers the frame's kernels: it is
    # not device work of its own
    kern = [e for e in evs if e.device_type == dev and e.name != "chip_smoke.fleet_frame"]
    busy = sum(e.time_range.elapsed_us() for e in kern) * 1e-3
    copies = sum(e.time_range.elapsed_us() for e in kern if e.name.startswith("Memcpy")) * 1e-3
    devices = [FLEET_STAGES[x][2] for x in launched if x != "scan_front"]
    count = {d: sum(d in e.name for e in kern) for d in (
        *devices, "scan_gate_query_kernel", "scan_deskew_points_kernel")}
    chain = sorted({e.name for e in kern if any(x in e.name for x in (
        *CHAIN_DEVICE.values(), "gn_step_kernel", "scan_ring_query_kernel", "deskew_kernel",
        "pcm_measurement_kernel", "ekf_update_kernel", "ring_push_kernel"))})
    top = {}
    for e in kern:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(top.items(), key=lambda kv: -kv[1])[:6]
    log_line(f"[{path}] traced fleet replay: {len(spans)} frames, device busy {busy:.2f} ms of "
             f"{wall:.2f} ms wall ({100 * busy / wall:.1f}%; copies {copies:.2f} ms of it); "
             f"lane-form kernels on the device "
             f"{count}; chain kernels {chain}; synchronizing calls inside the frames "
             f"{blocking}; top: " + "; ".join(f"{k[:40]} {v * 1e-3 / n:.3f} ms/frame"
                                              for k, v in top) + f"; card {card()}")
    if len(spans) != n or any(v != n for v in count.values()) or chain or blocking:
        raise AssertionError(f"[{path}] the traced fleet replay breaks the one-launch-a-"
                             "frame contract")
    return {"device_busy_share_profiled": busy / wall, "profiled_wall_ms": wall,
            "device_copies_ms": copies, "traced_lane_kernels": count}


def fleet_lane_forms(path):
    """(the lane forms each frame of fleet path ``path`` launches once, the
    ones whose rows it adds): the P2P fleet's rows are its own lane forms,
    the other paths' what they add to them (their loop and, with radar
    covariances, X; the fusion path kernel W)."""
    cfg_path = FLEET_PATHS[path]
    fusion, radar = cfg_path == FUSION, is_radar(cfg_path)
    shared = tuple(x for x in FLEET_SHARED if not (is_hash(cfg_path) and x == "assign_slots"))
    added = (path_loop(cfg_path),) + (("radar_rows",) if radar else ())
    launched = shared + added + (("can_gps_update",) if fusion else ())
    if path == FLEET:
        return launched, launched
    return launched, ("can_gps_update",) if fusion else added


def far_log(log):
    """``log`` in the FAR_X map frame: its truth and GPS moved (the scans
    are sensor-frame)."""
    off = np.array([FAR_X, 0.0, 0.0])
    return dataclasses.replace(log, truth_pos=log.truth_pos + off, gps_pos=log.gps_pos + off)


def far_maps(built, builder, tiles):
    """The headline BuiltMap in a map frame whose origin lies FAR_X m away
    (where the reference's world-frame radar model is well-posed): every
    point and mean moved by FAR_X in x in float32, the voxel coords by
    FAR_X / voxel, the hash table rebuilt on them (the builder's table at
    build_voxel_map's default load factor and probe limit); the covariances
    do not depend on the frame's origin and stay. Returns {"built": it,
    1: its tile packing at halo margin 1, 2: at margin 2}."""
    t0 = time.time()
    shift = FAR_X / built.voxel_size
    if shift != int(shift):
        raise AssertionError("FAR_X is not a whole number of voxels")
    off = np.array([FAR_X, 0.0, 0.0], np.float32)
    coords = built.vox_coords + np.array([int(shift), 0, 0], np.int32)
    table, table_fp, size, probe = builder._build_table(coords, 0.25, 16)
    far = dataclasses.replace(
        built, vox_coords=coords, points=built.points + off, vox_mean=built.vox_mean + off,
        point_cov_mean=built.point_cov_mean + off, table=table, table_fp=table_fp,
        table_size=size, max_probe=probe)
    maps = {"built": far, **{m: tiles.build_tile_map(far, tile_voxels=4, halo_margin=m)
                             for m in (1, 2)}}
    log_line(f"map: moved {FAR_X:.0f} m off the origin, its hash table rebuilt and packed at "
             f"halo margins 1 and 2 in {time.time() - t0:.1f} s")
    return maps


def fleet_pipe(cfg, cfg_path, maps, runtime, tiles, ds_points, max_slots):
    """A card pipeline of the run_fused configuration ``cfg_path`` on
    ``maps`` (far_maps' keys): on the hash grid of maps["built"], or on its
    tile packing of the method's halo margin with qb 16 and ``max_slots``."""
    if is_hash(cfg_path):
        return runtime.LocalizationPipeline(
            cfg, maps["built"], backend="hash", device="cuda", ds_points=ds_points,
            ego_ring_size=512, imu_ring_size=256)
    return runtime.LocalizationPipeline(
        cfg, maps[2 if path_method(cfg_path) == "AVGICP" else 1], device="cuda",
        ds_points=ds_points, tile_budget=tiles.TileQueryBudget(qb=16, max_slots=max_slots),
        ego_ring_size=512, imu_ring_size=256)


def fleet_cfg(cfg_mod, cfg_path):
    """``method_cfg`` of ``cfg_path``, with radar covariances its initial
    position in the FAR_X frame."""
    cfg = method_cfg(cfg_mod, cfg_path)
    if is_radar(cfg_path):
        cfg.ekf.ekf_init_x_m += FAR_X
    return cfg


def fleet_phase(path, log, second, maps, mods, ate_rmse, deferred):
    """A fleet path (FLEET_PATHS): ``run_fused_fleet`` on FLEET_LANES lanes
    (the headline log and ``second``, a log of the same world and
    duration, alternating) at the headline widths, on the pipeline of the
    path's run_fused configuration whose budgets fit both logs (the tile
    packing or the hash grid of ``maps``: {"near": the headline maps, "far":
    far_maps}; a radar path in the FAR_X frame, its logs moved there). A
    warm-up fleet replay records one fleet frame's stage calls
    (StageRecorder; on the fusion path a frame with a GPS fix); the
    lane-form rows (``fleet_rows``); the timed replay with the launch counts
    from 0 (each lane form once a frame: 21 each, T's host call once a
    frame, no single chain kernel, no pack) beside the single-stream
    run_fused of the headline log in the same call; each lane bit for bit
    its log's ``run_frames`` on a fresh pipeline with the lane's padded
    batches; each lane's ATE within its method's ATE_GATE (AVGICP's radar
    form: RADAR_AVG_ATE_GATE) and applied >= 0.9 (the radar forms: applied
    recorded); the traced replay (``fleet_trace``) with the other profiler
    passes. Returns (rows, summary, the recorded calls)."""
    kernels, tiles, cfg_mod, runtime = mods["kernels"], mods["tiles"], mods["cfg"], \
        mods["runtime"]
    cfg_path = FLEET_PATHS[path]
    method = path_method(cfg_path)
    launched, row_names = fleet_lane_forms(path)
    if is_radar(cfg_path):
        log, second = far_log(log), far_log(second)
    logs = [log if i % 2 == 0 else second for i in range(FLEET_LANES)]
    pcm = cfg_mod.ElimalocConfig().pcm
    sizes = [runtime.autosize_budgets(lg, float(pcm.input_voxel_ds_m), 4.0 * pcm.pcm_voxel_size,
                                      qb=16) for lg in (log, second)]
    ds_points, max_slots = (max(x) for x in zip(*sizes))
    path_maps = maps["far" if is_radar(cfg_path) else "near"]

    def make():
        return fleet_pipe(fleet_cfg(cfg_mod, cfg_path), cfg_path, path_maps, runtime, tiles,
                          ds_points, max_slots)

    pipe = make()
    n = len(log.scan_t)
    _, batches = runtime.fleet_batches(logs)
    at = N_SCANS // 2
    if cfg_path == FUSION:  # record a frame with a GPS fix for W's row
        at = next(k for k in range(at, n) if batches["gps_valid"][:, k].any())
    log_line(f"[{path}] {FLEET_LANES} lanes x {n} scans x {log.scan_points.shape[1]} points "
             f"(seeds 4 and {FLEET_SEED} alternating), the {cfg_path} configuration"
             + (f" {FAR_X:.0f} m off the map origin" if is_radar(cfg_path) else "")
             + f", ds_points {ds_points}, max_slots {max_slots}; lane forms {launched}")
    with StageRecorder(mods, at, row_names + FLEET_RECORDS.get(path, ())) as rec:
        pipe.run_fused_fleet(logs)
    torch.cuda.synchronize()

    # the timed replay, then the single stream in the same call, each with
    # its stage marks (CUDA events), and the fleet's host batch prep alone
    stages = StageTimer()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, outs = pipe.run_fused_fleet(logs, mark=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, packs = dict(kernels.launches), dict(kernels.packs)
    pipe.run_fused(log)
    single = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run_fused(log, mark=single)
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime.fleet_batches(logs)
    prep_ms = (time.perf_counter() - t0) * 1e3
    split = {}
    for what, timer in (("fleet", stages), ("single", single)):
        per_stage, frames, per_frame = timer.split()
        split[what] = {"stage_ms": per_stage, "frame_ms_p50": float(np.percentile(per_frame, 50)),
                       "frame_ms_p95": float(np.percentile(per_frame, 95))}
        log_line(f"[{path}] {what} stage ms/frame (frames 1..{frames}): "
                 + ", ".join(f"{k} {v:.3f}" for k, v in per_stage.items())
                 + f"; frame ms p50 {split[what]['frame_ms_p50']:.3f} p95 "
                 f"{split[what]['frame_ms_p95']:.3f}")
    log_line(f"[{path}] {FLEET_LANES * n / wall:.2f} scans/s ({wall:.3f} s for "
             f"{FLEET_LANES} x {n} scans, host batch prep + upload included; the prep "
             f"alone, runtime.fleet_batches, {prep_ms:.1f} ms); single-stream run_fused of "
             f"the headline log ({cfg_path}) {n / single_wall:.2f} scans/s; launches "
             f"{launches}, packs {packs}; card {card()}")
    others = {k: v for k, v in launches.items() if k not in launched and v}
    if any(launches[k] != n for k in launched) or others or any(packs.values()):
        raise AssertionError(f"[{path}] not one launch of each lane form a fleet frame: "
                             f"{launches}, packs {packs}")

    # each lane against its log's run_frames on a fresh pipeline
    mismatch = []
    for j, lg in enumerate((log, second)):
        _, ref = make().run_frames(lg, batches={k: v[j] for k, v in batches.items()})
        for lane in range(j, FLEET_LANES, 2):
            for k, v in ref.items():
                x = outs[k][lane]
                same = (np.array_equal(x, v, equal_nan=True) if x.dtype.kind == "f"
                        else np.array_equal(x, v))
                if not same or x.shape != v.shape:
                    mismatch.append((lane, k))
    ates = [ate_rmse(outs["ego_t_abs"][i], outs["ego_pos"][i], lg.truth_t, lg.truth_pos)
            for i, lg in enumerate(logs)]
    applied = [float(x.mean()) for x in outs["applied"]]
    gate = RADAR_AVG_ATE_GATE if is_radar(cfg_path) and method == "AVGICP" else ATE_GATE[method]
    log_line(f"[{path}] each lane against its log's run_frames (fresh pipeline, the lane's "
             f"padded batches), every output of every frame bit for bit: mismatches "
             f"{mismatch[:6]}; ATE per lane {[round(a, 4) for a in ates]} m (gate "
             f"{gate} m), applied {[round(a, 3) for a in applied]}, slots_dropped "
             f"max {int(outs['slots_dropped'].max())}, iterations mean "
             f"{float(outs['iterations'].mean()):.2f}")
    converged = min(applied) >= 0.9
    if is_radar(cfg_path) and not converged:
        # the radar forms: applied recorded (the lanes equal their single
        # streams bit for bit), the ATE gate held
        log_line(f"[{path}] applied below 0.9: the reference's radar covariance (world "
                 "frame, R S without R^T) weighs the registration's covariance, and the "
                 "PCM update admits fewer of its poses; applied recorded, not gated")
    if mismatch or not all(a < gate for a in ates) or not (converged or is_radar(cfg_path)):
        raise AssertionError(f"[{path}] the fleet's lanes fail their gates")
    if outs["ego_pos"].shape != (FLEET_LANES, n, 3) or states.ekf.P.shape[0] != FLEET_LANES:
        raise AssertionError(f"[{path}] misshapen fleet outputs")

    rows = fleet_rows(path, row_names, rec, mods, launches)
    summary = {"lanes": FLEET_LANES, "scans": n, "configuration": cfg_path,
               "converged": converged,
               "fleet_scans_per_s": FLEET_LANES * n / wall,
               "single_stream_scans_per_s": n / single_wall, "batch_prep_ms": prep_ms,
               **split, "ate_m": ates,
               "applied": applied, "launches": {k: launches[k] for k in launched},
               "ds_points": ds_points, "max_slots": max_slots}

    def traced():
        summary.update(fleet_trace(path, pipe, logs, runtime, n, launched))

    deferred.append(traced)
    return rows, summary, rec


def other_lane_rows(recs, maps, mods, max_slots):
    """Every lane instantiation no fleet path launches (OTHER_LANE_FORMS),
    each on a fleet frame a path recorded (``lane_form_row``, 0 launches on
    any path): the frame's downsampled scans and initial poses (the GICP
    hash fleet's registration; the tile GICP radar fleet's downsample rerun
    and X's world poses) registered by ``run_register`` on a pipeline of
    the configuration (the headline maps, the radar forms' FAR_X ones), its
    loop call recorded."""
    icp, cfg_mod, runtime, tiles = mods["icp"], mods["cfg"], mods["runtime"], mods["tiles"]
    rows = []
    for label, name, cfg_path, path in OTHER_LANE_FORMS:
        calls = recs[path].calls
        if path == HASH_FLEET:
            src, valid, pose = calls[HASH_LOOP][0][2:5]
        else:
            src, valid, _ = runtime.voxel_downsample(*calls["voxel_downsample"][0])
            pose = calls["radar_rows"][0][3]
        pipe = fleet_pipe(fleet_cfg(cfg_mod, cfg_path), cfg_path,
                          maps["far" if is_radar(cfg_path) else "near"], runtime, tiles,
                          src.shape[1], max_slots)
        with StageRecorder(mods, 0, (name,)) as rec:
            icp.run_register(src, valid, pipe.map, pose, pipe.params.icp, pipe.static.icp_static)
        rows.append(lane_form_row(f"{path}: {label}", label, name, *rec.calls[name], mods, 0))
    return rows


def small_fleet_phase(what, cfg_path, lanes, world, maps, mods, log_mod, use_imu=True,
                      fusion=False):
    """A small fleet (TICK_FLEET, WIDE_FLEET): ``lanes`` lanes of two logs of
    SMALL_SCANS scans of SMALL_POINTS raw points on the headline world
    (seeds 6 and 7, alternating) in the FAR_X frame, on the pipeline of
    ``cfg_path`` (with ``use_imu``, with GPS + CAN when ``fusion``) on
    maps["far"]: one run_fused_fleet with the launch counts from 0 (each
    lane form once a frame, the loop ceil(lanes / MAX_LANES) times a frame,
    nothing else, no pack); each lane bit for bit its log's run_fused on the
    same pipeline, every output of every frame; finite poses."""
    kernels, tiles, cfg_mod, runtime = mods["kernels"], mods["tiles"], mods["cfg"], \
        mods["runtime"]
    two = [far_log(log_mod.synthesize_log(world, duration=SMALL_SCANS * 0.1 + 0.05,
                                          points_per_scan=SMALL_POINTS, max_range=100.0,
                                          seed=seed)) for seed in (6, 7)]
    logs = [two[i % 2] for i in range(lanes)]
    cfg = fleet_cfg(cfg_mod, cfg_path)
    cfg.ekf.use_imu = use_imu
    cfg.ekf.use_gps = cfg.ekf.use_can = fusion
    pcm = cfg.pcm
    sizes = [runtime.autosize_budgets(lg, float(pcm.input_voxel_ds_m), 4.0 * pcm.pcm_voxel_size,
                                      qb=16) for lg in two]
    ds_points, max_slots = (max(x) for x in zip(*sizes))
    pipe = fleet_pipe(cfg, cfg_path, maps["far"], runtime, tiles, ds_points, max_slots)
    n = len(two[0].scan_t)
    loop = path_loop(cfg_path)
    launched = tuple(x for x in FLEET_SHARED
                     if not (is_hash(cfg_path) and x == "assign_slots")) + (loop, "radar_rows") \
        + (("can_gps_update",) if fusion else ())
    want = {x: n for x in launched}
    want[loop] = n * -(-lanes // kernels.MAX_LANES)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, outs = pipe.run_fused_fleet(logs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, packs = dict(kernels.launches), dict(kernels.packs)
    singles = [pipe.run_fused(lg)[1] for lg in two]
    mismatch = [(i, k) for i in range(lanes) for k, v in singles[i % 2].items()
                if outs[k][i].shape != v.shape or not np.array_equal(
                    outs[k][i], v, equal_nan=v.dtype.kind == "f")]
    applied = float(outs["applied"].mean())
    log_line(f"[{what}] {lanes} lanes x {n} scans x {SMALL_POINTS} points (seeds 6 and 7 "
             f"alternating), the {cfg_path} configuration {FAR_X:.0f} m off the map origin, "
             f"use_imu {use_imu}, GPS + CAN {fusion}, ds_points {ds_points}, max_slots "
             f"{max_slots}: {lanes * n / wall:.2f} scans/s ({wall:.3f} s); launches "
             f"{ {k: v for k, v in launches.items() if v} } (want {want}), packs {packs}; "
             f"each lane against its log's run_fused, every output of every frame bit for "
             f"bit: mismatches {mismatch[:6]}; applied {applied:.3f}; card {card()}")
    others = {k: v for k, v in launches.items() if k not in want and v}
    if (any(launches[k] != v for k, v in want.items()) or others or any(packs.values())
            or mismatch or not np.isfinite(outs["ego_pos"]).all()
            or outs["ego_pos"].shape != (lanes, n, 3) or states.ekf.P.shape[0] != lanes):
        raise AssertionError(f"[{what}] the small fleet fails its checks")
    return {"lanes": lanes, "scans": n, "configuration": cfg_path, "use_imu": use_imu,
            "fusion": fusion, "scans_per_s": lanes * n / wall, "launches": want,
            "applied": applied}


def long_lead_phase(mods, builder, log_mod):
    """A log whose IMU stream leads its first scan by LEAD_S (the vehicle at
    rest; the small P2P log of the reference phase, 1024 points a scan):
    frame 0 holds the lead's samples and ``build_fused_batches`` pads every
    frame to them, past the 1,024 samples one launch of kernel H takes.
    ``run_fused`` and ``run_frames`` on the card, launch counts from 0
    around each: H ceil(cap / 1024) times a frame (``runtime.imu_chunks``),
    J never, no pack; ``run_frames`` equals ``run_fused`` to 1e-6 m with
    ``applied`` equal; every scan applied; the card's ``run_fused`` against
    the port on the CPU under the closed-loop contract. Rings of 2,048 rows
    hold a whole padded frame (with smaller rings one batch push keeps only
    a padded frame's last positions, as JAX's does, and neither package
    localizes past frame 0)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_parity import stationary_lead

    kernels, tiles, cfg_mod, runtime = mods[0], mods[3], mods[5], mods[6]
    cfg = method_cfg(cfg_mod, "P2P")
    cfg.pcm.input_voxel_ds_m = 1.0
    world = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = stationary_lead(log_mod.synthesize_log(world, duration=0.7, points_per_scan=1024,
                                                 max_range=50.0, seed=10, gps_hz=1.0),
                          LEAD_S, seed=11)
    built = builder.build_voxel_map(world, 1.0, 30)
    n = len(log.scan_t)
    cap = runtime.build_fused_batches(log)["imu_t"].shape[1]
    per_frame = -(-cap // kernels.IMU_STAGE_MAX_SAMPLES)

    def make(device):
        return runtime.LocalizationPipeline(
            cfg, built, device=device, ds_points=1024,
            tile_budget=tiles.TileQueryBudget(qb=8, max_slots=1024), ego_ring_size=2048,
            imu_ring_size=2048)

    pipe = make("cuda")
    outs, out = {}, {"scans": n, "imu_per_frame": cap, "h_launches_a_frame": per_frame,
                     "lead_s": float(log.scan_t[0] - log.imu_t[0])}
    for loop in ("run_fused", "run_frames"):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[loop] = getattr(pipe, loop)(log)[1]
        torch.cuda.synchronize()
        out[f"{loop}_scans_per_s"] = n / (time.perf_counter() - t0)
        launches, packs = dict(kernels.launches), dict(kernels.packs)
        log_line(f"[{LEAD}] {loop}: {n} scans, lead {out['lead_s']:.2f} s, {cap} IMU samples "
                 f"a frame, imu_stage launched {launches['imu_stage']} times "
                 f"({per_frame} a frame), applied {outs[loop]['applied'].tolist()}")
        check_imu_stage(f"{LEAD} {loop}", launches, packs, n * per_frame)
        check_scan_end(f"{LEAD} {loop}", launches, n, 0)
    frames_err = float(np.abs(outs["run_frames"]["ego_pos"] - outs["run_fused"]["ego_pos"]).max())
    cpu = make("cpu").run_fused(log)[1]["ego_pos"]
    err = np.linalg.norm(outs["run_fused"]["ego_pos"] - cpu, axis=1)
    out.update(run_frames_vs_fused_m=frames_err, reference=_stats(err))
    log_line(f"[{LEAD}] run_frames vs run_fused max {frames_err:.2e} m; card vs CPU port over "
             f"{n} scans: max {err.max():.2e} m, median {np.median(err):.2e} m, last 3 max "
             f"{err[-3:].max():.2e} m")
    if not (per_frame >= 2 and frames_err <= 1e-6 and contract(err)
            and np.array_equal(outs["run_frames"]["applied"], outs["run_fused"]["applied"])
            and outs["run_fused"]["applied"].all()):
        raise AssertionError(f"[{LEAD}] the long-lead replay failed its gates")
    return out


def reference_phase(path, cfg_mod, runtime, builder, tiles, log_mod):
    """A small log on the card (kernels) against the same port on the CPU
    (plain versions, which tests/test_torch_*.py hold to the JAX package),
    under the repo's closed-loop contract: max < 3 cm, median < 5 mm, last 3
    < 5 mm. The logs are those of tests/test_torch_slice.py (P2P) and
    tests/test_torch_methods_replay.py (where each method converges); the
    fusion path runs AVGICP's, with its 1 Hz GPS and 50 Hz CAN, through
    run_fused and through the event loop run; a hash path runs its method's
    log on the hash backend."""
    method = path_method(path)
    cfg = method_cfg(cfg_mod, path)
    cfg.pcm.input_voxel_ds_m = 1.0
    ds_points = 1024
    if method in ("P2P", "GICP"):
        world = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
        log = log_mod.synthesize_log(world, duration=3.0, max_range=50.0, seed=10,
                                     gps_hz=1.0,
                                     points_per_scan=1024 if method == "P2P" else 4096)
        ds_points = 1024 if method == "P2P" else 2048
    else:
        world = log_mod.make_world(seed=7, extent=60.0, n_ground=150_000, n_wall=80_000)
        log = log_mod.synthesize_log(world, duration=2.0, points_per_scan=8192,
                                     max_range=60.0, seed=8, imu_noise_gyro=0.001,
                                     imu_noise_acc=0.01)
        ds_points = 4096
    built = builder.build_voxel_map(world, 1.0, 30, compute_voxel_cov=method != "GICP",
                                    compute_point_cov=method == "GICP")
    loops = {"run_fused": lambda p: p.run_fused(log)[1]["ego_pos"]}
    if path == FUSION:
        loops["run"] = lambda p: p.run(log)[1]["pos"]
    pos = {}
    for device in ("cuda", "cpu"):
        pipe = runtime.LocalizationPipeline(
            cfg, built, device=device, ds_points=ds_points,
            backend="hash" if is_hash(path) else "tile",
            tile_budget=tiles.TileQueryBudget(qb=8, max_slots=1024),
            ego_ring_size=128, imu_ring_size=128)
        for loop, fn in loops.items():
            pos[loop, device] = fn(pipe)
    out = {}
    for loop in loops:
        err = np.linalg.norm(pos[loop, "cuda"] - pos[loop, "cpu"], axis=1)
        log_line(f"[{path}] reference ({loop}): card vs CPU port over {len(err)} scans: max "
                 f"{err.max():.2e} m, median {np.median(err):.2e} m, last 3 max "
                 f"{err[-3:].max():.2e} m")
        if not contract(err):
            raise AssertionError(f"[{path}] the card's trajectory ({loop}) left the "
                                 "closed-loop contract")
        out[loop] = {"max_m": float(err.max()), "median_m": float(np.median(err)),
                     "last3_m": float(err[-3:].max())}
    return out


def hash_vs_tile(fused, slices):
    """Each hash path's trajectory against the tile path of its method, in
    the same run: P2P, GICP and VGICP under the closed-loop contract (the
    same matches up to ties, the same sums up to their order); AVGICP's
    ATE beside the tile path's (the tile path's slot assignment is hoisted
    out of the GN loop, the hash backend looks the voxels up from the
    current pose every iteration: ROADMAP Queue 3's open question)."""
    out = {}
    for path in HASH_PATHS:
        method = path_method(path)
        err = np.linalg.norm(fused[path]["ego_pos"] - fused[method]["ego_pos"], axis=1)
        out[method] = _stats(err)
        out[method].update(ate_hash_m=slices[path]["ate_m"], ate_tile_m=slices[method]["ate_m"])
        log_line(f"[{path}] vs {method} (tile): max {err.max():.2e} m, median "
                 f"{np.median(err):.2e} m, last 3 max {err[-3:].max():.2e} m; ATE hash "
                 f"{slices[path]['ate_m']:.4f} m, tile {slices[method]['ate_m']:.4f} m")
        if method != "AVGICP" and not contract(err):
            raise AssertionError(f"[{path}] left the closed-loop contract of the tile path")
    return out


def _stats(err):
    return {"max_m": float(err.max()), "median_m": float(np.median(err)),
            "last3_m": float(err[-3:].max())}


def card_vs_cpu(what, loop, make_pipe, noise_floor=False):
    """``loop(pipe)`` -> positions, on a card pipeline and on a CPU one,
    held to each other under the closed-loop contract. With
    ``noise_floor``, a replay outside the contract is held instead to the
    CPU port's own float32-vs-float64 spread on the same log: max, median
    and last 3 each at most twice the spread's (each float32 replay, card or
    CPU, carries its own rounding walk of that size; the contract assumes
    a closed loop that contracts it away, which an ill-conditioned radar
    objective does not)."""
    pos = {device: loop(make_pipe(device, torch.float32)) for device in ("cuda", "cpu")}
    err = np.linalg.norm(pos["cuda"] - pos["cpu"], axis=1)
    log_line(f"[{what}] reference: card vs CPU port over {len(err)} scans: max "
             f"{err.max():.2e} m, median {np.median(err):.2e} m, last 3 max "
             f"{err[-3:].max():.2e} m")
    out = _stats(err)
    if contract(err):
        return out
    if not noise_floor:
        raise AssertionError(f"[{what}] the card's trajectory left the closed-loop contract")
    spread = np.linalg.norm(pos["cpu"] - loop(make_pipe("cpu", torch.float64)), axis=1)
    out["cpu_f32_vs_f64"] = floor = _stats(spread)
    log_line(f"[{what}] reference outside the contract; the CPU port's own float32 vs "
             f"float64 replay: max {floor['max_m']:.2e} m, median {floor['median_m']:.2e} m, "
             f"last 3 max {floor['last3_m']:.2e} m")
    if not all(out[k] <= 2.0 * floor[k] for k in floor):
        raise AssertionError(f"[{what}] the card's trajectory left twice the CPU port's "
                             "float32 spread")
    return out


def tick_reference_phase(cfg_mod, runtime, builder, tiles, log_mod):
    """The tick-mode event loop on the small log of tests/test_torch_tick.py
    (tiny_pipe(use_imu=False), 30 scans of 1024 points), card against the
    CPU port."""
    cfg = method_cfg(cfg_mod, "P2P")
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.ekf.use_imu = False
    world = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = log_mod.synthesize_log(world, duration=3.0, points_per_scan=1024, max_range=50.0,
                                 seed=10, gps_hz=1.0)
    built = builder.build_voxel_map(world, 1.0, 30)
    return card_vs_cpu(TICK, lambda p: p.run(log)[1]["pos"], lambda device, dtype:
                       runtime.LocalizationPipeline(
                           cfg, built, device=device, dtype=dtype, ds_points=1024,
                           tile_budget=tiles.TileQueryBudget(qb=8, max_slots=1024),
                           ego_ring_size=128, imu_ring_size=128))


def radar_reference_phase(path, cfg_mod, runtime, builder, tiles, log_mod):
    """A radar path's run_fused on a small log, card against the CPU port,
    in a map frame whose origin lies FAR_X m away (the same drive, every
    position shifted): near the origin the reference's world-frame radar
    model diverges and a chaotic divergence says nothing about the port.
    GICP and VGICP replay the tiny_pipe world at 4096 points a scan
    (tests/test_torch_radar_replay.py), AVGICP the bench_methods world.
    AVGICP's radar objective is flat along the directions the large radar
    variances damp, and its float32 replay wanders by ~1 cm on the CPU port
    alone (float32 vs float64: median ~1 cm on this log): a replay outside
    the contract is held to twice that spread, measured in the same run
    (``card_vs_cpu``)."""
    method = path_method(path)
    cfg = method_cfg(cfg_mod, path)
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.ekf.ekf_init_x_m += FAR_X
    off = np.array([FAR_X, 0.0, 0.0])
    if method in ("GICP", "VGICP"):
        world = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
        log = log_mod.synthesize_log(world, duration=3.0, points_per_scan=4096, max_range=50.0,
                                     seed=10, gps_hz=1.0)
        ds_points = 2048
    else:
        world = log_mod.make_world(seed=7, extent=60.0, n_ground=150_000, n_wall=80_000)
        log = log_mod.synthesize_log(world, duration=2.0, points_per_scan=8192, max_range=60.0,
                                     seed=8, imu_noise_gyro=0.001, imu_noise_acc=0.01)
        ds_points = 4096
    log = dataclasses.replace(log, truth_pos=log.truth_pos + off, gps_pos=log.gps_pos + off)
    built = builder.build_voxel_map(world + off, 1.0, 30, compute_voxel_cov=method != "GICP",
                                    compute_point_cov=method == "GICP")
    return card_vs_cpu(path, lambda p: p.run_fused(log)[1]["ego_pos"], lambda device, dtype:
                       runtime.LocalizationPipeline(
                           cfg, built, device=device, dtype=dtype, ds_points=ds_points,
                           tile_budget=tiles.TileQueryBudget(qb=8, max_slots=1024),
                           ego_ring_size=128, imu_ring_size=128), noise_floor=True)


#: the ring pushes: LocalizationPipeline's ring capacities (ego_ring_size,
#: imu_ring_size) and the one-ring push times of kernels U and V that
#: PERF.md §6 holds (event ms, device ms), beside which J's are printed
RING_PUSHES = "ring pushes"
RING_CAPS = (1024, 512)
UV_PUSH_MS = (0.0068, 0.0033)
#: the command line: its replay's method is the CLI's default (GICP)
CLI = "cli"
#: "[cli]" builds its GICP map from every 16th point of the headline world:
#: the per-point covariances are a NumPy build that costs ~90 s on the whole
CLI_THIN = 16


def ring_push_sequence(ego_cap=RING_CAPS[0], imu_cap=RING_CAPS[1], seed=11):
    """The calls of "[ring pushes]" (and of tests/test_torch_small_api.py):
    ``(ring, t, fields)`` in call order, ring "ego" (fields pos, rpy,
    vel_local, gyro) or "imu" (gyro, acc), every value exact in float32.
    Each ring sees pushes a step later, an equal time, a time 2**-18 s
    later (inside the ego ring's 1e-5 dedupe, accepted by the IMU ring's
    eps 0), a time one float32 ulp later, a time regression that clears it,
    more accepted pushes than its capacity (the roll), then the equal,
    in-eps and ulp times on the full ring and a regression of the full
    ring."""
    rng = np.random.default_rng(seed)

    def calls(kind, cap, nf):
        n = cap + 300
        special = {5: "equal", 7: "eps", 9: "ulp", 200: "regress", n - 40: "equal",
                   n - 38: "eps", n - 36: "ulp", n - 20: "regress"}
        t, out = 1.0, []
        for i in range(n):
            s = special.get(i)
            if s == "equal":
                new = t
            elif s == "eps":
                new = t + 2.0 ** -18
            elif s == "ulp":
                new = float(np.nextafter(np.float32(t), np.float32(np.inf)))
            elif s == "regress":
                new = t - 1.0
            else:
                new = t + 10.0 / 1024.0
            t = new if s == "regress" else max(t, new)
            out.append((kind, new, tuple(rng.normal(size=(nf, 3)).astype(np.float32))))
        return out

    ego, imu = calls("ego", ego_cap, 4), calls("imu", imu_cap, 2)
    seq = []
    for i in range(max(len(ego), len(imu))):
        seq += ego[i:i + 1] + imu[i:i + 1]
    return seq


def ring_push_phase(mods):
    """"[ring pushes]": ``rings.push_ego`` / ``push_imu`` on card rings of the
    pipeline's capacities over :func:`ring_push_sequence`, each call one
    launch of kernel J, every ring after every call bit for bit the plain
    version's (the same calls on CPU rings: ``push_ego_batch`` /
    ``push_imu_batch`` of one row). Then J's one-row push into a full ring
    (a roll, every row moved) timed by CUDA events and on the device alone,
    beside U's and V's pushes. Rows ``ring_push[push_ego]`` and
    ``ring_push[push_imu]``."""
    kernels, rings = mods[0], mods[8]
    dev = torch.device("cuda")
    seq = ring_push_sequence()
    make = {"ego": (rings.make_ego_ring, RING_CAPS[0], rings.push_ego),
            "imu": (rings.make_imu_ring, RING_CAPS[1], rings.push_imu)}
    on_card = {k: m(c, device=dev) for k, (m, c, _) in make.items()}
    plain = {k: m(c, device="cpu") for k, (m, c, _) in make.items()}
    fields = {k: torch.from_numpy(np.stack([f for kind, _, f in seq if kind == k])).to(dev)
              for k in make}
    idx = {"ego": 0, "imu": 0}
    kernels.reset_launches()
    counts, full, j_launches = {"ego": [], "imu": []}, {}, {"ego": 0, "imu": 0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kind, t, f in seq:
        push = make[kind][2]
        row = fields[kind][idx[kind]]
        idx[kind] += 1
        before = kernels.launches["ring_push"]
        on_card[kind] = push(on_card[kind], t, *row.unbind(0))
        j_launches[kind] += kernels.launches["ring_push"] - before
        plain[kind] = push(plain[kind], t, *(torch.from_numpy(v) for v in f))
        for fl in dataclasses.fields(plain[kind]):
            got, ref = getattr(on_card[kind], fl.name).cpu(), getattr(plain[kind], fl.name)
            if not torch.equal(got, ref):
                raise AssertionError(f"[{RING_PUSHES}] {kind} push at t={t!r}: kernel J "
                                     f"differs from the plain version in {fl.name}")
        counts[kind].append(int(plain[kind].count))
        if counts[kind][-1] == make[kind][1]:
            full[kind] = on_card[kind]
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    n_calls = {k: sum(1 for kind, _, _ in seq if kind == k) for k in make}
    if (j_launches != n_calls or launches["ring_push"] != len(seq)
            or any(v for k, v in launches.items() if k != "ring_push")):
        raise AssertionError(f"[{RING_PUSHES}] launches {launches}, kernel J's by ring "
                             f"{j_launches}, for calls {n_calls}")
    for k, (_, cap, _) in make.items():
        c = counts[k]
        if not (max(c) == cap and min(c[1:]) == 1 and c[-1] > 1):
            raise AssertionError(f"[{RING_PUSHES}] the {k} sequence missed the roll or "
                                 f"the clear: counts {c[:12]} ... {c[-24:]}")
    log_line(f"[{RING_PUSHES}] {len(seq)} calls ({n_calls['ego']} push_ego, "
             f"{n_calls['imu']} push_imu) on rings of {RING_CAPS[0]} and {RING_CAPS[1]} rows: "
             f"every ring bit for bit the plain version's after every call, kernel J "
             f"launched {launches['ring_push']} times ({j_launches['ego']} by push_ego, "
             f"{j_launches['imu']} by push_imu, read from its count around each call), no "
             f"other kernel; the counts reached "
             f"the capacities (rolls) and 1 after each regression; {wall:.2f} s with the "
             f"comparisons")
    rows = []
    for k, (_, cap, push) in make.items():
        ring = full[k]           # the last full ring of the sequence
        last = float(ring.t[-1])
        f = fields[k][0].unbind(0)
        t_row, rows_in, valid = rings._one_row(ring, last + 0.25, f)
        new = (t_row, *rows_in)
        if k == "ego":
            def call(new=new, ring=ring, valid=valid):
                return kernels.ring_push(ring, None, new, None, valid)

            def plain_call(new=new, ring=ring, valid=valid):
                return rings.push_ego_batch(ring, *new, valid)
        else:
            def call(new=new, ring=ring, valid=valid):
                return kernels.ring_push(None, ring, None, new, valid)

            def plain_call(new=new, ring=ring, valid=valid):
                return rings.push_imu_batch(ring, *new, valid)
        out = call()[0 if k == "ego" else 1]
        if not same_ring(out, plain_call()):
            raise AssertionError(f"[{RING_PUSHES}] the timed {k} push differs from plain")
        ms = time_ms(call)
        entry_ms = time_ms(lambda ring=ring, push=push, t=last + 0.25, f=f: push(ring, t, *f))
        dev_ms = kernel_device_ms(call, "ring_push_kernel")
        moved = ring_bytes(ring) + ring_bytes(out) + nbytes(*new, valid)
        uv = UV_PUSH_MS[0] if k == "ego" else UV_PUSH_MS[1]
        log_line(f"[{RING_PUSHES}] kernel J, one row into the full {k} ring ({cap} rows, a "
                 f"roll): {ms:.4f} ms by CUDA events (push_{k} with its two fills "
                 f"{entry_ms:.4f} ms), on the device alone "
                 + (f"{dev_ms:.4f} ms" if dev_ms else "not measured")
                 + f" (torch.profiler); PERF.md's {'U' if k == 'ego' else 'V'} push "
                 f"{uv} ms; card {card()}")
        rows.append(dict(name=f"ring_push[push_{k}]", route="cuda", source=RING_PUSH[0],
                         replaces=f"elimaloc_tpu/pipeline/rings.py:{106 if k == 'ego' else 116}"
                                  f" push_{k} (:75 _push_arrays)",
                         launches=j_launches[k], max_abs_err=0.0, ms=ms,
                         plain_ms=time_ms(plain_call), bound=bound(8, moved),
                         device_ms=dev_ms))
    return rows, {"calls": n_calls, "launches": j_launches, "seconds": wall,
                  "device_ms": {r["name"]: r.pop("device_ms") for r in rows}}


def cli_phase(world, built, log, mods, ate_rmse, ds_points, max_slots):
    """"[cli]": ``elimaloc_tpu_torch.cli.main`` in process on the card, each
    subcommand's wall clock printed. ``synth --seed 3 --points 131072`` at
    the headline log's length: the world bit for bit the headline world,
    the log bit for bit ``synthesize_log`` of that world with the CLI's
    arguments (seed 4 as the headline log's; the CLI keeps the generator's
    80 m range where the headline log asks 100 m, so the scans differ from
    it). ``build-map`` with its defaults (GICP: the per-point covariances)
    from every :data:`CLI_THIN`-th world point (the cut: the whole world's
    covariance build costs ~90 s on the host): every field bit for bit
    ``build_voxel_map`` of those points with the configuration's defaults.
    The world through ``write_pcd`` (binary) and ``read_pcd_points``. The
    headline BuiltMap through ``save_built_map`` is the replays' map:
    ``replay --fused --traj`` (131,072-point scans, ``--ds-points`` /
    ``--max-slots`` from this log's budgets as the headline's are sized)
    must write the TUM file, line for line, that ``run_fused`` gives on the
    pipeline of ``cli.replay_pipeline`` for the same arguments, with GICP's
    gates: applied >= 0.9, no dropped slot,
    ATE; each scan one launch of the GICP path's kernels. Then the event
    loop ``replay --metrics --viz --traj``: the files complete and finite,
    its applied share and ATE printed."""
    from elimaloc_tpu_torch import cli
    from elimaloc_tpu_torch.map import build_voxel_map, read_pcd_points, write_pcd
    from elimaloc_tpu_torch.ops import lie
    from elimaloc_tpu_torch.utils import export_trajectory_tum, load_built_map, save_built_map

    kernels, cfg_mod, runtime = mods[0], mods[5], mods[6]
    log_mod = sys.modules[type(log).__module__]
    walls, out = {}, {}

    def timed(what, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
        return r

    with tempfile.TemporaryDirectory() as d:
        paths = {k: str(Path(d) / v) for k, v in (
            ("log", "drive.npz"), ("world", "world.npy"), ("thin", "thin.npy"),
            ("map", "map.npz"),
            ("pcd", "world.pcd"), ("built", "built.npz"), ("tum", "fused.tum"),
            ("ref_tum", "run_fused.tum"), ("ev_tum", "events.tum"),
            ("metrics", "metrics.jsonl"), ("viz", "replay.html"))}
        duration = (N_SCANS + 3) * 0.1
        timed("synth", lambda: cli.main([
            "synth", "--out", paths["log"], "--map-out", paths["world"], "--seed", "3",
            "--points", str(RAW_POINTS), "--duration", repr(duration)]))
        cli_log = log_mod.ReplayLog.load(paths["log"])
        ref = log_mod.synthesize_log(world, duration=duration, points_per_scan=RAW_POINTS,
                                     seed=4)
        same = {f.name: same_array(getattr(cli_log, f.name), getattr(ref, f.name))
                for f in dataclasses.fields(ref)}
        as_headline = [f.name for f in dataclasses.fields(log)
                       if getattr(log, f.name) is not None
                       and np.array_equal(getattr(cli_log, f.name), getattr(log, f.name))]
        world_same = same_array(np.load(paths["world"]), world)
        log_line(f"[{CLI}] synth: {walls['synth']:.2f} s, {len(cli_log.scan_t)} scans x "
                 f"{cli_log.scan_points.shape[1]} points; world bit for bit the headline "
                 f"world {world_same}; log bit for bit synthesize_log(headline world, seed 4, "
                 f"{duration:.1f} s) in {sum(same.values())} of {len(same)} fields; fields "
                 f"equal to the headline log's (range 100 m, scans 1/{INDEX_SAMPLING}): "
                 f"{as_headline}")
        if not (world_same and all(same.values())):
            raise AssertionError(f"[{CLI}] synth differs: world {world_same}, log {same}")

        thin = world[::CLI_THIN]
        np.save(paths["thin"], thin)
        timed("build-map", lambda: cli.main([
            "build-map", "--points", paths["thin"], "--out", paths["map"]]))
        got = load_built_map(paths["map"])
        pcm = cfg_mod.ElimalocConfig().pcm
        t0 = time.perf_counter()
        ref_map = build_voxel_map(thin, pcm.pcm_voxel_size, pcm.pcm_voxel_max_point,
                                  compute_voxel_cov=False, compute_point_cov=True,
                                  gicp_cov_search_dist=pcm.gicp_cov_search_dist)
        ref_s = time.perf_counter() - t0
        fields = [f.name for f in dataclasses.fields(ref_map)]
        differ = [k for k in fields if not same_array(getattr(got, k), getattr(ref_map, k))]
        log_line(f"[{CLI}] build-map (its defaults: GICP, the per-point covariances) from "
                 f"every {CLI_THIN}th world point (cut from {len(world)} for the host's "
                 f"covariance build): {walls['build-map']:.2f} s for {len(thin)} points -> "
                 f"{got.num_voxels} voxels, point_cov {np.shape(got.point_cov)}; "
                 f"{len(fields) - len(differ)} of {len(fields)} fields bit for bit "
                 f"build_voxel_map of those points at the configuration's defaults "
                 f"({ref_s:.2f} s)")
        if differ or got.point_cov is None:
            raise AssertionError(f"[{CLI}] build-map differs from build_voxel_map in {differ}")

        t0 = time.perf_counter()
        write_pcd(paths["pcd"], world)
        back = read_pcd_points(paths["pcd"])
        walls["pcd"] = time.perf_counter() - t0
        pcd_ok = same_array(back, world.astype(np.float32).astype(np.float64))
        log_line(f"[{CLI}] write_pcd (binary) + read_pcd_points of the world: "
                 f"{walls['pcd']:.2f} s, {Path(paths['pcd']).stat().st_size} bytes, the float32 "
                 f"points back bit for bit {pcd_ok}")
        if not pcd_ok:
            raise AssertionError(f"[{CLI}] the PCD round trip changed the points")

        t0 = time.perf_counter()
        save_built_map(paths["built"], built)
        walls["save_built_map"] = time.perf_counter() - t0
        ds_cli, slots_cli = runtime.autosize_budgets(
            cli_log, float(cfg_mod.ElimalocConfig().pcm.input_voxel_ds_m),
            4.0 * cfg_mod.ElimalocConfig().pcm.pcm_voxel_size, qb=16)
        replay = ["replay", "--log", paths["log"], "--map", paths["built"], "--ds-points",
                  str(ds_cli), "--max-slots", str(slots_cli)]
        kernels.reset_launches()
        timed("replay --fused", lambda: cli.main([*replay, "--fused", "--traj",
                                                  paths["tum"]]))
        launches = dict(kernels.launches)
        n = len(cli_log.scan_t)
        want = loop_kernels(SHARED + (KERNEL["GICP"][0], "imu_stage") + tuple(SCAN_KERNELS),
                            GICP_LOOP)
        check_launches(f"{CLI}] [replay --fused", launches, want)
        check_loop(f"{CLI}] [replay --fused", launches, n, GICP_LOOP)

        pipe = cli.replay_pipeline(cli.parser().parse_args(replay), cli_log, built)
        _, outs = pipe.run_fused(cli_log)
        quats = lie.rot_to_quat(lie.euler_to_rot(torch.as_tensor(outs["ego_rpy"]))).numpy()
        export_trajectory_tum(paths["ref_tum"], outs["ego_t_abs"], outs["ego_pos"], quats)
        lines = Path(paths["tum"]).read_text().splitlines()
        ref_lines = Path(paths["ref_tum"]).read_text().splitlines()
        tum_equal = lines == ref_lines
        applied = float(outs["applied"].mean())
        dropped = int(np.asarray(outs["slots_dropped"]).max())
        ate = ate_rmse(outs["ego_t_abs"], outs["ego_pos"], cli_log.truth_t, cli_log.truth_pos)
        log_line(f"[{CLI}] replay --fused --traj (GICP, ds_points {ds_cli}, max_slots "
                 f"{slots_cli}; the headline's {ds_points}, {max_slots}): "
                 f"{walls['replay --fused']:.2f} s with the map's load and packing; TUM "
                 f"{len(lines)} lines, equal line for line to run_fused's on "
                 f"cli.replay_pipeline's pipeline {tum_equal}; applied {applied:.3f}, slots dropped "
                 f"{dropped}, ATE {ate:.4f} m (gate {ATE_GATE['GICP']}); launches "
                 + str({k: v for k, v in launches.items() if v}))
        if not (tum_equal and len(lines) == n and applied >= 0.9 and dropped == 0
                and ate < ATE_GATE["GICP"]):
            raise AssertionError(f"[{CLI}] replay --fused failed its gates")

        kernels.reset_launches()
        timed("replay", lambda: cli.main([
            *replay, "--metrics", paths["metrics"], "--viz", paths["viz"], "--traj",
            paths["ev_tum"]]))
        launches = dict(kernels.launches)
        check_launches(f"{CLI}] [replay", launches, want)
        check_loop(f"{CLI}] [replay", launches, n, GICP_LOOP)
        metrics = [json.loads(x) for x in Path(paths["metrics"]).read_text().splitlines()]
        tum = np.loadtxt(paths["ev_tum"], ndmin=2)
        ev_ate = ate_rmse(tum[:, 0], tum[:, 1:4], cli_log.truth_t, cli_log.truth_pos)
        ev_applied = float(np.mean([m["applied"] for m in metrics]))
        html = Path(paths["viz"]).stat().st_size
        log_line(f"[{CLI}] replay (event loop) --metrics --viz --traj: "
                 f"{walls['replay']:.2f} s; {len(metrics)} metric rows, TUM {len(tum)} "
                 f"lines, viz {html} bytes; applied {ev_applied:.3f}, ATE {ev_ate:.4f} m; "
                 f"launches " + str({k: v for k, v in launches.items() if v}))
        if not (len(metrics) == n and tum.shape == (n, 8) and np.isfinite(tum).all()
                and html > 0):
            raise AssertionError(f"[{CLI}] the event-loop replay's files are incomplete")
    log_line(f"[{CLI}] wall clocks (s): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
             + f"; card {card()}")
    out.update(walls=walls, tum_lines_equal=tum_equal, applied=applied, ate_m=ate,
               event_loop={"applied": ev_applied, "ate_m": ev_ate},
               budgets={"ds_points": ds_cli, "max_slots": slots_cli})
    return out


#: the sharded modes ("[sharding]", ``sharding_phase``): the tile methods
#: and the hash P2P path registered at frame N_SCANS // 2, four lanes of
#: P2P frames N_SCANS // 2 - 1 .. + 2, the P2P headline replay and the P2P
#: fleet's first four lanes (the headline log and the seed-5 log in turns)
SHARDING = "sharding"
SHARD_WORLD = 4
SHARD_LANES = 4
SHARD_METHODS = ("P2P", "GICP", "VGICP", "AVGICP")
SHARD_LOOPS = {"P2P": LOOP, "GICP": GICP_LOOP, "VGICP": VGICP_LOOP, "AVGICP": AVG_LOOP,
               "P2P hash": HASH_LOOP}
SHARD_SEARCH = {"P2P": "p2p_correspond", "GICP": "gicp_correspond",
                "VGICP": "vgicp_correspond", "AVGICP": "avgicp_correspond",
                "P2P hash": "hash_correspond"}
#: set before the phase first ran on a card (PERF.md §6): a sharded
#: registration against the unsharded loop kernel differs only in the f32
#: GN sums' summation order: every pose entry within SHARD_TOL a GN
#: iteration (the AVGICP loop's own bound against its plain version),
#: fitness within SHARD_TOL x max(1, |fitness|), overlap within
#: SHARD_OVERLAP_TOL (a match flipping at the search radius), iterations
#: and success equal; a sharded replay against the unsharded one under the
#: closed-loop contract (``contract``)
SHARD_TOL = 1e-4
SHARD_OVERLAP_TOL = 1e-3
#: a rank's wait in a collective and the worlds' deadline, s
SHARD_COLLECTIVE_S = 120
SHARD_DEADLINE_S = 420


def record_registrations(pipe, log, runtime, frames):
    """The (scan, valid, initial guess) of ``run_register``'s calls at the
    frame indices ``frames`` of one ``run_fused`` of ``log`` on ``pipe``
    (copies on the card)."""
    seen, calls, orig = [0], {}, runtime.run_register

    def wrapped(src, valid, tmap, guess, params, static, mark=None):
        if seen[0] in frames:
            calls[seen[0]] = (src.clone(), valid.clone(), guess.clone())
        seen[0] += 1
        return orig(src, valid, tmap, guess, params, static, mark=mark)

    runtime.run_register = wrapped
    try:
        pipe.run_fused(log)
    finally:
        runtime.run_register = orig
    return [calls[k] for k in frames]


def fresh_record(state):
    """A pipeline state whose EKF state is a new view of its record, with no
    typed field views made yet: ``torch.save`` refuses one storage seen as
    several dtypes, and a record's fields are such views."""
    from elimaloc_tpu_torch.ekf.state import RecordState

    root = state.ekf.intact_record() if isinstance(state.ekf, RecordState) else None
    return state if root is None else state.replace(ekf=RecordState(root, state.ekf.P.dtype))


def to_numpy(tree):
    """A record / dict / tuple of tensors as nested dicts of NumPy arrays."""
    if dataclasses.is_dataclass(tree):
        return {f.name: to_numpy(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def same_tree(a, b, skip=()):
    """Two :func:`to_numpy` trees equal bit for bit (keys in ``skip``
    aside)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(same_tree(a[k], b[k], skip) for k in a if k not in skip)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_tree(x, y, skip) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return same_array(a, b)
    return a == b


def sharding_rank(rank, world, backend, tmp):
    """One rank of a "[sharding]" world on cuda:0: the inputs from
    ``tmp/inputs.pt``, the meshes (sp: 1 x world, dp: world x 1, 2d: 2 x
    world / 2 or 1 x 1), every case of ``inputs["cases"]`` with its launch
    counts, collectives, wall clock and, for a registration, the first
    GN iteration's local sums beside their all-reduce; the results to
    ``tmp/<backend>-rank<r>.pt``."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous-{backend}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_COLLECTIVE_S))
    try:
        import elimaloc_tpu_torch  # noqa: F401  (pins full-f32 matmuls)
        from elimaloc_tpu_torch import kernels, parallel
        from elimaloc_tpu_torch.parallel import sharding
        from elimaloc_tpu_torch.register import icp

        inp = torch.load(Path(tmp) / "inputs.pt", map_location="cuda:0", weights_only=False)
        meshes = {"sp": sharding.make_mesh(world, dp=1),
                  "dp": sharding.make_mesh(world, dp=world),
                  "2d": sharding.make_mesh(world, dp=2 if world % 2 == 0 else 1)}
        first, psum = [], sharding.psum

        def recording_psum(t, axis, count="gn_sums"):
            local = t.clone() if count == "gn_sums" and not first else None
            out = psum(t, axis, count)
            if local is not None:
                first.append((local.cpu().numpy(), out.cpu().numpy()))
            return out

        sharding.psum = recording_psum
        results = {}
        for name, case in inp["cases"]:
            kind, a = case["kind"], case
            kernels.reset_launches()
            sharding.reset_collectives()
            first.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "point":
                out = parallel.register_sharded(a["scan"], a["valid"], a["map"], a["guess"],
                                                a["params"], a["static"], meshes["sp"])
            elif kind == "slot":
                static = dataclasses.replace(a["static"], slot_shard_axis="sp")
                with sharding.use_mesh(meshes["sp"]):
                    out = icp.run_register(a["scan"], a["valid"], a["map"], a["guess"],
                                           a["params"], static)
            elif kind in ("dp", "2d"):
                fn = parallel.register_batch_dp if kind == "dp" else parallel.register_batch_2d
                out = fn(a["scan"], a["valid"], a["map"], a["guess"], a["params"], a["static"],
                         meshes[kind])
            else:
                fn = {"replay_sp": parallel.replay_fused_sp, "replay_dp": parallel.replay_fused_dp,
                      "replay_2d": parallel.replay_fused_2d}[kind]
                out = fn(a["state"], a["batches"], a["map"], a["pp"], a["ps"],
                         meshes[kind.split("_")[1]])
            torch.cuda.synchronize()
            results[name] = {"out": to_numpy(out), "seconds": time.perf_counter() - t0,
                             "launches": {k: v for k, v in kernels.launches.items() if v},
                             "collectives": dict(sharding.collectives),
                             "first": first[0] if first else None}
        torch.save(results, Path(tmp) / f"{backend}-rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def sharding_world(tmp, world, backend, smi):
    """``world`` spawned ranks of :func:`sharding_rank` on cuda:0; their
    results, one dict a rank. A rank that fails, or a world past
    SHARD_DEADLINE_S, raises here; every rank is stopped."""
    import torch.multiprocessing as mp

    t0 = time.time()
    ctx = mp.start_processes(sharding_rank, args=(world, backend, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=2):
            if time.time() - t0 > SHARD_DEADLINE_S:
                raise TimeoutError(f"[{SHARDING}] the {world}-rank {backend} world passed "
                                   f"{SHARD_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    log_line(f"[{SHARDING}] the {world}-rank {backend} world on cuda:0: "
             f"{time.time() - t0:.2f} s wall, spawn and set-up included; card {smi}")
    return [torch.load(Path(tmp) / f"{backend}-rank{r}.pt", weights_only=False)
            for r in range(world)]


def registration_close(got, ref):
    """(within the sharded registration's bounds, the largest pose entry
    error) of a sharded result against the unsharded loop kernel's."""
    its = int(ref["iterations"])
    err = float(np.abs(got["pose"].astype(np.float64) - ref["pose"]).max())
    fit = float(ref["fitness"])
    ok = (int(got["iterations"]) == its and bool(got["success"]) == bool(ref["success"])
          and err <= SHARD_TOL * max(its, 1)
          and abs(float(got["fitness"]) - fit) <= SHARD_TOL * max(1.0, abs(fit))
          and abs(float(got["overlap"]) - float(ref["overlap"])) <= SHARD_OVERLAP_TOL)
    return ok, err


def sums_within_bound(name, res, groups):
    """The first GN iteration's all-reduced sums against the float64 sum of
    the local sums of each group of ranks that all-reduced together
    (``groups``: lists of ranks): within 4 eps x the sum of |local sums|,
    and the same bits on every rank of the group. Returns the largest error
    in units of that bound."""
    worst = 0.0
    for group in groups:
        firsts = [res[r][name]["first"] for r in group]
        local = np.stack([f[0] for f in firsts]).astype(np.float64)
        reduced = firsts[0][1]
        if not all(same_array(f[1], reduced) for f in firsts):
            raise AssertionError(f"[{SHARDING}] {name}: ranks {group}' all-reduced sums differ")
        exact, scale = local.sum(0), np.abs(local).sum(0)
        allowed = 4 * np.finfo(np.float32).eps * scale
        over = np.abs(reduced.astype(np.float64) - exact) > allowed
        if over.any():
            raise AssertionError(f"[{SHARDING}] {name}: all-reduced sums off the float64 sum "
                                 f"past 4 eps at {np.flatnonzero(over).tolist()}")
        worst = max(worst, float(np.max(np.abs(reduced - exact)
                                        / np.maximum(allowed, 1e-300))))
    return worst


def check_sharded_launches(name, res, iterations, search, lanes_launch=None):
    """Each rank's launch counts and collectives for a sharded case:
    ``iterations[r]`` GN iterations on rank r, each one launch of
    ``search`` and one of M (kernel ``gn_step``) and one all-reduce of the
    sums, no loop kernel; or with ``lanes_launch`` (the dp cases) that
    many launches of the loop kernel's lane form and no search kernel, M
    or all-reduce."""
    for r, rr in enumerate(res):
        launches, coll = rr[name]["launches"], rr[name]["collectives"]
        if lanes_launch is not None:
            loop, n = lanes_launch
            ok = (launches.get(loop) == n and not launches.get(search)
                  and not launches.get("gn_step") and coll["gn_sums"] == 0)
        else:
            its = iterations[r]
            ok = (launches.get(search) == its and launches.get("gn_step") == its
                  and coll["gn_sums"] == its
                  and not any(launches.get(k) for k in SHARD_LOOPS.values()))
        if not ok:
            raise AssertionError(f"[{SHARDING}] {name} rank {r}: launches {launches}, "
                                 f"collectives {coll}")


def sharding_phase(pipes, log, second, mods):
    """"[sharding]": the sharded modes of ``parallel/sharding.py`` on the
    card, over ``torch.distributed`` at the headline width.

    Inputs: frame N_SCANS // 2's registration (scan, valid, initial guess)
    on the P2P, GICP, VGICP, AVGICP and P2P hash pipelines, recorded on one
    ``run_fused`` each; four lanes of P2P frames 9-12; the P2P pipeline's
    reset state and the headline log's batches; the P2P fleet's first four
    lanes (the headline log and the seed-5 log in turns, ``fleet_batches``).
    The unsharded references run here: ``run_register`` (the loop kernel),
    ``run_register_lanes`` (its lane form), ``replay_fused`` and
    ``replay_fused_fleet``. The ranks get the maps, states and batches
    through one ``torch.save`` file; the kernels are already built.

    A one-rank NCCL world: every entry point at its mesh of one (sp
    ``register_sharded`` and slot-sharded ``run_register`` per method and
    on the hash grid, ``register_batch_dp``, ``register_batch_2d``,
    ``replay_fused_sp``, ``replay_fused_dp``, ``replay_fused_2d``), each
    output bit for bit the unsharded path's. A four-rank gloo world on
    cuda:0 (NCCL refuses two ranks on one card): sp = 4 and slot-sharded per
    tile method, sp = 4 on the hash grid, dp = 4 and 2 x 2 batches, sp = 4,
    dp = 4 and 2 x 2 replays. Checks: every rank's outputs bit for bit rank
    0's (a point-sharded ``dropped`` aside); dp lanes bit for bit the
    unsharded lanes; sp and 2D within SHARD_TOL / SHARD_OVERLAP_TOL
    (registrations) or the closed-loop contract (replays); the first
    iteration's all-reduced sums within 4 eps of the float64 sum of the
    ranks' sums; per rank, per GN iteration one launch of the method's
    search kernel (A, E, F, G or Q) and one of M and one all-reduce, no
    loop kernel (dp: one lane-form loop launch a registration or frame).
    Each case's wall clock is printed beside the card; these are not speed
    figures (four ranks time-share one card). Returns the slice numbers."""
    kernels, tiles, icp, runtime = mods[0], mods[3], mods[4], mods[6]
    from elimaloc_tpu_torch import parallel

    t_phase = time.time()
    smi = card()
    at = N_SCANS // 2
    paths = SHARD_METHODS + ("P2P hash",)
    dev_maps = {"P2P": pipes["P2P"].map, "GICP": pipes["P2P"].map, "VGICP": pipes["P2P"].map,
                "AVGICP": pipes["AVGICP"].map, "P2P hash": pipes["P2P hash"].map}
    # the slot axis must split max_slots into multiples of 8 (JAX's
    # _shard_slots): the budget's slots rounded up to 8 x SHARD_WORLD, the
    # unsharded references on the same budget
    old = pipes["P2P"].static.icp_static.tile_budget
    budget = tiles.TileQueryBudget(qb=old.qb, max_slots=-(-old.max_slots // (8 * SHARD_WORLD))
                                   * 8 * SHARD_WORLD)
    regs, refs = {}, {}
    for path in paths:
        pipe = pipes[path]
        frames = tuple(range(at - 1, at + SHARD_LANES - 1)) if path == "P2P" else (at,)
        calls = record_registrations(pipe, log, runtime, frames)
        scan, valid, guess = calls[1] if path == "P2P" else calls[0]
        static = dataclasses.replace(pipe.static.icp_static, tile_budget=budget)
        regs[path] = dict(scan=scan, valid=valid, guess=guess, map=dev_maps[path],
                          params=pipe.params.icp, static=static)
        refs[path] = to_numpy(icp.run_register(scan, valid, dev_maps[path], guess,
                                               pipe.params.icp, static))
        if path == "P2P":
            lanes = dict(regs[path], scan=torch.stack([c[0] for c in calls]),
                         valid=torch.stack([c[1] for c in calls]),
                         guess=torch.stack([c[2] for c in calls]))
            refs["lanes"] = to_numpy(icp.run_register_lanes(
                lanes["scan"], lanes["valid"], lanes["map"], lanes["guess"], lanes["params"],
                lanes["static"]))
    p2p = pipes["P2P"]
    state = p2p.reset()
    p2p._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = runtime.batches_to_device(runtime.build_fused_batches(log, time_base=p2p.time_base),
                                        p2p.device, p2p.dtype)
    ps = dataclasses.replace(p2p.static, icp_static=regs["P2P"]["static"])
    replay = dict(state=fresh_record(state), batches=batches, map=p2p.map, pp=p2p.params, ps=ps)
    refs["replay"] = to_numpy(runtime.replay_fused(state, batches, p2p.map, p2p.params, ps))
    _, fleet_b = runtime.fleet_batches([log, second] * (SHARD_LANES // 2))
    fleet_b = runtime.batches_to_device(fleet_b, p2p.device, p2p.dtype)
    states = parallel.stack_streams([p2p.reset() for _ in range(SHARD_LANES)])
    fleet = dict(replay, state=fresh_record(states), batches=fleet_b)
    refs["fleet"] = to_numpy(parallel.replay_fused_fleet(states, fleet_b, p2p.map, p2p.params,
                                                         ps))
    torch.cuda.synchronize()
    log_line(f"[{SHARDING}] inputs and unsharded references: {time.time() - t_phase:.2f} s "
             f"(a run_fused each on {', '.join(paths)} to record frame {at}'s registration; "
             f"max_slots {old.max_slots} -> {budget.max_slots})")

    cases = []
    for path in paths:
        cases += [(f"{path} sp", dict(regs[path], kind="point"))]
        if path != "P2P hash":
            cases += [(f"{path} slot", dict(regs[path], kind="slot"))]
    cases += [("P2P dp", dict(lanes, kind="dp")), ("P2P 2d", dict(lanes, kind="2d")),
              ("replay sp", dict(replay, kind="replay_sp")),
              ("replay dp", dict(fleet, kind="replay_dp")),
              ("replay 2d", dict(fleet, kind="replay_2d"))]
    summary = {"cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        torch.save({"cases": cases}, Path(tmp) / "inputs.pt")
        size = (Path(tmp) / "inputs.pt").stat().st_size
        log_line(f"[{SHARDING}] inputs file: {size / 2**20:.1f} MiB in "
                 f"{time.time() - t0:.2f} s")
        one = sharding_world(tmp, 1, "nccl", smi)
        four = sharding_world(tmp, SHARD_WORLD, "gloo", smi)

    def ref_of(name):
        if name.startswith("replay"):
            return refs["fleet" if name != "replay sp" else "replay"]
        return refs["lanes" if name in ("P2P dp", "P2P 2d") else name.rsplit(" ", 1)[0]]

    # the one-rank NCCL world: every entry point bit for bit the unsharded path
    for name, _ in cases:
        got = one[0][name]["out"]
        ok = same_tree(got, ref_of(name))
        summary["cases"][f"{name} nccl x1"] = {"bit_for_bit": ok,
                                               "s": round(one[0][name]["seconds"], 4)}
        log_line(f"[{SHARDING}] nccl x1 {name}: bit for bit the unsharded path {ok}; "
                 f"{one[0][name]['seconds']:.4f} s; launches {one[0][name]['launches']}; "
                 f"card {smi}")
        if not ok:
            raise AssertionError(f"[{SHARDING}] nccl x1 {name} differs from the unsharded path")

    # the four-rank gloo world on cuda:0
    for name, case in cases:
        kind = case["kind"]
        skip = ("dropped",) if kind in ("point", "2d") else ()
        if not all(same_tree(r[name]["out"], four[0][name]["out"], skip) for r in four[1:]):
            raise AssertionError(f"[{SHARDING}] gloo x4 {name}: the ranks' outputs differ")
        got, ref = four[0][name]["out"], ref_of(name)
        row = {"s": [round(r[name]["seconds"], 4) for r in four]}
        if kind in ("point", "slot"):
            path = name.rsplit(" ", 1)[0]
            ok, err = registration_close(got, ref)
            its = int(got["iterations"])
            check_sharded_launches(name, four, [its] * SHARD_WORLD, SHARD_SEARCH[path])
            row.update(within=ok, pose_err=err, iterations=its,
                       sums_err_in_bound=sums_within_bound(name, four, [range(SHARD_WORLD)]))
        elif kind == "dp":
            ok = same_tree(got, ref)
            check_sharded_launches(name, four, None, "p2p_correspond", (LOOP, 1))
            row.update(bit_for_bit=ok)
        elif kind == "2d":
            lane_ok = [registration_close({k: v[i] for k, v in got.items()},
                                          {k: v[i] for k, v in ref.items()}) for i in range(4)]
            ok = all(o for o, _ in lane_ok)
            its = got["iterations"]
            check_sharded_launches(name, four, [int(its[2 * (r // 2):2 * (r // 2) + 2].sum())
                                                for r in range(SHARD_WORLD)], "p2p_correspond")
            row.update(within=ok, pose_err=max(e for _, e in lane_ok),
                       sums_err_in_bound=sums_within_bound(
                           name, four, [range(g, g + 2) for g in range(0, SHARD_WORLD, 2)]))
        else:
            g, rf = got[1], ref[1]
            frames = int(np.asarray(rf["iterations"]).shape[-1])
            if kind == "replay_dp":
                ok = same_tree(got, ref)
                check_sharded_launches(name, four, None, "p2p_correspond", (LOOP, frames))
                row.update(bit_for_bit=ok)
            else:
                pos, rpos = g["ego_pos"].reshape(-1, frames, 3), rf["ego_pos"].reshape(-1, frames, 3)
                errs = [np.linalg.norm(pos[i].astype(np.float64) - rpos[i], axis=1)
                        for i in range(pos.shape[0])]
                ok = all(contract(e) for e in errs)
                its = np.asarray(g["iterations"]).reshape(-1, frames).sum(1)
                per_rank = ([int(its.sum())] * SHARD_WORLD if kind == "replay_sp" else
                            [int(its[2 * (r // 2):2 * (r // 2) + 2].sum())
                             for r in range(SHARD_WORLD)])
                check_sharded_launches(name, four, per_rank, "p2p_correspond")
                row.update(within=ok, ego_pos=[_stats(e) for e in errs],
                           applied=float(np.mean(g["applied"])))
        summary["cases"][f"{name} gloo x4"] = row
        log_line(f"[{SHARDING}] gloo x4 {name}: {row}; launches (rank 0) "
                 f"{four[0][name]['launches']}; card {smi}")
        if not ok:
            raise AssertionError(f"[{SHARDING}] gloo x4 {name} outside its bound: {row}")
    summary["phase_s"] = round(time.time() - t_phase, 2)
    summary["card"] = smi
    return summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    import elimaloc_tpu_torch  # noqa: F401  (pins full-f32 matmuls)
    from elimaloc_tpu_torch import config as cfg_mod
    from elimaloc_tpu_torch import deskew, kernels
    from elimaloc_tpu_torch import struct as struct_mod
    from elimaloc_tpu_torch.ekf import filter as efilter
    from elimaloc_tpu_torch.kernels import build
    from elimaloc_tpu_torch.map import builder, grid, tiles
    from elimaloc_tpu_torch.pipeline import ate_rmse, runtime
    from elimaloc_tpu_torch.pipeline import log as log_mod
    from elimaloc_tpu_torch.pipeline import rings
    from elimaloc_tpu_torch.register import icp

    t_start = time.time()
    clock = PhaseClock()
    smi = device_phase()
    clock.lap("device")
    build_phase(build)
    clock.lap("build")
    world, built, log, packed, ds_points, max_slots = make_headline(
        cfg_mod, runtime, builder, tiles, log_mod)
    clock.lap("headline world, map and log")
    mods = (kernels, deskew, grid, tiles, icp, cfg_mod, runtime, efilter, rings)
    rows, slices, deferred, pipes, fused, recs = [], {}, [], {}, {}, {}
    for path in PATHS + RADAR_PATHS + HASH_PATHS + HASH_RADAR_PATHS:
        r, slices[path], pipes[path], fused[path], recs[path] = run_path(
            path, log, packed, built, ds_points, max_slots, mods, ate_rmse, deferred)
        rows += r
        if is_radar(path):
            del pipes[path]
        torch.cuda.empty_cache()
        clock.lap(path)
    slices[FRAMES] = frames_path(pipes["GICP"], log, fused["GICP"], kernels)
    check_loop(FRAMES, kernels.launches, len(log.scan_t), GICP_LOOP)
    clock.lap(FRAMES)
    slices[EVENTS] = events_path(pipes[FUSION], log, fused[FUSION], mods, ate_rmse, deferred)
    clock.lap(EVENTS)
    r, slices[JOSEPH] = joseph_path(pipes[FUSION], log, fused[FUSION], recs[FUSION], mods)
    rows += r
    clock.lap(JOSEPH)
    r, slices[TICK] = tick_path(packed, log, ds_points, max_slots, mods, ate_rmse)
    rows += r
    clock.lap(TICK)
    slices["reloc"] = reloc_phase(pipes["P2P"], log, kernels)
    clock.lap("reloc")
    r, slices[WINDOWED] = windowed_path(built, window_log(world, log_mod), packed, mods,
                                        ate_rmse)
    rows += r
    clock.lap(WINDOWED)
    hash_kernels = loop_kernels(SHARED[:2] + ("hash_correspond",) + tuple(EKF_KERNELS)
                                + tuple(SCAN_KERNELS), HASH_LOOP)
    slices[HASH_FRAMES] = frames_path(pipes["GICP hash"], log, fused["GICP hash"], kernels,
                                      HASH_FRAMES, hash_kernels)
    check_loop(HASH_FRAMES, kernels.launches, len(log.scan_t), HASH_LOOP)
    clock.lap(HASH_FRAMES)
    slices["reloc hash"] = reloc_phase(pipes["P2P hash"], log, kernels, "reloc hash",
                                       ("voxel_downsample", HASH_LOOP))
    check_loop("reloc hash", kernels.launches, 1, HASH_LOOP)
    if any(kernels.launches[k] for k in TILE_ONLY):
        raise AssertionError(f"[reloc hash] a tile kernel ran: {kernels.launches}")
    clock.lap("reloc hash")
    r, slices[HASH_GRID] = hash_grid_phase(pipes["P2P hash"], recs["P2P hash"].calls, mods)
    rows += r
    clock.lap(HASH_GRID)
    r, slices[TILE_QUERIES] = tile_query_phase(pipes["P2P"], pipes["P2P hash"],
                                               recs["P2P hash"].calls, mods,
                                               slices[WINDOWED]["tile_queries"], deferred)
    rows += r
    clock.lap(TILE_QUERIES)
    for path in FUNCTIONAL_PATHS:
        slices[f"{FUNCTIONAL} {path}"] = functional_replay_phase(
            path, pipes[path], log, fused[path], slices[path], mods)
        clock.lap(f"{FUNCTIONAL} {path}")
    slices[LEAD] = long_lead_phase(mods, builder, log_mod)
    clock.lap(LEAD)
    fleet_mods = {"kernels": kernels, "runtime": runtime, "tiles": tiles, "icp": icp,
                  "grid": grid, "struct": struct_mod, "cfg": cfg_mod, "efilter": efilter}
    second = headline_log(world, log_mod, FLEET_SEED)
    maps = {"near": {**packed, "built": built}, "far": far_maps(built, builder, tiles)}
    fleet_recs = {}
    for path in FLEET_PATHS:
        r, slices[path], fleet_recs[path] = fleet_phase(path, log, second, maps, fleet_mods,
                                                        ate_rmse, deferred)
        rows += r
        torch.cuda.empty_cache()
        clock.lap(path)
    rows += other_lane_rows(fleet_recs, maps, fleet_mods, slices[RADAR_FLEET]["max_slots"])
    clock.lap("other lane forms")
    slices[TICK_FLEET] = small_fleet_phase(TICK_FLEET, "GICP hash+radar", 2, world, maps,
                                           fleet_mods, log_mod, use_imu=False)
    clock.lap(TICK_FLEET)
    slices[WIDE_FLEET] = small_fleet_phase(WIDE_FLEET, "GICP+radar", SMALL_WIDE_LANES, world,
                                           maps, fleet_mods, log_mod, fusion=True)
    del fleet_recs
    torch.cuda.empty_cache()
    clock.lap(WIDE_FLEET)
    slices["hash vs tile"] = hash_vs_tile(fused, slices)
    r, slices[RING_PUSHES] = ring_push_phase(mods)
    rows += r
    clock.lap(RING_PUSHES)
    slices[CLI] = cli_phase(world, built, log, mods, ate_rmse, ds_points, max_slots)
    torch.cuda.empty_cache()
    clock.lap(CLI)
    slices[SHARDING] = sharding_phase(pipes, log, second, mods)
    torch.cuda.empty_cache()
    clock.lap(SHARDING)
    # the profiler passes, after every timed replay
    for r in rows:
        if "stage_fn" in r:
            # STAGE_CALLS calls of the stage's runtime entry: its kernels alone on the
            # device (the IMU stage: H; the scan's front: T's two; the scan's
            # end: S; the tick: U; the tick mode's IMU event: V)
            fn, names = r.pop("stage_fn")
            names = names if isinstance(names, tuple) else (names,)
            per, _ = device_profile(lambda: [fn() for _ in range(STAGE_CALLS)])
            log_line(f"kernel {r['name']}: {STAGE_CALLS} calls of its runtime entry under "
                     f"torch.profiler, device kernels {per}")
            if len(per) != len(names) or not all(any(n in k for k in per) for n in names):
                raise AssertionError(f"{r['name']}: its stage launched {sorted(per)} on the "
                                     f"device, not {names} alone")
        if "device_fn" in r:
            dev = kernel_device_ms(*r.pop("device_fn"))
            chain = kernel_device_ms(r.pop("chain_fn"), "") if "chain_fn" in r else None
            label = r.pop("chain_label", "kernel L then kernel I")
            log_line(f"kernel {r['name']}: on the device alone "
                     + (f"{dev:.4f} ms" if dev else "not measured")
                     + " (torch.profiler)" + (f"; {label} {chain:.4f} ms" if chain else ""))
    clock.lap("profiler passes")
    for job in deferred:
        job()
    clock.lap("deferred checks")
    for path in PATHS + ("P2P hash",):
        slices[path]["reference"] = reference_phase(path, cfg_mod, runtime, builder,
                                                    tiles, log_mod)
    for path in RADAR_PATHS:
        slices[path]["reference"] = radar_reference_phase(path, cfg_mod, runtime, builder,
                                                          tiles, log_mod)
    slices[TICK]["reference"] = tick_reference_phase(cfg_mod, runtime, builder, tiles, log_mod)
    slices[WINDOWED]["reference"] = window_reference_phase(cfg_mod, runtime, builder, tiles,
                                                           log_mod)
    clock.lap("references")
    for r in rows:
        if "plain_check" in r:  # the lane forms against their plain lane forms
            r["max_abs_err"] = r.pop("plain_check")()
        if "plain_fn" in r:  # the plain lane forms, after every profiler pass
            r["plain_ms"] = time_ms(r.pop("plain_fn"), PLAIN_LANE_REPEATS)
            log_line(f"kernel {r['name']}: the plain lane form {r['plain_ms']:.4f} ms (median "
                     f"of {PLAIN_LANE_REPEATS}); card {card()}")
    clock.lap("plain lane forms")
    slices["clock"] = clock.laps
    log_line(f"chip_smoke: {time.time() - t_start:.1f} s; by phase (s): "
             + ", ".join(f"{k} {v:.2f}" for k, v in clock.laps.items()))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms")
    table = []
    for r in rows:
        row = {k: r[k] for k in keys}
        row["bound_ms"], row["bound_by"] = r["bound"]
        row["library_ms"] = None  # no single PyTorch call computes any of them
        if "partial_library_ms" in r:  # B, C: the library sort of their keys alone
            row["partial_library_ms"] = r["partial_library_ms"]
            row["partial_library_call"] = r["partial_library_call"]
        if "singles_ms" in r:  # a lane form: its lanes' single-lane launches one by one
            row["lanes"] = r["lanes"]
            row["single_lane_launches_ms"] = r["singles_ms"]
        table.append(row)
    log_line(json.dumps({"slices": slices, "card": smi}))
    log_line(json.dumps({"kernels": table}))
    log_line(smi)
    log_line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
