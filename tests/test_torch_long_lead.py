"""A log whose IMU stream leads its first scan by 12 s, replayed by the
port's ``run_fused`` on the CPU against the JAX package's.

The vehicle stands still for the lead (a car switched on before its LiDAR
streams), then drives the ``tiny_pipe`` drive (tests/test_pipeline_modes.py
:22-43; four scans of 1024 points). ``build_fused_batches`` puts the lead's
1,200 samples into frame 0 and pads every frame to that count, past the
1,024 samples one launch of kernel H takes: the port runs each frame in the
ranges of ``runtime.imu_chunks`` (two a frame here), on the CPU through
``imu_subbatch_plain``. Rings of 2,048 rows hold a whole padded frame: with
rings smaller than it, one batch push keeps only the frame's last positions,
which padding fills (rings._push_arrays_batch, as JAX's), and neither package
localizes past frame 0. Float32, closed loop: the repo's contract (max
< 3 cm, median < 5 mm, last 3 frames < 5 mm), every scan applied.
"""

import numpy as np

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.pipeline import LocalizationPipeline, log as jlog
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import kernels
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import one_torch_thread, stationary_lead, tiny_cfg  # noqa: F401

LEAD_S = 12.0
RING = 2048


def test_long_lead_replay_matches_jax(monkeypatch):
    world = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = jlog.synthesize_log(world, duration=0.6, points_per_scan=1024, max_range=50.0,
                              seed=10, gps_hz=1.0)
    log = stationary_lead(log, LEAD_S, seed=11)
    n = len(log.scan_t)
    assert n >= 4 and log.scan_t[0] - log.imu_t[0] >= LEAD_S
    cap = truntime.build_fused_batches(log)["imu_t"].shape[1]
    assert cap > kernels.IMU_STAGE_MAX_SAMPLES
    kw = dict(ds_points=1024, use_native=False, ego_ring_size=RING, imu_ring_size=RING)
    jpipe = LocalizationPipeline(tiny_cfg(jconfig), world,
                                 tile_budget=TileQueryBudget(qb=8, max_slots=1024), **kw)
    _, jouts = jpipe.run_fused(log)
    ranges = []
    stage = truntime._imu_stage

    def counted(st, b, pp, ps):
        ranges.append(b["imu_t"].shape[0])
        return stage(st, b, pp, ps)

    monkeypatch.setattr(truntime, "_imu_stage", counted)
    tpipe = TPipeline(tiny_cfg(tconfig), world, device="cpu",
                      tile_budget=TBudget(qb=8, max_slots=1024), **kw)
    _, touts = tpipe.run_fused(log)
    per_frame = len(truntime.imu_chunks(cap, (RING, RING)))
    assert per_frame == -(-cap // kernels.IMU_STAGE_MAX_SAMPLES) == 2
    assert len(ranges) == n * per_frame and sum(ranges) == n * cap
    assert touts["applied"].all() and np.asarray(jouts["applied"]).all()
    err = np.linalg.norm(touts["ego_pos"] - np.asarray(jouts["ego_pos"]), axis=1)
    assert float(err.max()) < 0.03, err
    assert float(np.median(err)) < 0.005, err
    assert float(err[-3:].max()) < 0.005, err
