"""Fleet replay with CAN and GPS fusion: the lane form of kernel W's stage
(``ekf.filter.update_chain`` on a fleet state) and ``LocalizationPipeline.
run_fused_fleet`` of elimaloc_tpu_torch on AVGICP + GPS + CAN (BASELINE
config 5's fusion), against the JAX package's fleet (runtime.py:
1590-1649).

* ``update_chain_lanes_plain`` on three lanes of a P2P + GPS + CAN fleet
  frame (the ``tiny_pipe`` world at 5 Hz GPS, the frame of the first fix)
  equals three single-lane ``update_chain_plain`` calls bit for bit, with
  the fleet's padding rows (zeros, ``valid`` False) appended to every
  sub-batch and some real rows made invalid.
* float64: the AVGICP + GPS + CAN fleet of two logs on the bench_methods
  world (bench.py:562, where AVGICP converges; tests/test_torch_fusion.py's
  seven-frame case), 0.8 s at 8192 points a scan, against JAX's
  run_fused_fleet: ego_pos to 1e-6 m, ``applied``, ``iterations`` and
  ``slots_dropped`` equal; the first GPS fix (t = 0.5 s) lands inside.
* float32: the same fleet against JAX's float64 fleet under the repo's
  closed-loop contract (max < 3 cm, median < 5 mm, last 3 frames < 5 mm).
* ``cuda``-marked (skipped without a card): W's lane form on the padded
  three-lane frame: one launch, each lane bit for bit its single-lane
  launch, within 1e-4 x max(1, |plain|) of the plain lane form. The module
  imports JAX only inside its JAX fixture, so this case also runs on a
  host without JAX (``python -m pytest --noconftest -m cuda``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import kernels
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.ekf.state import EkfState
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map.tiles import TileQueryBudget as TBudget
from elimaloc_tpu_torch.parallel import stack_streams
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.struct import lane
from torch_parity import method_cfg, one_torch_thread  # noqa: F401

LANE_SEEDS = (10, 77, 5)


def _fusion_cfg(cfg_mod, method):
    cfg = method_cfg(cfg_mod, method)
    cfg.ekf.use_gps = True
    cfg.ekf.use_can = True
    return cfg


def _pad(xs):
    """A sub-batch (t, a, b, valid) [B, n, ...] with one padding row more
    per lane: zeros, ``valid`` False (fleet_batches' padding)."""
    return tuple(torch.cat([x, torch.zeros_like(x[:, :1])], dim=1) for x in xs)


def _update_scene(device="cpu"):
    """A float32 P2P + GPS + CAN pipeline, the fleet state after the frames
    before the first GPS fix and the CAN and GPS sub-batches of the fix's
    frame, padded (:func:`_pad`), with lane 1's first CAN row and lane 2's
    GPS fix made invalid."""
    world = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    logs = [tlog.synthesize_log(world, duration=0.8, points_per_scan=1024, max_range=50.0,
                                seed=seed, gps_hz=5.0) for seed in LANE_SEEDS]
    pipe = TPipeline(_fusion_cfg(tconfig, "P2P"), world, device=device, use_native=False,
                     tile_budget=TBudget(qb=8, max_slots=1024), ds_points=1024,
                     ego_ring_size=128, imu_ring_size=128)
    _, batches = truntime.fleet_batches(logs)
    frames = {k: v.transpose(0, 1).contiguous() for k, v in
              truntime.batches_to_device(batches, pipe.device, torch.float32).items()}
    fix = int(np.flatnonzero(batches["gps_valid"].any(axis=(0, 2)))[0])
    st = stack_streams([pipe.reset() for _ in logs])
    for k in range(fix):
        st, _ = truntime.fused_frame(st, {key: v[k] for key, v in frames.items()}, pipe.map,
                                     pipe.params, pipe.static)
    b = {key: v[fix] for key, v in frames.items()}
    st = truntime.imu_subbatch(st, b, pipe.params, pipe.static)
    can = _pad([b["can_t"], b["can_vel"], b["can_yaw"], b["can_valid"]])
    gps = _pad([b["gps_t"], b["gps_pos"], b["gps_cov"], b["gps_valid"]])
    can[3][1, 0] = False
    gps[3][2] = False
    assert bool(gps[3][:2].any(dim=1).all())
    return pipe, st.ekf, dict(can=can, gps=gps,
                              gnss_uncertainty_max=pipe.params.gnss_uncertainty_max)


def _rows(kw, i):
    return {k: tuple(x[i] for x in v) if k in ("can", "gps") else v for k, v in kw.items()}


def _fields(state):
    return [getattr(state, f.name) for f in dataclasses.fields(EkfState)]


def test_update_chain_lanes_plain_equals_single_lane_calls():
    pipe, ekf, kw = _update_scene()
    flags = pipe.static.ekf_flags
    got = tfilter.update_chain(ekf, pipe.params.ekf, flags, **kw)
    assert got.P.shape == (3, 27, 27)
    moved = []
    for i in range(3):
        ref = tfilter.update_chain_plain(lane(ekf, i), pipe.params.ekf, flags, **_rows(kw, i))
        for g, r in zip(_fields(got), _fields(ref)):
            assert torch.equal(g[i], r), i
        moved.append(not torch.equal(got.P[i], ekf.P[i]))
    # every lane took CAN updates; the lane without a valid fix took only those
    assert all(moved)
    assert float(got.prev_gnss_timestamp[2]) == float(ekf.prev_gnss_timestamp[2])
    assert float(got.prev_gnss_timestamp[0]) != float(ekf.prev_gnss_timestamp[0])


# --------------------------------------------------------------------------- #
# The AVGICP + GPS + CAN fleet against JAX's
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def bench_scene():
    """The bench_methods world's map (voxel covariances) and two 0.8 s logs
    of it, as NumPy, built with the JAX builder."""
    from elimaloc_tpu.map import builder as jbuilder

    world = tlog.make_world(seed=7, extent=60.0, n_ground=150_000, n_wall=80_000)
    logs = [tlog.synthesize_log(world, duration=0.8, points_per_scan=8192, max_range=60.0,
                                seed=seed, imu_noise_gyro=0.001, imu_noise_acc=0.01)
            for seed in (8, 11)]
    built = jbuilder.build_voxel_map(world, 1.0, 30, use_native=False,
                                     compute_voxel_cov=True)
    return built, logs


KW = dict(ds_points=4096, ego_ring_size=128, imu_ring_size=128)


@pytest.fixture(scope="module")
def jax_fleet(bench_scene):
    """JAX's float64 run_fused_fleet of the AVGICP + GPS + CAN pipeline."""
    import jax.numpy as jnp

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu.map import TileQueryBudget
    from elimaloc_tpu.pipeline import LocalizationPipeline

    built, logs = bench_scene
    pipe = LocalizationPipeline(_fusion_cfg(jconfig, "AVGICP"), built, dtype=jnp.float64,
                                tile_budget=TileQueryBudget(qb=8, max_slots=1024), **KW)
    _, outs = pipe.run_fused_fleet(logs)
    return {k: np.asarray(v) for k, v in outs.items()}


def _port_fleet(bench_scene, dtype):
    built, logs = bench_scene
    tbuilt = tbuilder.BuiltMap(**{k: getattr(built, k)
                                  for k in tbuilder.BuiltMap.__dataclass_fields__})
    pipe = TPipeline(_fusion_cfg(tconfig, "AVGICP"), tbuilt, device="cpu", dtype=dtype,
                     tile_budget=TBudget(qb=8, max_slots=1024), **KW)
    assert pipe.static.use_gps and pipe.static.use_can
    return pipe.run_fused_fleet(logs)[1]


def test_fusion_fleet_f64_matches_jax(bench_scene, jax_fleet):
    fleet = _port_fleet(bench_scene, torch.float64)
    assert set(fleet) == set(jax_fleet)
    for k, v in jax_fleet.items():
        assert fleet[k].shape == v.shape, k
    np.testing.assert_allclose(fleet["ego_pos"], jax_fleet["ego_pos"], rtol=0, atol=1e-6)
    for k in ("applied", "iterations", "slots_dropped", "ego_t_abs"):
        np.testing.assert_array_equal(fleet[k], jax_fleet[k], err_msg=k)
    assert fleet["applied"].mean() >= 0.9
    # a GPS fix lands in the replay (every lane's first at t = 0.5 s)
    assert float(fleet["ego_t"][0, -1]) > 0.5


def test_fusion_fleet_f32_closed_loop_contract_against_jax(bench_scene, jax_fleet):
    fleet = _port_fleet(bench_scene, torch.float32)
    for i in range(fleet["ego_pos"].shape[0]):
        err = np.linalg.norm(fleet["ego_pos"][i] - jax_fleet["ego_pos"][i], axis=1)
        assert float(np.max(err)) < 0.03, (i, err.max())
        assert float(np.median(err)) < 0.005, (i, np.median(err))
        assert float(np.max(err[-3:])) < 0.005, (i, err[-3:])
        assert fleet["applied"][i].mean() >= 0.9
        assert int(fleet["slots_dropped"][i].max()) == 0


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_can_gps_lane_form_on_card(cuda):
    """Kernel W's lane form on the padded three-lane frame: one launch,
    every lane bit for bit its single-lane launch, within 1e-4 x max(1,
    |plain|) of the plain lane form (integers and flags equal)."""
    pipe, ekf, kw = _update_scene(cuda)
    flags = pipe.static.ekf_flags
    kernels.reset_launches()
    got = tfilter.update_chain(ekf, pipe.params.ekf, flags, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["can_gps_update"] == 1 and kernels.packs["ekf_state"] == 0
    for i in range(3):
        one = tfilter.update_chain(lane(ekf, i), pipe.params.ekf, flags, **_rows(kw, i))
        for g, r in zip(_fields(got), _fields(one)):
            assert torch.equal(g[i], r), i
    ref = tfilter.update_chain_lanes_plain(ekf, pipe.params.ekf, flags, **kw)
    for g, r in zip(_fields(got), _fields(ref)):
        if g.dtype.is_floating_point:
            err = (g - r).abs() / torch.clamp(r.abs(), min=1.0)
            assert float(err.max()) <= 1e-4, float(err.max())
        else:
            assert torch.equal(g, r)
