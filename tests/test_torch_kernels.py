"""The CUDA kernels of elimaloc_tpu_torch against their plain PyTorch versions.

On the CPU: a caller given CPU tensors runs the plain version — the kernel
library is never built or loaded and no launch is counted — and a kernel
wrapper given a CPU tensor raises instead of falling back.

On the card (``cuda`` marker; skipped without one): each kernel against its
plain version on the same CUDA inputs. Bounds: kernels B (assign) and C
(downsample) exact; kernel D (deskew) atol 1e-4 m at ranges up to 60 m (the
interval sum and the rotation run in another order and with FMAs); kernel
A: ``tgt``/``ok`` exactly equal (exact diff^2 sums on both sides) and JTJ /
JTr rtol 1e-4 (the f32 sums over ~1k rows are reduced in another order).
Run them on a GPU host with
``python -m pytest --noconftest tests/test_torch_kernels.py`` (tests/conftest.py
imports jax, which the GPU host does not have).
"""

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import deskew, kernels
from elimaloc_tpu_torch.kernels import build
from elimaloc_tpu_torch.map import builder, grid, tiles
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import rings
from elimaloc_tpu_torch.register import icp


@pytest.fixture(scope="module")
def scene():
    """A small map, its tile map, one scan and the deskew inputs (NumPy)."""
    world = tlog.make_world(seed=9, extent=40.0, n_ground=20_000, n_wall=10_000)
    log = tlog.synthesize_log(world, duration=0.5, points_per_scan=2048,
                              max_range=40.0, seed=10, radius=20.0)
    built = builder.build_voxel_map(world, 1.0, 30, use_native=False)
    return world, log, tiles.build_tile_map(built)


def _inputs(scene, device, dtype=torch.float32):
    world, log, host_map = scene
    rng = np.random.default_rng(41)
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    pts = t(log.scan_points[1])
    valid = t(log.scan_valid[1], torch.bool)
    rel = t(log.scan_times[1] - log.scan_times[1].min())
    ring = rings.make_ego_ring(16, dtype, device)
    tt = 0.95 + 0.01 * np.arange(16)
    ring = ring.replace(
        t=t(tt), pos=t(np.c_[20 + 8 * (tt - 0.95), np.zeros((16, 2))]),
        rpy=t(np.c_[np.zeros((16, 2)), 0.1 * tt]),
        vel_local=t(np.c_[np.full(16, 8.0), np.zeros((16, 2))]),
        gyro=t(np.c_[np.zeros((16, 2)), np.full(16, 0.1)]),
        count=torch.tensor(16, dtype=torch.int32, device=device))
    imu_t = 0.98 + 0.005 * np.arange(40)
    info = deskew.make_deskew_info(
        t(imu_t), t(rng.normal(0, 0.05, (40, 3)) + [0, 0, 0.3]),
        t(np.ones(40, bool), torch.bool), ring.t, ring.pos, ring.rpy,
        ring.vel_local, ring.gyro, ring.valid_mask(), t(1.0), t(1.1))
    tmap = host_map.to_device(device, dtype)
    pose = np.eye(4)
    pose[:3, :3] = icp.lie.so3_exp(torch.tensor([0.01, 0.0, 1.2], dtype=torch.float64)).numpy()
    pose[:3, 3] = [19.7, 0.4, 0.1]
    return dict(pts=pts, valid=valid, rel=rel, info=info, tmap=tmap, pose=t(pose),
                max_dist=t(5.0), voxel=t(1.5))


def _calls(inp, budget, out_size=1024, bug_compat_z=False):
    """One call of each kernel's caller; returns their outputs."""
    tmap = inp["tmap"]
    out = {}
    out["deskew"] = deskew.deskew_points(inp["pts"], inp["rel"], inp["valid"],
                                         inp["info"], bug_compat_z=bug_compat_z)[0]
    out["downsample"] = grid.voxel_downsample(inp["pts"], inp["valid"], inp["voxel"],
                                              out_size)
    ds, ds_valid, _ = out["downsample"]
    asg = tiles.assign_slots(tmap, icp.lie.transform_points(inp["pose"], ds),
                             ds_valid, budget)
    out["assign"] = asg
    n = ds.shape[0]
    sbuf = torch.where(asg.qmask[..., None], ds[asg.qidx.long().clamp(max=n - 1)],
                       torch.zeros((), dtype=ds.dtype, device=ds.device))
    params = icp.make_icp_params(icp.PcmConfig(), dtype=ds.dtype, device=ds.device)
    out["p2p"] = (asg, sbuf, params)
    out["p2p_sums"] = icp.p2p_search_reduce(tmap, asg.slot_tile, sbuf, asg.qmask,
                                            inp["pose"], params, budget)
    return out


def test_cpu_callers_run_plain_versions_only(scene, monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    inp = _inputs(scene, "cpu")
    budget = tiles.TileQueryBudget(qb=16, max_slots=256)
    out = _calls(inp, budget)
    assert all(v == 0 for v in kernels.launches.values()), kernels.launches
    # and what they returned is the plain versions' result
    torch.testing.assert_close(out["deskew"], deskew.deskew_points_plain(
        inp["pts"], inp["rel"], inp["valid"], inp["info"]), rtol=0, atol=0)
    ref = grid.voxel_downsample_plain(inp["pts"], inp["valid"], inp["voxel"], 1024)
    for a, b in zip(out["downsample"], ref):
        assert torch.equal(a, b)
    assert int(out["assign"].qmask.sum()) > 100


@pytest.mark.parametrize("which", ["deskew", "voxel_downsample", "assign_slots",
                                   "p2p_correspond"])
def test_kernel_wrappers_refuse_cpu_tensors(scene, which):
    inp = _inputs(scene, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        if which == "deskew":
            kernels.deskew(inp["pts"], inp["rel"], inp["valid"], inp["info"], False)
        elif which == "voxel_downsample":
            kernels.voxel_downsample(inp["pts"], inp["valid"], inp["voxel"], 64)
        elif which == "assign_slots":
            kernels.assign_slots(inp["pts"], inp["valid"], 16, 64, voxel_size=1.0,
                                 tile_size=4.0, tx0=0, ty0=0, tx_dim=4, ty_dim=4)
        else:
            s = torch.zeros(8, dtype=torch.int32)
            kernels.p2p_correspond(inp["tmap"].halo_points, s,
                                   torch.zeros(8, 16, 3), torch.zeros(8, 16, dtype=torch.bool),
                                   inp["pose"], inp["max_dist"], voxel_size=1.0,
                                   tile_size=4.0, tx0=0, ty0=0, ty_dim=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("qb,max_slots,out_size,bug_compat_z", [
    (8, 512, 1024, False), (16, 512, 1024, True), (32, 512, 1024, False),
    (16, 12, 96, True),
], ids=["qb8", "qb16_bugz", "qb32", "overflow"])
def test_kernels_match_plain_on_card(scene, cuda, qb, max_slots, out_size,
                                     bug_compat_z):
    inp = _inputs(scene, cuda)
    budget = tiles.TileQueryBudget(qb=qb, max_slots=max_slots)
    kernels.reset_launches()
    out = _calls(inp, budget, out_size, bug_compat_z)
    torch.cuda.synchronize()
    assert all(v == 1 for v in kernels.launches.values()), kernels.launches

    ref = deskew.deskew_points_plain(inp["pts"], inp["rel"], inp["valid"], inp["info"],
                                     bug_compat_z)
    torch.testing.assert_close(out["deskew"], ref, rtol=0, atol=1e-4)
    ref = grid.voxel_downsample_plain(inp["pts"], inp["valid"], inp["voxel"], out_size)
    for a, b in zip(out["downsample"], ref):
        assert torch.equal(a, b)
    ds, ds_valid, _ = out["downsample"]
    ref = tiles.assign_slots_plain(inp["tmap"], icp.lie.transform_points(inp["pose"], ds),
                                   ds_valid, budget)
    for name in ("qbuf", "qvox", "qmask", "qidx", "slot_tile", "dropped"):
        assert torch.equal(getattr(out["assign"], name), getattr(ref, name)), name

    asg, sbuf, params = out["p2p"]
    sums, tgt, ok = kernels.p2p_correspond(
        inp["tmap"].halo_points, asg.slot_tile, sbuf, asg.qmask, inp["pose"],
        params.max_search_dist, voxel_size=inp["tmap"].voxel_size,
        tile_size=inp["tmap"].tile_size, tx0=inp["tmap"].tx0, ty0=inp["tmap"].ty0,
        ty_dim=inp["tmap"].ty_dim, with_matches=True)
    matched, JTJ, JTr, fit, rtgt, rok = icp.p2p_search_reduce_plain(
        inp["tmap"], asg.slot_tile, sbuf, asg.qmask, inp["pose"], params, budget)
    assert torch.equal(ok, rok)
    assert torch.equal(tgt, rtgt)
    k_matched, k_JTJ, k_JTr, k_fit = icp.assemble_p2p(sums)
    assert int(k_matched) == int(matched) > 10
    if max_slots == 12:   # the overflow case really overflows both budgets
        assert int(out["assign"].dropped) > 0 and int(out["downsample"][2]) == out_size
    for a, b in ((k_JTJ, JTJ), (k_JTr, JTr), (k_fit, fit)):
        assert float(torch.linalg.norm(a - b)) <= 1e-4 * float(torch.linalg.norm(b))
