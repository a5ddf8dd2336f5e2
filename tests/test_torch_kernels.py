"""The CUDA kernels of elimaloc_tpu_torch against their plain PyTorch versions.

On the CPU: a caller given CPU tensors runs the plain version — the kernel
library is never built or loaded and no launch is counted — and a kernel
wrapper given a CPU tensor raises instead of falling back.

On the card (``cuda`` marker; skipped without one): each kernel against its
plain version on the same CUDA inputs. Bounds: kernels B (assign) and C
(downsample) exact, on the scene's scan and on the sort's edge inputs of
tests/sort_edges.py (one launch a call); kernel D (deskew) atol 1e-4 m at ranges up to 60 m (the
interval sum and the rotation run in another order and with FMAs); kernel
A: ``tgt``/``ok`` exactly equal (exact diff^2 sums on both sides) and JTJ /
JTr rtol 1e-4 (the f32 sums over ~1k rows are reduced in another order);
kernels E, F, G (GICP, VGICP, AVGICP): ``ok`` and the selected covariances
and means exactly equal (the same exact search, then copies), JTJ, JTr and
the fitness numerator rtol 1e-4 on the norms (the per-row 3x3 inverses and
products run with FMAs and the sums in another order); kernel H (the whole
IMU stage in one launch, per flag set and on the rings' edge cases, against
``runtime.imu_subbatch_plain``): pos / vel atol 1e-4 m, the quaternions
1e-6, each P entry within 1e-4 sqrt(P_ii P_jj) plus eight float32 ulps of
its scale before the call (the plain version's small products go through
cuBLAS, whose summation order and FMAs differ from the kernel's ordered
sums), both rings' t and count exactly, their pos / vel_local / gyro / acc
atol 1e-4 and rpy 1e-5 rad; H's packed output through I and O with no
pack, and a hot reload's parameters reaching I; kernel I (CAN, GPS
3- and 6-DOF, the PCM pose with ``apply`` true and false, and the
pipeline's one-sample CAN and GPS steps): each P entry within 1e-5
sqrt(P_ii P_jj) plus the same rounding term, every other float field of
the state within rel 1e-5 of its largest entry, the flags and counters
equal; kernel J (the ring pushes) exactly equal; kernel K (the ring queries)
masks, indices and flags equal, floats atol 1e-5 (the plain cumsum is a
parallel scan on the card, the 4x4 products go through cuBLAS); kernel L
(the PCM measurement) rel 1e-5 and ``apply`` equal; kernel M (the GN step,
on each method's sums) pose atol 1e-4, local_cov rel 1e-3 (an LU in
another order than cuSOLVER's), fitness, overlap and the flags equal;
kernel N (the window shift, over a drive of 1-, 2- and 3-tile shifts on
both axes into the map corner) every tensor bit-identical to its plain
version and to a fresh crop at the same origin; kernel O (the CA tick,
through every gate) as kernel H but P within 1e-5 sqrt(P_ii P_jj) plus the
rounding term (two sparse passes against the plain dense F P F^T through
cuBLAS); kernel P (the slot-packed radar covariances) atol 1e-5 on entries
up to ~1 (the plain transform is a cuBLAS product, the trigonometry the
same libm); the Joseph forms of H and I as their reference forms; the radar
forms of E, F, G as their plain forms (matches exactly equal, sums rtol
1e-4); kernel J with one ring left out exactly equal.
Run them on a GPU host with
``python -m pytest --noconftest tests/test_torch_kernels.py`` (tests/conftest.py
imports jax, which the GPU host does not have).
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import deskew, kernels
from elimaloc_tpu_torch.config import ElimalocConfig, GpsType, IcpMethod
from elimaloc_tpu_torch.ekf import EkfParams, EkfState, GnssMeas
from elimaloc_tpu_torch.ekf import filter as efilter
from elimaloc_tpu_torch.kernels import build
from elimaloc_tpu_torch.map import builder, grid, tiles
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import rings
from elimaloc_tpu_torch.pipeline import runtime
from elimaloc_tpu_torch.register import icp

import sort_edges

METHODS = (IcpMethod.GICP, IcpMethod.VGICP, IcpMethod.AVGICP)
#: each method's kernel wrapper (kernel E, F, G)
WRAPPER = {IcpMethod.GICP: "gicp_correspond", IcpMethod.VGICP: "vgicp_correspond",
           IcpMethod.AVGICP: "avgicp_correspond"}


@pytest.fixture(scope="module")
def scene():
    """A small map with both covariances, its tile maps at halo margins 1
    and 2, one scan and the deskew inputs (NumPy), and the BuiltMap (the
    hash grid's source)."""
    world = tlog.make_world(seed=9, extent=40.0, n_ground=20_000, n_wall=10_000)
    log = tlog.synthesize_log(world, duration=0.5, points_per_scan=2048,
                              max_range=40.0, seed=10, radius=20.0)
    built = builder.build_voxel_map(world, 1.0, 30, compute_voxel_cov=True,
                                    compute_point_cov=True, use_native=False)
    return world, log, {m: tiles.build_tile_map(built, halo_margin=m) for m in (1, 2)}, built


def _inputs(scene, device, dtype=torch.float32):
    world, log, host_maps = scene[:3]
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
    tmap = host_maps[1].to_device(device, dtype)
    tmap2 = host_maps[2].to_device(device, dtype)
    pose = np.eye(4)
    pose[:3, :3] = icp.lie.so3_exp(torch.tensor([0.01, 0.0, 1.2], dtype=torch.float64)).numpy()
    pose[:3, 3] = [19.7, 0.4, 0.1]
    return dict(pts=pts, valid=valid, rel=rel, info=info, tmap=tmap, tmap2=tmap2,
                pose=t(pose), max_dist=t(5.0), voxel=t(1.5))


def _method_map(inp, method):
    """AVGICP runs on the halo margin 2 map, the other methods on margin 1."""
    return inp["tmap2"] if method == IcpMethod.AVGICP else inp["tmap"]


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
    for method in (IcpMethod.P2P,) + METHODS:
        args = (int(method), _method_map(inp, method), asg.slot_tile, sbuf, asg.qmask,
                inp["pose"], params)
        if sbuf.device.type == "cpu":
            out[method] = icp.search_reduce(*args, budget)
        else:
            assemble = icp.assemble_p2p if method == IcpMethod.P2P else icp.assemble_gn
            out[method] = assemble(icp.search_sums(*args))
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
    asg, sbuf, params = out["p2p"]
    for method in (IcpMethod.P2P,) + METHODS:
        ref = icp._PLAIN[int(method)](_method_map(inp, method), asg.slot_tile, sbuf,
                                      asg.qmask, inp["pose"], params, budget)
        for a, b in zip(out[method], ref):
            assert torch.equal(a, b), method
        assert int(out[method][0]) > 100, method


def test_launch_counters_name_all_seven_kernels():
    """Every kernel's counter: A-G, the EKF kernels H (the whole IMU stage)
    and I, the scan-time ring ops and GN step J, K, L, M, the window shift N,
    the CA tick O, the radar covariances P, the hash grid's Q (its fused,
    query and lookup entries), the ground probe R, the P2P loop kernel (A
    and M in one launch), the scan's end S (L and I's PCM leg in one
    launch), the scan's front T (the gate, the scan times, K and D in
    one host call), the GICP, VGICP, AVGICP and hash loop kernels (E, F,
    G or Q with M in one launch) and the tick mode's U (O's tick and J's
    ego push in one launch) and V (its IMU intake), W and X (I's CAN and
    GPS legs and P, redesigned), and Y and Z (Q's query entry and R,
    redesigned); the record packs apart."""
    assert sorted(kernels.packs) == ["ekf_params", "ekf_state"]
    assert sorted(kernels.launches) == sorted([
        "p2p_register", "p2p_correspond", "assign_slots", "voxel_downsample", "deskew",
        "gicp_correspond", "vgicp_correspond", "avgicp_correspond", "imu_stage",
        "ekf_update", "ring_push", "scan_ring_query", "scan_front", "pcm_measurement",
        "pcm_stage",
        "gn_step", "shift_window", "ca_tick", "radar_cov", "hash_correspond", "hash_query",
        "hash_lookup", "ground_height", "gicp_register", "vgicp_register", "avgicp_register",
        "hash_register", "tick_stage", "imu_intake", "can_gps_update", "radar_rows",
        "grid_query", "ground_probe"])


def test_ekf_field_tables_match_the_records_and_the_kernels():
    """The packed records' layouts (ekf/state.py) are csrc/ekf.cuh's: every
    EkfState field once, at the byte offsets of ``kRecordOffsets`` in the
    record of ``kRecordBytes``, and every EkfParams field at the float
    offset of its ``Param`` enumerator in a record of ``kParamWords``."""
    from elimaloc_tpu_torch.ekf import state as estate

    assert [f[0] for f in kernels.EKF_FIELDS] == [
        f.name for f in dataclasses.fields(EkfState)]
    assert sorted(f[0] for f in estate.RECORD_FIELDS) == sorted(
        f.name for f in dataclasses.fields(EkfState))
    assert [f[0] for f in estate.PARAM_FIELDS] == [
        f.name for f in dataclasses.fields(EkfParams)]
    src = (build.SRC_DIR / "ekf.cuh").read_text()
    lay = estate.record_layout(torch.float32)
    offsets = re.search(r"kRecordOffsets\[\] = \{([^}]*)\}", src).group(1)
    assert [int(v) for v in offsets.split(",")] == [off for _, off, _, _ in lay.fields]
    assert int(re.search(r"constexpr int kRecordBytes = (\d+);", src).group(1)) == lay.nbytes
    body = re.search(r"enum Param \{([^}]*)\}", src).group(1)
    enum = dict((k.strip(), int(v)) for k, v in (e.split("=") for e in body.split(",")))
    assert enum.pop("kParamWords") == estate.PARAM_WORDS
    off, want = 0, []
    for _, shape in estate.PARAM_FIELDS:
        want.append(off)
        off += int(np.prod(shape))
    assert list(enum.values()) == want and off <= estate.PARAM_WORDS


def _ekf_inputs(device, dtype=torch.float32, flags="default"):
    """A filter past initialization (moving at 5 m/s with a tight P, or
    stationary for ZUPT), one frame's IMU budget (an invalid sample, two of
    padding, a repeated stamp), and one frame's CAN, GPS and PCM inputs."""
    rng = np.random.default_rng(31)
    cfg = ElimalocConfig()
    kw = {"zupt": dict(use_zupt=True), "calibration": dict(imu_estimate_calibration=True),
          "no_gravity": dict(imu_estimate_gravity=False),
          "no_cf": dict(use_complementary_filter=False), "default": {},
          "odometry": dict(gps_type=GpsType.ODOMETRY)}[flags]
    for k, v in kw.items():
        setattr(cfg.ekf, k, v)
    pp = runtime.make_pipeline_params(cfg, dtype=dtype, device=device)
    ps = runtime.make_pipeline_static(cfg)
    f = lambda a, dt=dtype: torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    # calibration runs only once rotation is stabilized (std < 0.2 deg)
    a = rng.normal(size=(27, 27)) * (1e-4 if flags == "calibration" else 1e-3)
    q = np.array([1.0, 0.01, -0.02, 0.3])
    still = flags == "zupt"
    st = efilter.init_state(pp.ekf, dtype=dtype).replace(
        P=f(a @ a.T + np.eye(27) * 1e-6), rot=f(q / np.linalg.norm(q)),
        pos=f([60.0, 2.0, 0.1]), vel=f([0.02, -0.01, 0.0] if still else [4.0, 3.0, 0.0]),
        state_initialized=f(True, torch.bool), yaw_initialized=f(True, torch.bool),
        prev_timestamp=f(1.0), prev_can_timestamp=f(1.0))
    n = 12
    ts = 1.0 + 0.01 * np.arange(1, n + 1)
    ts[7] = ts[6]
    if still:
        acc = rng.normal(0, 0.01, (n, 3)) + [0.0, 0.0, 9.81]
        gyro = np.zeros((n, 3))
    else:
        acc = rng.normal(0, 0.3, (n, 3)) + [0.5, 0.1, 9.81]
        gyro = rng.normal(0, 0.05, (n, 3)) + [0.0, 0.0, 0.13]
    valid = np.ones(n, bool)
    valid[[4, 10, 11]] = False
    ts[-2:], acc[-2:], gyro[-2:] = 0.0, 0.0, 0.0
    imu = (f(ts), f(acc), f(gyro), f(valid, torch.bool))
    can = (f([1.005, 1.02, 1.04, 1.06, 0.0]), f([5.1, 5.0, 0.03, 4.9, 0.0]),
           f([0.13, 0.12, 0.002, 0.11, 0.0]), f([True, True, True, True, False], torch.bool))
    gps = (f([1.05]), f([[60.2, 1.7, 0.1]]), f([[0.3, 0.3, 0.3]]), f([True], torch.bool))
    qm = np.array([1.0, 0.012, -0.021, 0.31])
    b = rng.normal(size=(3, 3)) * 0.05
    meas = GnssMeas(timestamp=f(1.1), source=3, pos=f([60.3, 2.1, 0.12]),
                    rot=f(qm / np.linalg.norm(qm)), pos_cov=f(b @ b.T + 0.01 * np.eye(3)),
                    rot_cov=f(np.eye(3) * 1e-4))
    return st, pp, ps.ekf_flags, imu, can, gps, meas


@pytest.mark.parametrize("which", ["imu_chain", "ekf_update"])
def test_ekf_callers_run_the_joseph_form_plain_on_cpu(which, monkeypatch):
    """With ``joseph_form`` a CPU caller runs the plain Joseph form (no
    kernel library, no launch): P comes out symmetric to rounding and not
    equal to the reference form's (tests/test_torch_joseph.py holds it to
    the JAX package)."""
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_library)
    st, pp, flags, imu, can, gps, meas = _ekf_inputs("cpu", flags="calibration")
    joseph = dataclasses.replace(flags, joseph_form=True)
    kernels.reset_launches()
    if which == "imu_chain":
        pst = runtime.PipelineState(ekf=st, ego_ring=rings.make_ego_ring(8),
                                    imu_ring=rings.make_imu_ring(8))
        b = dict(zip(("imu_t", "imu_acc", "imu_gyro", "imu_valid"), imu))
        ps = runtime.make_pipeline_static(ElimalocConfig())
        got = runtime.imu_subbatch(pst, b, pp, dataclasses.replace(ps, ekf_flags=joseph)).ekf
        ref = runtime.imu_subbatch(pst, b, pp, dataclasses.replace(ps, ekf_flags=flags)).ekf
    else:
        kw = dict(can=can, gps=gps, gnss_uncertainty_max=pp.gnss_uncertainty_max,
                  pcm=(meas, torch.tensor(True)))
        got = efilter.update_chain(st, pp.ekf, joseph, **kw)
        ref = efilter.update_chain(st, pp.ekf, flags, **kw)
    assert all(v == 0 for v in kernels.launches.values()), kernels.launches
    assert float((got.P - got.P.T).abs().max()) <= 1e-6 * float(got.P.abs().max())
    assert not torch.equal(got.P, ref.P)
    assert _p_entry_err(got.P, ref.P, st.P, 1e-3) <= 1.0


@pytest.mark.parametrize("which", ["deskew", "voxel_downsample", "assign_slots",
                                   "p2p_register", "p2p_correspond", "gicp_correspond",
                                   "vgicp_correspond", "avgicp_correspond", "imu_stage",
                                   "ekf_update", "ring_push", "scan_ring_query",
                                   "pcm_measurement", "gn_step", "shift_window", "ca_tick",
                                   "radar_cov", "hash_correspond", "hash_query",
                                   "hash_lookup", "ground_height", "tick_stage",
                                   "imu_intake", "can_gps_update", "radar_rows",
                                   "grid_query", "ground_probe"])
def test_kernel_wrappers_refuse_cpu_tensors(scene, which):
    if which in ("hash_correspond", "hash_query", "hash_lookup", "ground_height",
                 "grid_query", "ground_probe"):
        g = grid.to_device(scene[3], "cpu")
        q = torch.zeros(16, 3)
        with pytest.raises(ValueError, match="CUDA tensor required"):
            if which == "hash_correspond":
                kernels.hash_correspond(g, q, torch.ones(16, dtype=torch.bool), torch.eye(4),
                                        torch.tensor(1.0), "GICP")
            elif which in ("hash_query", "grid_query"):
                getattr(kernels, which)(g, q, 1.0, "AVGICP")
            elif which == "hash_lookup":
                kernels.hash_lookup(g, torch.zeros(16, 3, dtype=torch.int32))
            elif which == "ground_probe":
                kernels.ground_probe(g, (0.0, 0.0), 5.0, 5)
            else:
                kernels.ground_height(g.points, (0.0, 0.0), 5.0, 5)
        return
    if which in ("ring_push", "scan_ring_query", "pcm_measurement", "gn_step"):
        with pytest.raises(ValueError, match="CUDA tensor required"):
            if which == "ring_push":
                kernels.ring_push(*_push_inputs("cpu", "append"))
            elif which == "scan_ring_query":
                kernels.scan_ring_query(*_query_inputs("cpu", "inside"), 64, True)
            elif which == "pcm_measurement":
                res, tf, ring, end, usable = _measurement_inputs("cpu", "gicp_cov")
                kernels.pcm_measurement(res.pose, tf, res.local_cov, res.fitness,
                                        res.success, usable, ring, end, True)
            else:
                params = icp.make_icp_params(icp.PcmConfig())
                kernels.gn_step(torch.zeros(18), torch.eye(4), torch.zeros(()),
                                torch.eye(6), torch.ones(()), params, False)
        return
    if which in ("imu_stage", "ekf_update", "ca_tick", "tick_stage", "imu_intake",
                 "can_gps_update"):
        st, pp, flags, imu, can, *_ = _ekf_inputs("cpu")
        with pytest.raises(ValueError, match="CUDA tensor required"):
            if which == "imu_stage":
                kernels.imu_stage(st, rings.make_ego_ring(8), rings.make_imu_ring(8), *imu,
                                  pp.ego_to_imu_rot, pp.ego_to_imu_trans, pp.ekf, flags)
            elif which == "ca_tick":
                kernels.ca_tick(st, torch.tensor(1.01), pp.ekf)
            elif which == "tick_stage":
                kernels.tick_stage(st, torch.tensor(1.01), pp.ekf, rings.make_ego_ring(8))
            elif which == "imu_intake":
                kernels.imu_intake(rings.make_imu_ring(8), imu[0][0], imu[1][0], imu[2][0],
                                   pp.ego_to_imu_rot)
            elif which == "can_gps_update":
                kernels.can_gps_update(st, pp.ekf, flags, can=can[:3] + (None,))
            else:
                kernels.ekf_update(st, pp.ekf, flags, can=can)
        return
    if which in ("radar_cov", "radar_rows"):
        params = icp.make_icp_params(icp.PcmConfig())
        with pytest.raises(ValueError, match="CUDA tensor required"):
            getattr(kernels, which)(torch.zeros(16, 3), torch.zeros(2, 8, dtype=torch.int32),
                                    torch.ones(2, 8, dtype=torch.bool), torch.eye(4), params)
        return
    inp = _inputs(scene, "cpu")
    tm = inp["tmap"]
    if which == "shift_window":
        base = {f: getattr(tm, f) for f in tiles.HALO_FIELDS}
        payload = {f: None if a is None else a[:4] for f, a in base.items()}
        with pytest.raises(ValueError, match="CUDA tensor required"):
            kernels.shift_window(base, tm.tx_dim, tm.ty_dim, 1, 0,
                                 torch.zeros(4, dtype=torch.int32), payload)
        return
    s = torch.zeros(8, dtype=torch.int32)
    slot_args = (s, torch.zeros(8, 16, 3), torch.zeros(8, 16, dtype=torch.bool),
                 inp["pose"], inp["max_dist"])
    geo = dict(voxel_size=1.0, tile_size=4.0, tx0=0, ty0=0, ty_dim=4)
    with pytest.raises(ValueError, match="CUDA tensor required"):
        if which == "gicp_correspond":
            kernels.gicp_correspond(tm.halo_points, tm.halo_point_cov,
                                    tm.halo_point_cov_mean, *slot_args, **geo)
        elif which == "vgicp_correspond":
            kernels.vgicp_correspond(tm.halo_vox_mean, tm.halo_vox_cov,
                                     tm.halo_vox_coord, *slot_args, **geo)
        elif which == "avgicp_correspond":
            kernels.avgicp_correspond(tm.halo_vox_mean, tm.halo_vox_cov,
                                      tm.halo_vox_coord, *slot_args, voxel_size=1.0)
        elif which == "deskew":
            kernels.deskew(inp["pts"], inp["rel"], inp["valid"], inp["info"], False)
        elif which == "voxel_downsample":
            kernels.voxel_downsample(inp["pts"], inp["valid"], inp["voxel"], 64)
        elif which == "assign_slots":
            kernels.assign_slots(inp["pts"], inp["valid"], 16, 64, voxel_size=1.0,
                                 tile_size=4.0, tx0=0, ty0=0, tx_dim=4, ty_dim=4)
        elif which == "p2p_register":
            params = icp.make_icp_params(icp.PcmConfig())
            kernels.p2p_register(inp["tmap"].halo_points, *slot_args[:4], torch.zeros(()),
                                 torch.eye(6), torch.ones(()), params, 10, **geo)
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
    # each scan-path kernel once (the EKF kernels H and I, and J, K, L, M,
    # are not called here)
    assert all(v == (k in ("deskew", "voxel_downsample", "assign_slots", "p2p_correspond",
                           "gicp_correspond", "vgicp_correspond", "avgicp_correspond"))
               for k, v in kernels.launches.items()), kernels.launches

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
    for a, b in zip(out[IcpMethod.P2P], (k_matched, k_JTJ, k_JTr, k_fit)):
        assert torch.equal(a, b)

    for method in METHODS:
        tm = _method_map(inp, method)
        geo = dict(voxel_size=tm.voxel_size)
        if method == IcpMethod.GICP:
            rows = (tm.halo_points, tm.halo_point_cov, tm.halo_point_cov_mean)
        else:
            rows = (tm.halo_vox_mean, tm.halo_vox_cov, tm.halo_vox_coord)
        if method != IcpMethod.AVGICP:
            geo.update(tile_size=tm.tile_size, tx0=tm.tx0, ty0=tm.ty0, ty_dim=tm.ty_dim)
        sums, cov, mean, ok = getattr(kernels, WRAPPER[method])(
            *rows, asg.slot_tile, sbuf, asg.qmask, inp["pose"], params.max_search_dist,
            **geo, with_matches=True)
        ref = icp._PLAIN[int(method)](tm, asg.slot_tile, sbuf, asg.qmask, inp["pose"],
                                      params, budget)
        assert torch.equal(ok, ref[6]), method
        assert torch.equal(cov, ref[4]), method
        assert torch.equal(mean, ref[5]), method
        got = icp.assemble_gn(sums)
        assert int(got[0]) == int(ref[0]) > 10, method
        for a, b in zip(got[1:], ref[1:4]):
            assert float(torch.linalg.norm(a - b)) <= 1e-4 * float(torch.linalg.norm(b)), method
        # and the caller's dispatch launched this same kernel on the main path
        for a, b in zip(out[method], got):
            assert torch.equal(a, b), method


def _rel(a, b):
    """max |a - b| over the largest |b| (1 for an all-zero b)."""
    scale = float(b.abs().max()) or 1.0
    return float((a.double() - b.double()).abs().max()) / scale


def _p_entry_err(got, ref, prior, tol):
    """P's error as a share of its limit (at most 1 passes): max over (i, j)
    of |got_ij - ref_ij| / (tol sqrt(ref_ii ref_jj) + 8 eps sqrt(prior_ii
    prior_jj)). Each entry is held to its own variances; the second term is
    the rounding P -= K H P leaves on an entry whose variance an update
    collapses (the 6-DOF fix has zero rotation noise), eight float32 ulps of
    the entry's scale before the call."""
    def scale(p):
        d = torch.sqrt(torch.diagonal(p).double().clamp(min=0.0))
        return d[:, None] * d[None, :]

    limit = tol * scale(ref) + 8 * torch.finfo(torch.float32).eps * scale(prior)
    return float(((got.double() - ref.double()).abs() / limit.clamp(min=1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sort_edges.DOWNSAMPLE_CASES)
def test_voxel_downsample_edges_match_plain_on_card(cuda, case):
    """Kernel C, one launch a call, bit for bit on the sort's edge inputs."""
    p, valid, voxel, out_size = sort_edges.downsample_cases()[case]
    pts = torch.as_tensor(p, dtype=torch.float32, device=cuda)
    ok = torch.as_tensor(valid, device=cuda)
    kernels.reset_launches()
    got = grid.voxel_downsample(pts, ok, voxel, out_size)
    torch.cuda.synchronize()
    assert kernels.launches["voxel_downsample"] == 1 == sum(kernels.launches.values())
    for a, b in zip(got, grid.voxel_downsample_plain(pts, ok, voxel, out_size)):
        assert torch.equal(a, b), case


@pytest.mark.cuda
@pytest.mark.parametrize("case", sort_edges.ASSIGN_CASES)
def test_assign_slots_edges_match_plain_on_card(cuda, case):
    """Kernel B, one launch a call, bit for bit on the sort's edge inputs
    (the 257 x 257 grid: per-tile tables in global scratch, 3 passes)."""
    q, valid, geo, qb, slots = sort_edges.assign_cases()[case]
    tm = tiles.TileMap(halo_points=torch.zeros((1, 1, 3), device=cuda),
                       voxel_size=sort_edges.VOXEL, tile_size=sort_edges.TILE,
                       origin=torch.zeros(2, device=cuda), **geo)
    qs = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    ok = torch.as_tensor(valid, device=cuda)
    budget = tiles.TileQueryBudget(qb=qb, max_slots=slots)
    kernels.reset_launches()
    got = tiles.assign_slots(tm, qs, ok, budget)
    torch.cuda.synchronize()
    assert kernels.launches["assign_slots"] == 1 == sum(kernels.launches.values())
    ref = tiles.assign_slots_plain(tm, qs, ok, budget)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), (case, f.name)


#: ring cases of kernel H's pushes: the ego and IMU rings' capacities, then
#: (count, first time) of each (None: empty rings); the frame's 12 samples
#: are more than the smaller rings hold
STAGE_RINGS = {"append": (16, 8, None), "fill_and_roll": (16, 8, ((16, 0.8), (8, 0.9))),
               "regress_clears": (16, 8, ((10, 1.5), (5, 1.5))),
               "longer_than_ring": (8, 4, ((3, 0.9), (2, 0.9)))}


def _stage_inputs(device, flags="default", joseph=False, rings_case="append"):
    """A pipeline state (the filter of ``_ekf_inputs``, rings per
    ``rings_case``), the frame's raw IMU batch and an ego-to-IMU
    calibration with a rotation and a lever arm."""
    st, pp, eflags, imu, *_ = _ekf_inputs(device, flags=flags)
    eflags = dataclasses.replace(eflags, joseph_form=joseph)
    rng = np.random.default_rng(5)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    rot = icp.lie.euler_to_rot(torch.tensor([0.01, -0.005, 0.02], dtype=torch.float64))
    pp = pp.replace(ego_to_imu_rot=f(rot.numpy()), ego_to_imu_trans=f([0.2, 0.0, 0.1]))
    re, ri, fill = STAGE_RINGS[rings_case]
    ego = rings.make_ego_ring(re, device=device)
    imu_ring = rings.make_imu_ring(ri, device=device)
    if fill is not None:
        (ce, te), (ci, ti) = fill
        rows = lambda n: f(rng.normal(size=(n, 3)))  # noqa: E731
        ego = ego.replace(t=f(te + 0.01 * np.arange(re)), pos=rows(re), rpy=rows(re),
                          vel_local=rows(re), gyro=rows(re),
                          count=torch.tensor(ce, dtype=torch.int32, device=device))
        imu_ring = imu_ring.replace(t=f(ti + 0.01 * np.arange(ri)), gyro=rows(ri), acc=rows(ri),
                                    count=torch.tensor(ci, dtype=torch.int32, device=device))
    pst = runtime.PipelineState(ekf=st, ego_ring=ego, imu_ring=imu_ring)
    b = dict(zip(("imu_t", "imu_acc", "imu_gyro", "imu_valid"), imu))
    ps = dataclasses.replace(runtime.make_pipeline_static(ElimalocConfig()), ekf_flags=eflags)
    return pst, b, pp, ps


def _check_stage(got, ref, prior):
    """Kernel H's gates against its plain composition: pos / vel 1e-4 m, the
    quaternions 1e-6, P within its share of 1e-4 sqrt(P_ii P_jj) plus the
    rounding term, flags and counters equal; the rings' t and count
    exactly, their fields within the history gates (pos, vel_local, gyro,
    acc 1e-4, rpy 1e-5 rad)."""
    for name in ("pos", "vel"):
        torch.testing.assert_close(getattr(got.ekf, name), getattr(ref.ekf, name), rtol=0,
                                   atol=1e-4)
    for name in ("rot", "imu_rot"):
        torch.testing.assert_close(getattr(got.ekf, name), getattr(ref.ekf, name), rtol=0,
                                   atol=1e-6)
    assert _p_entry_err(got.ekf.P, ref.ekf.P, prior.P, 1e-4) <= 1.0
    for f, dt, _ in kernels.EKF_FIELDS:
        if dt != torch.float32:
            assert torch.equal(getattr(got.ekf, f), getattr(ref.ekf, f)), f
    for ring, atol in (("ego_ring", dict(pos=1e-4, rpy=1e-5, vel_local=1e-4, gyro=1e-4)),
                       ("imu_ring", dict(gyro=1e-4, acc=1e-4))):
        a, b = getattr(got, ring), getattr(ref, ring)
        assert torch.equal(a.t, b.t) and torch.equal(a.count, b.count), ring
        for f, tol in atol.items():
            torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["default", "zupt", "calibration", "no_gravity", "no_cf"])
def test_imu_chain_matches_plain_on_card(cuda, flags):
    """Kernel H, the frame's whole IMU stage in one launch, against its plain
    composition ``runtime.imu_subbatch_plain`` on the same raw samples."""
    pst, b, pp, ps = _stage_inputs(cuda, flags)
    kernels.reset_launches()
    got = runtime.imu_subbatch(pst, b, pp, ps)
    torch.cuda.synchronize()
    assert kernels.launches["imu_stage"] == 1 == sum(kernels.launches.values())
    ref = runtime.imu_subbatch_plain(pst, b, pp, ps)
    _check_stage(got, ref, pst.ekf)
    if flags == "zupt":
        assert not torch.equal(got.ekf.ba, pst.ekf.ba)
    if flags == "calibration":
        assert bool(got.ekf.vehicle_imu_calib_started)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fill_and_roll", "regress_clears", "dedupe", "none_valid",
                                  "one_sample", "longer_than_ring"])
def test_imu_stage_ring_edges_match_plain_on_card(cuda, case):
    """Kernel H's pushes on the rings' edge cases: a ring that fills and
    rolls, a time regression at the first valid sample (clear), duplicate
    and near-duplicate stamps (the ego ring's 1e-5 dedupe), a frame with no
    valid sample, one sample with ``valid`` None (``imu_step``), and more
    samples than either ring holds."""
    pst, b, pp, ps = _stage_inputs(cuda, rings_case=case if case in STAGE_RINGS else "append")
    if case == "dedupe":
        t = b["imu_t"].clone()
        t[2], t[3] = t[1], t[1] + 5e-6
        b["imu_t"] = t
    elif case == "none_valid":
        b["imu_valid"] = torch.zeros_like(b["imu_valid"])
    elif case == "one_sample":
        b = {k: None if v.dtype == torch.bool else v[:1] for k, v in b.items()}
    kernels.reset_launches()
    got = runtime.imu_subbatch(pst, b, pp, ps)
    torch.cuda.synchronize()
    assert kernels.launches["imu_stage"] == 1 == sum(kernels.launches.values())
    _check_stage(got, runtime.imu_subbatch_plain(pst, b, pp, ps), pst.ekf)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["frames", "events"])
def test_imu_stage_chains_its_own_outputs_on_card(cuda, loop):
    """Kernel H fed its own outputs (the state and the rings it made, taken
    back by identity), frame after frame or one IMU event after another:
    each launch against the plain composition on the same input, the
    rings' old rows included."""
    pst, b, pp, ps = _stage_inputs(cuda, rings_case="fill_and_roll")
    got = pst
    for step in range(4 if loop == "frames" else 12):
        if loop == "frames":
            bs = {**b, "imu_t": b["imu_t"] + 0.12 * step}
        else:
            k = step % 10
            bs = {"imu_t": b["imu_t"][k:k + 1] + 0.12 * (step // 10),
                  "imu_acc": b["imu_acc"][k:k + 1], "imu_gyro": b["imu_gyro"][k:k + 1],
                  "imu_valid": None}
        kernels.reset_launches()
        nxt = runtime.imu_subbatch(got, bs, pp, ps)
        assert kernels.launches["imu_stage"] == 1 and not any(kernels.packs.values()) or \
            step == 0
        _check_stage(nxt, runtime.imu_subbatch_plain(got, bs, pp, ps), got.ekf)
        got = nxt


@pytest.mark.cuda
def test_packed_states_flow_through_kernels_h_i_o_on_card(cuda):
    """One pack where a state is built field by field, none after: kernel H's
    packed output goes into kernels I and O as it is, each one launch and
    each against its plain version on that packed state."""
    pst, b, pp, ps = _stage_inputs(cuda)
    _, _, flags, _, can, gps, meas = _ekf_inputs(cuda)
    kernels.reset_launches()
    st = runtime.imu_subbatch(pst, b, pp, ps)
    assert kernels.packs["ekf_state"] == 1
    from elimaloc_tpu_torch.ekf import state as estate

    assert estate.state_record(st.ekf) is not None
    kw = dict(can=can, gps=gps, gnss_uncertainty_max=pp.gnss_uncertainty_max,
              pcm=(meas, torch.tensor(True, device=cuda)))
    upd = efilter.update_chain(st.ekf, pp.ekf, flags, **kw)
    tick, _ = kernels.ca_tick(upd, torch.tensor(1.2, device=cuda), pp.ekf)
    torch.cuda.synchronize()
    assert kernels.packs == {"ekf_state": 1, "ekf_params": 0}
    assert (kernels.launches["imu_stage"], kernels.launches["ekf_update"],
            kernels.launches["ca_tick"]) == (1, 1, 1)
    ref = efilter.update_chain_plain(st.ekf, pp.ekf, flags, **kw)
    assert _p_entry_err(upd.P, ref.P, st.ekf.P, 1e-5) <= 1.0
    for f in ("pos", "vel", "rot"):
        assert _rel(getattr(upd, f), getattr(ref, f)) <= 1e-5, f
    ref, _ = efilter.ca_tick_plain(upd, torch.tensor(1.2, device=cuda), pp.ekf)
    assert _p_entry_err(tick.P, ref.P, upd.P, 1e-5) <= 1.0
    torch.testing.assert_close(tick.pos, ref.pos, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_hot_reload_reaches_kernel_i_on_card(cuda):
    """A value-only reload (a new params record) changes the CAN gain of
    ``update_chain`` on the card (kernel W) as it changes the plain
    version's."""
    st, pp, flags, _, can, *_ = _ekf_inputs(cuda)
    cfg = ElimalocConfig()
    cfg.ekf.can_meas_uncertainty_vel_mps *= 0.01
    pp2 = runtime.make_pipeline_params(cfg, device=cuda)
    a = efilter.update_chain(st, pp.ekf, flags, can=can)
    b = efilter.update_chain(st, pp2.ekf, flags, can=can)
    assert float((a.vel - b.vel).abs().max()) > 1e-3
    for got, params in ((a, pp.ekf), (b, pp2.ekf)):
        ref = efilter.update_chain_plain(st, params, flags, can=can)
        assert _rel(got.vel, ref.vel) <= 1e-5
        assert _p_entry_err(got.P, ref.P, st.P, 1e-5) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["can", "gps3", "gps6", "pcm", "pcm_skipped", "frame"])
def test_ekf_update_matches_plain_on_card(cuda, case):
    st, pp, flags, _, can, gps, meas = _ekf_inputs(
        cuda, flags="odometry" if case == "gps6" else "default")
    gate = pp.gnss_uncertainty_max
    apply = torch.tensor(case != "pcm_skipped", device=cuda)
    kw = {"can": dict(can=can), "gps3": dict(gps=gps, gnss_uncertainty_max=gate),
          "gps6": dict(gps=gps, gnss_uncertainty_max=gate),
          "pcm": dict(pcm=(meas, apply)), "pcm_skipped": dict(pcm=(meas, apply)),
          "frame": dict(can=can, gps=gps, gnss_uncertainty_max=gate,
                        pcm=(meas, apply))}[case]
    kernels.reset_launches()
    got = efilter.update_chain(st, pp.ekf, flags, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["ekf_update" if "pcm" in kw else "can_gps_update"] == 1
    ref = efilter.update_chain_plain(st, pp.ekf, flags, **kw)
    for f, _, _ in kernels.EKF_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if f == "P":
            assert _p_entry_err(a, b, st.P, 1e-5) <= 1.0, _p_entry_err(a, b, st.P, 1e-5)
        elif a.dtype == torch.float32:
            assert _rel(a, b) <= 1e-5, (f, _rel(a, b))
        else:
            assert torch.equal(a, b), f
    moved = float((ref.P - st.P).abs().max())
    assert (moved == 0.0) == (case == "pcm_skipped")


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["can_step", "gps_step"])
def test_pipeline_steps_go_through_kernel_i_on_card(cuda, step):
    """The pipeline's one-sample CAN and GPS steps launch kernel W once
    (kernel I's CAN and GPS legs, redesigned), with no mask tensor."""
    st, pp, flags, _, can, gps, _ = _ekf_inputs(cuda)
    ps = dataclasses.replace(runtime.make_pipeline_static(ElimalocConfig()),
                             ekf_flags=flags, use_can=True, use_gps=True)
    pst = runtime.PipelineState(ekf=st, ego_ring=rings.make_ego_ring(8, torch.float32, cuda),
                                imu_ring=rings.make_imu_ring(8, torch.float32, cuda))
    kernels.reset_launches()
    if step == "can_step":
        got = runtime.can_step(pst, can[0][1], can[1][1], can[2][1], pp, ps).ekf
        ref = efilter.update_chain_plain(st, pp.ekf, flags, can=tuple(x[1:2] for x in can))
    else:
        got = runtime.gps_step(pst, gps[0][0], gps[1][0], gps[2][0], pp, ps).ekf
        ref = efilter.update_chain_plain(st, pp.ekf, flags, gps=gps,
                                         gnss_uncertainty_max=pp.gnss_uncertainty_max)
    torch.cuda.synchronize()
    assert kernels.launches["can_gps_update"] == 1 == sum(kernels.launches.values())
    assert float((ref.P - st.P).abs().max()) > 0.0
    for f, _, _ in kernels.EKF_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if f == "P":
            assert _p_entry_err(a, b, st.P, 1e-5) <= 1.0, _p_entry_err(a, b, st.P, 1e-5)
        elif a.dtype == torch.float32:
            assert _rel(a, b) <= 1e-5, (f, _rel(a, b))
        else:
            assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["imu_stage", "ekf_update", "tick_stage", "imu_intake",
                                   "can_gps_update"])
def test_ekf_kernels_refuse_float64_on_card(cuda, which):
    st, pp, flags, imu, can, *_ = _ekf_inputs(cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        if which == "imu_stage":
            kernels.imu_stage(st, rings.make_ego_ring(8, torch.float64, cuda),
                              rings.make_imu_ring(8, torch.float64, cuda), *imu,
                              pp.ego_to_imu_rot, pp.ego_to_imu_trans, pp.ekf, flags)
        elif which == "tick_stage":
            kernels.tick_stage(st, imu[0][0], pp.ekf, rings.make_ego_ring(8, torch.float64, cuda))
        elif which == "imu_intake":
            kernels.imu_intake(rings.make_imu_ring(8, torch.float64, cuda), imu[0][0],
                               imu[1][0], imu[2][0], pp.ego_to_imu_rot)
        elif which == "can_gps_update":
            kernels.can_gps_update(st, pp.ekf, flags, can=can)
        else:
            kernels.ekf_update(st, pp.ekf, flags, can=can)


def _w_inputs(cuda, case):
    """(state, params, flags, kwargs) of one CAN / GPS call: the frame's CAN
    sub-batch (a padded slot last), a 3-DOF fix, one with yaw not yet
    initialised (the antenna inflation: yaw std above 5 deg), a 6-DOF
    (NOVATEL) fix, a frame of both, every slot padded, one sample with
    ``valid`` None (the event loop's steps), and 300 CAN samples (more than
    one staging pass of kernel W, every seventh invalid)."""
    st, pp, flags, _, can, gps, _ = _ekf_inputs(cuda, flags="odometry" if case == "gps6"
                                               else "default")
    gate = pp.gnss_uncertainty_max
    src = efilter.GPS_SOURCE[flags.gps_type]
    g = dict(gps=gps, gps_source=src, gnss_uncertainty_max=gate)
    if case == "gps3_yaw_uninit":
        p = st.P.clone()
        p[5, 5] = 0.05
        st = st.replace(P=p)
    if case == "can_long":
        n = 300
        f = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
        can = (f(1.0 + 0.02 * np.arange(1, n + 1)), f(5.0 + 0.1 * np.sin(np.arange(n))),
               f(0.1 + 0.01 * np.cos(np.arange(n))), f(np.arange(n) % 7 != 3, torch.bool))
    kw = {"can": dict(can=can), "gps3": g, "gps3_yaw_uninit": g, "gps6": g,
          "frame": dict(can=can, **g),
          "padded": dict(can=can[:3] + (torch.zeros_like(can[3]),),
                         gps=gps[:3] + (torch.zeros_like(gps[3]),), gps_source=src,
                         gnss_uncertainty_max=gate),
          "one_sample": dict(can=tuple(x[1:2] for x in can[:3]) + (None,),
                             gps=tuple(x[:1] for x in gps[:3]) + (None,), gps_source=src,
                             gnss_uncertainty_max=gate),
          "can_long": dict(can=can)}[case]
    return st, pp, flags, kw


@pytest.mark.cuda
@pytest.mark.parametrize("joseph", [False, True], ids=["reference", "joseph"])
@pytest.mark.parametrize("case", ["can", "gps3", "gps3_yaw_uninit", "gps6", "frame", "padded",
                                  "one_sample", "can_long"])
def test_can_gps_update_matches_kernel_i_on_card(cuda, case, joseph):
    """Kernel W bit for bit against kernel I, its reference, on the same
    inputs (I takes an explicit all-true mask where W takes None), one
    launch each; and against the plain version within I's gates, except
    the 300 chained Joseph-form CAN updates: the kernels' Joseph pass
    mirrors P's upper triangle and the plain version's two products do
    not, a rounding difference that 300 updates grow past a gate set for
    one frame's sub-batch (to 2.5 times it on the H100, with W equal to I
    bit for bit)."""
    st, pp, flags, kw = _w_inputs(cuda, case)
    flags = dataclasses.replace(flags, joseph_form=joseph)
    kernels.reset_launches()
    got = kernels.can_gps_update(st, pp.ekf, flags, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["can_gps_update"] == 1 == sum(kernels.launches.values())
    ikw = {k: (v[:3] + (torch.ones(v[0].shape[0], dtype=torch.bool, device=cuda),)
               if k in ("can", "gps") and v[3] is None else v) for k, v in kw.items()}
    ref_i = kernels.ekf_update(st, pp.ekf, flags, **ikw)
    assert torch.equal(got.intact_record(), ref_i.intact_record()), case
    ref = efilter.update_chain_plain(st, pp.ekf, flags,
                                     **{k: v for k, v in kw.items() if k != "gps_source"})
    moved = float((ref.P - st.P).abs().max())
    assert (moved == 0.0) == (case == "padded")
    if case == "can_long" and joseph:
        return
    assert _p_entry_err(got.P, ref.P, st.P, 1e-5) <= 1.0
    for f, dt, _ in kernels.EKF_FIELDS:
        if dt == torch.float32 and f != "P":
            assert _rel(getattr(got, f), getattr(ref, f)) <= 1e-5, f
        elif dt != torch.float32:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["slots", "identity"])
def test_radar_rows_match_kernel_p_on_card(scene, cuda, rows):
    """Kernel X bit for bit against kernel P, its reference: on a slot
    assignment of the scene's scan (live and dead rows), and on the rows
    0..N-1 given as no index and no mask (the hash backend's query order)
    against P on an arange index and an all-true mask."""
    inp = _inputs(scene, cuda)
    out = _calls(inp, tiles.TileQueryBudget(qb=16, max_slots=256))
    asg, ds = out["assign"], out["downsample"][0]
    params = icp.make_icp_params(icp.PcmConfig(), device=cuda)
    n = ds.shape[0]
    if rows == "slots":
        qidx, qmask, ref_args = asg.qidx, asg.qmask, (asg.qidx, asg.qmask)
    else:
        qidx = qmask = None
        ref_args = (torch.arange(n, dtype=torch.int32, device=cuda).view(1, n),
                    torch.ones((1, n), dtype=torch.bool, device=cuda))
    kernels.reset_launches()
    got = kernels.radar_rows(ds, qidx, qmask, inp["pose"], params)
    torch.cuda.synchronize()
    assert kernels.launches["radar_rows"] == 1 == sum(kernels.launches.values())
    ref = kernels.radar_cov(ds, *ref_args, inp["pose"], params)
    assert torch.equal(got.view(ref.shape), ref)
    assert got.shape == ((n, 3, 3) if rows == "identity" else tuple(asg.qmask.shape) + (3, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["window_in_last_range", "rings_past_the_cap"])
def test_imu_stage_split_matches_plain_on_card(cuda, case):
    """A frame of more samples than one launch of kernel H takes
    (``kernels.IMU_STAGE_MAX_SAMPLES``): ``runtime.imu_subbatch`` runs it in
    the ranges of ``runtime.imu_chunks``, chaining the state and the rings,
    against one unsplit call of the plain composition within H's gates.
    The frame is a long lead's padded frame: valid samples at its start
    and end, padding between (H's gates hold over these ~40 predictions).
    Rings of 16 / 8 rows keep only the last range's rows; rings of 1100
    rows (past the cap, below n) take the ranges past n - 1100, and not the
    20 valid samples before it, as one push would."""
    pst, b, pp, ps = _stage_inputs(cuda)
    n = kernels.IMU_STAGE_MAX_SAMPLES + 200
    k = b["imu_t"].shape[0]
    rng = np.random.default_rng(12)
    ts = np.zeros(n)
    valid = np.zeros(n, bool)
    ts[:20] = 1.0 + 0.01 * np.arange(1, 21)
    ts[-20:] = 1.2 + 0.01 * np.arange(1, 21)
    valid[:20] = valid[-20:] = True
    acc = rng.normal(0, 0.3, (n, 3)) + [0.5, 0.1, 9.81]
    gyro = rng.normal(0, 0.05, (n, 3)) + [0.0, 0.0, 0.13]
    f = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    b = {"imu_t": f(ts), "imu_acc": f(acc), "imu_gyro": f(gyro),
         "imu_valid": f(valid, torch.bool)}
    assert k < n
    if case == "rings_past_the_cap":
        pst = pst.replace(ego_ring=rings.make_ego_ring(1100, device=cuda),
                          imu_ring=rings.make_imu_ring(1100, device=cuda))
    chunks = runtime.imu_chunks(n, (pst.ego_ring.capacity, pst.imu_ring.capacity))
    kernels.reset_launches()
    got = runtime.imu_subbatch(pst, b, pp, ps)
    torch.cuda.synchronize()
    assert kernels.launches["imu_stage"] == len(chunks) >= 2
    assert sum(kernels.launches.values()) == len(chunks)
    ref = runtime.imu_subbatch_plain(pst, b, pp, ps)
    _check_stage(got, ref, pst.ekf)
    assert len(chunks) == (2 if case == "window_in_last_range" else 3)
    assert int(got.ego_ring.count) == (16 if case == "window_in_last_range" else 20)


# --------------------------------------------------------------------------- #
# Kernels J, K, L, M: the scan-time ring ops and the GN step
# --------------------------------------------------------------------------- #

#: ring pushes: (ego ring count, new sample times, valid mask); the IMU ring
#: (capacity 8) takes the same times shifted by 1 us
PUSHES = {
    "append": (4, 1.0 + 0.01 * np.arange(6), np.ones(6, bool)),
    "overflow": (12, 1.0 + 0.01 * np.arange(9), np.r_[np.ones(8, bool), False]),
    "regress_clears": (10, 0.5 + 0.01 * np.arange(5), np.ones(5, bool)),
    "longer_than_ring": (3, 1.0 + 0.01 * np.arange(20), np.ones(20, bool)),
    "eps_dedupe": (10, 1.0 + np.array([0.0, 4e-6, 2e-5, 2.5e-5, 0.01]), np.ones(5, bool)),
    "masked": (6, 1.0 + 0.01 * np.arange(6), np.array([0, 1, 1, 0, 1, 0], bool)),
    "none_valid": (6, 1.0 + 0.01 * np.arange(6), np.zeros(6, bool)),
    "one_sample": (0, np.array([1.0]), np.ones(1, bool)),
}


def _rings(device, ego_count, imu_count, seed=7, ego_t0=0.9, imu_t0=0.985):
    """An ego ring of 16 rows at 100 Hz and an IMU ring of 32 rows at
    200 Hz, random fields, the given counts."""
    rng = np.random.default_rng(seed)
    f = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    t = ego_t0 + 0.01 * np.arange(16)
    ego = rings.make_ego_ring(16, torch.float32, device).replace(
        t=f(t), pos=f(np.c_[60 + 8.0 * (t - ego_t0), 0.5 * (t - ego_t0), np.zeros(16)]),
        rpy=f(np.c_[rng.normal(0, 0.01, (16, 2)), 1.5 + 0.1 * (t - ego_t0)]),
        vel_local=f(np.c_[np.full(16, 8.0), rng.normal(0, 0.1, (16, 2))]),
        gyro=f(np.c_[np.zeros((16, 2)), np.full(16, 0.1)]),
        count=f(ego_count, torch.int32))
    ti = imu_t0 + 0.005 * np.arange(32)
    imu = rings.make_imu_ring(32, torch.float32, device).replace(
        t=f(ti), gyro=f(np.c_[rng.normal(0, 0.02, (32, 2)), 0.3 + rng.normal(0, 0.02, 32)]),
        acc=f(rng.normal(0, 1.0, (32, 3))), count=f(imu_count, torch.int32))
    return ego, imu


def _push_inputs(device, case):
    count, new_t, valid = PUSHES[case]
    ego, imu = _rings(device, count, min(count, 32))
    rng = np.random.default_rng(11)
    f = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    m = len(new_t)
    vals = [f(rng.normal(size=(m, 3))) for _ in range(4)]
    return ego, imu, (f(new_t), *vals), (f(new_t + 1e-6), vals[0], vals[1]), f(valid, torch.bool)


def _query_inputs(device, case):
    """(imu ring, ego ring, scan_cur, scan_end, tf_ego_to_lidar): a scan
    inside both rings, one past the ego ring (extrapolated), one whose
    window overflows the 8-wide budget, empty rings, and a zero-length
    interpolation interval."""
    ego_count, imu_count, cur, span = {
        "inside": (16, 30, 1.0, 0.1), "extrapolate": (10, 30, 1.02, 0.1),
        "window_overflow": (16, 32, 1.0, 0.1), "empty": (0, 0, 1.0, 0.1),
        "zero_interval": (16, 30, 1.0, 0.0)}[case]
    ego, imu = _rings(device, ego_count, imu_count)
    tf = np.eye(4)
    tf[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    tf[:3, 3] = [1.0, 0.2, 1.5]
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    return imu, ego, f(cur), f(cur + span), f(tf)


def _measurement_inputs(device, case):
    """An ICP result (GICP-like local_cov, or the identity of the other
    methods) and the ego ring it is compensated against."""
    rng = np.random.default_rng(13)
    ego, _ = _rings(device, 16 if case != "empty_ring" else 0, 0)
    f = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    pose = np.eye(4)
    pose[:3, :3] = icp.lie.so3_exp(torch.tensor([0.01, -0.02, 1.55], dtype=torch.float64)).numpy()
    pose[:3, 3] = [60.5, 0.3, 0.1]
    a = rng.normal(size=(6, 6))
    local_cov = a @ a.T * 1e-6 if case != "identity_cov" else np.eye(6)
    res = icp.IcpResult(pose=f(pose), success=f(True, torch.bool), fitness=f(0.12),
                        local_cov=f(local_cov), iterations=f(3, torch.int32),
                        overlap=f(0.9), dropped=f(0, torch.int32))
    tf = np.eye(4)
    tf[:3, 3] = [-1.0, 0.0, -1.5]
    return res, f(tf), ego, f(0.95), f(True, torch.bool)


def _gn_inputs(scene, device, method):
    """The sums of one GN iteration of ``method`` (kernel A, E, F or G on the
    card, their plain versions' JTJ / JTr in the same layout on the CPU)
    and the loop's carries."""
    inp = _inputs(scene, device)
    budget = tiles.TileQueryBudget(qb=16, max_slots=512)
    ds, ds_valid, _ = grid.voxel_downsample(inp["pts"], inp["valid"], inp["voxel"], 1024)
    tm = _method_map(inp, method)
    asg = tiles.assign_slots(tm, icp.lie.transform_points(inp["pose"], ds), ds_valid, budget)
    n = ds.shape[0]
    sbuf = torch.where(asg.qmask[..., None], ds[asg.qidx.long().clamp(max=n - 1)],
                       torch.zeros((), dtype=ds.dtype, device=ds.device))
    params = icp.make_icp_params(icp.PcmConfig(), dtype=ds.dtype, device=ds.device)
    total = torch.clamp(torch.sum(ds_valid), min=1).to(ds.dtype)
    carry = (inp["pose"], torch.zeros((), device=device), torch.eye(6, device=device), total)
    return tm, asg, sbuf, params, budget, carry


def test_cpu_scan_time_callers_run_plain_versions_only(scene, monkeypatch):
    """The callers of K, L, M and of the ring pushes (the tick mode's steps,
    kernels U and V on the card) on CPU tensors: the plain versions, no
    library, no launch."""
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    ego, imu, ego_new, imu_new, valid = _push_inputs("cpu", "append")
    st, pp, *_ = _tick_state("cpu", "predict")
    pst = runtime.PipelineState(ekf=st, ego_ring=ego, imu_ring=imu)
    ps = runtime.make_pipeline_static(ElimalocConfig())
    t, acc, gyro = ego_new[0][1], imu_new[2][0], imu_new[1][0]
    got = runtime.imu_ring_step(pst, t, acc, gyro, pp, ps).imu_ring
    ref = rings.imu_intake_plain(imu, t, acc, gyro, pp.ego_to_imu_rot)
    assert all(torch.equal(getattr(got, k), getattr(ref, k)) for k in ("t", "count", "acc"))
    got = runtime.tick_step(pst, t, pp, ps).ego_ring
    _, ref = efilter.tick_stage_plain(st, ego, t, pp.ekf)
    assert all(torch.equal(getattr(got, k), getattr(ref, k)) for k in ("t", "count", "pos"))
    query = _query_inputs("cpu", "inside")
    info, guess, found, usable = deskew.scan_ring_query(*query)
    assert bool(found) and bool(usable) and bool(info.imu_available)
    res, tf, ring, end, usable = _measurement_inputs("cpu", "gicp_cov")
    _, meas, apply = runtime.pcm_measurement(res, tf, ring, end, usable, True)
    assert bool(apply) and meas.pos_cov.is_contiguous()
    tm, asg, sbuf, params, budget, carry = _gn_inputs(scene, "cpu", IcpMethod.GICP)
    out = icp.gn_iteration(int(IcpMethod.GICP), tm, asg.slot_tile, sbuf, asg.qmask, *carry,
                           params, budget)
    assert not bool(out[5])
    assert all(v == 0 for v in kernels.launches.values()), kernels.launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PUSHES))
def test_ring_push_matches_plain_on_card(cuda, case):
    """Kernel J against ``push_rings_plain``: both rings exactly equal (the
    same copies and float32 comparisons)."""
    args = _push_inputs(cuda, case)
    kernels.reset_launches()
    got = kernels.ring_push(*args)
    torch.cuda.synchronize()
    assert kernels.launches["ring_push"] == 1
    ref = rings.push_rings_plain(*args)
    for a, b in zip(got, ref):
        for f in dataclasses.fields(b):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), (case, f.name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inside", "extrapolate", "window_overflow", "empty",
                                  "zero_interval"])
def test_scan_ring_query_matches_plain_on_card(cuda, case):
    """Kernel K against ``scan_ring_query_plain``: the masks, indices and
    flags equal; the float outputs within 1e-5 (the plain version's cumsum
    is a parallel scan on the card, the kernel's a sequential double sum;
    the 4x4 products run with FMAs in cuBLAS)."""
    args = _query_inputs(cuda, case)
    window = 8 if case == "window_overflow" else 64
    kernels.reset_launches()
    info, guess, found, usable = deskew.scan_ring_query(*args, window=window)
    torch.cuda.synchronize()
    assert kernels.launches["scan_ring_query"] == 1
    rinfo, rguess, rfound, rusable = deskew.scan_ring_query_plain(*args, window=window)
    for f in dataclasses.fields(rinfo):
        a, b = getattr(info, f.name), getattr(rinfo, f.name)
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        else:
            assert torch.equal(a, b), (case, f.name)
    torch.testing.assert_close(guess, rguess, rtol=0, atol=1e-5)
    assert bool(found) == bool(rfound) and bool(usable) == bool(rusable)
    if case == "window_overflow":
        assert not bool(info.imu_covers_start)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gicp_cov", "identity_cov", "empty_ring"])
def test_pcm_measurement_matches_plain_on_card(cuda, case):
    """Kernel L against ``pcm_measurement_plain``: every float output within
    rel 1e-5 of its largest entry, ``apply`` equal."""
    res, tf, ring, end, usable = _measurement_inputs(cuda, case)
    kernels.reset_launches()
    pose, meas, apply = runtime.pcm_measurement(res, tf, ring, end, usable, True)
    torch.cuda.synchronize()
    assert kernels.launches["pcm_measurement"] == 1
    rpose, rmeas, rapply = runtime.pcm_measurement_plain(res, tf, ring, end, usable, True)
    for a, b in ((pose, rpose), (meas.timestamp, rmeas.timestamp), (meas.pos, rmeas.pos),
                 (meas.rot, rmeas.rot), (meas.pos_cov, rmeas.pos_cov),
                 (meas.rot_cov, rmeas.rot_cov)):
        assert _rel(a, b) <= 1e-5, (case, a, b)
    assert bool(apply) == bool(rapply) == (case != "empty_ring")


@pytest.mark.cuda
@pytest.mark.parametrize("method", [IcpMethod.P2P, *METHODS], ids=lambda m: m.name)
def test_gn_step_matches_plain_on_card(scene, cuda, method):
    """Kernel M against ``gn_update_plain`` on the sums kernel A, E, F or G
    gave on the card: pose within 1e-4 (entries up to ~60 m), local_cov
    within rel 1e-3 (the inverse of reg, conditioned ~1e3, from an LU in
    another order than cuSOLVER's), fitness and overlap equal (the same
    divisions), the stop flags equal."""
    tm, asg, sbuf, params, budget, carry = _gn_inputs(scene, cuda, method)
    sums = icp.search_sums(int(method), tm, asg.slot_tile, sbuf, asg.qmask, carry[0], params)
    gicp = method == IcpMethod.GICP
    kernels.reset_launches()
    got = kernels.gn_step(sums, *carry, params, gicp)
    torch.cuda.synchronize()
    assert kernels.launches["gn_step"] == 1
    assemble = icp.assemble_p2p if method == IcpMethod.P2P else icp.assemble_gn
    ref = icp.gn_update_plain(*assemble(sums), *carry, params, gicp)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    assert _rel(got[1], ref[1]) <= 1e-3
    assert not torch.equal(got[0], carry[0])
    assert gicp == (not torch.equal(got[1], carry[2]))
    for a, b in zip(got[2:], ref[2:]):
        assert torch.equal(a, b), method


#: a drive of window shifts (tiles units): both axes, 1, 2 and 3 tiles, into
#: the map corner and back
WINDOW_DRIVE = [(1, 0), (1, 1), (0, 2), (3, 1), (2, 2), (3, 3), (-3, -2), (0, -1)]


@pytest.mark.cuda
def test_shift_window_matches_plain_on_card(scene, cuda):
    """Kernel N against ``shift_window_plain`` after every step of a drive
    of a 7x7 window over the scene's map (all six halo tensors), and both
    against the same rows packed fresh at the same origin."""
    h = scene[2][1]
    dims = (7, 7)
    origin = h.window_anchor(np.array([-20.0, -20.0]), dims)
    got = ref = h.crop_window(np.array([-20.0, -20.0]), 3, dims=dims).to_device(cuda)
    anchor, moved = origin, 0
    kernels.reset_launches()
    for step in WINDOW_DRIVE:
        new = (int(np.clip(anchor[0] + step[0], h.tx0, h.tx0 + h.tx_dim - dims[0])),
               int(np.clip(anchor[1] + step[1], h.ty0, h.ty0 + h.ty_dim - dims[1])))
        k = max(abs(new[0] - anchor[0]), abs(new[1] - anchor[1]))
        if not k:
            continue
        dst, payload = h.crop_entering_rows(anchor, new, dims, origin, k * sum(dims))
        d = torch.as_tensor(dst, device=cuda)
        p = {f: None if v is None else torch.as_tensor(v, device=cuda)
             for f, v in payload.items()}
        dx, dy = new[0] - anchor[0], new[1] - anchor[1]
        got = tiles.shift_window(got, dx, dy, d, p)
        ref = tiles.shift_window_plain(ref, dx, dy, d, p)
        torch.cuda.synchronize()
        fresh = h._pack_rows(h.window_rows(new, dims), *h._origin_offsets(origin))
        for f in tiles.HALO_FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), (f, new)
            assert np.array_equal(getattr(got, f).cpu().numpy(), fresh[f]), (f, new)
        assert got.tile_anchor == ref.tile_anchor == (new[0] - origin[0], new[1] - origin[1])
        anchor, moved = new, moved + 1
    assert moved >= 5 and kernels.launches["shift_window"] == moved


# --------------------------------------------------------------------------- #
# Kernels O and P, the Joseph forms of H and I, the radar forms of E, F, G
# --------------------------------------------------------------------------- #

#: CA ticks: (state overrides before the tick, tick time); the state's
#: prev_timestamp is 1.0 and its reset-for-init flag is cleared
TICKS = {
    "predict": ({}, 1.01),
    "small_dt": ({}, 1.0 + 5e-7),
    "negative_dt": ({}, 0.99),
    "reset": ({"reset_for_init_prediction": True}, 1.01),
    "pcm_init": ({"pcm_init_on_going": True}, 1.01),
}


def _tick_state(device, case):
    st, pp, *_ = _ekf_inputs(device)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    st = st.replace(acc=f([0.3, -0.2, 0.05]), gyro=f([0.01, -0.02, 0.2]),
                    reset_for_init_prediction=torch.tensor(False, device=device))
    over, t = TICKS[case]
    st = st.replace(**{k: torch.tensor(v, device=device) for k, v in over.items()})
    return st, pp, f(t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TICKS))
def test_ca_tick_matches_plain_on_card(cuda, case):
    st, pp, t = _tick_state(cuda, case)
    kernels.reset_launches()
    got, ghist = kernels.ca_tick(st, t, pp.ekf)
    torch.cuda.synchronize()
    assert kernels.launches["ca_tick"] == 1
    ref, rhist = efilter.ca_tick_plain(st, t, pp.ekf)
    for name in ("pos", "vel"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=0, atol=1e-4)
    torch.testing.assert_close(got.rot, ref.rot, rtol=0, atol=1e-6)
    assert _p_entry_err(got.P, ref.P, st.P, 1e-5) <= 1.0
    for f, _, _ in kernels.EKF_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if a.dtype != torch.float32:
            assert torch.equal(a, b), f
    assert torch.equal(got.prev_timestamp, ref.prev_timestamp)
    for a, b, atol in zip(ghist, rhist, (0.0, 1e-4, 1e-5, 1e-4, 1e-4)):
        torch.testing.assert_close(a, b, rtol=0, atol=atol)
    assert torch.equal(got.P, st.P) == (case not in ("predict", "negative_dt"))


@pytest.mark.cuda
def test_radar_cov_matches_plain_on_card(scene, cuda):
    """The radar rows on a slot assignment of the scene's scan (live and
    dead rows, a world pose far from the map origin): ``icp.radar_slots``
    on the card, kernel X (kernel P redesigned), against the plain
    version."""
    inp = _inputs(scene, cuda)
    out = _calls(inp, tiles.TileQueryBudget(qb=16, max_slots=256))
    asg = out["assign"]
    ds = out["downsample"][0]
    params = icp.make_icp_params(icp.PcmConfig(), device=cuda)
    kernels.reset_launches()
    got = icp.radar_slots(ds, asg.qidx, asg.qmask, inp["pose"], params)
    torch.cuda.synchronize()
    assert kernels.launches["radar_rows"] == 1 == sum(kernels.launches.values())
    ref = icp.radar_slots_plain(ds, asg.qidx, asg.qmask, inp["pose"], params)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    assert torch.equal(got[~asg.qmask], torch.zeros_like(got[~asg.qmask]))
    assert int(asg.qmask.sum()) > 100
    # not symmetric: R S with no R^T
    live = got[asg.qmask]
    assert float((live - live.transpose(-1, -2)).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["default", "calibration"])
def test_imu_chain_joseph_matches_plain_on_card(cuda, flags):
    pst, b, pp, ps = _stage_inputs(cuda, flags, joseph=True)
    kernels.reset_launches()
    got = runtime.imu_subbatch(pst, b, pp, ps)
    torch.cuda.synchronize()
    assert kernels.launches["imu_stage"] == 1
    _check_stage(got, runtime.imu_subbatch_plain(pst, b, pp, ps), pst.ekf)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["can", "gps3", "gps6", "pcm", "frame"])
def test_ekf_update_joseph_matches_plain_on_card(cuda, case):
    st, pp, flags, _, can, gps, meas = _ekf_inputs(
        cuda, flags="odometry" if case == "gps6" else "default")
    flags = dataclasses.replace(flags, joseph_form=True)
    gate = pp.gnss_uncertainty_max
    apply = torch.tensor(True, device=cuda)
    kw = {"can": dict(can=can), "gps3": dict(gps=gps, gnss_uncertainty_max=gate),
          "gps6": dict(gps=gps, gnss_uncertainty_max=gate), "pcm": dict(pcm=(meas, apply)),
          "frame": dict(can=can, gps=gps, gnss_uncertainty_max=gate,
                        pcm=(meas, apply))}[case]
    kernels.reset_launches()
    got = efilter.update_chain(st, pp.ekf, flags, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["ekf_update" if "pcm" in kw else "can_gps_update"] == 1
    ref = efilter.update_chain_plain(st, pp.ekf, flags, **kw)
    for f, _, _ in kernels.EKF_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if f == "P":
            assert _p_entry_err(a, b, st.P, 1e-5) <= 1.0, _p_entry_err(a, b, st.P, 1e-5)
        elif a.dtype == torch.float32:
            assert _rel(a, b) <= 1e-5, (f, _rel(a, b))
        else:
            assert torch.equal(a, b), f
    assert float((ref.P - st.P).abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_radar_forms_match_plain_on_card(scene, cuda, method):
    """Kernels E, F, G with the slot-packed radar covariances (kernel P's)
    against their plain versions with the same radar input: matched equal,
    JTJ / JTr / fitness numerator rtol 1e-3 on the norms. The radar term
    makes R^T C R + radar non-symmetric and some rows near-singular: on
    this input the plain float32 radar forms themselves lie up to 4.2e-4
    (JTJ) and 8.6e-4 (JTr) from float64 (AVGICP; 1.5e-6 without radar)."""
    inp = _inputs(scene, cuda)
    budget = tiles.TileQueryBudget(qb=16, max_slots=256)
    out = _calls(inp, budget)
    asg, sbuf, params = out["p2p"]
    radar = icp.radar_slots(out["downsample"][0], asg.qidx, asg.qmask, inp["pose"], params)
    tm = _method_map(inp, method)
    kernels.reset_launches()
    sums = icp.search_sums(int(method), tm, asg.slot_tile, sbuf, asg.qmask, inp["pose"],
                           params, radar)
    torch.cuda.synchronize()
    assert kernels.launches[WRAPPER[method]] == 1
    got = icp.assemble_gn(sums)
    ref = icp._PLAIN[int(method)](tm, asg.slot_tile, sbuf, asg.qmask, inp["pose"], params,
                                  budget, radar)
    plain_form = icp._PLAIN[int(method)](tm, asg.slot_tile, sbuf, asg.qmask, inp["pose"],
                                         params, budget)
    assert int(got[0]) == int(ref[0]) > 10, method
    for a, b in zip(got[1:], ref[1:4]):
        assert float(torch.linalg.norm(a - b)) <= 1e-3 * float(torch.linalg.norm(b)), method
    # the radar term changed the sums
    assert float(torch.linalg.norm(ref[1] - plain_form[1])) > 1e-3 * float(
        torch.linalg.norm(plain_form[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["ego", "imu"])
def test_ring_push_one_side_matches_plain_on_card(cuda, side):
    """Kernel J with one ring left out (the tick mode's pushes)."""
    ego, imu, ego_new, imu_new, valid = _push_inputs(cuda, "append")
    if side == "ego":
        imu = imu_new = None
    else:
        ego = ego_new = None
    kernels.reset_launches()
    got = kernels.ring_push(ego, imu, ego_new, imu_new, valid)
    torch.cuda.synchronize()
    assert kernels.launches["ring_push"] == 1
    ref = rings.push_rings_plain(ego, imu, ego_new, imu_new, valid)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is None:
            continue
        for f in ("t", "count") + tuple(k for k in ("pos", "rpy", "vel_local", "gyro", "acc")
                                        if hasattr(r, k)):
            assert torch.equal(getattr(g, f), getattr(r, f)), f


def _hash_inputs(scene, device):
    """The scene's hash grid on ``device``, the downsampled scan and the
    pose of ``_inputs`` and the scan's world queries."""
    inp = _inputs(scene, device)
    ds, ds_valid, _ = grid.voxel_downsample(inp["pts"], inp["valid"], inp["voxel"], 1024)
    params = icp.make_icp_params(icp.PcmConfig(), device=device)
    return (grid.to_device(scene[3], device), ds, ds_valid, inp["pose"], params,
            icp.transform_slots(inp["pose"], ds))


#: each grid query's plain version and its kernel-Q outputs, in its order
HASH_QUERIES = {
    "P2P": (grid.query_nearest_point_plain, ("target", "valid", "rows", "slots")),
    "GICP": (grid.query_nearest_point_cov_plain, ("target", "cov", "mean", "valid")),
    "VGICP": (grid.query_nearest_voxel_cov_plain, ("cov", "mean", "valid")),
    "AVGICP": (grid.query_all_voxel_cov_plain, ("cov", "mean", "valid")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(HASH_QUERIES))
def test_hash_queries_match_plain_on_card(scene, cuda, method):
    """Kernel Q's query entry against the plain grid queries on the scan's
    world queries (and a lookup of every voxel, of misses and of negative
    coords): every output bit for bit (the same exact search, then copies)."""
    g, _, _, _, params, q = _hash_inputs(scene, cuda)
    plain, keys = HASH_QUERIES[method]
    kernels.reset_launches()
    out = kernels.hash_query(g, q, params.max_search_dist, method)
    torch.cuda.synchronize()
    assert kernels.launches["hash_query"] == 1
    for k, r in zip(keys, plain(g, q, params.max_search_dist)):
        assert torch.equal(out[k], r.to(out[k].dtype)), (method, k)
    assert 0 < int(out["valid"].sum()) < out["valid"].numel()
    v = g.num_voxels
    coords = torch.cat([g.vox_coords[:v], -g.vox_coords[:v] - 1, g.vox_coords[:v] + 7])
    rows = grid.lookup(g, coords)
    assert kernels.launches["hash_lookup"] == 1
    assert torch.equal(rows, grid.lookup_plain(g, coords))
    assert torch.equal(rows[:v], torch.arange(v, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("radar", [False, True], ids=["reference", "radar"])
@pytest.mark.parametrize("method", ["P2P", "GICP", "VGICP", "AVGICP"])
def test_hash_correspond_matches_plain_on_card(scene, cuda, method, radar):
    """Kernel Q's fused entry against ``hash_search_reduce_plain``: matched
    equal, JTJ / JTr / fitness numerator within rtol 1e-4 on the norms
    (1e-3 in the radar form, whose rows can be near-singular: the plain
    float32 forms lie up to ~1e-3 from float64, test_radar_forms_match_...),
    then one ``gn_iteration_hash``: Q and M launched once each."""
    if radar and method == "P2P":
        pytest.skip("P2P has no radar form (its tail takes no radar term)")
    g, ds, ds_valid, pose, params, _ = _hash_inputs(scene, cuda)
    rad = icp.radar_points(ds, pose, params) if radar else None
    code = int(IcpMethod[method])
    kernels.reset_launches()
    sums = kernels.hash_correspond(g, ds, ds_valid, pose, params.max_search_dist, method, rad)
    torch.cuda.synchronize()
    assert kernels.launches["hash_correspond"] == 1
    got = icp.assemble_p2p(sums) if method == "P2P" else icp.assemble_gn(sums)
    ref = icp.hash_search_reduce_plain(g, ds, ds_valid, pose, params, code, rad)
    assert int(got[0]) == int(ref[0]) > 100, method
    rtol = 1e-3 if radar else 1e-4
    for a, b in zip(got[1:], ref[1:]):
        assert float(torch.linalg.norm(a - b)) <= rtol * float(torch.linalg.norm(b)), method
    kernels.reset_launches()
    total = ds_valid.sum().to(torch.float32)
    out = icp.gn_iteration_hash(code, g, ds, ds_valid, pose, torch.zeros((), device=cuda),
                                torch.eye(6, device=cuda), total, params, rad)
    torch.cuda.synchronize()
    assert kernels.launches["hash_correspond"] == kernels.launches["gn_step"] == 1
    assert bool(torch.isfinite(out[0]).all())


#: the ground probe's card cases on the scene's grid: (xy, r, k)
GROUND_CASES = {"centre": ((20.0, 0.0), 5.0, 5), "off_centre": ((-7.5, 12.25), 5.0, 5),
                "off_map": ((500.0, 0.0), 5.0, 5), "small_radius": ((20.0, 0.0), 0.4, 5),
                "k1": ((20.0, 0.0), 5.0, 1), "k8": ((-7.5, 12.25), 5.0, 8)}


def _ulp_close(z, rz):
    """z within one float32 ulp of rz (equal where rz is not finite)."""
    if torch.isfinite(rz):
        return abs(float(z) - float(rz)) <= float(torch.finfo(torch.float32).eps) * max(
            abs(float(rz)), 1e-30)
    return float(z) == float(rz)


@pytest.mark.cuda
@pytest.mark.parametrize("xy,r", [c[:2] for k, c in GROUND_CASES.items() if c[2] == 5],
                         ids=[k for k, c in GROUND_CASES.items() if c[2] == 5])
def test_ground_height_matches_plain_on_card(scene, cuda, xy, r):
    """Kernel R (kernel Z's reference, called through its wrapper: no path
    launches it) against ``find_ground_height_plain``: found equal, z within
    one float32 ulp (the plain mean sums its 5 values in another order);
    +inf on both sides where fewer than 5 points are in range."""
    g = grid.to_device(scene[3], cuda)
    kernels.reset_launches()
    found, z = kernels.ground_height(g.points, xy, r, 5)
    torch.cuda.synchronize()
    assert kernels.launches["ground_height"] == 1
    rf, rz = grid.find_ground_height_plain(g, xy, r)
    assert bool(found) == bool(rf)
    assert _ulp_close(z, rz)


#: tests/test_torch_hash.py's tie (a query equidistant from two map points)
#: and its query set; a query whose neighbourhood is empty
TIE_POINTS = np.array([[0.25, 0.5, 40.5], [1.75, 0.5, 40.5]])
TIE_QUERY = np.array([[1.0, 0.5, 40.5]])
EMPTY_QUERY = np.array([[500.0, 500.0, 0.0]])


@functools.lru_cache(maxsize=None)
def _small_built(name):
    """The host maps of kernel Y's and Z's extra card cases (both
    covariances, M = 10 or, with full voxels, 60)."""
    kw = dict(compute_voxel_cov=True, compute_point_cov=True, gicp_cov_search_dist=0.5,
              use_native=False)
    if name == "m60":
        pts = np.random.default_rng(61).uniform(-3.0, 3.0, size=(20_000, 3))
        return builder.build_voxel_map(pts, 1.0, 60, **kw)
    pts = np.r_[np.random.default_rng(33).uniform(-15.0, 15.0, size=(4000, 3)), TIE_POINTS]
    load = 0.9 if name == "long_chains" else 0.25
    return builder.build_voxel_map(pts, 1.0, 10, table_load_factor=load, **kw)


def _y_case(scene, device, case):
    """(grid, queries, max_dist) of one of kernel Y's card cases."""
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    if case in ("scene", "scene_odd"):
        g, _, _, _, params, q = _hash_inputs(scene, device)
        # 1,001 queries: not a multiple of a CTA's 8 (32 for AVGICP)
        return g, q[:1001] if case == "scene_odd" else q, params.max_search_dist
    rng = np.random.default_rng(5)
    if case == "m60":
        g = grid.to_device(_small_built("m60"), device)
        return g, f(np.r_[rng.uniform(-3.5, 3.5, size=(200, 3)), EMPTY_QUERY]), f(0.8)
    g = grid.to_device(_small_built("long_chains" if case == "long_chains" else "tie"), device)
    if case == "n1":
        return g, f(TIE_QUERY), f(0.8)
    if case == "empty":
        return g, f(EMPTY_QUERY + rng.uniform(-50.0, 50.0, size=(37, 3))), f(0.8)
    return g, f(np.r_[rng.uniform(-16.0, 16.0, size=(512, 3)), TIE_QUERY, EMPTY_QUERY]), f(0.8)


#: each grid query's public function (kernel Y on the card)
GRID_QUERIES = {"P2P": grid.query_nearest_point, "GICP": grid.query_nearest_point_cov,
                "VGICP": grid.query_nearest_voxel_cov, "AVGICP": grid.query_all_voxel_cov}
Y_CASES = ("scene", "scene_odd", "tie", "long_chains", "m60", "n1", "empty")


@pytest.mark.cuda
@pytest.mark.parametrize("case", Y_CASES)
@pytest.mark.parametrize("method", sorted(HASH_QUERIES))
def test_grid_query_matches_q_and_plain_on_card(cuda, scene, method, case):
    """Kernel Y against kernel Q's query entry and the plain queries: every
    output bit for bit (the same exact search, then copies), through its
    wrapper and through the public ``map.grid`` function (one launch of Y,
    none of Q)."""
    g, q, md = _y_case(scene, cuda, case)
    plain, keys = HASH_QUERIES[method]
    kernels.reset_launches()
    out = kernels.grid_query(g, q, md, method)
    torch.cuda.synchronize()
    assert kernels.launches["grid_query"] == 1
    ref = kernels.hash_query(g, q, md, method)
    assert out.keys() == ref.keys()
    for k in out:
        assert torch.equal(out[k], ref[k]), (method, case, k)
    want = plain(g, q, md)
    for k, r in zip(keys, want):
        assert torch.equal(out[k], r.to(out[k].dtype)), (method, case, k)
    kernels.reset_launches()
    got = GRID_QUERIES[method](g, q, md)
    torch.cuda.synchronize()
    assert kernels.launches["grid_query"] == 1 and kernels.launches["hash_query"] == 0
    for a, r in zip(got, want):
        assert torch.equal(a, r.to(a.dtype)), (method, case)
    n_valid = int(out["valid"].sum())
    if case == "empty":
        assert n_valid == 0 and bool((out["rows"] == g.sentinel).all())
    elif case != "n1":
        assert 0 < n_valid < out["valid"].numel(), (method, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUND_CASES) + ["m60"])
def test_ground_probe_matches_r_and_plain_on_card(cuda, scene, case):
    """Kernel Z through ``find_ground_height`` (one launch of Z, none of
    R) against kernel R bit for bit and ``find_ground_height_plain`` within
    one float32 ulp; the M = 60 grid's voxels are full."""
    if case == "m60":
        g, (xy, r, k) = grid.to_device(_small_built("m60"), cuda), ((0.5, -0.5), 2.0, 5)
    else:
        g, (xy, r, k) = grid.to_device(scene[3], cuda), GROUND_CASES[case]
    kernels.reset_launches()
    found, z = grid.find_ground_height(g, xy, r, k)
    torch.cuda.synchronize()
    assert kernels.launches["ground_probe"] == 1 and kernels.launches["ground_height"] == 0
    rf, rz = kernels.ground_height(g.points, xy, r, k)
    assert torch.equal(found, rf) and torch.equal(z, rz), (case, float(z), float(rz))
    pf, pz = grid.find_ground_height_plain(g, xy, r, k)
    assert bool(found) == bool(pf)
    assert _ulp_close(z, pz), (case, float(z), float(pz))
    # the workspace's done counter is back at 0: a second call agrees
    f2, z2 = kernels.ground_probe(g, xy, r, k)
    assert torch.equal(f2, found) and torch.equal(z2, z)
