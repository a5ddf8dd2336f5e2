"""Guards of the PyTorch port.

* ``import elimaloc_tpu_torch`` (every submodule) never imports jax or the
  JAX package: the GPU host has no jax.
* The port's NumPy copies (config, the synthetic world and log, the voxel
  map builder, the tile packer, the fused batch builder) produce
  bit-identical output to the JAX package's on the same seeds.
* Features the port does not run raise NotImplementedError naming the
  ROADMAP item instead of running silently; those it once refused (the
  radar covariances, the tick mode, the hash backend) build.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.map import builder as jbuilder
from elimaloc_tpu.map import tiles as jtiles
from elimaloc_tpu.pipeline import log as jlog
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch.map import builder as tbuilder
from elimaloc_tpu_torch.map import grid as tgrid
from elimaloc_tpu_torch.map import tiles as ttiles
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import tiny_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_never_pulls_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import elimaloc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'elimaloc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'elimaloc_tpu' or m.startswith('elimaloc_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('elimaloc_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20  # every submodule was imported


def test_precision_pinned_at_import():
    import elimaloc_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_config_defaults_and_ini_roundtrip(tmp_path):
    assert dataclasses.asdict(tconfig.ElimalocConfig()) == \
        dataclasses.asdict(jconfig.ElimalocConfig())
    cfg = jconfig.ElimalocConfig()
    cfg.pcm.icp_method = jconfig.IcpMethod.P2P
    cfg.pcm.max_iteration = 7
    cfg.ekf.ekf_init_yaw_deg = 12.25
    cfg.ekf.use_zupt = True
    path = str(tmp_path / "loc.ini")
    jconfig.export_ini(cfg, path)
    with open(path) as f:
        jtext = f.read()
    tconfig.export_ini(tconfig.load_localization_ini(path), path)
    with open(path) as f:
        assert f.read() == jtext
    assert dataclasses.asdict(tconfig.load_localization_ini(path)) == \
        dataclasses.asdict(jconfig.load_localization_ini(path))


def _assert_same_arrays(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.fixture(scope="module")
def both_worlds():
    jw = jlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    tw = tlog.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    return jw, tw


def test_world_and_log_bit_identical(both_worlds):
    jw, tw = both_worlds
    np.testing.assert_array_equal(tw, jw)
    kw = dict(duration=1.5, points_per_scan=512, max_range=50.0, seed=10)
    _assert_same_arrays(tlog.synthesize_log(tw, **kw), jlog.synthesize_log(jw, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(compute_voxel_cov=True)],
                         ids=["points", "voxel_cov"])
def test_voxel_and_tile_map_bit_identical(both_worlds, kw):
    jw, _ = both_worlds
    pts = jw[::4]
    jb = jbuilder.build_voxel_map(pts, 1.0, 30, use_native=False, **kw)
    tb = tbuilder.build_voxel_map(pts, 1.0, 30, use_native=False, **kw)
    _assert_same_arrays(tb, jb)
    _assert_same_arrays(ttiles.build_tile_map(tb), jtiles.build_tile_map(jb))


def test_fused_batches_bit_identical(both_worlds):
    jw, _ = both_worlds
    log = jlog.synthesize_log(jw, duration=1.5, points_per_scan=512,
                              max_range=50.0, seed=10)
    for dtype in (np.float32, np.float64):
        jb = jruntime.build_fused_batches(log, dtype=dtype, time_base=999_999.0)
        tb = truntime.build_fused_batches(log, dtype=dtype, time_base=999_999.0)
        assert set(tb) == set(jb)
        for k in jb:
            assert tb[k].dtype == np.asarray(jb[k]).dtype, k
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("change", ["fleet", "hash"])
def test_pipeline_refuses_unported(both_worlds, change):
    """A GICP + radar pipeline ("fleet") and a hash-backend one ("hash"),
    whose fleet replays were refused until their lane forms were ported
    (tests/test_torch_fleet*.py run them now): their fleet replay refuses
    only what JAX's run_fused_fleet refuses (runtime.py:1590-1649; here an
    empty fleet, which shares no scan count), and the registration still
    refuses what is not ported, naming its ROADMAP Queue 1 item
    (multi-device registration, "parallel/sharding.py")."""
    _, tw = both_worlds
    cfg = tiny_cfg(tconfig)
    kw = {}
    if change == "fleet":
        cfg.pcm.icp_method = tconfig.IcpMethod.GICP
        cfg.pcm.use_radar_cov = True
    if change == "hash":
        kw["backend"] = "hash"
    pipe = truntime.LocalizationPipeline(cfg, tw[:1000], device="cpu", use_native=False, **kw)
    with pytest.raises(ValueError, match="share a scan count"):
        pipe.run_fused_fleet([])
    from elimaloc_tpu_torch.register import icp as ticp

    sharded = dataclasses.replace(pipe.static.icp_static, psum_axis="lanes")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        ticp.check_supported(sharded)


@pytest.mark.parametrize("change", ["gicp_radar", "tick_mode", "hash", "hash_gicp_radar"])
def test_pipeline_builds_the_configurations_it_once_refused(both_worlds, change):
    """A GICP pipeline with radar covariances, a use_imu=False pipeline and
    hash-backend pipelines build and carry their switches into the static
    configuration the steps read (test_torch_radar.py, test_torch_tick.py
    and test_torch_hash_*.py run them)."""
    _, tw = both_worlds
    cfg = tiny_cfg(tconfig)
    if change.endswith("gicp_radar"):
        cfg.pcm.icp_method = tconfig.IcpMethod.GICP
        cfg.pcm.use_radar_cov = True
    elif change == "tick_mode":
        cfg.ekf.use_imu = False
    backend = "hash" if change.startswith("hash") else "tile"
    pipe = truntime.LocalizationPipeline(cfg, tw[:1000], device="cpu", use_native=False,
                                         backend=backend)
    assert pipe.static.icp_static.backend == backend
    if change == "gicp_radar":
        assert pipe.static.icp_static.use_radar_cov
        assert pipe.host_map.halo_point_cov is not None
    elif change == "tick_mode":
        assert pipe.static.use_imu is False and pipe.static.tick_hz == 100.0
    else:
        # the hash grid on the device, built from the BuiltMap; no tile map
        assert isinstance(pipe.map, tgrid.MapGrid) and pipe.host_map is None
        assert pipe.map.num_voxels == pipe.built.num_voxels
        assert (pipe.map.point_cov is not None) == (change == "hash_gicp_radar")
        assert pipe.static.icp_static.use_radar_cov == (change == "hash_gicp_radar")



#: the port's modules that the online entry points, the active-window
#: serving path (the host crops, the shift and the window management), the
#: tick mode and the radar covariances, kernels J-P and their plain versions
#: live in, the packed EKF records, the smoke script and the timing scripts
#: of kernels B and C, of the IMU stage, of the P2P GN loop, of the scan's
#: end, of its front, of the registration loops, of the tick mode and of
#: the CAN / GPS updates and radar rows (kernels W and X), the command line
#: and the host modules it imports (PCD, rosbag, sites, utils)
SLICE_FILES = ["elimaloc_tpu_torch/ops/geo.py", "elimaloc_tpu_torch/pipeline/runtime.py",
               "elimaloc_tpu_torch/ekf/filter.py", "elimaloc_tpu_torch/ekf/state.py",
               "elimaloc_tpu_torch/map/grid.py",
               "elimaloc_tpu_torch/pipeline/rings.py", "elimaloc_tpu_torch/deskew.py",
               "elimaloc_tpu_torch/register/icp.py", "elimaloc_tpu_torch/kernels/__init__.py",
               "elimaloc_tpu_torch/kernels/build.py", "elimaloc_tpu_torch/map/tiles.py",
               "elimaloc_tpu_torch/convert.py", "elimaloc_tpu_torch/config.py",
               "chip_smoke.py", "tools/time_sort_kernels.py", "tools/time_imu_stage.py",
               "tools/time_gn_loop.py", "tools/time_pcm_stage.py",
               "tools/time_scan_front.py", "tools/time_register_loops.py",
               "tools/time_tick_mode.py", "tools/time_ekf_update.py",
               "tools/probe_profiler_drops.py", "elimaloc_tpu_torch/parallel/__init__.py",
               "elimaloc_tpu_torch/parallel/sharding.py", "elimaloc_tpu_torch/struct.py",
               "tools/compare_checkouts.py", "elimaloc_tpu_torch/cli.py",
               "elimaloc_tpu_torch/sites.py", "elimaloc_tpu_torch/map/pcd.py",
               "elimaloc_tpu_torch/map/native_builder.py", "elimaloc_tpu_torch/pipeline/lz4f.py",
               "elimaloc_tpu_torch/pipeline/pointcloud.py",
               "elimaloc_tpu_torch/pipeline/rosbag.py", "elimaloc_tpu_torch/utils/__init__.py",
               "elimaloc_tpu_torch/utils/checkpoint.py",
               "elimaloc_tpu_torch/utils/observability.py",
               "elimaloc_tpu_torch/utils/timing.py", "elimaloc_tpu_torch/utils/viz.py"]


@pytest.mark.parametrize("path", SLICE_FILES)
def test_no_jax_import_anywhere_in_source(path):
    """Every import statement of the file, at any depth (a function-level
    import runs only when the function does), names neither jax nor the JAX
    package."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "elimaloc_tpu")]
    assert not bad, (path, bad)


def _ctypes_kind(param):
    """The ctypes argument types a C parameter declaration may be bound
    with: a pointer (``cudaStream_t`` is one) any ctypes pointer type,
    ``int`` ``c_int``, ``float`` ``c_float``, ``long long``
    ``c_longlong``."""
    import ctypes

    decl = " ".join(param.split()[:-1])  # the type: the name dropped
    if "*" in decl or decl == "cudaStream_t":
        return "pointer"
    return {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}[decl.replace("const ", "")]


def _bound_kind(argtype):
    import ctypes

    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "pointer"
    return argtype


def test_every_kernel_entry_point_has_its_ctypes_signature():
    """Each ``extern "C" int elm_*`` of csrc/*.cu is bound in
    kernels/build.py with as many argument types as the C function has
    parameters (ctypes would pass an unbound pointer as a 32-bit int), each
    of the parameter's kind: a pointer as ``c_void_p`` or a ctypes pointer
    type, an ``int`` as ``c_int``, a ``float`` as ``c_float``, a ``long
    long`` as ``c_longlong`` (a float bound as an int, or an int where the C
    entry takes a pointer, passes the wrong bits without an error)."""
    import re

    from elimaloc_tpu_torch.kernels import build

    found = {}
    for src in build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (elm_\w+)\(([^)]*)\)', text):
            found[m.group(1)] = [p.strip() for p in m.group(2).split(",") if p.strip()]
    assert set(found) == set(build._SIGNATURES)
    for name, params in found.items():
        bound = build._SIGNATURES[name]
        assert len(bound) == len(params), name
        for i, (param, argtype) in enumerate(zip(params, bound)):
            assert _bound_kind(argtype) == _ctypes_kind(param), (name, i, param, argtype)
    assert {"elm_ring_push", "elm_scan_ring_query", "elm_pcm_measurement",
            "elm_gn_step", "elm_shift_window", "elm_ca_tick", "elm_radar_cov",
            "elm_hash_search_reduce", "elm_hash_query", "elm_hash_lookup",
            "elm_ground_height", "elm_assign_slots", "elm_voxel_downsample",
            "elm_can_gps_update", "elm_radar_rows", "elm_grid_query",
            "elm_ground_probe"} <= set(found)
    # kernels B and C are one entry each; their former two-launch halves are gone
    assert not {"elm_tile_keys", "elm_assign_scatter", "elm_voxel_keys",
                "elm_voxel_compact"} & set(found)


def _wrappers_ast():
    import ast

    return ast.parse(open(os.path.join(ROOT, "elimaloc_tpu_torch/kernels/__init__.py")).read())


def test_kernel_wrappers_call_no_library_sort():
    """No wrapper sorts with PyTorch: kernels B and C sort on the card in
    csrc/sort.cuh (the plain versions in map/ keep ``torch.sort``)."""
    import ast

    calls = [n.func.attr for n in ast.walk(_wrappers_ast())
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)]
    assert not {"sort", "argsort", "msort", "unique", "unique_consecutive", "topk"} & set(calls)


@pytest.mark.parametrize("wrapper,entry", [("assign_slots", "elm_assign_slots"),
                                           ("voxel_downsample", "elm_voxel_downsample")])
def test_sorting_wrappers_make_one_library_call(wrapper, entry):
    """Kernels B and C: one ``lib.elm_*`` call (one launch) per wrapper call."""
    import ast

    fn = next(n for n in ast.walk(_wrappers_ast())
              if isinstance(n, ast.FunctionDef) and n.name == wrapper)
    entries = [n.func.attr for n in ast.walk(fn) if isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute) and n.func.attr.startswith("elm_")]
    assert entries == [entry]


def test_sort_constants_match_the_sources():
    """The wrappers' copies of the sort's cluster size, kernel B's shared
    table limit and the no-cluster return code are the sources' own."""
    import re

    from elimaloc_tpu_torch import kernels
    from elimaloc_tpu_torch.kernels import build

    sort_h = (build.SRC_DIR / "sort.cuh").read_text()
    assign = (build.SRC_DIR / "assign.cu").read_text()
    assert re.search(r"constexpr int kSortCtas = (\d+);", sort_h).group(1) == \
        str(kernels.SORT_CTAS)
    assert re.search(r"constexpr int kNoCluster = (-?\d+);", sort_h).group(1) == \
        str(kernels.NO_CLUSTER)
    assert re.search(r"constexpr int kSharedTiles = (\d+);", assign).group(1) == \
        str(kernels.SHARED_TILES)


def _front_by_plain(calls):
    """A stand-in for kernel T's wrapper on CPU tensors: its plain version,
    returned in the wrapper's order; each call's points go to ``calls``."""
    from types import SimpleNamespace

    def front(points, times, valid, stamp, delay, max_dist, imu, ego, tf, scan_time_end,
              run_deskew, bug_compat_z, window=64):
        calls.append(points)
        f = truntime.scan_front_plain(
            SimpleNamespace(imu_ring=imu, ego_ring=ego), stamp, points, times, valid,
            SimpleNamespace(lidar_time_delay=delay, input_max_dist=max_dist,
                            tf_ego_to_lidar=tf),
            SimpleNamespace(scan_time_end=scan_time_end, run_deskew=run_deskew,
                            bug_compat_deskew_z=bug_compat_z))
        i = f.info
        return (f.valid, f.points, f.scan_cur, f.scan_end, f.init_guess, f.found, f.usable,
                f.deskew_ok, i.imu_time, i.imu_rot, i.imu_included, i.first_idx, i.last_idx,
                i.odom_incre, i.imu_available, i.odom_available, i.imu_covers_start)

    return front


def test_scan_step_card_branch_ends_the_scan_in_kernel_s(both_worlds, monkeypatch):
    """On the card route (``runtime._on_card``) the scan's end is one call of
    kernel S's wrapper a scan (``kernels.pcm_stage``, stubbed here by its
    plain version), in fused_frame and in ``run``: kernel L
    (``kernels.pcm_measurement``) is never called, nor kernel I or
    ``update_chain`` with a PCM pose, and the outputs are the CPU route's."""
    from types import SimpleNamespace

    from elimaloc_tpu_torch import kernels
    from elimaloc_tpu_torch.ekf import filter as tfilter
    from elimaloc_tpu_torch.pipeline import LocalizationPipeline

    _, tw = both_worlds
    log = tlog.synthesize_log(tw, duration=0.8, points_per_scan=512, max_range=50.0,
                              seed=10)
    pipe = LocalizationPipeline(tiny_cfg(tconfig), tw, device="cpu", ds_points=512,
                                tile_budget=ttiles.TileQueryBudget(qb=8, max_slots=512),
                                use_native=False, ego_ring_size=64, imu_ring_size=64)
    _, ref_frames = pipe.run_fused(log)
    _, ref_events = pipe.run(log)
    calls = []

    def stage(ekf, params, flags, pose, tf, local_cov, fitness, success, usable, ring, end,
              use_pcm):
        calls.append(pose)
        res = SimpleNamespace(pose=pose, local_cov=local_cov, fitness=fitness, success=success)
        ekf, meas, pub = truntime.pcm_stage_plain(ekf, res, tf, ring, end, usable, params,
                                                  flags, use_pcm)
        return ekf, (pub["icp_pose"], meas.timestamp, meas.pos, meas.rot, meas.pos_cov,
                     meas.rot_cov, pub["applied"], *(pub[k] for k in truntime.PUBLISHED))

    def refused(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} called on the card route of the scan's end")
        return fn

    def no_pcm(fn):
        def chain(*a, **k):
            assert k.get("pcm") is None, "a PCM pose went through update_chain"
            return fn(*a, **k)
        return chain

    monkeypatch.setattr(truntime, "_on_card", lambda t: True)
    monkeypatch.setattr(kernels, "scan_front", _front_by_plain([]))
    monkeypatch.setattr(kernels, "pcm_stage", stage)
    monkeypatch.setattr(kernels, "pcm_measurement", refused("kernels.pcm_measurement"))
    monkeypatch.setattr(kernels, "ekf_update", refused("kernels.ekf_update"))
    monkeypatch.setattr(truntime, "update_chain", no_pcm(truntime.update_chain))
    monkeypatch.setattr(tfilter, "update_chain", no_pcm(tfilter.update_chain))
    _, frames = pipe.run_fused(log)
    n = len(log.scan_t)
    assert len(calls) == n > 0
    _, events = pipe.run(log)
    assert len(calls) == 2 * n
    for k, v in ref_frames.items():
        np.testing.assert_array_equal(frames[k], v, err_msg=k)
    for k in ("t", "pos", "rpy"):
        np.testing.assert_array_equal(events[k], ref_events[k], err_msg=k)


def test_scan_step_card_branch_runs_the_front_in_kernel_t(both_worlds, monkeypatch):
    """On the card route (``runtime._on_card``) the scan's front is one call
    of kernel T's wrapper a scan (``kernels.scan_front``, stubbed here by its
    plain version), in fused_frame and in ``run``: kernel K
    (``kernels.scan_ring_query``) and kernel D (``kernels.deskew``) are never
    called, and the outputs are the CPU route's."""
    from types import SimpleNamespace

    from elimaloc_tpu_torch import kernels
    from elimaloc_tpu_torch.pipeline import LocalizationPipeline

    _, tw = both_worlds
    log = tlog.synthesize_log(tw, duration=0.8, points_per_scan=512, max_range=50.0,
                              seed=10)
    pipe = LocalizationPipeline(tiny_cfg(tconfig), tw, device="cpu", ds_points=512,
                                tile_budget=ttiles.TileQueryBudget(qb=8, max_slots=512),
                                use_native=False, ego_ring_size=64, imu_ring_size=64)
    _, ref_frames = pipe.run_fused(log)
    _, ref_events = pipe.run(log)
    calls = []

    def stage(ekf, params, flags, pose, tf, local_cov, fitness, success, usable, ring, end,
              use_pcm):
        res = SimpleNamespace(pose=pose, local_cov=local_cov, fitness=fitness, success=success)
        ekf, meas, pub = truntime.pcm_stage_plain(ekf, res, tf, ring, end, usable, params,
                                                  flags, use_pcm)
        return ekf, (pub["icp_pose"], meas.timestamp, meas.pos, meas.rot, meas.pos_cov,
                     meas.rot_cov, pub["applied"], *(pub[k] for k in truntime.PUBLISHED))

    def refused(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} called on the card route of the scan's front")
        return fn

    monkeypatch.setattr(truntime, "_on_card", lambda t: True)
    monkeypatch.setattr(kernels, "scan_front", _front_by_plain(calls))
    monkeypatch.setattr(kernels, "pcm_stage", stage)
    monkeypatch.setattr(kernels, "scan_ring_query", refused("kernels.scan_ring_query"))
    monkeypatch.setattr(kernels, "deskew", refused("kernels.deskew"))
    _, frames = pipe.run_fused(log)
    n = len(log.scan_t)
    assert len(calls) == n > 0
    _, events = pipe.run(log)
    assert len(calls) == 2 * n
    for k, v in ref_frames.items():
        np.testing.assert_array_equal(frames[k], v, err_msg=k)
    for k in ("t", "pos", "rpy"):
        np.testing.assert_array_equal(events[k], ref_events[k], err_msg=k)
