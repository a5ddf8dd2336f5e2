"""Guards of the PyTorch port.

* ``import elimaloc_tpu_torch`` (every submodule) never imports jax or the
  JAX package: the GPU host has no jax.
* The port's NumPy copies (config, the synthetic world and log, the voxel
  map builder, the tile packer, the fused batch builder) produce
  bit-identical output to the JAX package's on the same seeds.
* Features the slice does not run raise NotImplementedError naming the
  ROADMAP item instead of running silently.
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


@pytest.mark.parametrize("change", ["gicp", "window", "hash"])
def test_pipeline_refuses_unported(both_worlds, change):
    _, tw = both_worlds
    cfg = tiny_cfg(tconfig)
    kw = {}
    if change == "gicp":
        cfg.pcm.icp_method = tconfig.IcpMethod.GICP
    elif change == "window":
        kw["map_window_radius"] = 40.0
    else:
        kw["backend"] = "hash"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        truntime.LocalizationPipeline(cfg, tw[:1000], use_native=False, **kw)


@pytest.mark.parametrize("flag", ["use_gps", "use_can"])
def test_fused_frame_refuses_gps_can(flag):
    static = dataclasses.replace(
        truntime.make_pipeline_static(tiny_cfg(tconfig)), **{flag: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        truntime.fused_frame(None, {}, None, None, static)
