"""Helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The same NumPy inputs go to a JAX function and to its port; JAX records are
flattened here to NumPy dicts (``dataclasses.fields`` + ``np.asarray``) and
handed to ``elimaloc_tpu_torch.convert``, which never imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port while a test module that imports
    this fixture runs: under the test runner's parallel workers PyTorch's
    default (a thread per core, in every worker) oversubscribes the CPU many
    times over (the methods' test files ran 3-7x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten(obj):
    """A (JAX or port) dataclass record -> nested dict of NumPy arrays; fields
    that are not arrays (static geometry) pass through."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = flatten(v)
        elif v is None or isinstance(v, (int, float, str, tuple)):
            out[f.name] = v
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = np.asarray(v)
    return out


def assert_tree_close(port, ref, atol, rtol=0.0, path=""):
    """Field-wise comparison of two flattened records (port vs reference)."""
    assert set(port) == set(ref) or set(port) <= set(ref), (path, set(port) ^ set(ref))
    for k, v in port.items():
        r = ref[k]
        if isinstance(v, dict):
            assert_tree_close(v, r, atol, rtol, f"{path}.{k}")
        elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
            np.testing.assert_allclose(v, np.asarray(r, v.dtype), atol=atol,
                                       rtol=rtol, err_msg=f"{path}.{k}")
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, np.asarray(r), err_msg=f"{path}.{k}")


def t(a, dtype=torch.float64):
    """NumPy -> CPU tensor (float arrays take ``dtype``)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.as_tensor(a, dtype=dtype)
    return torch.as_tensor(a)


def tiny_cfg(cfg_mod):
    """The ``tiny_pipe`` configuration of tests/test_pipeline_modes.py:22-43,
    built from either package's config module."""
    cfg = cfg_mod.ElimalocConfig()
    cfg.pcm.icp_method = cfg_mod.IcpMethod.P2P
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    return cfg


def method_cfg(cfg_mod, method):
    """:func:`tiny_cfg` with the ICP method ``method`` (a name such as
    "GICP"); VGICP and AVGICP get bench.py's ``max_fitness_score=2.0`` (the
    mean |residual| to voxel means is ~0.5 m at 1 m voxels)."""
    cfg = tiny_cfg(cfg_mod)
    cfg.pcm.icp_method = cfg_mod.IcpMethod[method]
    if method in ("VGICP", "AVGICP"):
        cfg.pcm.max_fitness_score = 2.0
    return cfg


def tiny_world_and_log(log_mod, duration=3.0):
    world = log_mod.make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = log_mod.synthesize_log(world, duration=duration, points_per_scan=1024,
                                 max_range=50.0, seed=10, gps_hz=1.0)
    return world, log


def stationary_lead(log, seconds, seed):
    """``log`` with ``seconds`` of 100 Hz IMU before its first sample, the
    vehicle at rest (it starts from rest, pipeline/log.py ``_traj``): the
    specific force and the rates are synthesize_log's biases, gravity and
    noise. Frame 0 then holds the lead's samples, and
    ``build_fused_batches`` pads every frame to them."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * 100))
    t = log.imu_t[0] - 0.01 * np.arange(n, 0, -1)
    acc = np.array([0.02, -0.01, 9.81 + 0.015]) + rng.normal(0, 0.02, (n, 3))
    gyro = np.array([0.002, -0.001, 0.003]) + rng.normal(0, 0.002, (n, 3))
    return dataclasses.replace(log, imu_t=np.r_[t, log.imu_t],
                               imu_acc=np.r_[acc, log.imu_acc],
                               imu_gyro=np.r_[gyro, log.imu_gyro])
