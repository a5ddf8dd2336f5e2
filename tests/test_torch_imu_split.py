"""A frame of more IMU samples than one launch of kernel H takes.

``build_fused_batches`` pads every frame to the largest frame's IMU count,
so a log whose IMU stream leads its first scan by seconds gives every frame
more than ``kernels.IMU_STAGE_MAX_SAMPLES`` (1024) samples. The port's
``runtime.imu_subbatch`` runs such a frame in the ranges of
``runtime.imu_chunks`` on both devices (kernel H once a range on the card,
``imu_subbatch_plain`` once a range on the CPU), chaining the EKF state and
the rings. A batch push of n rows into a ring of C < n rows keeps only the
rows n - C..n-1 (rings._push_arrays_batch, as JAX's): a ring takes a
range's output only where that push would.

* ``imu_chunks``: the ranges, ceil(n / 1024) of them for rings of at most
  1024 rows, one more cut at n - C for a ring of C between 1024 and n.
* A frame of 2,500 samples (2,300 valid, then 200 of padding, some invalid
  inside) into an ego ring of 512 rows and an IMU ring of 256, both
  partly filled: the chunked frame against one JAX ``imu_subbatch`` in
  float64 (atol 1e-10, tests/test_torch_imu_chain.py's bound), against one
  unsplit ``imu_subbatch_plain`` call bit for bit, and its ego ring's
  last 512 rows against JAX's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import assert_tree_close, flatten, one_torch_thread, t  # noqa: F401

N = 2500


@pytest.mark.parametrize("n,caps,want", [
    (1000, (512, 256), [(0, 1000)]),
    (1024, (1024, 512), [(0, 1024)]),
    (1025, (1024, 512), [(0, 1), (1, 1025)]),
    (2500, (512, 256), [(0, 452), (452, 1476), (1476, 2500)]),
    (1224, (1100, 1100), [(0, 124), (124, 200), (200, 1224)]),
    (1224, (2048, 2048), [(0, 200), (200, 1224)]),
])
def test_imu_chunks(n, caps, want):
    got = truntime.imu_chunks(n, caps)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(0 < e - s <= 1024 for s, e in got)


def _cfg(mod):
    cfg = mod.ElimalocConfig()
    cfg.calib.ego_to_imu_rot_deg = (0.5, -0.3, 1.0)
    cfg.calib.ego_to_imu_trans = (0.2, 0.0, 0.1)
    return cfg


def _ring(kind, cap, count, rng):
    ring = (jrings.make_ego_ring if kind == "ego" else jrings.make_imu_ring)(cap, jnp.float64)
    fields = ("pos", "rpy", "vel_local", "gyro") if kind == "ego" else ("gyro", "acc")
    return ring.replace(t=jnp.asarray(1.0 - 0.01 * np.arange(cap)[::-1], jnp.float64),
                        count=jnp.asarray(count, jnp.int32),
                        **{f: jnp.asarray(rng.normal(size=(cap, 3))) for f in fields})


@pytest.fixture(scope="module")
def frames():
    """JAX's one frame of N samples and the port's, chunked and in one
    plain call, from the same float64 state, rings and batch."""
    rng = np.random.default_rng(77)
    jpp = jruntime.make_pipeline_params(_cfg(jconfig), dtype=jnp.float64)
    a = rng.normal(size=(27, 27)) * 1e-5
    ekf = jfilter.init_state(jpp.ekf, dtype=jnp.float64).replace(
        P=jnp.asarray(a @ a.T + np.eye(27) * 1e-8), vel=jnp.asarray([5.0, 0.3, 0.0]),
        pos=jnp.asarray([60.0, 2.0, 0.1]), state_initialized=jnp.asarray(True),
        yaw_initialized=jnp.asarray(True), prev_timestamp=jnp.asarray(1.0))
    jst = jruntime.PipelineState(ekf=ekf, ego_ring=_ring("ego", 512, 300, rng),
                                 imu_ring=_ring("imu", 256, 100, rng))
    valid = np.zeros(N, bool)
    valid[:2300] = True
    valid[[7, 800, 1500, 2299]] = False
    ts = np.where(np.arange(N) < 2300, 1.0 + 0.01 * np.arange(1, N + 1), 0.0)
    acc = rng.normal(0, 0.3, (N, 3)) + [0.5, 0.1, 9.81]
    gyro = rng.normal(0, 0.05, (N, 3)) + [0.0, 0.0, 2.0]
    b = dict(imu_t=ts, imu_acc=acc, imu_gyro=gyro, imu_valid=valid)
    jps = jruntime.make_pipeline_static(_cfg(jconfig))
    jout = jruntime.imu_subbatch(jst, {k: jnp.asarray(v) for k, v in b.items()}, jpp, jps)
    tpp = convert.pipeline_params(flatten(jpp), dtype=torch.float64)
    tps = truntime.make_pipeline_static(_cfg(tconfig))
    tst = convert.pipeline_state(flatten(jst), dtype=torch.float64)
    tb = {k: t(v, torch.float64) for k, v in b.items()}
    split = truntime.imu_subbatch(tst, tb, tpp, tps)
    whole = truntime.imu_subbatch_plain(tst, tb, tpp, tps)
    return jout, split, whole, valid


def test_split_frame_matches_one_jax_frame_f64(frames):
    jout, split = frames[:2]
    assert_tree_close(flatten(split), flatten(jout), atol=1e-10)


def test_split_frame_equals_one_unsplit_plain_call(frames):
    _, split, whole, _ = frames
    got, ref = flatten(split), flatten(whole)
    for part in ("ekf", "ego_ring", "imu_ring"):
        for k, v in ref[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part}.{k}")


@pytest.mark.parametrize("ring,cap,old", [("ego_ring", 512, 300), ("imu_ring", 256, 100)])
def test_split_frame_rings_keep_jax_last_rows(frames, ring, cap, old):
    """The rings hold JAX's rows: the frame's valid samples among its last
    ``cap`` positions (one batch push keeps only those, so the padding at
    the frame's end shadows part of the window), after the old rows."""
    jout, split, _, valid = frames
    got, ref = getattr(split, ring), getattr(jout, ring)
    new = int(valid[-cap:].sum())
    assert int(got.count) == int(ref.count) == min(cap, old + new)
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))
    assert int(np.sum(got.t.numpy()[:int(got.count)] > 1.0)) == new
