"""The port's small functions and its packages' exports against the JAX
package's.

* ``ops.lie``: ``norm_angle_deg``, ``angle_diff_rad``, ``angle_diff_deg``
  (at 0, +-180, +-360 and multiples of 360 and on random angles) and
  ``exp_gyro_to_rot``; ``ops.frames``: the two angular-rate conversions,
  with pitch near +-89 deg; ``ekf.imu_calibration`` on a converted state;
  ``register.calculate_velocity`` at small and large angles and
  ``separate_points_z`` with invalid points and points exactly at z; each
  in float32 and float64 (float64 to 1e-12; float32 to the few ulps the
  two libraries' sin / cos / remainder may differ by).
* ``pipeline.push_ego`` / ``push_imu`` over chip_smoke's "[ring pushes]"
  sequence against JAX's: every field and the count after every call
  (float64 to 1e-12, float32 bit for bit).
* Every name each JAX package's ``__init__`` exports, the port's package
  exports (but the sharded modes of ``parallel``, ROADMAP Queue 1, and
  ``align_clouds_global``, ROADMAP's "Not ported").
* ``cuda``-marked (skipped without a card): the same ring sequence on the
  card, one launch of kernel J a call, bit for bit the plain version.
  This module imports JAX only inside its tests, so that case also runs on
  a host without JAX (``python -m pytest --noconftest -m cuda``).
"""

import ast
import dataclasses
import importlib
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.config import EkfConfig
from elimaloc_tpu_torch.ekf import imu_calibration, init_state, make_params
from elimaloc_tpu_torch.ops import frames, lie
from elimaloc_tpu_torch.pipeline import make_ego_ring, make_imu_ring, push_ego, push_imu
from elimaloc_tpu_torch.register import calculate_velocity, separate_points_z
from torch_parity import flatten, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
#: float64 agrees to rounding; float32 within a few ulps of the values'
#: scale (the libraries' sin / cos / remainder round differently)
ATOL = {"f32": 1e-6, "f64": 1e-12}


def jnp_():
    import jax.numpy as jnp

    return jnp


def close(port, ref, key, scale=1.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL[key] * scale)


def angles(np_dt):
    rng = np.random.default_rng(3)
    edges = [0.0, 180.0, -180.0, 360.0, -360.0, 720.0, -720.0, 1080.0, 540.0, -540.0,
             90.0, -90.0, 179.999, -179.999, 359.999]
    return np.r_[edges, rng.uniform(-1000.0, 1000.0, 64)].astype(np_dt)


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_angle_functions_match_jax(key):
    from elimaloc_tpu.ops import lie as jlie

    jnp = jnp_()
    np_dt, t_dt = DTYPES[key]
    deg = angles(np_dt)
    ref_deg = np.roll(deg, 7)
    d, rd = torch.from_numpy(deg), torch.from_numpy(ref_deg)
    close(lie.norm_angle_deg(d), jlie.norm_angle_deg(jnp.asarray(deg)), key)
    got = lie.angle_diff_deg(rd, d)
    close(got, jlie.angle_diff_deg(jnp.asarray(ref_deg), jnp.asarray(deg)), key)
    assert float(got.min()) > -180.0 and float(got.max()) <= 180.0
    # rel - ref exactly -180 (mod 360) comes back as +180, as the reference's
    exact = lie.angle_diff_deg(torch.tensor([0.0, 180.0, 360.0], dtype=t_dt),
                               torch.tensor([-180.0, 0.0, 180.0], dtype=t_dt))
    assert exact.tolist() == [180.0, 180.0, 180.0]
    rad, ref_rad = np.deg2rad(deg).astype(np_dt), np.deg2rad(ref_deg).astype(np_dt)
    close(lie.angle_diff_rad(torch.from_numpy(ref_rad), torch.from_numpy(rad)),
          jlie.angle_diff_rad(jnp.asarray(ref_rad), jnp.asarray(rad)), key)


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_exp_gyro_to_rot_matches_jax(key):
    from elimaloc_tpu.ops import lie as jlie

    jnp = jnp_()
    np_dt, _ = DTYPES[key]
    rng = np.random.default_rng(5)
    gyro = np.r_[rng.normal(size=(32, 3)), np.full((1, 3), 1e-9), np.zeros((1, 3))].astype(np_dt)
    dt = np_dt(0.01)
    close(lie.exp_gyro_to_rot(torch.from_numpy(gyro), dt),
          jlie.exp_gyro_to_rot(jnp.asarray(gyro), dt), key)


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_angular_rates_match_jax_near_gimbal_lock(key):
    from elimaloc_tpu.ops import frames as jframes

    jnp = jnp_()
    np_dt, _ = DTYPES[key]
    rng = np.random.default_rng(7)
    pitch = np.deg2rad([89.0, -89.0, 88.9, -88.99, 89.0, 0.0, 45.0, -30.0])
    rpy = np.c_[rng.uniform(-math.pi, math.pi, 8), pitch, rng.uniform(-math.pi, math.pi, 8)]
    rpy = np.r_[rpy, rng.uniform(-1.5, 1.5, (24, 3))].astype(np_dt)
    rate = rng.normal(size=(len(rpy), 3)).astype(np_dt)
    r_t, rpy_t = torch.from_numpy(rate), torch.from_numpy(rpy)
    close(frames.local_to_global_angular_rate(r_t, rpy_t),
          jframes.local_to_global_angular_rate(jnp.asarray(rate), jnp.asarray(rpy)), key)
    # 1/cos(89 deg) ~ 57: the results reach ~36, float32 rounding with them
    close(frames.global_to_local_angular_rate(r_t, rpy_t),
          jframes.global_to_local_angular_rate(jnp.asarray(rate), jnp.asarray(rpy)), key,
          10.0)


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_imu_calibration_on_a_converted_state(key):
    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu import ekf as jekf

    jnp = jnp_()
    np_dt, t_dt = DTYPES[key]
    params = jekf.make_params(jconfig.EkfConfig(), dtype=jnp.dtype(np_dt))
    q = np.array([0.9, 0.05, -0.2, 0.3])
    st = jekf.init_state(params, dtype=jnp.dtype(np_dt)).replace(
        imu_rot=jnp.asarray(q / np.linalg.norm(q), np_dt))
    port = convert.ekf_state(flatten(st), dtype=t_dt)
    close(imu_calibration(port), jekf.imu_calibration(st), key)
    # the port's own initial state: the identity mounting, zero angles
    mine = init_state(make_params(EkfConfig(), dtype=t_dt), dtype=t_dt)
    assert imu_calibration(mine).abs().max() == 0


@pytest.mark.parametrize("key", sorted(DTYPES))
@pytest.mark.parametrize("angle", [1e-7, 1e-3, 0.5, 3.0])
def test_calculate_velocity_matches_jax(key, angle):
    from elimaloc_tpu.ops import lie as jlie
    from elimaloc_tpu.register import calculate_velocity as j_velocity

    jnp = jnp_()
    np_dt, _ = DTYPES[key]
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    tf = np.eye(4)
    tf[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(axis * angle)))
    tf[:3, 3] = [1.25, -0.5, 0.125]
    tf = tf.astype(np_dt)
    lin, ang = calculate_velocity(torch.from_numpy(tf), 0.1)
    jlin, jang = j_velocity(jnp.asarray(tf), 0.1)
    close(lin, jlin, key, 10.0)
    close(ang, jang, key, 10.0 * (1.0 if angle < 2.0 else 100.0))


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_separate_points_z_matches_jax(key):
    from elimaloc_tpu.register import separate_points_z as j_separate

    jnp = jnp_()
    np_dt, _ = DTYPES[key]
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(64, 3)).astype(np_dt)
    pts[::5, 2] = np_dt(0.25)                  # exactly at z: "down", as the reference
    valid = rng.random(64) > 0.3
    up, down = separate_points_z(torch.from_numpy(pts), torch.from_numpy(valid), 0.25)
    jup, jdown = j_separate(jnp.asarray(pts), jnp.asarray(valid), 0.25)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))
    np.testing.assert_array_equal(down.numpy(), np.asarray(jdown))
    assert not (up & down).any() and torch.equal(up | down, torch.from_numpy(valid))
    assert not up.numpy()[::5].any()


def _ring_fields(ring):
    return {f.name: getattr(ring, f.name) for f in dataclasses.fields(ring)}


def _port_rings(device, t_dt):
    return {"ego": make_ego_ring(chip_smoke.RING_CAPS[0], t_dt, device),
            "imu": make_imu_ring(chip_smoke.RING_CAPS[1], t_dt, device)}


PUSH = {"ego": push_ego, "imu": push_imu}


@pytest.mark.parametrize("key", sorted(DTYPES))
def test_push_ego_push_imu_match_jax_over_the_smoke_sequence(key):
    """chip_smoke's "[ring pushes]" sequence through the port's CPU pushes
    (the plain one-row batch) and JAX's ``push_ego`` / ``push_imu``: after
    every call every field and the count equal (float32 bit for bit,
    float64 to 1e-12); the sequence reaches the capacities and clears."""
    import jax

    from elimaloc_tpu.pipeline import rings as jrings

    jnp = jnp_()
    np_dt, t_dt = DTYPES[key]
    jdt = jnp.dtype(np_dt)
    ref = {"ego": jrings.make_ego_ring(chip_smoke.RING_CAPS[0], jdt),
           "imu": jrings.make_imu_ring(chip_smoke.RING_CAPS[1], jdt)}
    jpush = {"ego": jax.jit(jrings.push_ego), "imu": jax.jit(jrings.push_imu)}
    port = _port_rings("cpu", t_dt)
    seen = {"ego": set(), "imu": set()}
    for i, (kind, t, fields) in enumerate(chip_smoke.ring_push_sequence()):
        port[kind] = PUSH[kind](port[kind], t, *(torch.from_numpy(f.astype(np_dt))
                                                 for f in fields))
        ref[kind] = jpush[kind](ref[kind], jnp.asarray(t, jdt),
                                *(jnp.asarray(f, jdt) for f in fields))
        seen[kind].add(int(port[kind].count))
        if i % 7 and i < 2100:   # every 7th call and the last ones in full
            continue
        for name, v in _ring_fields(port[kind]).items():
            r = np.asarray(getattr(ref[kind], name))
            if key == "f32" or name == "count":
                np.testing.assert_array_equal(v.numpy(), r, err_msg=f"{i} {kind}.{name}")
            else:
                np.testing.assert_allclose(v.numpy(), r, rtol=0, atol=1e-12,
                                           err_msg=f"{i} {kind}.{name}")
        seen[kind].add(int(port[kind].count))
    for kind, cap in zip(("ego", "imu"), chip_smoke.RING_CAPS):
        assert cap in seen[kind] and 1 in seen[kind]
    # a 0-d tensor time, as the pipeline holds its times, pushes the same row
    one = PUSH["imu"](port["imu"], torch.tensor(30.0, dtype=t_dt), torch.ones(3), torch.ones(3))
    two = PUSH["imu"](port["imu"], 30.0, torch.ones(3), torch.ones(3))
    for name, v in _ring_fields(one).items():
        assert torch.equal(v, getattr(two, name)), name


def test_push_on_a_cpu_ring_runs_the_plain_version(monkeypatch):
    """A CPU ring never reaches kernel J's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("kernel J called for a CPU ring")

    monkeypatch.setattr(kernels, "ring_push", refuse)
    ring = push_ego(make_ego_ring(8), 1.0, torch.ones(3), torch.zeros(3), torch.ones(3),
                    torch.zeros(3))
    assert int(ring.count) == 1 and float(ring.t[0]) == 1.0
    assert int(push_imu(make_imu_ring(8), 1.0, torch.ones(3), torch.ones(3)).count) == 1


@pytest.mark.parametrize("where", ["t", "field"])
def test_push_refuses_a_tensor_on_another_device(where):
    """The time and the fields follow one rule: a tensor on another device
    than the ring's is refused, not copied (the meta device stands in for
    the card here)."""
    other = torch.device("meta")
    t = torch.tensor(1.0, device=other) if where == "t" else 1.0
    gyro = torch.ones(3, device=other) if where == "field" else torch.ones(3)
    with pytest.raises(ValueError, match="meta"):
        push_imu(make_imu_ring(8), t, gyro, torch.ones(3))


#: JAX package -> names its __init__ exports that the port leaves out, each
#: with its ROADMAP entry
NOT_EXPORTED = {
    "parallel": {"make_mesh", "register_batch_2d", "register_batch_dp", "register_sharded",
                 "replay_fused_2d", "replay_fused_dp", "replay_fused_sp", "replicate"},
    "register": {"align_clouds_global"},
}


def _exports(path):
    """The names a package ``__init__`` binds by its ``from ... import``
    statements (an ``as`` name where it renames)."""
    tree = ast.parse(open(path).read())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names}


@pytest.mark.parametrize("pkg", ["", "ekf", "map", "pipeline", "register", "parallel",
                                 "utils"])
def test_each_package_exports_what_its_jax_counterpart_exports(pkg):
    jax_init = os.path.join(ROOT, "elimaloc_tpu", pkg, "__init__.py")
    names = _exports(jax_init) - {"config"} - NOT_EXPORTED.get(pkg, set())
    port = importlib.import_module("elimaloc_tpu_torch" + (f".{pkg}" if pkg else ""))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, (pkg, missing)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ring_pushes_on_card_launch_kernel_j_bit_for_bit_plain(cuda):
    """The "[ring pushes]" sequence on card rings: each call one launch of
    kernel J and no other kernel; every ring after every call bit for bit
    the same call on a CPU ring (the plain one-row batch)."""
    card, plain = _port_rings(cuda, torch.float32), _port_rings("cpu", torch.float32)
    seq = chip_smoke.ring_push_sequence()
    kernels.reset_launches()
    for kind, t, fields in seq:
        f = [torch.from_numpy(v) for v in fields]
        card[kind] = PUSH[kind](card[kind], t, *(v.to(cuda) for v in f))
        plain[kind] = PUSH[kind](plain[kind], t, *f)
        for name, v in _ring_fields(card[kind]).items():
            assert torch.equal(v.cpu(), getattr(plain[kind], name)), (kind, t, name)
    assert kernels.launches["ring_push"] == len(seq)
    assert all(v == 0 for k, v in kernels.launches.items() if k != "ring_push")
    # a 0-d CUDA time goes in without a host read
    t, one = torch.tensor(99.0, device=cuda), torch.ones(3, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ring = push_imu(card["imu"], t, one, one)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(ring.t[int(ring.count) - 1]) == 99.0
