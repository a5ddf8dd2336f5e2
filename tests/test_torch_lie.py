"""Port parity: elimaloc_tpu_torch.ops.{lie,frames} vs elimaloc_tpu.ops.

Inputs come from a seeded NumPy generator and include the small-angle
(< 1e-5 rad) and gimbal-lock (|R20| > 0.998) branches. Tolerance: an
absolute bound scaled by the output's magnitude (at least 1) — float64
1e-12 (the two sides run the same formulas; only libm and summation-order
ulps differ), float32 1e-5 (a few f32 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu.ops import frames as jframes
from elimaloc_tpu.ops import lie as jlie
from elimaloc_tpu_torch.ops import frames as tframes
from elimaloc_tpu_torch.ops import lie as tlie

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _vecs(rng, n=64):
    v = rng.normal(size=(n, 3))
    v[:4] *= 1e-7          # below the 1e-5 small-angle guard
    v[4:8] *= np.pi / np.linalg.norm(v[4:8], axis=1, keepdims=True) * 0.999
    return v


def _rots(rng, n=64):
    rpy = rng.uniform(-np.pi, np.pi, size=(n, 3))
    rpy[:4, 1] = np.pi / 2 - 1e-4     # gimbal lock, both signs
    rpy[4:8, 1] = -np.pi / 2 + 1e-4
    return np.asarray(jlie.euler_to_rot(jnp.asarray(rpy, jnp.float64)))


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _tfs(rng, n=16):
    r = _rots(rng, n)
    tf = np.tile(np.eye(4), (n, 1, 1))
    tf[:, :3, :3] = r
    tf[:, :3, 3] = rng.normal(size=(n, 3)) * 50.0
    return tf


CASES = {
    "norm_angle_rad": (lambda r: [r.uniform(-20, 20, 200)],
                       jlie.norm_angle_rad, tlie.norm_angle_rad),
    "skew": (lambda r: [_vecs(r)], jlie.skew, tlie.skew),
    "so3_exp": (lambda r: [_vecs(r)], jlie.so3_exp, tlie.so3_exp),
    "so3_log": (lambda r: [_rots(r)], jlie.so3_log, tlie.so3_log),
    "right_jacobian": (lambda r: [_vecs(r) * 10.0, np.float64(0.01)],
                       jlie.right_jacobian_d_rot_d_gyro,
                       tlie.right_jacobian_d_rot_d_gyro),
    "rot_to_euler": (lambda r: [_rots(r)], jlie.rot_to_euler, tlie.rot_to_euler),
    "euler_to_rot": (lambda r: [r.uniform(-4, 4, (64, 3))], jlie.euler_to_rot,
                     tlie.euler_to_rot),
    "quat_normalize": (lambda r: [r.normal(size=(64, 4))], jlie.quat_normalize,
                       tlie.quat_normalize),
    "quat_mul": (lambda r: [_quats(r), _quats(r)], jlie.quat_mul, tlie.quat_mul),
    "quat_conj": (lambda r: [_quats(r)], jlie.quat_conj, tlie.quat_conj),
    "quat_to_rot": (lambda r: [_quats(r)], jlie.quat_to_rot, tlie.quat_to_rot),
    "rot_to_quat": (lambda r: [_rots(r)], jlie.rot_to_quat, tlie.rot_to_quat),
    "quat_from_axis_angle": (lambda r: [_vecs(r)], jlie.quat_from_axis_angle,
                             tlie.quat_from_axis_angle),
    "exp_gyro_to_quat": (lambda r: [_vecs(r) * 20.0, np.float64(0.01)],
                         jlie.exp_gyro_to_quat, tlie.exp_gyro_to_quat),
    "quat_rotate": (lambda r: [_quats(r), r.normal(size=(64, 3)) * 30.0],
                    jlie.quat_rotate, tlie.quat_rotate),
    "euler_residual": (lambda r: [_quats(r), _quats(r)],
                       jlie.euler_residual_from_quats,
                       tlie.euler_residual_from_quats),
    "make_transform": (lambda r: [_rots(r, 16), r.normal(size=(16, 3))],
                       jlie.make_transform, tlie.make_transform),
    "transform_inverse": (lambda r: [_tfs(r)], jlie.transform_inverse,
                          tlie.transform_inverse),
    "transform_points": (lambda r: [_tfs(r, 1)[0], r.normal(size=(50, 3)) * 40.0],
                         jlie.transform_points, tlie.transform_points),
    "compose": (lambda r: [_tfs(r), _tfs(r)], jlie.compose, tlie.compose),
    "interpolate_tf": (lambda r: [_tfs(r, 1)[0], np.float64(0.03),
                                  np.float64(0.1)],
                       jlie.interpolate_tf_with_time,
                       tlie.interpolate_tf_with_time),
    "interpolate_tf_zero_dt": (lambda r: [_tfs(r, 1)[0], np.float64(0.03),
                                          np.float64(0.0)],
                               jlie.interpolate_tf_with_time,
                               tlie.interpolate_tf_with_time),
    "inv3x3": (lambda r: [r.normal(size=(64, 3, 3)) + 3 * np.eye(3)],
               jlie.inv3x3, tlie.inv3x3),
    "global_to_local_velocity": (
        lambda r: [r.normal(size=(64, 3)) * 10, r.uniform(-3, 3, (64, 3))],
        jframes.global_to_local_velocity, tframes.global_to_local_velocity),
    "local_to_global_velocity": (
        lambda r: [r.normal(size=(64, 3)) * 10, r.uniform(-3, 3, (64, 3))],
        jframes.local_to_global_velocity, tframes.local_to_global_velocity),
    "imu_to_ego": (
        lambda r: [r.normal(size=(32, 3)) * 9.8, r.normal(size=(32, 3)),
                   _rots(r, 1)[0], r.normal(size=3)],
        jframes.imu_to_ego, tframes.imu_to_ego),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_matches_jax(name, dtype):
    make, jfn, tfn = CASES[name]
    args = [np.asarray(a, dtype) for a in make(np.random.default_rng(5))]
    ref = jfn(*[jnp.asarray(a) for a in args])
    got = tfn(*[torch.as_tensor(a) for a in args])
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for g, r in zip(gots, refs):
        assert g.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL[dtype] * max(1.0, float(np.abs(r).max())))
