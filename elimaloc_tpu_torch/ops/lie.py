"""SO(3) / quaternion / Euler utilities — port of ``elimaloc_tpu/ops/lie.py``.

Same semantics as the JAX functions (reference: localization_functions.hpp:
248-483): branch-free small-angle guards with ``torch.where`` on safe
operands, quaternions ``[..., 4]`` in (w, x, y, z) order, dtype and device
follow the inputs. Norms are written as ``sqrt(sum(x*x))``, the form
``jnp.linalg.norm`` lowers to, so float64 results track the reference to
rounding.
"""

from __future__ import annotations

import math

import torch

_EPS_THETA = 1e-5  # small-angle guard, same threshold as the reference


def norm(v, keepdim: bool = False):
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------- #
# Angle helpers (localization_functions.hpp:248-303)
# --------------------------------------------------------------------------- #

def norm_angle_rad(angle):
    """Wrap angle(s) to (-pi, pi]. Reference: NormAngleRad (hpp:263-271)."""
    wrapped = torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi
    return torch.where(wrapped == -math.pi, torch.full_like(wrapped, math.pi),
                       wrapped)


def norm_angle_deg(angle):
    """Wrap angle(s) to [0, 360). Reference: NormAngleDeg (hpp:248-256)."""
    return torch.remainder(angle, 360.0)


def angle_diff_rad(ref, rel):
    """Shortest signed difference rel - ref in radians (AngleDiffRad)."""
    return norm_angle_rad(rel - ref)


def angle_diff_deg(ref, rel):
    """Shortest signed difference rel - ref in degrees, in (-180, 180]
    (AngleDiffDeg)."""
    d = torch.remainder(rel - ref + 180.0, 360.0) - 180.0
    return torch.where(d == -180.0, torch.full_like(d, 180.0), d)


# --------------------------------------------------------------------------- #
# so(3) <-> SO(3) (localization_functions.hpp:380-483)
# --------------------------------------------------------------------------- #

def skew(v):
    """3-vector(s) -> skew-symmetric matrix (hpp:380)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(omega):
    """so(3) vector -> rotation matrix (Rodrigues, hpp:410-419)."""
    theta = norm(omega, keepdim=True)
    small = theta < _EPS_THETA
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    k = skew(omega / safe_theta)
    t = theta[..., None]
    eye = _eye(3, omega).expand(k.shape)
    rot = eye + torch.sin(t) * k + (1.0 - torch.cos(t)) * (k @ k)
    return torch.where(small[..., None], eye, rot)


def so3_log(rot):
    """Rotation matrix -> so(3) vector (hpp:393-403); zero below the guard."""
    tr = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    small = torch.abs(theta) < _EPS_THETA
    safe_sin = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    log_m = (rot - rot.transpose(-1, -2)) / (2.0 * safe_sin)[..., None, None]
    vec = torch.stack(
        [log_m[..., 2, 1], log_m[..., 0, 2], log_m[..., 1, 0]], dim=-1)
    return torch.where(small[..., None], torch.zeros_like(vec),
                       theta[..., None] * vec)


def exp_gyro_to_rot(gyro, dt):
    """Rotation increment from body rates over dt (ExpGyroToRotMatrix)."""
    return so3_exp(gyro * dt)


def right_jacobian_d_rot_d_gyro(gyro, dt):
    """d Exp(gyro*dt) / d gyro (hpp:466-483); zero for near-zero rotation."""
    omega = gyro * dt
    theta = norm(omega, keepdim=True)
    small = theta < _EPS_THETA
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    k = skew(omega / safe_theta)
    t = safe_theta[..., None]
    eye = _eye(3, gyro).expand(k.shape)
    jac = dt * (
        eye
        + (1.0 - torch.cos(t)) / (t * t) * k
        + (t - torch.sin(t)) / (t * t * t) * (k @ k)
    )
    return torch.where(small[..., None], torch.zeros_like(jac), jac)


# --------------------------------------------------------------------------- #
# Euler <-> rotation matrix with gimbal-lock branch (hpp:312-345)
# --------------------------------------------------------------------------- #

def rot_to_euler(rot):
    """Rotation matrix -> (roll, pitch, yaw), gimbal-lock-safe (hpp:312-333),
    with the C ``fmod`` renormalization."""
    r20 = rot[..., 2, 0]
    locked = torch.abs(r20) > 0.998
    yaw_l = torch.atan2(-rot[..., 1, 2], rot[..., 1, 1])
    pitch_l = (math.pi / 2.0) * torch.where(
        r20 >= 0, torch.ones_like(r20), -torch.ones_like(r20))
    roll_l = torch.zeros_like(yaw_l)

    pitch = torch.arcsin(-torch.clamp(r20, -1.0, 1.0))
    cp = torch.cos(pitch)
    safe_cp = torch.where(torch.abs(cp) < 1e-12, torch.ones_like(cp), cp)
    roll = torch.atan2(rot[..., 2, 1] / safe_cp, rot[..., 2, 2] / safe_cp)
    yaw = torch.atan2(rot[..., 1, 0] / safe_cp, rot[..., 0, 0] / safe_cp)

    angles = torch.stack(
        [
            torch.where(locked, roll_l, roll),
            torch.where(locked, pitch_l, pitch),
            torch.where(locked, yaw_l, yaw),
        ],
        dim=-1,
    )
    return torch.fmod(angles + math.pi, 2.0 * math.pi) - math.pi


def euler_to_rot(rpy):
    """(roll, pitch, yaw) -> Rz(yaw) Ry(pitch) Rx(roll) (hpp:340-345)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack(
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack(
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], dim=-2)


# --------------------------------------------------------------------------- #
# Quaternions, (w, x, y, z)
# --------------------------------------------------------------------------- #

def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    n = norm(q, keepdim=True)
    return q / torch.where(n < 1e-30, torch.ones_like(n), n)


def quat_mul(a, b):
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_to_rot(q):
    """Unit quaternion -> rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_to_quat(rot):
    """Rotation matrix -> unit quaternion (w >= 0), branch-free max-pivot."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    def build(pw, px, py, pz):
        return torch.stack([pw, px, py, pz], dim=-1)

    s0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-30)) * 2.0
    q0 = build(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-30)) * 2.0
    q1 = build((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    s2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-30)) * 2.0
    q2 = build((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    s3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-30)) * 2.0
    q3 = build((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = quat_normalize(q)
    return torch.where(q[..., 0:1] < 0, -q, q)


def quat_from_axis_angle(axis_vec):
    """Rotation vector -> quaternion, identity for ~zero (hpp:133-141)."""
    angle = norm(axis_vec, keepdim=True)
    small = angle < 1e-12
    safe = torch.where(small, torch.ones_like(angle), angle)
    axis = axis_vec / safe
    half = 0.5 * angle
    q = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    ident = torch.cat([torch.ones_like(q[..., :1]), torch.zeros_like(q[..., 1:])],
                      dim=-1)
    return torch.where(small, ident, q)


def exp_gyro_to_quat(gyro, dt):
    """Quaternion increment from body rates over dt (ExpGyroToQuat)."""
    return rot_to_quat(so3_exp(gyro * dt))


def matvec(m, v):
    """[..., i, j] @ [..., j] -> [..., i]."""
    return (m @ v[..., None])[..., 0]


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q."""
    return matvec(quat_to_rot(q), v)


def euler_residual_from_quats(state_q, meas_q):
    """Per-axis wrapped Euler residual (CalEulerResidualFromQuat, hpp:355-370)."""
    s = rot_to_euler(quat_to_rot(state_q))
    m = rot_to_euler(quat_to_rot(meas_q))
    return norm_angle_rad(m - s)


# --------------------------------------------------------------------------- #
# SE(3) 4x4 helpers
# --------------------------------------------------------------------------- #

def make_transform(rot, trans):
    """(3x3, 3) -> 4x4 homogeneous transform (batched)."""
    batch = torch.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    top = torch.cat(
        [rot.expand(batch + (3, 3)), trans[..., None].expand(batch + (3, 1))],
        dim=-1,
    )
    bottom = torch.cat([torch.zeros_like(top[..., :1, :3]),
                        torch.ones_like(top[..., :1, 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def compose(a, b):
    """Rigid 4x4 compose ``a @ b`` in full precision (the package pins full
    f32 matmuls at import; see __init__)."""
    return a @ b


def transform_inverse(tf):
    """Closed-form inverse of a rigid 4x4 transform."""
    rot_t = tf[..., :3, :3].transpose(-1, -2)
    return make_transform(rot_t, -matvec(rot_t, tf[..., :3, 3]))


def transform_points(tf, pts):
    """Apply a 4x4 transform to [..., N, 3] points."""
    rot = tf[..., :3, :3]
    return pts @ rot.transpose(-1, -2) + tf[..., None, :3, 3]


def interpolate_tf_with_time(tf_between, dt_scan, dt_trans):
    """Fractional rigid transform: ratio * translation, slerp(I, R); identity
    when dt_trans == 0 (InterpolateTfWithTime, hpp:219-241)."""
    zero = dt_trans == 0.0
    ratio = torch.where(
        zero, torch.zeros_like(dt_scan),
        dt_scan / torch.where(zero, torch.ones_like(dt_trans), dt_trans))
    trans = tf_between[..., :3, 3] * ratio
    rot = so3_exp(so3_log(tf_between[..., :3, :3]) * ratio)
    ident = _eye(4, tf_between).expand(tf_between.shape)
    return torch.where(zero[..., None, None], ident, make_transform(rot, trans))


def inv3x3(m):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]
