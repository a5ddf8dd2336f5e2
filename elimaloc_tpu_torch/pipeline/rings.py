"""Fixed-size state rings — port of ``elimaloc_tpu/pipeline/rings.py``.

Chronologically ordered fixed arrays + a count, as in the JAX version:
"pop front when full" is a roll, the reference's clear-on-time-regression
guards (pcm_matching.cpp:330-334, 345-350; ekf_localization.cpp:405) are
masked resets, and a batch push gives the same result as sequential pushes.

On the card a frame's (and an IMU event's) pushes into both rings run
inside kernel H (``runtime.imu_subbatch``), the tick mode's one-ring
pushes inside kernels U (the tick's ego push, ``runtime.tick_step``) and V
(the IMU-only intake, ``runtime.imu_ring_step``), the pose sync inside
kernel T (kernel K's body, ``runtime.scan_front``) and the latency
compensation inside kernel S (kernel L's body, ``runtime.pcm_stage``); the
functions here are their plain versions, which CPU tensors run. Kernel J
(``kernels.ring_push``, plain version :func:`push_rings_plain`) is U's and
V's reference, and pushes the one row of :func:`push_ego` and
:func:`push_imu` on the card.

A fleet's rings carry a leading lane axis on every field (t [B, R], the
[B, R, 3] fields, count [B]); ``capacity`` is R either way.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..ops import lie
from ..struct import Struct


@dataclasses.dataclass
class EgoRing(Struct):
    """Published EKF state history (UpdateEkfOdom, ekf_localization.cpp:518-556)."""

    t: torch.Tensor          # [R]
    pos: torch.Tensor        # [R,3]
    rpy: torch.Tensor        # [R,3]
    vel_local: torch.Tensor  # [R,3]
    gyro: torch.Tensor       # [R,3]
    count: torch.Tensor      # int32 valid entries (chronological prefix)

    @property
    def capacity(self) -> int:
        return self.t.shape[-1]

    def valid_mask(self):
        return torch.arange(self.capacity, device=self.t.device) < self.count


@dataclasses.dataclass
class ImuRing(Struct):
    t: torch.Tensor     # [R]
    gyro: torch.Tensor  # [R,3]
    acc: torch.Tensor   # [R,3]
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.t.shape[-1]

    def valid_mask(self):
        return torch.arange(self.capacity, device=self.t.device) < self.count


def make_ego_ring(capacity: int, dtype=torch.float32, device=None) -> EgoRing:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EgoRing(t=z(capacity), pos=z(capacity, 3), rpy=z(capacity, 3),
                   vel_local=z(capacity, 3), gyro=z(capacity, 3),
                   count=torch.tensor(0, dtype=torch.int32, device=device))


def make_imu_ring(capacity: int, dtype=torch.float32, device=None) -> ImuRing:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ImuRing(t=z(capacity), gyro=z(capacity, 3), acc=z(capacity, 3),
                   count=torch.tensor(0, dtype=torch.int32, device=device))


def _first_true(mask):
    """Index of the first True (0 if none), like ``jnp.argmax`` on bool."""
    return torch.argmax(mask.to(torch.int32))


def take(x, i):
    """``x[i]`` for a 0-d index tensor ``i`` without a host sync (PyTorch
    reads a 0-d tensor index back to the host; a 1-element index does not)."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def _last_true(mask):
    """Index of the last True (n-1 if none), like ``n-1-argmax(mask[::-1])``."""
    return mask.shape[0] - 1 - torch.argmax(torch.flip(mask, (0,)).to(torch.int32))


def _push_arrays_batch(ring, fields, new_t, valid, guard_eps):
    """M chronological pushes at once with the result of M sequential pushes
    (rings.py:126-180). PRECONDITION: ``new_t`` is nondecreasing over valid
    samples, so a time regression can only happen at the first valid one."""
    cap = ring.capacity
    if new_t.shape[0] > cap:
        # M rolling pushes into a cap-deep ring keep the last cap samples
        new_t = new_t[-cap:]
        valid = valid[-cap:]
        fields = {k: v[-cap:] for k, v in fields.items()}
    count0 = ring.count.to(torch.int64)
    last0 = take(ring.t, torch.clamp(count0 - 1, min=0))
    first_t = take(new_t, _first_true(valid))
    regress = torch.any(valid) & (count0 > 0) & (last0 > first_t)
    count0 = torch.where(regress, torch.zeros_like(count0), count0)
    has0 = count0 > 0
    last = torch.where(has0, take(ring.t, torch.clamp(count0 - 1, min=0)),
                       torch.full_like(last0, -torch.inf)).to(new_t.dtype)

    # the eps-dedupe acceptance chain, one sample at a time (lax.scan there)
    accept = []
    for i in range(new_t.shape[0]):
        a = valid[i] & (last + guard_eps < new_t[i])
        last = torch.where(a, new_t[i], last)
        accept.append(a)
    accept = torch.stack(accept)

    ranks = torch.cumsum(accept.to(torch.int64), 0) - 1
    n_acc = ranks[-1] + 1
    # rolling once by the total overflow == rolling by one per overflowing push
    roll_amt = torch.clamp(count0 + n_acc - cap, min=0)
    base = count0 - roll_amt
    dst = torch.where(accept, base + ranks, torch.full_like(ranks, cap))
    src = (torch.arange(cap, device=new_t.device) + roll_amt) % cap

    def upd(arr, vals):
        out = torch.cat([arr[src], arr[:1]])       # row cap absorbs drops
        out[dst] = vals.to(arr.dtype)
        return out[:cap]

    new_fields = {k: upd(getattr(ring, k), v) for k, v in fields.items()}
    new_count = torch.clamp(count0 + n_acc, max=cap).to(torch.int32)
    return ring.replace(count=new_count, **new_fields)


def push_ego_batch(ring: EgoRing, t, pos, rpy, vel_local, gyro, valid) -> EgoRing:
    return _push_arrays_batch(
        ring, dict(t=t, pos=pos, rpy=rpy, vel_local=vel_local, gyro=gyro),
        t, valid, guard_eps=1e-5)


def push_imu_batch(ring: ImuRing, t, gyro, acc, valid) -> ImuRing:
    return _push_arrays_batch(ring, dict(t=t, gyro=gyro, acc=acc), t, valid,
                              guard_eps=0.0)


def push_rings_plain(ego: EgoRing, imu: ImuRing, ego_new, imu_new, valid):
    """Plain PyTorch version of kernel J: ``ego_new = (t, pos, rpy,
    vel_local, gyro)`` through :func:`push_ego_batch` and ``imu_new = (t,
    gyro, acc)`` through :func:`push_imu_batch`, both masked by ``valid``. A
    ring given as None (with its samples None) is left out and comes back
    None."""
    return (None if ego is None else push_ego_batch(ego, *ego_new, valid),
            None if imu is None else push_imu_batch(imu, *imu_new, valid))


def _one_row(ring, t, fields):
    """``t`` (a Python float or a 0-d tensor) and [3] fields as the one-row
    batch of a push, in the ring's dtype on its device, with its mask. A
    tensor must lie on the ring's device (no copy, no host read is made for
    it); a Python number or an array is made there."""
    like = ring.t

    def on_ring(v, shape):
        if isinstance(v, torch.Tensor):
            if v.device != like.device:
                raise ValueError(f"a push into a ring on {like.device} was given a "
                                 f"tensor on {v.device}")
            return v.to(like.dtype).reshape(shape)
        if shape == (1,) and isinstance(v, (int, float)):
            return torch.full(shape, v, dtype=like.dtype, device=like.device)
        return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(shape)

    rows = [on_ring(v, (1, 3)) for v in fields]
    return on_ring(t, (1,)), rows, torch.ones(1, dtype=torch.bool, device=like.device)


def push_ego(ring: EgoRing, t, pos, rpy, vel_local, gyro) -> EgoRing:
    """One sample into the ego ring (rings.py:106): accepted when newer than
    the last entry by 1e-5, a time regression clears the ring first, a full
    ring rolls. On the card one launch of kernel J, on the CPU
    :func:`push_ego_batch` of one row."""
    t, rows, valid = _one_row(ring, t, (pos, rpy, vel_local, gyro))
    if ring.t.device.type == "cpu":
        return push_ego_batch(ring, t, *rows, valid)
    return kernels.ring_push(ring, None, (t, *rows), None, valid)[0]


def push_imu(ring: ImuRing, t, gyro, acc) -> ImuRing:
    """One sample into the IMU ring (rings.py:116): as :func:`push_ego` with
    eps 0, so an equal time is dropped."""
    t, rows, valid = _one_row(ring, t, (gyro, acc))
    if ring.t.device.type == "cpu":
        return push_imu_batch(ring, t, *rows, valid)
    return kernels.ring_push(None, ring, None, (t, *rows), valid)[1]


def imu_intake_plain(ring: ImuRing, t, acc_raw, gyro_raw, ego_to_imu_rot) -> ImuRing:
    """Plain PyTorch version of kernel V: one raw IMU sample rotated into
    the ego frame without lever-arm compensation, then pushed into the IMU
    ring (:func:`push_imu_batch`, eps 0): JAX ``runtime.py:237-246``
    imu_ring_step."""
    one = torch.ones(1, dtype=torch.bool, device=t.device)
    return push_imu_batch(ring, t.reshape(1), gyro_raw[None] @ ego_to_imu_rot.T,
                          acc_raw[None] @ ego_to_imu_rot.T, one)


# --------------------------------------------------------------------------- #
# Pose interpolation at scan-end time (GetInterpolatedPose,
# pcm_matching.cpp:933-1045)
# --------------------------------------------------------------------------- #

def get_interpolated_pose(ring: EgoRing, t):
    """Ego pose at time t: slerp between the bracketing samples, or velocity /
    Euler-rate extrapolation past the last one. Returns (pose [4,4], found)."""
    valid = ring.valid_mask()
    le = valid & (ring.t <= t)
    gt = valid & (ring.t > t)
    found_before = torch.any(le)
    found_after = torch.any(gt)

    before_idx = torch.where(found_before, _last_true(le),
                             torch.zeros((), dtype=torch.int64, device=t.device))
    after_idx = torch.where(found_after, _first_true(gt), before_idx)

    def tf_of(i):
        return lie.make_transform(lie.euler_to_rot(take(ring.rpy, i)), take(ring.pos, i))

    tf_before = tf_of(before_idx)

    # extrapolated "after" sample (cpp:956-1011)
    last = torch.clamp(ring.count.to(torch.int64) - 1, min=0)
    dt_ex = t - take(ring.t, last)
    rpy_l = take(ring.rpy, last)
    v_glob = lie.matvec(lie.euler_to_rot(rpy_l), take(ring.vel_local, last))
    pos_ex = take(ring.pos, last) + v_glob * dt_ex
    rpy_ex = rpy_l + take(ring.gyro, last) * dt_ex
    tf_after_ex = lie.make_transform(lie.euler_to_rot(rpy_ex), pos_ex)

    tf_after = torch.where(found_after, tf_of(after_idx), tf_after_ex)
    t_after = torch.where(found_after, take(ring.t, after_idx), t)

    between = lie.compose(lie.transform_inverse(tf_before), tf_after)
    dt_scan = t - take(ring.t, before_idx)
    dt_trans = t_after - take(ring.t, before_idx)
    interp = lie.interpolate_tf_with_time(between, dt_scan, dt_trans)
    return lie.compose(tf_before, interp), found_before


# --------------------------------------------------------------------------- #
# Measurement-latency compensation (GnssTimeCompensation,
# ekf_localization.cpp:323-394)
# --------------------------------------------------------------------------- #

def gnss_time_compensation(ring: EgoRing, meas_t, meas_pos, meas_quat):
    """Forward-extrapolate a late measurement to the EKF's current time by
    linear-ratio interpolation over the ego ring. Returns (t', pos', quat',
    ok); ok=False when the ring is empty or its oldest entry is newer than
    the measurement (cpp:331-336)."""
    valid = ring.valid_mask()
    has = ring.count > 0
    last = torch.clamp(ring.count.to(torch.int64) - 1, min=0)
    cur_t = take(ring.t, last)
    cur_pos = take(ring.pos, last)
    cur_rpy = take(ring.rpy, last)

    ok = has & (ring.t[0] <= meas_t)

    # closest = first entry with t > meas_t, else the last entry (cpp:339-345)
    gt = valid & (ring.t > meas_t)
    closest_idx = torch.where(torch.any(gt), _first_true(gt), last)

    dt = cur_t - meas_t
    need = dt > 0.0
    span = cur_t - take(ring.t, closest_idx)
    do = need & (torch.abs(span) > 1e-5)
    ratio = torch.where(
        do, dt / torch.where(span == 0, torch.ones_like(span), span),
        torch.zeros_like(dt))

    dpos = (cur_pos - take(ring.pos, closest_idx)) * ratio
    drpy = lie.norm_angle_rad(cur_rpy - take(ring.rpy, closest_idx)) * ratio

    out_t = torch.where(need, cur_t, meas_t)
    out_pos = meas_pos + torch.where(need, dpos, torch.zeros_like(dpos))
    dq = lie.rot_to_quat(lie.euler_to_rot(
        torch.where(need, drpy, torch.zeros_like(drpy))))
    out_quat = lie.quat_normalize(lie.quat_mul(meas_quat, dq))
    return out_t, out_pos, out_quat, ok
