"""27-state error-state EKF, main-path half — port of
``elimaloc_tpu/ekf/filter.py`` (reference: ekf_algorithm.cpp).

Pure functions ``(state, input, params) -> state`` built from masked selects
exactly as the JAX version, so the port keeps its gate order, its preserved
reference quirks and its dtype dispatch: float32 takes the sparse block
F P F^T and the broadcast-multiply-reduce products (``_vpu_forms``), float64
the dense forms that the float64 oracle parity rests on.

Ported: ``init_state``, the ``check_*`` gates, ``_ekf_measurement_update``
(any selector), ``_fpf_dense``/``_fpf_sparse``, ``_propagate_imu``,
``_zupt_imu``, ``_complementary_filter``, ``_calibrate_vehicle_to_imu``,
``predict_imu``, ``predict`` (the constant-acceleration tick of
``use_imu=False``), ``update_gnss``, ``update_can`` and ``ego_state``, plus
the filter half of the pipeline's GPS step (``update_gps``). A frame's IMU
samples run through :func:`imu_chain_plain` and :func:`ego_history` in the
plain composition of ``pipeline.runtime.imu_subbatch_plain``; on the card
the whole IMU stage (sensor-frame conversion, this chain, the ego-ring rows
and both ring pushes) is one launch of kernel H, ``kernels.imu_stage``.
:func:`update_chain` (CAN and GPS updates: kernel W; with a PCM pose,
kernel I) dispatches by device; :func:`tick_stage_plain` (one CA tick and
its ego push) is kernel U's plain version, which
``pipeline.runtime.tick_step`` runs on CPU tensors. ``EkfFlags.joseph_form``
selects the Joseph-form covariance update in the plain versions and in
kernels H, I and W, which take and give the state as one packed record
(``state.RECORD_FIELDS``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .. import kernels
from ..config import EkfConfig, GnssSource, GpsType
from ..ops import lie
from ..ops.frames import global_to_local_velocity
from ..struct import lane, select
from .state import (
    CanMeas,
    EkfParams,
    EkfState,
    GnssMeas,
    ImuMeas,
    INIT_STATE_COV,
    STATE_ORDER,
    S_AX,
    S_AZ,
    S_B_AX,
    S_B_ROLL_RATE,
    S_G_X,
    S_G_Z,
    S_IMU_ROLL,
    S_PITCH,
    S_ROLL,
    S_ROLL_RATE,
    S_VX,
    S_VZ,
    S_X,
    S_YAW,
    S_YAW_RATE,
    S_Z,
    empty_state,
    stack_states,
)

_D2R = math.pi / 180.0


def _bmm(a, b):
    """Small [m,k]@[k,n] as broadcast-multiply-reduce (the f32 form)."""
    return torch.sum(a[:, :, None] * b[None, :, :], dim=1)


def _vpu_forms(dtype) -> bool:
    """True for float32: sparse F P F^T and ``_bmm``. float64 keeps the dense
    accumulation order of the float64 oracle (filter.py:71-85)."""
    return dtype == torch.float32


@dataclasses.dataclass(frozen=True)
class EkfFlags:
    """Static feature switches (host booleans)."""

    use_zupt: bool = False
    use_complementary_filter: bool = True
    imu_estimate_gravity: bool = True
    imu_estimate_calibration: bool = False
    gps_type: int = int(GpsType.NAVSATFIX)
    joseph_form: bool = False

    @classmethod
    def from_config(cls, cfg: EkfConfig) -> "EkfFlags":
        return cls(
            use_zupt=cfg.use_zupt,
            use_complementary_filter=cfg.use_complementary_filter,
            imu_estimate_gravity=cfg.imu_estimate_gravity,
            imu_estimate_calibration=cfg.imu_estimate_calibration,
            gps_type=int(cfg.gps_type),
        )

    @property
    def run_cf(self) -> bool:
        # reference: ekf_algorithm.cpp:203, 312
        return self.gps_type == int(GpsType.BESTPOS) or self.use_complementary_filter


def _scalar(v, like, dtype=None):
    return torch.tensor(v, dtype=dtype or like.dtype, device=like.device)


# --------------------------------------------------------------------------- #
# Init (ekf_algorithm.cpp:22-66)
# --------------------------------------------------------------------------- #

def init_state(params: EkfParams, dtype=torch.float32) -> EkfState:
    """The initial state, packed in one record (``state.RECORD_FIELDS``) as
    the EKF kernels take it: every field not set here starts at zero or
    false."""
    st = empty_state(dtype, params.init_pos.device)
    st.pos.copy_(params.init_pos)
    st.rot.copy_(lie.rot_to_quat(lie.euler_to_rot(params.init_rpy.to(dtype))))
    P = st.P
    P.copy_(torch.eye(STATE_ORDER, dtype=dtype, device=P.device) * INIT_STATE_COV)
    bias_gyro = params.imu_bias_cov_gyro.to(dtype)
    bias_acc = params.imu_bias_cov_acc.to(dtype)
    for lo, val in ((S_B_ROLL_RATE, bias_gyro), (S_B_AX, bias_acc),
                    (S_G_X, bias_acc), (S_IMU_ROLL, bias_gyro)):
        for i in range(lo, lo + 3):
            P[i, i] = val
    st.grav.copy_(torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=P.device)
                  * params.imu_gravity.to(dtype))
    st.imu_rot.copy_(lie.quat_identity(dtype, P.device))
    st.reset_for_init_prediction.fill_(True)
    return st


# --------------------------------------------------------------------------- #
# Convergence gates (ekf_algorithm.hpp:148-209)
# --------------------------------------------------------------------------- #

def _std(P, i):
    return torch.sqrt(torch.clamp(P[i, i], min=0.0))


def check_state_initialized(P):
    lim = 5.0 * _D2R
    return ((_std(P, S_ROLL) < lim) & (_std(P, S_PITCH) < lim)
            & (_std(P, S_YAW) < lim) & (_std(P, S_X) < 1.0)
            & (_std(P, S_X + 1) < 1.0))


def check_yaw_initialized(P):
    return _std(P, S_YAW) < 5.0 * _D2R


def check_rotation_stabilized(P):
    lim = 0.2 * _D2R
    return (_std(P, S_ROLL) < lim) & (_std(P, S_PITCH) < lim) & (_std(P, S_YAW) < lim)


def check_state_stabilized(P):
    lim = 0.2 * _D2R
    return ((_std(P, S_ROLL) < lim) & (_std(P, S_PITCH) < lim)
            & (_std(P, S_YAW) < lim) & (_std(P, S_X) < 0.5)
            & (_std(P, S_X + 1) < 0.5))


# --------------------------------------------------------------------------- #
# Generic measurement injection (ekf_algorithm.hpp:116-145)
# --------------------------------------------------------------------------- #

def _ekf_measurement_update(state: EkfState, idx: Tuple[int, ...], Y, R,
                            joseph: bool = False) -> EkfState:
    """One Kalman update with H a 0/1 selector of state indices ``idx``
    (any order; CAN observes (6, 7, 8, 11))."""
    P = state.P
    sel = torch.as_tensor(idx, device=P.device)
    Pi = P.index_select(0, sel)         # H P
    S = Pi.index_select(1, sel) + R     # H P H^T + R
    PHt = P.index_select(1, sel)
    m = len(idx)
    small = m <= 3 and _vpu_forms(P.dtype)
    mm = _bmm if small else torch.matmul
    if m == 2:
        # closed-form 2x2 inverse (S is SPD here)
        det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
        Sinv = torch.stack([torch.stack([S[1, 1], -S[0, 1]]),
                            torch.stack([-S[1, 0], S[0, 0]])]) / det
        K = mm(PHt, Sinv)
    elif m == 3:
        K = mm(PHt, lie.inv3x3(S))
    else:
        # K = P H^T S^-1; solve_ex leaves S unchecked like the JAX solve,
        # so the device path does not stop for an error readback
        K = torch.linalg.solve_ex(S.T, PHt.T)[0].T
    if small:
        su = torch.sum(K * Y[None, :], dim=1)
    else:
        su = K @ Y
    if joseph:
        ikh = torch.eye(P.shape[0], dtype=P.dtype, device=P.device)
        ikh[:, sel] -= K
        P_new = ikh @ P @ ikh.T + K @ R @ K.T
    else:
        P_new = P - mm(K, Pi)          # P -= K H P (reference form)

    rot = lie.quat_normalize(
        lie.quat_mul(state.rot, lie.quat_from_axis_angle(su[3:6])))
    imu_rot = lie.quat_normalize(
        lie.quat_mul(state.imu_rot, lie.quat_from_axis_angle(su[24:27])))
    return state.replace(
        pos=state.pos + su[0:3],
        vel=state.vel + su[6:9],
        gyro=state.gyro + su[9:12],
        acc=state.acc + su[12:15],
        bg=state.bg + su[15:18],
        ba=state.ba + su[18:21],
        grav=state.grav + su[21:24],
        rot=rot,
        imu_rot=imu_rot,
        P=P_new,
    )


# --------------------------------------------------------------------------- #
# IMU prediction (ekf_algorithm.cpp:167-316)
# --------------------------------------------------------------------------- #

def _fpf_dense(P, G_R_I, Jr, dt, flags: EkfFlags):
    """F P F^T with the dense Jacobian (cpp:275-297), the float64 form."""
    eye3 = torch.eye(3, dtype=P.dtype, device=P.device)
    F = torch.eye(STATE_ORDER, dtype=P.dtype, device=P.device)
    F[S_X:S_X + 3, S_VX:S_VX + 3] = eye3 * dt
    F[S_X:S_X + 3, S_B_AX:S_B_AX + 3] = -0.5 * G_R_I * dt * dt
    F[S_ROLL:S_ROLL + 3, S_B_ROLL_RATE:S_B_ROLL_RATE + 3] = -Jr
    F[S_VX:S_VX + 3, S_B_AX:S_B_AX + 3] = -G_R_I * dt
    F[S_ROLL_RATE:S_ROLL_RATE + 3, S_B_ROLL_RATE:S_B_ROLL_RATE + 3] = -eye3
    F[S_AX:S_AX + 3, S_B_AX:S_B_AX + 3] = -G_R_I
    if flags.imu_estimate_gravity:
        F[S_Z, S_G_Z] = -0.5 * dt * dt
        F[S_VZ, S_G_Z] = -dt
        F[S_AZ, S_G_Z] = -1.0
    return F @ P @ F.T


def _fpf_sparse(P, G_R_I, Jr, dt, flags: EkfFlags):
    """F P F^T in sparse block form, the float32 form: with F = I + A and P
    symmetric, F P F^T = P + B + B^T + A B^T for B = A P (filter.py:306-341)."""

    def a_rows(X):
        """Rows 0:15 of A @ X for X of shape [27, n]."""
        Gx = _bmm(G_R_I, X[S_B_AX:S_B_AX + 3])
        Jx = _bmm(Jr, X[S_B_ROLL_RATE:S_B_ROLL_RATE + 3])
        r_pos = dt * X[S_VX:S_VX + 3] - (0.5 * dt * dt) * Gx
        r_rot = -Jx
        r_vel = -dt * Gx
        r_gyro = -X[S_B_ROLL_RATE:S_B_ROLL_RATE + 3]
        r_acc = -Gx
        if flags.imu_estimate_gravity:
            gz = X[S_G_Z]
            r_pos = torch.cat([r_pos[:2], (r_pos[2] - (0.5 * dt * dt) * gz)[None]])
            r_vel = torch.cat([r_vel[:2], (r_vel[2] - dt * gz)[None]])
            r_acc = torch.cat([r_acc[:2], (r_acc[2] - gz)[None]])
        return torch.cat([r_pos, r_rot, r_vel, r_gyro, r_acc], dim=0)

    B = a_rows(P)                # [15, 27]
    C = a_rows(B.T)              # [15, 15]
    P_new = P.clone()
    P_new[:15, :] += B
    P_new[:, :15] += B.T
    P_new[:15, :15] += C
    return P_new


def _propagate_imu(state: EkfState, imu: ImuMeas, dt, params: EkfParams,
                   flags: EkfFlags) -> EkfState:
    """FAST-LIO-style nominal propagation + covariance (cpp:228-300)."""
    dtype = state.P.dtype
    G_R_I = lie.quat_to_rot(state.rot)

    corrected_gyro = imu.gyro - state.bg
    delta_rot = lie.exp_gyro_to_quat(corrected_gyro, dt)
    rot_new = lie.quat_normalize(lie.quat_mul(state.rot, delta_rot))

    corrected_accel = imu.acc - state.ba
    accel_global = lie.matvec(G_R_I, corrected_accel) - state.grav

    pos_new = state.pos + state.vel * dt + 0.5 * accel_global * dt * dt
    vel_new = state.vel + accel_global * dt

    # Process noise Q (cpp:256-272)
    dt2 = dt * dt
    blocks = (
        (S_X, params.state_std_pos_m), (S_ROLL, params.state_std_rot_rad),
        (S_VX, params.state_std_vel_mps), (S_ROLL_RATE, params.imu_std_gyro_rad),
        (S_AX, params.imu_std_acc_mps), (S_B_ROLL_RATE, params.imu_bias_cov_gyro),
        (S_B_AX, params.imu_bias_cov_acc), (S_G_X, params.imu_bias_cov_acc),
        (S_IMU_ROLL, params.state_std_rot_rad),
    )
    qd = torch.zeros(STATE_ORDER, dtype=dtype, device=dt.device)
    for lo, std in blocks:
        qd[lo:lo + 3] = std ** 2 * dt2
    Q = torch.diag(qd)

    Jr = lie.right_jacobian_d_rot_d_gyro(corrected_gyro, dt)
    if _vpu_forms(dtype):
        P_new = _fpf_sparse(state.P, G_R_I, Jr, dt, flags) + Q
    else:
        P_new = _fpf_dense(state.P, G_R_I, Jr, dt, flags) + Q

    return state.replace(pos=pos_new, rot=rot_new, vel=vel_new,
                         gyro=corrected_gyro, acc=accel_global, P=P_new)


def _zupt_imu(state: EkfState, imu: ImuMeas, flags: EkfFlags) -> EkfState:
    """Zero-velocity potential update (cpp:508-565), masked."""
    alpha = 0.01
    gamma = 0.01
    vel_thre, gyro_thre, acc_thre = 0.1, 0.1, 0.1

    vel_local = lie.quat_rotate(lie.quat_conj(state.rot), state.vel)
    vel_ok = torch.abs(vel_local[0]) <= vel_thre
    vel_coeff = (vel_thre - torch.abs(vel_local[0])) / vel_thre * 0.1
    vel_new = torch.where(vel_ok, state.vel + vel_coeff * (-state.vel), state.vel)

    bias_ok = (vel_ok & (lie.norm(state.gyro) <= gyro_thre)
               & (lie.norm(state.acc[:2]) <= acc_thre))

    gyro_error = imu.gyro - state.bg
    bg_new = torch.where(bias_ok, state.bg + gamma * gyro_error, state.bg)

    grav_local = lie.quat_rotate(lie.quat_conj(state.rot), state.grav)
    acc_error_loc = imu.acc - (grav_local + state.ba)
    acc_error_global = lie.quat_rotate(state.rot, imu.acc - state.ba) - state.grav
    ba_new = torch.where(bias_ok, state.ba + alpha * acc_error_loc, state.ba)

    grav_new = state.grav
    if flags.imu_estimate_gravity:
        gz = torch.where(bias_ok, state.grav[2] + alpha * acc_error_global[2],
                         state.grav[2])
        grav_new = torch.cat([state.grav[:2], gz[None]])
    return state.replace(vel=vel_new, bg=bg_new, ba=ba_new, grav=grav_new)


def _complementary_filter(state: EkfState, imu: ImuMeas, params: EkfParams,
                          flags: EkfFlags) -> EkfState:
    """Gravity-direction roll/pitch correction (cpp:597-701), masked."""
    acc_meas = imu.acc - state.ba
    vel_local = lie.quat_rotate(lie.quat_conj(state.rot), state.vel)
    centripetal_acc = vel_local[0] * state.gyro[2]

    # C++ function statics: the first call seeds them (cpp:613-617)
    first = ~state.cf_initialized
    prev_t = torch.where(first, imu.timestamp, state.cf_prev_time)
    prev_vx = torch.where(first, vel_local[0], state.cf_prev_vel_local_x)
    dt = imu.timestamp - prev_t
    run = dt >= 1e-6

    safe_dt = torch.where(run, dt, torch.ones_like(dt))
    est_acc_x = (vel_local[0] - prev_vx) / safe_dt

    # acc - [0,1,0] * centripetal, then - [1,0,0] * est_acc_x when stabilized
    compensated = torch.stack([acc_meas[0], acc_meas[1] - centripetal_acc,
                               acc_meas[2]])
    compensated = torch.where(
        state.rotation_stabilized,
        torch.stack([compensated[0] - est_acc_x, compensated[1], compensated[2]]),
        compensated)

    acc_diff = lie.norm(acc_meas) - lie.norm(state.grav)

    norm_c = lie.norm(compensated)
    run = run & (norm_c > 1e-12)  # guard: reference would NaN on a zero vector
    gdir = compensated / torch.where(norm_c > 1e-12, norm_c, torch.ones_like(norm_c))

    z = torch.stack([torch.atan2(gdir[1], gdir[2]),
                     -torch.arcsin(torch.clamp(gdir[0], -1.0, 1.0))])
    rpy = lie.rot_to_euler(lie.quat_to_rot(state.rot))
    innovation = lie.norm_angle_rad(z - rpy[:2])

    base_unc = torch.where(state.state_initialized, torch.full_like(dt, 1.0 * _D2R),
                           torch.full_like(dt, 10.0 * _D2R))
    centr_unc = torch.abs(centripetal_acc) / 9.81 * 10.0
    longi_unc = torch.abs(est_acc_x) / 9.81 * 10.0
    accd_unc = torch.abs(acc_diff) / 9.81 * 10.0
    lat_scale = 1.0 + accd_unc + centr_unc
    longi_scale = 1.0 + accd_unc + longi_unc
    min_r = (1.0 * _D2R) ** 2
    R = torch.diag(torch.stack([
        torch.clamp((base_unc * lat_scale) ** 2, min=min_r),
        torch.clamp((base_unc * longi_scale) ** 2, min=min_r),
    ])).to(state.P.dtype)

    updated = _ekf_measurement_update(state, (S_ROLL, S_PITCH), innovation, R,
                                      joseph=flags.joseph_form)
    true = torch.ones_like(state.cf_initialized)
    updated = updated.replace(cf_initialized=true,
                              cf_prev_vel_local_x=vel_local[0],
                              cf_prev_time=imu.timestamp)
    seeded = state.replace(cf_initialized=true, cf_prev_vel_local_x=prev_vx,
                           cf_prev_time=prev_t)
    return select(run, updated, seeded)


def _calibrate_vehicle_to_imu(state: EkfState, imu: ImuMeas,
                              joseph: bool = False) -> EkfState:
    """Online vehicle->IMU mounting calibration (cpp:703-776), masked."""
    run = (lie.norm(state.vel) >= 3.0) & state.rotation_stabilized
    q = lie.quat_mul(state.rot, lie.quat_conj(state.imu_rot))
    v_local = lie.quat_rotate(lie.quat_conj(q), state.vel)
    n = lie.norm(v_local)
    v_dir = v_local / torch.where(n > 1e-12, n, torch.ones_like(n))
    yaw = torch.atan2(v_dir[1], v_dir[0])
    pitch = -torch.arcsin(torch.clamp(v_dir[2], -1.0, 1.0))
    innovation = torch.stack([torch.zeros_like(yaw), -pitch, -yaw])
    # the adaptive R (cpp:744-759) is overwritten with a fixed (1 deg)^2
    R = torch.eye(3, dtype=state.P.dtype, device=state.P.device) * (1.0 * _D2R) ** 2
    updated = _ekf_measurement_update(
        state, (S_IMU_ROLL, S_IMU_ROLL + 1, S_IMU_ROLL + 2), innovation, R,
        joseph=joseph)
    updated = updated.replace(
        vehicle_imu_calib_started=torch.ones_like(state.vehicle_imu_calib_started))
    return select(run, updated, state)


def predict_imu(state: EkfState, imu: ImuMeas, params: EkfParams,
                flags: EkfFlags) -> EkfState:
    """RunPredictionImu (cpp:167-316) with the early returns as masks, in the
    reference's gate order."""
    t = imu.timestamp
    reset = state.reset_for_init_prediction
    gate_early = reset | state.pcm_init_on_going

    rot_stab = torch.where(gate_early, state.rotation_stabilized,
                           check_rotation_stabilized(state.P))
    state = state.replace(rotation_stabilized=rot_stab)

    initialized = state.state_initialized
    dt = t - state.prev_timestamp
    new_data = torch.abs(dt) >= 1e-6
    do_predict = (~gate_early) & initialized & new_data

    propagated = _propagate_imu(
        state, imu, torch.where(do_predict, dt, torch.full_like(dt, 1e-3)),
        params, flags)
    state = select(do_predict, propagated, state)

    if flags.use_zupt:
        state = select(do_predict, _zupt_imu(state, imu, flags), state)

    if flags.run_cf:
        cf_mask = do_predict | ((~gate_early) & (~initialized) & state.yaw_initialized)
        state = select(cf_mask, _complementary_filter(state, imu, params, flags),
                       state)

    if flags.imu_estimate_calibration:
        state = select(do_predict,
                       _calibrate_vehicle_to_imu(state, imu, flags.joseph_form),
                       state)

    prev_ts = torch.where(gate_early | (~initialized) | do_predict, t,
                          state.prev_timestamp)
    return state.replace(prev_timestamp=prev_ts,
                         reset_for_init_prediction=torch.zeros_like(reset))


# --------------------------------------------------------------------------- #
# Non-IMU constant-acceleration prediction (ekf_algorithm.cpp:81-165)
# --------------------------------------------------------------------------- #

def predict(state: EkfState, timestamp, params: EkfParams) -> EkfState:
    """RunPrediction, the system-clock CA tick when use_imu is off (JAX
    ``filter.py:568``): skipped under the reset and PCM-init gates and for
    |dt| < 1e-6 (then dt = 1e-3 feeds the masked-out branch), the dense
    F P F^T + Q in both dtypes, and the gyro std used in deg/s (cpp:138-139)."""
    dtype, dev = state.P.dtype, state.P.device
    t = torch.as_tensor(timestamp, dtype=dtype, device=dev)
    reset = state.reset_for_init_prediction
    gate_early = reset | state.pcm_init_on_going
    dt = t - state.prev_timestamp
    do_predict = (~gate_early) & (torch.abs(dt) >= 1e-6)
    dts = torch.where(do_predict, dt, torch.full_like(dt, 1e-3))

    delta_rot = lie.exp_gyro_to_quat(state.gyro, dts)
    pos_new = state.pos + state.vel * dts + 0.5 * state.acc * dts * dts
    rot_new = lie.quat_normalize(lie.quat_mul(state.rot, delta_rot))
    vel_new = state.vel + state.acc * dts

    dt2 = dts * dts
    qd = torch.zeros(STATE_ORDER, dtype=dtype, device=dev)
    for lo, std in ((S_X, params.state_std_pos_m), (S_ROLL, params.state_std_rot_rad),
                    (S_VX, params.state_std_vel_mps),
                    # quirk preserved: the gyro std in deg/s unconverted
                    (S_ROLL_RATE, params.state_std_gyro_dps),
                    (S_AX, params.state_std_acc_mps)):
        qd[lo:lo + 3] = std ** 2 * dt2
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.eye(STATE_ORDER, dtype=dtype, device=dev)
    F[S_X:S_X + 3, S_VX:S_VX + 3] = eye3 * dts
    F[S_ROLL:S_ROLL + 3, S_ROLL_RATE:S_ROLL_RATE + 3] = eye3 * dts
    F[S_X:S_X + 3, S_AX:S_AX + 3] = eye3 * 0.5 * dt2
    F[S_VX:S_VX + 3, S_AX:S_AX + 3] = eye3 * dts
    P_new = F @ state.P @ F.T + torch.diag(qd)

    predicted = state.replace(pos=pos_new, rot=rot_new, vel=vel_new, P=P_new)
    state = select(do_predict, predicted, state)
    prev_ts = torch.where(gate_early | do_predict, t, state.prev_timestamp)
    return state.replace(prev_timestamp=prev_ts,
                         reset_for_init_prediction=torch.zeros_like(reset))


# --------------------------------------------------------------------------- #
# GNSS / PCM pose update (ekf_algorithm.cpp:318-432)
# --------------------------------------------------------------------------- #

def update_gnss(state: EkfState, meas: GnssMeas, params: EkfParams,
                flags: EkfFlags) -> EkfState:
    """UpdateGnss. ``meas.source`` is a host int, so the source branches of
    the JAX function (which selects among all of them) are taken on the host;
    every branch computes exactly what the JAX select keeps."""
    dtype = state.P.dtype
    dev = state.P.device
    src = int(meas.source)

    if src == int(GnssSource.PCM_INIT):
        # hard reset (cpp:324-349); prev_gnss_ is not recorded on this branch
        z3 = torch.zeros(3, dtype=dtype, device=dev)
        P_reset = state.P.clone()
        P_reset[:S_AZ + 1, :S_AZ + 1] = (
            torch.eye(S_AZ + 1, dtype=dtype, device=dev) * INIT_STATE_COV)
        true = torch.ones_like(state.state_initialized)
        return state.replace(
            pos=meas.pos, rot=lie.quat_normalize(meas.rot),
            vel=z3, gyro=z3, acc=z3, bg=z3, ba=z3,
            grav=_scalar([0.0, 0.0, 1.0], state.P) * params.imu_gravity.to(dtype),
            P=P_reset, state_initialized=true, yaw_initialized=true,
            pcm_init_on_going=true,
        )

    # Flag refresh (cpp:351-354)
    P = state.P
    st = state.replace(
        yaw_initialized=check_yaw_initialized(P),
        state_initialized=check_state_initialized(P),
        rotation_stabilized=check_rotation_stabilized(P),
        state_stabilized=check_state_stabilized(P),
    )

    # PCM warm-up release (cpp:357-364); the counter is never reset elsewhere
    if src == int(GnssSource.PCM):
        warm = st.pcm_init_on_going
        release = warm & (st.pcm_update_count > 10)
        st = st.replace(
            pcm_init_on_going=st.pcm_init_on_going & ~release,
            pcm_update_count=torch.where(warm, st.pcm_update_count + 1,
                                         st.pcm_update_count),
        )

    # Measurement covariance (cpp:383-397)
    R6 = torch.zeros((6, 6), dtype=dtype, device=dev)
    R6[:3, :3] = meas.pos_cov.to(dtype)
    R6[3:, 3:] = meas.rot_cov.to(dtype)
    if src in (int(GnssSource.NOVATEL), int(GnssSource.BESTPOS),
               int(GnssSource.NAVSATFIX)):
        R6 = R6 + torch.diag(params.gnss_min_cov.to(dtype))

    # Residual (cpp:406-410)
    res_euler = lie.euler_residual_from_quats(st.rot, lie.quat_normalize(meas.rot))
    Y6 = torch.cat([meas.pos - st.pos, res_euler])

    if src in (int(GnssSource.NAVSATFIX), int(GnssSource.BESTPOS)):
        # 3-DOF position-only path with the antenna-offset inflation while yaw
        # is uninitialized (cpp:412-425)
        inflate = torch.where(st.yaw_initialized, _scalar(0.0, P), _scalar(3.0, P))
        R3 = R6[:3, :3] + torch.diag(torch.stack(
            [inflate, inflate, torch.zeros_like(inflate)]))
        out = _ekf_measurement_update(st, (0, 1, 2), Y6[:3], R3,
                                      joseph=flags.joseph_form)
    else:
        out = _ekf_measurement_update(st, tuple(range(6)), Y6, R6,
                                      joseph=flags.joseph_form)
    return out.replace(prev_gnss_timestamp=torch.as_tensor(
        meas.timestamp, dtype=state.prev_gnss_timestamp.dtype, device=dev))


#: the GNSS source a GPS fix takes per configured gps_type (runtime.py:216-220)
GPS_SOURCE = {
    int(GpsType.NAVSATFIX): int(GnssSource.NAVSATFIX),
    int(GpsType.BESTPOS): int(GnssSource.BESTPOS),
    int(GpsType.ODOMETRY): int(GnssSource.NOVATEL),
}


def update_gps(state: EkfState, t, pos, cov_diag, params: EkfParams,
               flags: EkfFlags, gnss_uncertainty_max) -> EkfState:
    """The filter half of the pipeline's GPS fix step (JAX ``runtime.py:205``
    gps_step): NAVSATFIX / BESTPOS take the 3-DOF path of ``update_gnss``,
    ODOMETRY the NOVATEL 6-DOF one; the fix is dropped unless both
    horizontal variances pass ``gnss_uncertainty_max``. Reference quirk: the
    NavSatFix covariance field is squared again (ekf_localization.cpp:
    104-106)."""
    var = cov_diag * cov_diag
    ok = (var[0] <= gnss_uncertainty_max) & (var[1] <= gnss_uncertainty_max)
    meas = GnssMeas(timestamp=t, source=GPS_SOURCE[flags.gps_type], pos=pos,
                    rot=lie.quat_identity(pos.dtype, pos.device),
                    pos_cov=torch.diag(var),
                    rot_cov=torch.zeros((3, 3), dtype=pos.dtype, device=pos.device))
    return select(ok, update_gnss(state, meas, params, flags), state)


# --------------------------------------------------------------------------- #
# CAN update (ekf_algorithm.cpp:434-506)
# --------------------------------------------------------------------------- #

def can_meas(t, vel_x, yaw_rate) -> CanMeas:
    """One CAN sample as the pipeline builds it (JAX ``runtime.py:260``)."""
    z = torch.zeros_like(vel_x)
    return CanMeas(timestamp=t, vel=torch.stack([vel_x, z, z]),
                   gyro=torch.stack([z, z, yaw_rate]))


def update_can(state: EkfState, can: CanMeas, params: EkfParams,
               flags: EkfFlags) -> EkfState:
    """UpdateCan: the global velocity and the yaw rate (m = 4 on state
    indices 6, 7, 8, 11), skipped within 0.01 s of the last CAN update, then
    ZuptCan on the raw (biased) input (cpp:567-587)."""
    dtype = state.P.dtype
    run = torch.abs(can.timestamp - state.prev_can_timestamp) >= 0.01

    unbiased_gyro_z = can.gyro[2] - state.can_yaw_rate_bias
    unbiased_vel = torch.cat([(can.vel[0] * params.can_vel_scale.to(dtype))[None],
                              can.vel[1:]])
    rot_m = lie.quat_to_rot(state.rot)
    Y = torch.cat([lie.matvec(rot_m, unbiased_vel) - state.vel,
                   (unbiased_gyro_z - state.gyro[2])[None]])

    unc = params.can_meas_uncertainty_vel.to(dtype)
    R_local = torch.diag(torch.stack([unc ** 2, (2 * unc) ** 2, (2 * unc) ** 2]))
    R = torch.zeros((4, 4), dtype=dtype, device=state.P.device)
    R[:3, :3] = rot_m @ R_local @ rot_m.T
    R[3, 3] = params.can_meas_uncertainty_yaw_rate_rad.to(dtype) ** 2

    updated = _ekf_measurement_update(state, (S_VX, S_VX + 1, S_VZ, S_YAW_RATE),
                                      Y, R, joseph=flags.joseph_form)
    zupt_on = lie.norm(can.vel) <= 0.05
    a = 0.05
    bias = updated.can_yaw_rate_bias
    zupted = updated.replace(
        prev_can_timestamp=can.timestamp,
        can_yaw_rate_bias=torch.where(zupt_on, a * can.gyro[2] + (1.0 - a) * bias,
                                      bias),
        vel=torch.where(zupt_on, (1.0 - a) * updated.vel, updated.vel),
    )
    return select(run, zupted, state)


# --------------------------------------------------------------------------- #
# A frame's sequences: the plain versions of kernels H (the chain half), O,
# U and I, and the dispatch of I (plain for CPU tensors, the kernel for CUDA
# ones; kernel H's is runtime.imu_subbatch, kernel U's runtime.tick_step)
# --------------------------------------------------------------------------- #

def imu_chain_plain(state: EkfState, ts, acc, gyro, valid, params: EkfParams,
                    flags: EkfFlags):
    """The frame's ego-frame IMU samples through :func:`predict_imu` one at a
    time, each masked by ``valid`` (the scan body of JAX ``runtime.py:405``
    imu_subbatch). Returns (state, (t, pos, rot, vel, gyro)) with the
    history stacked per sample."""
    hist = []
    for i in range(ts.shape[0]):
        nxt = predict_imu(state, ImuMeas(timestamp=ts[i], acc=acc[i], gyro=gyro[i]),
                          params, flags)
        state = select(valid[i], nxt, state)
        hist.append((state.prev_timestamp, state.pos, state.rot, state.vel,
                     state.gyro))
    return state, tuple(torch.stack(x) for x in zip(*hist))


def ego_history(t, pos, rot, vel, gyro):
    """(t, pos, rot, vel, gyro) per sample -> (t, pos, rpy, vel_local, gyro),
    the ego ring's fields (JAX runtime.py:435-436)."""
    rpy = lie.rot_to_euler(lie.quat_to_rot(rot))
    return t, pos, rpy, global_to_local_velocity(vel, rpy), gyro


def ca_tick_plain(state: EkfState, t, params: EkfParams):
    """Plain PyTorch version of kernel O: :func:`predict` at ``t``, then the
    tick's ego-ring entry (t, pos, rpy, vel_local, gyro), each of one row
    (JAX ``runtime.py:249`` tick_step before its push)."""
    state = predict(state, t, params)
    row = (state.prev_timestamp, state.pos, state.rot, state.vel, state.gyro)
    return state, ego_history(*(x[None] for x in row))


def tick_stage_plain(state: EkfState, ego_ring, t, params: EkfParams):
    """Plain PyTorch version of kernel U: :func:`ca_tick_plain` at ``t``,
    then its row pushed into ``ego_ring`` (``pipeline.rings.push_ego_batch``,
    eps 1e-5): JAX ``runtime.py:249`` tick_step with its ``_push_ego``
    (:172-179). Returns (state, ego ring)."""
    from ..pipeline import rings  # the pipeline package imports this module

    state, row = ca_tick_plain(state, t, params)
    one = torch.ones(1, dtype=torch.bool, device=t.device)
    return state, rings.push_ego_batch(ego_ring, *row, one)


def update_chain_plain(state: EkfState, params: EkfParams, flags: EkfFlags, *,
                       can=None, gps=None, gnss_uncertainty_max=None, pcm=None):
    """A frame's measurement updates in the fused frame's order (JAX
    ``runtime.py:453-480`` and ``:358-360``): the CAN samples
    ``can = (t, vel_x, yaw_rate, valid)`` through :func:`update_can`, then
    the GPS fixes ``gps = (t, pos, cov_diag, valid)`` through
    :func:`update_gps`, each masked by its ``valid``, then the PCM pose
    ``pcm = (GnssMeas, apply)`` through :func:`update_gnss` masked by
    ``apply``. A ``valid`` of None means every sample is valid (no select)."""
    if can is not None:
        for k, (t, vx, yr) in enumerate(zip(*can[:3])):
            nxt = update_can(state, can_meas(t, vx, yr), params, flags)
            state = nxt if can[3] is None else select(can[3][k], nxt, state)
    if gps is not None:
        for k, (t, pos, cov) in enumerate(zip(*gps[:3])):
            nxt = update_gps(state, t, pos, cov, params, flags, gnss_uncertainty_max)
            state = nxt if gps[3] is None else select(gps[3][k], nxt, state)
    if pcm is not None:
        meas, apply = pcm
        state = select(apply, update_gnss(state, meas, params, flags), state)
    return state


def update_chain_lanes_plain(state: EkfState, params: EkfParams, flags: EkfFlags, *,
                             can=None, gps=None, gnss_uncertainty_max=None):
    """Plain lane form of kernel W: :func:`update_chain_plain` on each lane of
    a fleet frame (the state with a lane axis, P [B, 27, 27]; each given
    sub-batch's rows [B, n], its ``valid`` [B, n] masking the fleet's
    padding as a stream's own invalid rows), stacked."""
    def rows(xs, i):
        return None if xs is None else tuple(None if x is None else x[i] for x in xs)

    return stack_states([update_chain_plain(lane(state, i), params, flags, can=rows(can, i),
                                            gps=rows(gps, i),
                                            gnss_uncertainty_max=gnss_uncertainty_max)
                         for i in range(state.P.shape[0])])


def update_chain(state: EkfState, params: EkfParams, flags: EkfFlags, **kw):
    """:func:`update_chain_plain` for CPU tensors; for CUDA ones kernel W
    (``kernels.can_gps_update``), or kernel I (``kernels.ekf_update``, W's
    reference) when a PCM pose is given: the pipeline's PCM update runs in
    kernel S (``pipeline.runtime.pcm_stage``). A fleet state (P [B, 27,
    27]) with [B, n] CAN / GPS rows goes to W's lane form, or on CPU
    tensors to :func:`update_chain_lanes_plain`."""
    if state.P.device.type == "cpu":
        plain = update_chain_lanes_plain if state.P.dim() == 3 else update_chain_plain
        return plain(state, params, flags, **kw)
    if kw.get("gps") is not None:
        kw["gps_source"] = GPS_SOURCE[flags.gps_type]
    pcm = kw.pop("pcm", None)
    if pcm is not None:
        return kernels.ekf_update(state, params, flags, pcm=pcm, **kw)
    return kernels.can_gps_update(state, params, flags, **kw)


# --------------------------------------------------------------------------- #
# EgoState output (ekf_algorithm.cpp:778-833)
# --------------------------------------------------------------------------- #

def imu_calibration(state: EkfState):
    """Estimated vehicle->IMU mounting rotation as Euler angles (radians):
    GetImuCalibration (ekf_algorithm.cpp:835-838)."""
    return lie.rot_to_euler(lie.quat_to_rot(state.imu_rot))


def ego_state(state: EkfState):
    """The published odometry view of the filter (localization_struct.hpp:
    30-73); the covariance diagonal is rotated like a vector and abs'd, as
    the reference does (cpp:814-820)."""
    rpy = lie.rot_to_euler(lie.quat_to_rot(state.rot))
    P = state.P
    pos_var = torch.stack([P[S_X, S_X], P[S_X + 1, S_X + 1], P[S_Z, S_Z]])
    return {
        "timestamp": state.prev_timestamp,
        "pos": state.pos,
        "rpy": rpy,
        "vel_local": global_to_local_velocity(state.vel, rpy),
        "acc_local": global_to_local_velocity(state.acc, rpy),
        "gyro": state.gyro,
        "pos_cov_local": torch.abs(global_to_local_velocity(pos_var, rpy)),
        "pos_std_global": torch.sqrt(torch.clamp(pos_var, min=0.0)),
        "rot_cov": torch.stack([P[S_ROLL, S_ROLL], P[S_PITCH, S_PITCH],
                                P[S_YAW, S_YAW]]),
    }
