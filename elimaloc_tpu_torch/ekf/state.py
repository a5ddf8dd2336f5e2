"""EKF state records — port of ``elimaloc_tpu/ekf/state.py:39-173``
(``CanMeas`` :103 included).

Plain dataclasses of tensors (see ``struct.Struct``) with the reference's
27-state layout (ekf_algorithm.hpp:41-67):
  0:3 position   3:6 rotation (rpy)   6:9 velocity   9:12 body rates
  12:15 accel    15:18 gyro bias      18:21 acc bias 21:24 gravity
  24:27 imu mount rotation

The packed records. An ``EkfState`` whose fields are the typed views of one
contiguous byte buffer in the layout of :data:`RECORD_FIELDS` (csrc/ekf.cuh
``State``, whose offsets ``kOff*`` it mirrors) goes into and out of the EKF
kernels by one pointer. :func:`init_state` (ekf/filter.py) and the kernels
make such states, as :class:`RecordState`s, whose fields are viewed only
when read; :func:`state_record` recognizes one by its fields (each field the
view at its offset of one record of the right size), so a state with a
replaced field is not taken for packed, and :func:`pack_state` copies any
state into a fresh record (counted in :data:`packs`). ``EkfParams`` is
packed the same way, once per params object, by :func:`make_params`.

A fleet's states (``parallel.stack_streams``) are B records in one
[B, nbytes] buffer, lane stride nbytes (3,072 bytes in f32): a
:class:`RecordState` on such a root views every field with a leading lane
axis, and the EKF kernels' lane forms take it by one pointer.
:func:`stack_states` makes one from B states, stacking intact records
without packing them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..struct import Struct

S_X, S_Y, S_Z = 0, 1, 2
S_ROLL, S_PITCH, S_YAW = 3, 4, 5
S_VX, S_VY, S_VZ = 6, 7, 8
S_ROLL_RATE, S_PITCH_RATE, S_YAW_RATE = 9, 10, 11
S_AX, S_AY, S_AZ = 12, 13, 14
S_B_ROLL_RATE, S_B_PITCH_RATE, S_B_YAW_RATE = 15, 16, 17
S_B_AX, S_B_AY, S_B_AZ = 18, 19, 20
S_G_X, S_G_Y, S_G_Z = 21, 22, 23
S_IMU_ROLL, S_IMU_PITCH, S_IMU_YAW = 24, 25, 26

STATE_ORDER = 27
GNSS_MEAS_ORDER = 6
INIT_STATE_COV = 100.0  # reference: ekf_algorithm.hpp:73


@dataclasses.dataclass
class EkfState(Struct):
    """Nominal state + covariance + filter bookkeeping
    (EkfAlgorithm members, ekf_algorithm.hpp:262-289)."""

    pos: torch.Tensor        # [3]
    rot: torch.Tensor        # [4] quaternion (w,x,y,z)
    vel: torch.Tensor        # [3]
    gyro: torch.Tensor       # [3]
    acc: torch.Tensor        # [3]
    bg: torch.Tensor         # [3]
    ba: torch.Tensor         # [3]
    grav: torch.Tensor       # [3]
    imu_rot: torch.Tensor    # [4]
    P: torch.Tensor          # [27, 27]

    reset_for_init_prediction: torch.Tensor  # bool
    state_initialized: torch.Tensor
    yaw_initialized: torch.Tensor
    rotation_stabilized: torch.Tensor
    state_stabilized: torch.Tensor
    pcm_init_on_going: torch.Tensor
    vehicle_imu_calib_started: torch.Tensor
    can_yaw_rate_bias: torch.Tensor          # scalar
    pcm_update_count: torch.Tensor           # int32
    prev_timestamp: torch.Tensor
    prev_gnss_timestamp: torch.Tensor
    prev_can_timestamp: torch.Tensor

    cf_initialized: torch.Tensor             # bool
    cf_prev_vel_local_x: torch.Tensor
    cf_prev_time: torch.Tensor


@dataclasses.dataclass
class ImuMeas(Struct):
    """Ego-frame IMU sample (ImuStruct, localization_struct.hpp:126)."""

    timestamp: torch.Tensor
    acc: torch.Tensor   # [3]
    gyro: torch.Tensor  # [3]


@dataclasses.dataclass
class GnssMeas(Struct):
    """6-DOF pose measurement (EkfGnssMeasurement, hpp:146-153)."""

    timestamp: torch.Tensor
    source: int           # GnssSource value (host constant on the slice)
    pos: torch.Tensor     # [3]
    rot: torch.Tensor     # [4]
    pos_cov: torch.Tensor  # [3,3]
    rot_cov: torch.Tensor  # [3,3]


@dataclasses.dataclass
class CanMeas(Struct):
    """CAN wheel-speed sample (CanStruct, localization_struct.hpp:120;
    ``elimaloc_tpu/ekf/state.py:103``)."""

    timestamp: torch.Tensor
    vel: torch.Tensor   # [3] local, only x valid
    gyro: torch.Tensor  # [3] local, only z valid


@dataclasses.dataclass(frozen=True)
class EkfParams(Struct):
    """Continuous EKF parameters (tensors), built by :func:`make_params`;
    frozen, so a params object keeps the record it was packed in."""

    init_pos: torch.Tensor
    init_rpy: torch.Tensor
    imu_gravity: torch.Tensor
    state_std_pos_m: torch.Tensor
    state_std_rot_rad: torch.Tensor
    state_std_vel_mps: torch.Tensor
    state_std_gyro_dps: torch.Tensor
    state_std_acc_mps: torch.Tensor
    imu_std_gyro_rad: torch.Tensor
    imu_std_acc_mps: torch.Tensor
    imu_bias_cov_gyro: torch.Tensor
    imu_bias_cov_acc: torch.Tensor
    gnss_min_cov: torch.Tensor        # [6]
    can_vel_scale: torch.Tensor
    can_meas_uncertainty_vel: torch.Tensor
    can_meas_uncertainty_yaw_rate_rad: torch.Tensor


def make_params(cfg, dtype=torch.float32, device=None) -> EkfParams:
    """EkfConfig -> EkfParams (unit conversions as in ekf_algorithm.cpp),
    packed in one record (:data:`PARAM_FIELDS`)."""
    def r(deg):  # same rounding as the reference's deg * pi / 180
        return deg * math.pi / 180.0

    values = dict(
        init_pos=[cfg.ekf_init_x_m, cfg.ekf_init_y_m, cfg.ekf_init_z_m],
        init_rpy=[r(cfg.ekf_init_roll_deg), r(cfg.ekf_init_pitch_deg),
                  r(cfg.ekf_init_yaw_deg)],
        imu_gravity=cfg.imu_gravity,
        state_std_pos_m=cfg.state_std_pos_m,
        state_std_rot_rad=r(cfg.state_std_rot_deg),
        state_std_vel_mps=cfg.state_std_vel_mps,
        state_std_gyro_dps=cfg.state_std_gyro_dps,
        state_std_acc_mps=cfg.state_std_acc_mps,
        imu_std_gyro_rad=r(cfg.imu_std_gyro_dps),
        imu_std_acc_mps=cfg.imu_std_acc_mps,
        imu_bias_cov_gyro=cfg.imu_bias_cov_gyro,
        imu_bias_cov_acc=cfg.imu_bias_cov_acc,
        gnss_min_cov=[
            cfg.gnss_min_cov_x_m, cfg.gnss_min_cov_y_m, cfg.gnss_min_cov_z_m,
            r(cfg.gnss_min_cov_roll_deg), r(cfg.gnss_min_cov_pitch_deg),
            r(cfg.gnss_min_cov_yaw_deg),
        ],
        can_vel_scale=cfg.can_vel_scale_factor,
        can_meas_uncertainty_vel=cfg.can_meas_uncertainty_vel_mps,
        can_meas_uncertainty_yaw_rate_rad=r(cfg.can_meas_uncertainty_yaw_rate_deg),
    )
    flat = []
    for name, _ in PARAM_FIELDS:
        v = values[name]
        flat += v if isinstance(v, list) else [v]
    rec = torch.tensor(flat + [0.0] * (PARAM_WORDS - len(flat)), dtype=dtype, device=device)
    return EkfParams(**_param_views(rec))


# --------------------------------------------------------------------------- #
# The packed records (csrc/ekf.cuh)
# --------------------------------------------------------------------------- #

#: EkfParams' fields in record order with their shapes (csrc/ekf.cuh
#: ``Param``: each field's offset in the record, in elements); the record is
#: padded to PARAM_WORDS elements of the params' float dtype
PARAM_FIELDS = (
    ("init_pos", (3,)), ("init_rpy", (3,)), ("imu_gravity", ()), ("state_std_pos_m", ()),
    ("state_std_rot_rad", ()), ("state_std_vel_mps", ()), ("state_std_gyro_dps", ()),
    ("state_std_acc_mps", ()), ("imu_std_gyro_rad", ()), ("imu_std_acc_mps", ()),
    ("imu_bias_cov_gyro", ()), ("imu_bias_cov_acc", ()), ("gnss_min_cov", (6,)),
    ("can_vel_scale", ()), ("can_meas_uncertainty_vel", ()),
    ("can_meas_uncertainty_yaw_rate_rad", ()),
)
PARAM_WORDS = 32

#: EkfState's fields in record order: (name, kind, shape), kind "f" the
#: state's float dtype, "i" int32, "b" bool (one byte); P first, then the
#: nominal vectors, the float scalars, the counter and the eight flags, the
#: record padded to a multiple of 16 bytes (csrc/ekf.cuh ``State``)
RECORD_FIELDS = (
    ("P", "f", (STATE_ORDER, STATE_ORDER)),
    ("pos", "f", (3,)), ("rot", "f", (4,)), ("vel", "f", (3,)), ("gyro", "f", (3,)),
    ("acc", "f", (3,)), ("bg", "f", (3,)), ("ba", "f", (3,)), ("grav", "f", (3,)),
    ("imu_rot", "f", (4,)),
    ("can_yaw_rate_bias", "f", ()), ("prev_timestamp", "f", ()),
    ("prev_gnss_timestamp", "f", ()), ("prev_can_timestamp", "f", ()),
    ("cf_prev_vel_local_x", "f", ()), ("cf_prev_time", "f", ()),
    ("pcm_update_count", "i", ()),
    ("reset_for_init_prediction", "b", ()), ("state_initialized", "b", ()),
    ("yaw_initialized", "b", ()), ("rotation_stabilized", "b", ()),
    ("state_stabilized", "b", ()), ("pcm_init_on_going", "b", ()),
    ("vehicle_imu_calib_started", "b", ()), ("cf_initialized", "b", ()),
)

#: states and params copied into a fresh record (:func:`pack_state`,
#: :func:`pack_params`) since the counts were last set to 0; the pipeline
#: packs at construction and relocalization only
packs = {"ekf_state": 0, "ekf_params": 0}

_KIND = {"i": torch.int32, "b": torch.bool}


@dataclasses.dataclass(frozen=True)
class _Layout:
    nbytes: int
    fields: tuple   # (name, byte offset, torch dtype, shape)
    views: dict     # name -> (torch dtype, shape, strides, offset in that dtype)


def _numel(shape):
    return math.prod(shape)


def record_layout(dtype) -> _Layout:
    """The record's byte layout for a state of float ``dtype``."""
    if dtype not in _LAYOUTS:
        off, fields, views = 0, [], {}
        for name, kind, shape in RECORD_FIELDS:
            dt = dtype if kind == "f" else _KIND[kind]
            size = torch.empty((), dtype=dt).element_size()
            fields.append((name, off, dt, shape))
            strides = tuple(_numel(shape[i + 1:]) for i in range(len(shape)))
            views[name] = (dt, shape, strides, off // size)
            off += size * _numel(shape)
        _LAYOUTS[dtype] = _Layout(-(-off // 16) * 16, tuple(fields), views)
    return _LAYOUTS[dtype]


_LAYOUTS = {}


class RecordState(EkfState):
    """An EkfState read from a record (``root``, uint8, of a state of float
    ``dtype``): each field is made on first access as its typed view of the
    record, so a state handed from one EKF kernel to the next is never
    viewed field by field. A root of [B, nbytes] holds B records, a fleet's
    lanes: every field then has a leading lane axis. Built from fields
    (``dataclasses.replace``, ``struct.select``) it is an EkfState like any
    other."""

    def __init__(self, root=None, dtype=torch.float32, **fields):
        if fields:
            EkfState.__init__(self, **fields)
        else:
            self.__dict__.update(_root=root, _layout=record_layout(dtype), _typed={},
                                 _views={})

    def __getattr__(self, name):
        d = self.__dict__
        if "_root" not in d or name not in d["_layout"].views:
            raise AttributeError(name)
        dtype, shape, strides, offset = d["_layout"].views[name]
        typed = d["_typed"].get(dtype)
        if typed is None:
            typed = d["_typed"][dtype] = d["_root"].view(dtype)
        if typed.dim() == 2:  # lanes: one record a row
            shape, strides = (typed.shape[0],) + shape, (typed.shape[1],) + strides
        v = typed.as_strided(shape, strides, offset)
        d[name] = d["_views"][name] = v
        return v

    def intact_record(self):
        """Its record (uint8) while every field it holds is the view made
        from it, else None (a field assigned since)."""
        d = self.__dict__
        views = d.get("_views")
        if views is None or len(d) != 4 + len(views):
            return None
        for k, v in views.items():
            if d[k] is not v:
                return None
        return d["_root"]


def empty_state(dtype, device, lanes=None) -> RecordState:
    """A state in a fresh record, every field zero or false (``lanes``
    records in one buffer when given)."""
    nbytes = record_layout(dtype).nbytes
    shape = (nbytes,) if lanes is None else (lanes, nbytes)
    return RecordState(torch.zeros(shape, dtype=torch.uint8, device=device), dtype)


def state_record(state: EkfState):
    """The storage of the record whose typed views ``state``'s fields are,
    or None when any field is not (a replaced field, a state built field by
    field): P starts a storage of the record's size, and every field's
    address lies at its offset from P's, so inside that storage."""
    if isinstance(state, RecordState):
        root = state.intact_record()
        if root is not None:
            return root.untyped_storage()
    P = state.P
    lay = _LAYOUTS.get(P.dtype)
    if lay is None or P.storage_offset() != 0 or not P.is_contiguous():
        return None
    root = P.untyped_storage()
    if root.nbytes() != lay.nbytes:
        return None
    base = P.data_ptr()
    for name, off, _, _ in lay.fields:
        if getattr(state, name).data_ptr() - base != off:
            return None
    return root


def pack_state(state: EkfState) -> EkfState:
    """``state`` copied field by field into a fresh record (counted); a
    state with a leading lane axis (P [B, 27, 27]) into B records of one
    buffer."""
    P = state.P
    out = empty_state(P.dtype, P.device, P.shape[0] if P.dim() == 3 else None)
    for name, _, _ in RECORD_FIELDS:
        getattr(out, name).copy_(getattr(state, name))
    packs["ekf_state"] += 1
    return out


def stack_states(states) -> EkfState:
    """B states as one fleet state with a leading lane axis: intact records
    of one dtype (``init_state``'s, a kernel's) are stacked into one
    [B, nbytes] buffer, which is not a pack; other states are stacked field
    by field, and the EKF kernels pack that when they take it."""
    roots = [s.intact_record() if isinstance(s, RecordState) else None for s in states]
    dtypes = {s.P.dtype for s in states}
    if len(dtypes) == 1 and all(r is not None and r.dim() == 1 for r in roots):
        return RecordState(torch.stack(roots), dtypes.pop())
    return EkfState(**{f.name: torch.stack([getattr(s, f.name) for s in states])
                       for f in dataclasses.fields(EkfState)})


def _param_views(rec) -> dict:
    views, off = {}, 0
    for name, shape in PARAM_FIELDS:
        views[name] = rec[off:off + _numel(shape)].view(shape)
        off += _numel(shape)
    return views


def params_record(params: EkfParams):
    """The record whose views ``params``' fields are, or None (as
    :func:`state_record`)."""
    p = params.init_pos
    if p.storage_offset() != 0:
        return None
    root = p.untyped_storage()
    if root.nbytes() != PARAM_WORDS * p.element_size():
        return None
    base, off = p.data_ptr(), 0
    for name, shape in PARAM_FIELDS:
        if getattr(params, name).data_ptr() - base != off * p.element_size():
            return None
        off += _numel(shape)
    return root


def pack_params(params: EkfParams) -> EkfParams:
    """``params`` copied into a fresh record (counted)."""
    p = params.init_pos
    rec = torch.zeros(PARAM_WORDS, dtype=p.dtype, device=p.device)
    views = _param_views(rec)
    for name, v in views.items():
        v.copy_(getattr(params, name))
    packs["ekf_params"] += 1
    return EkfParams(**views)
