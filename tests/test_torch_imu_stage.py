"""The frame's IMU stage and the packed EKF records: elimaloc_tpu_torch vs
the JAX package.

On the card the stage is one launch of kernel H (``kernels.imu_stage``); on
the CPU ``runtime.imu_subbatch`` runs its plain composition, which these
tests hold to JAX ``runtime.imu_subbatch`` (and ``imu_step`` for a
one-sample frame) through the ring edge cases, in float32 and float64:
rings that fill and roll, duplicate stamps (the ego ring's 1e-5 dedupe, the
IMU ring's strict order), a time regression at the first valid sample (both
rings cleared), a frame with no valid sample, and one sample. Inputs are
made with NumPy from a seed; both sides start from the same state bits. The
samples turn at 2 rad/s (tests/test_torch_imu_chain.py explains why).
Bounds: float64 atol 1e-10, float32 atol 1e-5 on states of order 1-60.

The packed records (``ekf.state``): packing a state and reading its views
back gives its fields; a state with a replaced field, or one that
``struct.select`` or ``replace`` builds, is never taken for packed unless
every field is still its record's view; ``init_state`` and relocalization
give packed states; a hot reload's parameter values reach the plain path.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu.ekf import filter as jfilter
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, struct
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.ekf import state as tstate
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import assert_tree_close, flatten, one_torch_thread, t  # noqa: F401

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10),
          "f32": (jnp.float32, torch.float32, 1e-5)}
N = 10
#: ring cases: (ego ring capacity, its (count, first time) or None, IMU ring
#: capacity, its (count, first time) or None)
RINGS = {"fill_and_roll": (12, (9, 0.85), 6, (5, 0.9)),
         "duplicates": (16, None, 16, None),
         "regress_clears": (16, (10, 1.5), 16, (8, 1.5)),
         "none_valid": (16, (4, 0.9), 16, (4, 0.9)),
         "one_sample": (8, (8, 0.9), 4, (4, 0.95))}


def _cfg(mod):
    cfg = mod.ElimalocConfig()
    cfg.calib.ego_to_imu_rot_deg = (0.5, -0.3, 1.0)
    cfg.calib.ego_to_imu_trans = (0.2, 0.0, 0.1)
    return cfg


def _ring(mod, kind, cap, fill, jdt, rng):
    """A ring of ``cap`` rows, ``fill = (count, t0)`` of them set (10 ms
    apart, random fields), else empty; JAX side."""
    ring = (mod.make_ego_ring if kind == "ego" else mod.make_imu_ring)(cap, jdt)
    if fill is None:
        return ring
    count, t0 = fill
    fields = ("pos", "rpy", "vel_local", "gyro") if kind == "ego" else ("gyro", "acc")
    return ring.replace(t=jnp.asarray(t0 + 0.01 * np.arange(cap), jdt),
                        count=jnp.asarray(count, jnp.int32),
                        **{f: jnp.asarray(rng.normal(size=(cap, 3)), jdt) for f in fields})


def _case(case, jdt, rng):
    """(JAX pipeline state, the frame's raw batch as NumPy) for one case."""
    jpp = jruntime.make_pipeline_params(_cfg(jconfig), dtype=jdt)
    a = rng.normal(size=(27, 27)) * 1e-5
    ekf = jfilter.init_state(jpp.ekf, dtype=jdt).replace(
        P=jnp.asarray(a @ a.T + np.eye(27) * 1e-8, jdt), vel=jnp.asarray([5.0, 0.3, 0.0], jdt),
        pos=jnp.asarray([60.0, 2.0, 0.1], jdt), state_initialized=jnp.asarray(True),
        yaw_initialized=jnp.asarray(True), prev_timestamp=jnp.asarray(1.0, jdt))
    re, fe, ri, fi = RINGS[case]
    st = jruntime.PipelineState(ekf=ekf, ego_ring=_ring(jrings, "ego", re, fe, jdt, rng),
                                imu_ring=_ring(jrings, "imu", ri, fi, jdt, rng))
    ts = 1.0 + 0.01 * np.arange(1, N + 1)
    acc = rng.normal(0, 0.3, (N, 3)) + [0.5, 0.1, 9.81]
    gyro = rng.normal(0, 0.05, (N, 3)) + [0.0, 0.0, 2.0]
    valid = np.ones(N, bool)
    valid[3] = False
    if case == "duplicates":
        ts[5] = ts[4]
        ts[7] = ts[6] + 4e-6
    elif case == "none_valid":
        valid[:] = False
    return jpp, st, dict(imu_t=ts, imu_acc=acc, imu_gyro=gyro, imu_valid=valid)


@pytest.mark.parametrize("case", sorted(RINGS))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_imu_stage_matches_jax_through_the_ring_edges(dt_name, case):
    jdt, tdt, atol = DTYPES[dt_name]
    rng = np.random.default_rng(101)
    jpp, jst, b = _case(case, jdt, rng)
    jps = jruntime.make_pipeline_static(_cfg(jconfig))
    tpp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    tps = truntime.make_pipeline_static(_cfg(tconfig))
    tst = convert.pipeline_state(flatten(jst), dtype=tdt)
    if case == "one_sample":
        # the event loop's step: the sequential JAX push against the port's
        # batch push of one row
        args = (b["imu_t"][0], b["imu_acc"][0], b["imu_gyro"][0])
        jout = jruntime.imu_step(jst, *(jnp.asarray(x, jdt) for x in args), jpp, jps)
        tout = truntime.imu_step(tst, *(t(x, tdt) for x in args), tpp, tps)
    else:
        jout = jruntime.imu_subbatch(jst, {k: jnp.asarray(v, jdt if v.dtype.kind == "f"
                                                          else None) for k, v in b.items()},
                                     jpp, jps)
        tout = truntime.imu_subbatch(tst, {k: t(v, tdt) for k, v in b.items()}, tpp, tps)
    assert_tree_close(flatten(tout), flatten(jout), atol=atol)
    counts = (int(tout.ego_ring.count), int(tout.imu_ring.count))
    want = {"fill_and_roll": (12, 6), "duplicates": (N - 3, N - 2),
            "regress_clears": (N - 1, N - 1), "none_valid": (4, 4),
            "one_sample": (8, 4)}[case]
    assert counts == want, counts
    if case == "regress_clears":   # cleared, then only the frame's samples
        assert float(tout.ego_ring.t[0]) == pytest.approx(1.01)
    if case == "one_sample":       # full rings roll by one
        assert float(tout.ego_ring.t[-1]) == pytest.approx(1.01)


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_pack_then_views_give_the_fields(dt_name):
    """A state built field by field is not packed; packed, every view reads
    its field back bit for bit, in one record of the layout's size."""
    _, tdt, _ = DTYPES[dt_name]
    rng = np.random.default_rng(3)
    st = tfilter.init_state(tstate.make_params(tconfig.EkfConfig(), dtype=tdt), dtype=tdt)
    loose = st.replace(**{f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)})
    loose = loose.replace(P=torch.as_tensor(rng.normal(size=(27, 27)), dtype=tdt),
                          pcm_update_count=torch.tensor(7, dtype=torch.int32),
                          cf_initialized=torch.tensor(True),
                          prev_timestamp=torch.tensor(3.5, dtype=tdt))
    assert tstate.state_record(loose) is None
    before = tstate.packs["ekf_state"]
    packed = tstate.pack_state(loose)
    assert tstate.packs["ekf_state"] == before + 1
    root = tstate.state_record(packed)
    assert root is not None and root.nbytes() == tstate.record_layout(tdt).nbytes
    for f in dataclasses.fields(st):
        a, b = getattr(packed, f.name), getattr(loose, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f.name
    copy = tstate.RecordState(torch.frombuffer(bytearray(bytes(root)), dtype=torch.uint8), tdt)
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(copy, f.name), getattr(loose, f.name)), f.name


@pytest.mark.parametrize("field", ["P", "pos", "prev_timestamp", "pcm_update_count",
                                   "state_initialized", "cf_initialized"])
def test_a_replaced_field_makes_a_state_unpacked(field):
    """Recognition goes by the fields: replacing any one of them (with a
    copy, or with another state's view) unpacks the state; the P view
    transposed too."""
    p = tstate.make_params(tconfig.EkfConfig())
    st = tfilter.init_state(p)
    other = tfilter.init_state(p)
    assert tstate.state_record(st) is not None
    assert tstate.state_record(st.replace(**{field: getattr(st, field).clone()})) is None
    assert tstate.state_record(st.replace(**{field: getattr(other, field)})) is None
    assert tstate.state_record(st.replace(P=st.P.T)) is None
    assert tstate.state_record(st.replace()) is not None


def test_select_and_replace_never_disagree_with_a_record():
    """``struct.select`` (a where per field) and ``replace`` give a state
    that is either unpacked or whose fields are all its record's views."""
    p = tstate.make_params(tconfig.EkfConfig())
    a, b = tfilter.init_state(p), tfilter.init_state(p)
    b = tstate.pack_state(b.replace(pos=b.pos + 1.0))
    for pred in (True, False):
        sel = struct.select(torch.tensor(pred), a, b)
        assert tstate.state_record(sel) is None
        want = a if pred else b
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(sel, f.name), getattr(want, f.name)), f.name
    pipe = truntime.PipelineState(ekf=a, ego_ring=None, imu_ring=None)
    assert tstate.state_record(pipe.replace(ego_ring=None).ekf) is not None
    mixed = a.replace(pos=b.pos)
    assert tstate.state_record(mixed) is None
    root = tstate.state_record(a)
    for f in dataclasses.fields(a):
        v = getattr(a, f.name)
        assert v.untyped_storage().data_ptr() == root.data_ptr(), f.name


def test_the_pipeline_packs_at_construction_and_relocalization_only():
    """``init_state`` (the pipeline's reset) is packed without a pack;
    relocalization's hard reset is packed once; params are packed by
    ``make_params``."""
    cfg = tconfig.ElimalocConfig()
    pp = truntime.make_pipeline_params(cfg)
    ps = truntime.make_pipeline_static(cfg)
    assert tstate.params_record(pp.ekf) is not None
    tstate.packs.update(ekf_state=0, ekf_params=0)
    st = truntime.PipelineState(ekf=tfilter.init_state(pp.ekf), ego_ring=None, imu_ring=None)
    assert tstate.state_record(st.ekf) is not None and tstate.packs["ekf_state"] == 0
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([3.0, -2.0, 0.5])
    st = truntime.pcm_init_step(st, torch.tensor(1.0), pose, pp, ps)
    assert tstate.state_record(st.ekf) is not None and tstate.packs["ekf_state"] == 1
    assert bool(st.ekf.pcm_init_on_going)
    torch.testing.assert_close(st.ekf.pos, pose[:3, 3])
    with pytest.raises(dataclasses.FrozenInstanceError):
        pp.ekf.imu_gravity = torch.tensor(9.0)


def test_hot_reload_values_reach_the_plain_path():
    """``reload_config`` swaps in a new params record: a changed CAN velocity
    uncertainty reaches the plain CAN update, which then equals the update
    with params made from the new config."""
    rng = np.random.default_rng(9)
    cloud = np.c_[rng.uniform(-20, 20, (3000, 2)), rng.uniform(0, 1, 3000)]
    cfg = tconfig.ElimalocConfig()
    pipe = truntime.LocalizationPipeline(cfg, cloud, device="cpu", use_native=False)
    st = pipe.reset().ekf.replace(P=torch.eye(27) * 1e-3, vel=torch.tensor([4.0, 3.0, 0.0]),
                                  prev_can_timestamp=torch.tensor(0.5))
    can = (torch.tensor([1.0]), torch.tensor([5.1]), torch.tensor([0.1]),
           torch.tensor([True]))
    flags = pipe.static.ekf_flags
    before = tfilter.update_chain(st, pipe.params.ekf, flags, can=can)
    cfg2 = tconfig.ElimalocConfig()
    cfg2.ekf.can_meas_uncertainty_vel_mps *= 0.01
    pipe.reload_config(cfg2)
    assert tstate.params_record(pipe.params.ekf) is not None
    assert float(pipe.params.ekf.can_meas_uncertainty_vel) == pytest.approx(0.02)
    after = tfilter.update_chain(st, pipe.params.ekf, flags, can=can)
    assert float((after.vel - before.vel).abs().max()) > 1e-2
    ref = tfilter.update_chain(st, tstate.make_params(cfg2.ekf), flags, can=can)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(after, f.name), getattr(ref, f.name)), f.name


def test_a_kernel_output_state_is_viewed_lazily_and_stays_recognized():
    """``RecordState`` (what the EKF kernels return): recognized as packed
    with no field viewed; a field read is its typed view at its offset;
    assigning a field, ``replace`` with a new field and ``select`` unpack
    it, ``replace`` with no change keeps every field a view."""
    p = tstate.make_params(tconfig.EkfConfig())
    src = tstate.pack_state(tfilter.init_state(p).replace(pos=torch.tensor([1.0, 2.0, 3.0])))
    root = torch.frombuffer(bytearray(bytes(tstate.state_record(src))), dtype=torch.uint8)
    rs = tstate.RecordState(root)
    assert tstate.state_record(rs) is not None and len(rs.__dict__) == 4
    base = root.data_ptr()
    for name, off, dt, shape in tstate.record_layout(torch.float32).fields:
        v = getattr(rs, name)
        assert v.dtype == dt and tuple(v.shape) == shape and v.data_ptr() - base == off, name
        assert torch.equal(v, getattr(src, name)), name
    assert tstate.state_record(rs) is not None
    assert tstate.state_record(rs.replace()) is not None
    assert tstate.state_record(rs.replace(pos=rs.pos.clone())) is None
    assert tstate.state_record(struct.select(torch.tensor(True), rs, src)) is None
    fresh = tstate.RecordState(root)
    fresh.prev_timestamp = torch.tensor(5.0)
    assert tstate.state_record(fresh) is None
    viewed = tstate.RecordState(root)
    viewed.pos = viewed.pos.clone()
    assert tstate.state_record(viewed) is None
