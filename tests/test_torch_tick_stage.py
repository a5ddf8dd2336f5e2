"""The tick mode's event steps as one launch each: kernel U (``tick_stage``:
the CA tick and its ego push) and kernel V (``imu_intake``: the IMU-only
intake), their plain versions against the JAX package, and the kernels
against their plain versions and the chains they replace on the card.

On the CPU, the same seeded NumPy inputs (a filter in motion, rings of 4 or
8 rows, each case's sequence of IMU samples and ticks) go through JAX's
``runtime.tick_step`` / ``imu_ring_step`` and through the port's
``ekf.filter.tick_stage_plain`` / ``pipeline.rings.imu_intake_plain``, in
float64 and float32, event after event. Bounds: every float field of the
state and of both rings within atol 1e-12 (float64; the EKF's libm and
matmul ulps) or 1e-5 (float32); the rings' times and counts and the
state's flags and counters exactly equal. The cases: rings that fill and
roll (seven events of each kind into rings of four), two ticks within the
ego ring's 1e-5 dedupe, a tick at dt < 1e-6 (no prediction), the reset
gate, the ``pcm_init_on_going`` gate and a time regression that clears
both rings. ``runtime.tick_step`` / ``imu_ring_step`` on CPU tensors are
the plain versions bit for bit, with no library and no launch.

On the card (``cuda`` marker; skipped without one), float32, on the same
cases: U bit for bit against kernel O then kernel J's ego push on every
tick, and against its plain version (pos / vel 1e-4 m, the quaternion
1e-6, each P entry within 1e-5 sqrt(P_ii P_jj) plus eight float32 ulps of
its prior scale: the plain dense F P F^T goes through cuBLAS; the ring's
times and count exactly, its fields 1e-4 and rpy 1e-5 rad); V bit for bit
against kernel H's IMU ring on the same sample, within the rotation's
rounding bound (3 float32 eps of sum_j |R_ij v_j|) of the old chain (the
rotation as two cuBLAS products, then kernel J: cuBLAS may contract into
FMAs, and with cancellation that is more than one ulp of the result) and
equal to its plain version in times and
count, its fields within 1e-5; 50 chained events, each reading the last
one's outputs (every ring after the first found by identity, ``_known``);
a hot reload's parameters reaching U. JAX is imported only inside the JAX
cases, so the card cases also run on a GPU host without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_tick_stage.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert, kernels
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.pipeline import rings as trings
from elimaloc_tpu_torch.pipeline import runtime as truntime
from torch_parity import flatten, one_torch_thread, tiny_cfg  # noqa: F401

ATOL = {"f64": 1e-12, "f32": 1e-5}
#: the ego-to-IMU rotation of these cases (degrees): the intake's rotation
#: is not the identity
IMU_ROT_DEG = (1.5, -2.0, 30.0)
#: a filter in motion with nonzero body rates and acceleration and a
#: correlated P, so every block of F moves P
_A = np.random.default_rng(17).normal(size=(27, 27)) * 0.03
_Q = np.array([0.72, 0.01, -0.02, 0.69])
MOVING = dict(P=_A @ _A.T + np.eye(27) * 1e-3, rot=_Q / np.linalg.norm(_Q),
              vel=[0.2, 8.0, 0.1], acc=[0.3, -0.2, 0.05], gyro=[0.01, -0.02, 0.2],
              prev_timestamp=1.0)
MOVING_FLAGS = dict(state_initialized=True, yaw_initialized=True,
                    reset_for_init_prediction=False)

#: per case: the rings' capacity and its events (kind, time, state flags set
#: just before the event); the filter's prev_timestamp starts at 1.0
CASES = {
    "fill_and_roll": (4, [(kind, 1.0 + 0.01 * k + (0.005 if kind == "tick" else 0.0), {})
                          for k in range(7) for kind in ("imu", "tick")]),
    "tick_dedupe": (8, [("imu", 1.0, {}), ("tick", 1.01, {}), ("tick", 1.01 + 5e-6, {}),
                        ("imu", 1.015, {}), ("tick", 1.02, {})]),
    "small_dt": (8, [("tick", 1.01, {}), ("tick", 1.01 + 5e-7, {}), ("imu", 1.012, {}),
                     ("tick", 1.02, {})]),
    "reset_gate": (8, [("tick", 1.01, {}), ("tick", 1.02, {"reset_for_init_prediction": True}),
                       ("imu", 1.025, {}), ("tick", 1.03, {})]),
    "pcm_init_gate": (8, [("tick", 1.01, {}), ("tick", 1.02, {"pcm_init_on_going": True}),
                          ("tick", 1.03, {}), ("tick", 1.04, {"pcm_init_on_going": False}),
                          ("tick", 1.05, {})]),
    "time_regression": (8, [("imu", 1.0, {}), ("tick", 1.01, {}), ("imu", 1.02, {}),
                            ("tick", 1.03, {}), ("imu", 0.995, {}), ("tick", 1.005, {}),
                            ("imu", 1.0, {}), ("tick", 1.015, {})]),
}
#: per case, the ticks (event indices) that must leave P as it was (a gate
#: or dt < 1e-6); every other tick moves it
STILL = {"small_dt": {1}, "reset_gate": {1}, "pcm_init_gate": {1, 2}}
#: per case, the ticks whose row the ego ring's 1e-5 dedupe drops
DROPPED = {"tick_dedupe": {2}, "small_dt": {1}}


def _samples(name):
    """The raw IMU sample (acc, gyro) of each event of case ``name``."""
    rng = np.random.default_rng(sorted(CASES).index(name) + 23)
    return [(np.array([0.3, 0.1, 9.81]) + rng.normal(0, 0.1, 3),
             np.array([0.0, 0.0, 0.13]) + rng.normal(0, 0.02, 3)) for _ in CASES[name][1]]


def _cfg(cfg_mod):
    cfg = tiny_cfg(cfg_mod)
    cfg.calib.ego_to_imu_rot_deg = IMU_ROT_DEG
    cfg.ekf.use_imu = False
    return cfg


def _port_state(cap, dtype, device="cpu"):
    """(pipeline state, params, static) of the port: the moving filter and
    empty rings of ``cap`` rows."""
    cfg = _cfg(tconfig)
    pp = truntime.make_pipeline_params(cfg, dtype=dtype, device=device)
    ekf = tfilter.init_state(pp.ekf, dtype=dtype).replace(
        **{k: torch.tensor(np.asarray(v), dtype=dtype, device=device) for k, v in MOVING.items()},
        **{k: torch.tensor(v, device=device) for k, v in MOVING_FLAGS.items()})
    st = truntime.PipelineState(ekf=ekf, ego_ring=trings.make_ego_ring(cap, dtype, device),
                                imu_ring=trings.make_imu_ring(cap, dtype, device))
    return st, pp, truntime.make_pipeline_static(cfg)


def _flagged(st, over):
    """``st`` with the state flags ``over`` set (a field assigned: the
    state's record is packed anew by the next kernel)."""
    if not over:
        return st
    dev = st.ekf.P.device
    return st.replace(ekf=st.ekf.replace(**{k: torch.tensor(v, device=dev)
                                            for k, v in over.items()}))


def _plain_step(st, kind, t, acc, gyro, pp):
    if kind == "tick":
        ekf, ego = tfilter.tick_stage_plain(st.ekf, st.ego_ring, t, pp.ekf)
        return st.replace(ekf=ekf, ego_ring=ego)
    return st.replace(imu_ring=trings.imu_intake_plain(st.imu_ring, t, acc, gyro,
                                                       pp.ego_to_imu_rot))


# --------------------------------------------------------------------------- #
# On the CPU: the plain versions against the JAX package
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _jax_steps(dt_name):
    """JAX's jitted tick_step and imu_ring_step, its params and the moving
    filter, in float64 or float32 (one compile per dtype)."""
    import jax
    import jax.numpy as jnp

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu.ekf import init_state as jinit
    from elimaloc_tpu.pipeline import runtime as jruntime

    jdt = {"f64": jnp.float64, "f32": jnp.float32}[dt_name]
    cfg = _cfg(jconfig)
    jpp = jruntime.make_pipeline_params(cfg, dtype=jdt)
    jps = jruntime.make_pipeline_static(cfg)
    ekf = jinit(jpp.ekf, dtype=jdt).replace(
        **{k: jnp.asarray(np.asarray(v), jdt) for k, v in MOVING.items()},
        **{k: jnp.asarray(v) for k, v in MOVING_FLAGS.items()})
    tick = jax.jit(functools.partial(jruntime.tick_step, ps=jps))
    imu = jax.jit(functools.partial(jruntime.imu_ring_step, ps=jps))
    return jdt, jpp, ekf, tick, imu


def _assert_close(got, ref, atol, what):
    """Port record ``got`` against the flattened JAX record ``ref``: floats
    within ``atol``, the rings' times, counts, flags and counters equal."""
    for f, v in flatten(got).items():
        r = np.asarray(ref[f])
        if v.dtype.kind == "f" and f != "t":
            np.testing.assert_allclose(v, r, rtol=0, atol=atol, err_msg=f"{what}.{f}")
        else:
            np.testing.assert_array_equal(v, r, err_msg=f"{what}.{f}")


@pytest.mark.parametrize("dt_name", sorted(ATOL))
@pytest.mark.parametrize("name", sorted(CASES))
def test_tick_stage_and_imu_intake_plain_match_jax(name, dt_name):
    import jax.numpy as jnp

    from elimaloc_tpu.pipeline import rings as jrings
    from elimaloc_tpu.pipeline import runtime as jruntime

    jdt, jpp, jekf, jtick, jimu = _jax_steps(dt_name)
    tdt = {"f64": torch.float64, "f32": torch.float32}[dt_name]
    cap, events = CASES[name]
    jst = jruntime.PipelineState(ekf=jekf, ego_ring=jrings.make_ego_ring(cap, jdt),
                                 imu_ring=jrings.make_imu_ring(cap, jdt))
    st = convert.pipeline_state(flatten(jst), dtype=tdt)
    pp = convert.pipeline_params(flatten(jpp), dtype=tdt)
    regressions = 0
    for k, ((kind, t, over), (acc, gyro)) in enumerate(zip(events, _samples(name))):
        if over:
            jst = jst.replace(ekf=jst.ekf.replace(**{f: jnp.asarray(v) for f, v in over.items()}))
            st = _flagged(st, over)
        before, counts = st.ekf.P.clone(), (int(st.ego_ring.count), int(st.imu_ring.count))
        if kind == "tick":
            jst = jtick(jst, jnp.asarray(t, jdt), pp=jpp)
        else:
            jst = jimu(jst, jnp.asarray(t, jdt), jnp.asarray(acc, jdt), jnp.asarray(gyro, jdt),
                       pp=jpp)
        st = _plain_step(st, kind, torch.tensor(t, dtype=tdt), torch.tensor(acc, dtype=tdt),
                         torch.tensor(gyro, dtype=tdt), pp)
        for part in ("ekf", "ego_ring", "imu_ring"):
            _assert_close(getattr(st, part), flatten(getattr(jst, part)), ATOL[dt_name],
                          f"event {k} ({kind}) {part}")
        if kind == "tick":
            assert torch.equal(before, st.ekf.P) == (k in STILL.get(name, ())), k
            assert (int(st.ego_ring.count) == counts[0]) == (
                k in DROPPED.get(name, ()) or counts[0] == cap), k
        regressions += int(st.ego_ring.count) < counts[0] or int(st.imu_ring.count) < counts[1]
    if name == "fill_and_roll":
        assert int(st.ego_ring.count) == int(st.imu_ring.count) == cap
    if name == "time_regression":
        assert regressions >= 1 and int(st.imu_ring.count) == 2 and int(st.ego_ring.count) == 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_runtime_tick_mode_steps_are_the_plain_versions_on_cpu(name, monkeypatch):
    """``runtime.tick_step`` and ``imu_ring_step`` on CPU tensors are
    ``tick_stage_plain`` and ``imu_intake_plain`` bit for bit: no library,
    no launch."""
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_library)
    cap, events = CASES[name]
    st, pp, ps = _port_state(cap, torch.float32)
    ref = st
    kernels.reset_launches()
    for (kind, t, over), (acc, gyro) in zip(events, _samples(name)):
        st, ref = _flagged(st, over), _flagged(ref, over)
        t, acc, gyro = (torch.tensor(x, dtype=torch.float32) for x in (t, acc, gyro))
        if kind == "tick":
            st = truntime.tick_step(st, t, pp, ps)
        else:
            st = truntime.imu_ring_step(st, t, acc, gyro, pp, ps)
        ref = _plain_step(ref, kind, t, acc, gyro, pp)
        for part in ("ekf", "ego_ring", "imu_ring"):
            got, want = getattr(st, part), getattr(ref, part)
            for f in dataclasses.fields(want):
                assert torch.equal(getattr(got, f.name), getattr(want, f.name)), (part, f.name)
    assert all(v == 0 for v in kernels.launches.values()), kernels.launches


def test_tick_stage_ring_layouts_match_the_sources():
    """The wrappers' ring layouts are the C entries': t [cap], the fields
    [cap, 3] one after another, then the int32 count (csrc/ca_tick.cu
    ``13 * ego_cap``, csrc/imu_chain.cu ``7 * imu_cap``)."""
    from elimaloc_tpu_torch.kernels import build

    tick = (build.SRC_DIR / "ca_tick.cu").read_text()
    intake = (build.SRC_DIR / "imu_chain.cu").read_text()
    assert "ring::fill_out(g, ring_out, (int*)(ring_out + 13 * ego_cap));" in tick
    assert "ring::fill_out(g, ring_out, (int*)(ring_out + 7 * imu_cap));" in intake
    assert len(kernels._EGO_FIELDS) * 3 + 1 == 13 and len(kernels._IMU_FIELDS) * 3 + 1 == 7


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


def _same(got, ref, what):
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), (what, f.name)


def _p_entry_err(got, ref, prior, tol):
    """P's error as a share of its limit (tests/test_torch_kernels.py)."""
    def scale(p):
        d = torch.sqrt(torch.diagonal(p).double().clamp(min=0.0))
        return d[:, None] * d[None, :]

    limit = tol * scale(ref) + 8 * torch.finfo(torch.float32).eps * scale(prior)
    return float(((got.double() - ref.double()).abs() / limit.clamp(min=1e-30)).max())


def _check_tick_plain(got, ring, ref, ref_ring, prior):
    for f in ("pos", "vel"):
        assert float((getattr(got, f) - getattr(ref, f)).abs().max()) <= 1e-4, f
    assert float((got.rot - ref.rot).abs().max()) <= 1e-6
    assert _p_entry_err(got.P, ref.P, prior, 1e-5) <= 1.0
    assert torch.equal(got.prev_timestamp, ref.prev_timestamp)
    for f, dtype, _ in kernels.EKF_FIELDS:
        if dtype != torch.float32:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(ring.t, ref_ring.t) and torch.equal(ring.count, ref_ring.count)
    for f, tol in (("pos", 1e-4), ("rpy", 1e-5), ("vel_local", 1e-4), ("gyro", 1e-4)):
        assert float((getattr(ring, f) - getattr(ref_ring, f)).abs().max()) <= tol, f


def _within_rounding(got, ref, rot, v):
    """``got`` and ``ref`` (two rings) within the rounding bound of the
    rotation ``rot v`` on each side: 2 gamma_3 sum_j |R_ij v_j|, gamma_3 ~
    3 u (u = eps / 2), the standard bound of a 3-term dot product, held
    against the products' scale, not the result: where the terms cancel, a
    product contracted into FMAs (cuBLAS) differs by more than one ulp of
    the small result. The rows not pushed are copies and must be equal."""
    bound = 3 * torch.finfo(torch.float32).eps * (rot.abs() @ v.abs())
    return bool(((got - ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_tick_stage_is_o_then_j_on_card(cuda, name):
    """Every tick of the case: kernel U bit for bit against kernel O, then
    kernel J's ego push of O's row, on the same inputs, one launch; and
    against ``tick_stage_plain``."""
    cap, events = CASES[name]
    st, pp, ps = _port_state(cap, torch.float32, cuda)
    one = torch.ones(1, dtype=torch.bool, device=cuda)
    for (kind, t, over), (acc, gyro) in zip(events, _samples(name)):
        st = _flagged(st, over)
        t, acc, gyro = (torch.tensor(x, dtype=torch.float32, device=cuda)
                        for x in (t, acc, gyro))
        if kind == "imu":
            st = truntime.imu_ring_step(st, t, acc, gyro, pp, ps)
            continue
        kernels.reset_launches()
        nxt = truntime.tick_step(st, t, pp, ps)
        torch.cuda.synchronize()
        assert kernels.launches["tick_stage"] == 1 and sum(kernels.launches.values()) == 1
        ekf, row = kernels.ca_tick(st.ekf, t, pp.ekf)
        ego, _ = kernels.ring_push(st.ego_ring, None, row, None, one)
        for f, _, _ in kernels.EKF_FIELDS:
            assert torch.equal(getattr(nxt.ekf, f), getattr(ekf, f)), (name, f)
        _same(nxt.ego_ring, ego, name)
        ref, ref_ring = tfilter.tick_stage_plain(st.ekf, st.ego_ring, t, pp.ekf)
        _check_tick_plain(nxt.ekf, nxt.ego_ring, ref, ref_ring, st.ekf.P)
        st = nxt


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_imu_intake_is_h_intake_on_card(cuda, name):
    """Every IMU sample of the case: kernel V bit for bit against kernel H's
    IMU ring on the same sample, one launch; within the rotation's rounding
    bound of the old chain (two cuBLAS products, then kernel J); against
    ``imu_intake_plain``."""
    cap, events = CASES[name]
    st, pp, ps = _port_state(cap, torch.float32, cuda)
    one = torch.ones(1, dtype=torch.bool, device=cuda)
    rot = pp.ego_to_imu_rot
    for (kind, t, over), (acc, gyro) in zip(events, _samples(name)):
        st = _flagged(st, over)
        t, acc, gyro = (torch.tensor(x, dtype=torch.float32, device=cuda)
                        for x in (t, acc, gyro))
        if kind == "tick":
            st = truntime.tick_step(st, t, pp, ps)
            continue
        kernels.reset_launches()
        nxt = truntime.imu_ring_step(st, t, acc, gyro, pp, ps)
        torch.cuda.synchronize()
        assert kernels.launches["imu_intake"] == 1 and sum(kernels.launches.values()) == 1
        _, _, h_imu = kernels.imu_stage(st.ekf, st.ego_ring, st.imu_ring, t.reshape(1),
                                        acc[None], gyro[None], None, rot, pp.ego_to_imu_trans,
                                        pp.ekf, ps.ekf_flags)
        _same(nxt.imu_ring, h_imu, name)
        _, j_imu = kernels.ring_push(None, st.imu_ring, None,
                                     (t.reshape(1), gyro[None] @ rot.T, acc[None] @ rot.T), one)
        assert torch.equal(nxt.imu_ring.t, j_imu.t) and torch.equal(nxt.imu_ring.count,
                                                                    j_imu.count)
        for f, v in (("gyro", gyro), ("acc", acc)):
            assert _within_rounding(getattr(nxt.imu_ring, f), getattr(j_imu, f), rot, v), f
        ref = trings.imu_intake_plain(st.imu_ring, t, acc, gyro, rot)
        assert torch.equal(nxt.imu_ring.t, ref.t) and torch.equal(nxt.imu_ring.count, ref.count)
        for f in ("gyro", "acc"):
            assert float((getattr(nxt.imu_ring, f) - getattr(ref, f)).abs().max()) <= 1e-5, f
        st = nxt


@pytest.mark.cuda
def test_tick_mode_chains_its_own_outputs_on_card(cuda, monkeypatch):
    """50 events, ticks and IMU samples in turn, each reading the last one's
    outputs: every ring after the first two is found by identity (no
    pointer list rebuilt), no state is packed, and the result matches the
    plain chain."""
    st, pp, ps = _port_state(32, torch.float32, cuda)
    st = truntime.tick_step(st, torch.tensor(1.0, device=cuda), pp, ps)  # packs the state
    ref = st
    lookups = {"hit": 0, "miss": 0}
    known = kernels._known

    def counted(key, obj):
        ptrs = known(key, obj)
        lookups["hit" if ptrs is not None else "miss"] += 1
        return ptrs

    monkeypatch.setattr(kernels, "_known", counted)
    rng = np.random.default_rng(5)
    kernels.reset_launches()
    for k in range(50):
        t = torch.tensor(1.0 + 0.005 * (k + 1), device=cuda)
        acc, gyro = (torch.tensor(rng.normal(size=3), dtype=torch.float32, device=cuda)
                     for _ in range(2))
        kind = "imu" if k % 2 == 0 else "tick"
        if kind == "tick":
            st = truntime.tick_step(st, t, pp, ps)
        else:
            st = truntime.imu_ring_step(st, t, acc, gyro, pp, ps)
        ref = _plain_step(ref, kind, t, acc, gyro, pp)
    torch.cuda.synchronize()
    assert kernels.launches["tick_stage"] == 25 and kernels.launches["imu_intake"] == 25
    assert sum(kernels.launches.values()) == 50 and not any(kernels.packs.values())
    # the first IMU ring (made by make_imu_ring) is the one miss; the ego
    # ring came from the first tick's U
    assert lookups == {"hit": 49, "miss": 1}, lookups
    assert torch.equal(st.ego_ring.t, ref.ego_ring.t) and torch.equal(st.imu_ring.t,
                                                                      ref.imu_ring.t)
    assert float((st.ekf.pos - ref.ekf.pos).abs().max()) <= 1e-4
    assert float((st.imu_ring.acc - ref.imu_ring.acc).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_hot_reload_reaches_kernel_u_on_card(cuda):
    """A value-only reload (a new params record: the position process noise
    x 100) changes kernel U's Q, and U follows each params object it is
    given, back and forth, each time within its plain version's bounds."""
    st, pp, ps = _port_state(8, torch.float32, cuda)
    cfg = _cfg(tconfig)
    cfg.ekf.state_std_pos_m *= 100.0
    pp2 = truntime.make_pipeline_params(cfg, device=cuda)
    t = torch.tensor(1.01, device=cuda)
    got = [truntime.tick_step(st, t, params, ps) for params in (pp, pp2, pp)]
    assert float((got[1].ekf.P[0, 0] - got[0].ekf.P[0, 0]).abs()) > 1e-4
    assert torch.equal(got[0].ekf.P, got[2].ekf.P)
    for out, params in zip(got, (pp, pp2, pp)):
        ref, ref_ring = tfilter.tick_stage_plain(st.ekf, st.ego_ring, t, params.ekf)
        _check_tick_plain(out.ekf, out.ego_ring, ref, ref_ring, st.ekf.P)
