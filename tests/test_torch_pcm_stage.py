"""The scan's end, kernel S: ``runtime.pcm_stage_plain`` against the JAX
package, and kernel S against its plain version and against kernels L then
I on the card.

On the CPU, the same seeded NumPy inputs (an EKF state, the ego ring, the
ICP result, the scan's end time) go through JAX's scan tail
(runtime.py:341-362: compose with tf_lidar_to_ego, rot_to_quat,
shape_icp_covariance, gnss_time_compensation, ``apply`` = usable & success
& compensation ok & use_pcm, update_gnss with the PCM source and
_select_state), then ``ego_state``'s pos, rpy and timestamp and the P
reductions of fused_frame (:481-490), and through the port's
``pcm_stage_plain``, in float64 and float32. Bounds: the EKF state, the
published outputs and the measurement atol 1e-6 in float64 (the EKF
state's bound of tests/test_oracle_parity.py:88-101) and 1e-5 in float32
(tests/test_torch_fusion.py's), the covariances relative to their largest
entry; flags, counters and ``applied`` equal. The cases reach every branch
of the tail: an empty ego ring, a measurement older than the ring, no newer
entry (no extrapolation), a span at or below 1e-5, a fitness below the 0.25
clamp, a covariance whose smallest diagonal is at or below 1e-9 (the 1e9
rescale), ``apply`` false from each of its four terms, the PCM warm-up
counter on both sides of its release, the Joseph form and a pitch near
90 degrees (rot_to_euler's gimbal-lock branch).

On the card (``cuda`` marker; skipped without one): kernel S on the same
inputs in float32 against ``pcm_stage_plain`` (the state as kernel I's
card tests hold it: each P entry within 1e-5 sqrt(P_ii P_jj) plus eight
float32 ulps of its scale before the call, the other floats within 1e-5 of
their largest entry; ego_rpy within 1e-6 rad of the plain conversion of
S's own state; p_asym and p_min_diag equal to the plain reductions of S's
own P), and bit for bit against kernel L then kernel I (the state record,
every measurement field, ``applied``). JAX is imported only inside the JAX
cases, so the card cases also run on a GPU host without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_pcm_stage.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import kernels
from elimaloc_tpu_torch.config import EkfConfig
from elimaloc_tpu_torch.ekf import EkfFlags, EkfState, GnssMeas, make_params
from elimaloc_tpu_torch.ekf import filter as tfilter
from elimaloc_tpu_torch.ops import lie as tlie
from elimaloc_tpu_torch.pipeline import rings as trings
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.register import icp as ticp

DTYPES = {"f64": 1e-6, "f32": 1e-5}
RING_CAP, RING_T0 = 16, 0.9


@dataclasses.dataclass
class Case:
    count: int = 10           # ego ring rows (t = 0.90, 0.91, ...)
    end: float = 0.955        # the scan's end time
    fitness: float = 0.4
    cov: str = "gicp"         # "gicp", or "tiny": smallest diagonal <= 1e-9
    usable: bool = True
    success: bool = True
    use_pcm: bool = True
    joseph: bool = False
    warmup: int = -1          # PCM warm-up on with this pcm_update_count; -1: off
    pitch_deg: float = 5.0    # the filter's pitch


CASES = {
    "nominal": Case(),
    "empty_ring": Case(count=0),
    "older_than_ring": Case(end=0.85),
    "no_newer_entry": Case(end=1.2),
    "span_below_1e-5": Case(end=0.985),
    "fitness_clamped": Case(fitness=0.1),
    "tiny_cov_rescaled": Case(cov="tiny"),
    "not_usable": Case(usable=False),
    "not_success": Case(success=False),
    "use_pcm_off": Case(use_pcm=False),
    "warmup_holds": Case(warmup=10),
    "warmup_releases": Case(warmup=11),
    "joseph": Case(joseph=True),
    "pitch_near_90": Case(pitch_deg=89.9),
}
#: whether each case applies the PCM pose
APPLIES = {k: c.count > 0 and c.end >= RING_T0 and c.usable and c.success and c.use_pcm
           for k, c in CASES.items()}


def _quat(rpy):
    r = tlie.euler_to_rot(torch.tensor(rpy, dtype=torch.float64))
    return tlie.rot_to_quat(r).numpy(), r.numpy()


def _inputs(case: Case):
    """NumPy inputs of one scan's end: the EKF state's fields (the filter as
    reset, then moving: a random SPD P of order 1e-2, tilted and turning),
    the ego ring's fields, the ICP pose in the LiDAR frame near the
    filter's, its local_cov and fitness, tf_lidar_to_ego and the end time."""
    rng = np.random.default_rng(29)
    params = make_params(EkfConfig(), dtype=torch.float64)
    st = tfilter.init_state(params, dtype=torch.float64)
    f = {fl.name: getattr(st, fl.name).numpy().copy() for fl in dataclasses.fields(EkfState)}
    a = rng.normal(size=(27, 27)) * 2e-2
    f["P"] = a @ a.T + np.eye(27) * 1e-3
    rpy = np.array([0.02, np.deg2rad(case.pitch_deg), 0.8])
    f["rot"], rot = _quat(rpy)
    f["pos"] = np.array([60.0, 1.5, 0.2])
    f["vel"] = np.array([0.8, 5.0, 0.1])
    f["gyro"] = np.array([0.01, -0.02, 0.3])
    f["prev_timestamp"] = np.array(0.99)
    f["prev_gnss_timestamp"] = np.array(0.5)
    f["state_initialized"] = np.array(True)
    f["yaw_initialized"] = np.array(True)
    f["pcm_init_on_going"] = np.array(case.warmup >= 0)
    f["pcm_update_count"] = np.array(max(case.warmup, 0), np.int32)

    t = RING_T0 + 0.01 * np.arange(RING_CAP)
    ring = {"t": t, "pos": np.c_[60 + 8.0 * (t - RING_T0), 0.5 * (t - RING_T0),
                                 np.zeros(RING_CAP)],
            "rpy": np.c_[rng.normal(0, 0.01, RING_CAP),
                         np.deg2rad(case.pitch_deg) + rng.normal(0, 0.01, RING_CAP),
                         0.8 + 0.1 * (t - RING_T0)],
            "vel_local": np.c_[np.full(RING_CAP, 8.0), rng.normal(0, 0.1, RING_CAP),
                               np.zeros(RING_CAP)],
            "gyro": np.c_[np.zeros((RING_CAP, 2)), np.full(RING_CAP, 0.1)],
            "count": np.array(case.count, np.int32)}

    tf_ego_to_lidar = np.eye(4)
    tf_ego_to_lidar[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    tf_ego_to_lidar[:3, 3] = [1.0, 0.2, 1.5]
    ego = np.eye(4)  # the registered pose in the ego frame: near the filter's
    _, d_rot = _quat(rng.normal(0, 0.01, 3))
    ego[:3, :3] = rot @ d_rot
    ego[:3, 3] = f["pos"] + rng.normal(0, 0.2, 3)
    b = rng.normal(size=(6, 6))
    local_cov = b @ b.T * (1e-13 if case.cov == "tiny" else 1e-4)
    return {"ekf": f, "ring": ring, "icp_pose": ego @ tf_ego_to_lidar,
            "tf": np.linalg.inv(tf_ego_to_lidar), "local_cov": local_cov,
            "fitness": case.fitness, "end": case.end}


def _port(inp, case: Case, dtype, device="cpu"):
    """The port's arguments of ``pcm_stage_plain`` (and of kernel S)."""
    def t(a):
        a = np.asarray(a)
        kw = {"dtype": dtype} if a.dtype.kind == "f" else {}
        return torch.as_tensor(a, device=device, **kw)

    ekf = EkfState(**{k: t(v) for k, v in inp["ekf"].items()})
    ring = trings.EgoRing(**{k: t(v) for k, v in inp["ring"].items()})
    res = ticp.IcpResult(pose=t(inp["icp_pose"]), success=t(case.success),
                         fitness=t(inp["fitness"]), local_cov=t(inp["local_cov"]),
                         iterations=t(np.int32(3)), overlap=t(0.9), dropped=t(np.int32(0)))
    params = make_params(EkfConfig(), dtype=dtype, device=device)
    return (ekf, res, t(inp["tf"]), ring, t(inp["end"]), t(case.usable), params,
            EkfFlags(joseph_form=case.joseph), case.use_pcm)


def _jax_tail(inp, case: Case, jdt):
    """JAX's scan tail, the PCM update and fused_frame's epilogue on the same
    inputs: (ekf', meas, published)."""
    import jax
    import jax.numpy as jnp

    from elimaloc_tpu import config as jconfig
    from elimaloc_tpu.ekf import filter as jfilter
    from elimaloc_tpu.ekf import state as jstate
    from elimaloc_tpu.ops import lie as jlie
    from elimaloc_tpu.pipeline import rings as jrings
    from elimaloc_tpu.pipeline import runtime as jruntime

    def j(a):
        a = np.asarray(a)
        return jnp.asarray(a, jdt if a.dtype.kind == "f" else None)

    st = jstate.EkfState(**{k: j(v) for k, v in inp["ekf"].items()})
    ring = jrings.EgoRing(**{k: j(v) for k, v in inp["ring"].items()})
    params = jstate.make_params(jconfig.EkfConfig(), dtype=jdt)
    pose = jlie.compose(j(inp["icp_pose"]), j(inp["tf"]))
    quat = jlie.rot_to_quat(pose[:3, :3])
    pos_cov, rot_cov = jruntime.shape_icp_covariance(pose[:3, :3], j(inp["local_cov"]),
                                                     j(inp["fitness"]))
    ct, cpos, cquat, ok = jrings.gnss_time_compensation(ring, j(inp["end"]), pose[:3, 3],
                                                        quat)
    meas = jstate.GnssMeas(timestamp=ct, source=jnp.asarray(3), pos=cpos, rot=cquat,
                           pos_cov=pos_cov.astype(jdt), rot_cov=rot_cov.astype(jdt))
    apply = jnp.asarray(case.usable) & jnp.asarray(case.success) & ok & case.use_pcm
    flags = jfilter.EkfFlags(joseph_form=case.joseph)
    ekf2 = jfilter.update_gnss(st, meas, params, flags)
    ekf = jax.tree_util.tree_map(lambda a, b: jnp.where(apply, a, b), ekf2, st)
    es = jfilter.ego_state(ekf)
    P = ekf.P
    return ekf, meas, {"icp_pose": pose, "applied": apply, "ego_pos": es["pos"],
                       "ego_rpy": es["rpy"], "ego_t": es["timestamp"],
                       "p_asym": jnp.max(jnp.abs(P - P.T)),
                       "p_min_diag": jnp.min(jnp.diagonal(P))}


def _close(got, want, atol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_pcm_stage_plain_matches_jax(dt_name, name):
    import jax.numpy as jnp

    case = CASES[name]
    atol = DTYPES[dt_name]
    tdt, jdt = ((torch.float64, jnp.float64) if dt_name == "f64"
                else (torch.float32, jnp.float32))
    inp = _inputs(case)
    args = _port(inp, case, tdt)
    ekf, meas, pub = truntime.pcm_stage_plain(*args)
    jekf, jmeas, jpub = _jax_tail(inp, case, jdt)

    for fl in dataclasses.fields(EkfState):
        _close(getattr(ekf, fl.name), getattr(jekf, fl.name), atol, f"ekf.{fl.name}")
    # the measurement and the ICP pose relative to their largest entry, as
    # tests/test_torch_rings_deskew.py holds kernel L's plain version
    for k in ("timestamp", "pos", "rot", "pos_cov", "rot_cov"):
        want = getattr(jmeas, k)
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        _close(getattr(meas, k), want, atol * scale, f"meas.{k}")
    assert set(pub) == set(jpub) == {"icp_pose", "applied", *truntime.PUBLISHED}
    for k, v in pub.items():
        scale = max(1.0, float(np.abs(np.asarray(jpub[k])).max())) if k == "icp_pose" else 1.0
        _close(v, jpub[k], atol * scale, k)
    assert bool(pub["applied"]) == APPLIES[name]
    moved = not torch.equal(ekf.P, args[0].P)
    assert moved == APPLIES[name]
    if name.startswith("warmup"):
        assert int(ekf.pcm_update_count) == case.warmup + 1
        assert bool(ekf.pcm_init_on_going) == (name == "warmup_holds")
    if name == "pitch_near_90":
        # the gimbal-lock branch: roll 0, pitch +-pi/2 by the sign of R[2, 0]
        assert abs(float(pub["ego_rpy"][0])) == 0.0
        assert abs(float(pub["ego_rpy"][1])) == pytest.approx(np.pi / 2, abs=1e-6)


def test_pcm_stage_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    """On CPU tensors ``runtime.pcm_stage`` is ``pcm_stage_plain``: no
    library, no launch."""
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_library)
    case = CASES["nominal"]
    args = _port(_inputs(case), case, torch.float32)
    kernels.reset_launches()
    got = truntime.pcm_stage(*args)
    ref = truntime.pcm_stage_plain(*args)
    assert all(v == 0 for v in kernels.launches.values())
    for k, v in ref[2].items():
        assert torch.equal(got[2][k], v), k
    assert torch.equal(got[0].P, ref[0].P)


def test_pcm_stage_wrapper_refuses_cpu_tensors():
    case = CASES["nominal"]
    ekf, res, tf, ring, end, usable, params, flags, use_pcm = _port(
        _inputs(case), case, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor required"):
        kernels.pcm_stage(ekf, params, flags, res.pose, tf, res.local_cov, res.fitness,
                          res.success, usable, ring, end, use_pcm)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


def _p_entry_err(got, ref, prior, tol):
    """P's error as a share of its limit: |got_ij - ref_ij| over tol
    sqrt(ref_ii ref_jj) + 8 eps sqrt(prior_ii prior_jj), the largest."""
    def scale(p):
        d = torch.sqrt(torch.diagonal(p).clamp(min=0.0))
        return d[:, None] * d[None, :]

    limit = tol * scale(ref) + 8 * torch.finfo(torch.float32).eps * scale(prior)
    return float(((got - ref).abs() / limit.clamp(min=1e-30)).max())


def _kernel_call(args):
    ekf, res, tf, ring, end, usable, params, flags, use_pcm = args
    return kernels.pcm_stage(ekf, params, flags, res.pose, tf, res.local_cov, res.fitness,
                             res.success, usable, ring, end, use_pcm)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_pcm_stage_matches_plain_on_card(cuda, name):
    case = CASES[name]
    args = _port(_inputs(case), case, torch.float32, cuda)
    kernels.reset_launches()
    ekf, _, pub = truntime.pcm_stage(*args)
    torch.cuda.synchronize()
    assert kernels.launches["pcm_stage"] == 1
    assert sum(kernels.launches.values()) == 1, kernels.launches
    ref, _, rpub = truntime.pcm_stage_plain(*args)
    assert _p_entry_err(ekf.P, ref.P, args[0].P, 1e-5) <= 1.0
    for fl in dataclasses.fields(EkfState):
        a, b = getattr(ekf, fl.name), getattr(ref, fl.name)
        if fl.name == "P":
            continue
        if a.dtype != torch.float32:
            assert torch.equal(a, b), fl.name
        else:
            assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1.0), fl.name
    assert bool(pub["applied"]) == bool(rpub["applied"]) == APPLIES[name]
    torch.testing.assert_close(pub["icp_pose"], rpub["icp_pose"], rtol=0, atol=1e-4)
    # the epilogue on S's own state: as the plain conversions and reductions
    P = ekf.P
    assert torch.equal(pub["ego_pos"], ekf.pos) and torch.equal(pub["ego_t"], ekf.prev_timestamp)
    torch.testing.assert_close(pub["ego_rpy"], truntime.ego_pose(ekf)["rpy"], rtol=0,
                               atol=1e-6)
    assert torch.equal(pub["p_asym"], torch.max(torch.abs(P - P.T)))
    assert torch.equal(pub["p_min_diag"], torch.min(torch.diagonal(P)))
    for k in ("ego_pos", "ego_rpy", "ego_t", "p_asym", "p_min_diag"):
        scale = max(float(rpub[k].abs().max()), 1.0)
        assert float((pub[k] - rpub[k]).abs().max()) <= 1e-5 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_pcm_stage_is_kernel_l_then_i_on_card(cuda, name):
    """Kernel S is bit-equal to kernel L's measurement then kernel I's PCM
    update on the same inputs: the state record, every measurement field
    and ``applied``."""
    case = CASES[name]
    args = _port(_inputs(case), case, torch.float32, cuda)
    ekf, res, tf, ring, end, usable, params, flags, use_pcm = args
    state, out = _kernel_call(args)
    lm = kernels.pcm_measurement(res.pose, tf, res.local_cov, res.fitness, res.success,
                                 usable, ring, end, use_pcm)
    meas = GnssMeas(timestamp=lm[1], source=3, pos=lm[2], rot=lm[3], pos_cov=lm[4],
                    rot_cov=lm[5])
    chain = kernels.ekf_update(ekf, params, flags, pcm=(meas, lm[6]))
    torch.cuda.synchronize()
    assert torch.equal(state.intact_record(), chain.intact_record())
    for a, b in zip(out[:7], lm):
        assert torch.equal(a, b)
