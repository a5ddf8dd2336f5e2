"""The scan's front, kernel T: ``runtime.scan_front_plain`` against the JAX
package, and kernel T against its plain version and against the chain it
replaced on the card.

On the CPU, the same seeded NumPy inputs (a scan's points, per-point times
and valid mask, its header stamp, the IMU and ego rings, the calibration)
go through JAX's scan front (runtime.py:299-338: ``stamp -
lidar_time_delay``, the range gate ``valid & (norm(points) <=
input_max_dist)``, deskew.normalize_scan_times, make_deskew_info,
deskew_points, rings.get_interpolated_pose, ``usable`` and the initial
guess compose(sync_pose, tf_ego_to_lidar)) and through the port's
``scan_front_plain``, in float64 and float32. Bounds: those of
tests/test_torch_rings_deskew.py, float64 atol 1e-12 (same formulas,
rounding-order ulps), float32 atol 1e-5 m (a few ulps at the ~60 m ranges
used); masks, indices and flags equal. The cases: no point valid after the
gate (first 0, last n - 1), the first points invalid, a point exactly at
``input_max_dist`` (kept: the gate is ``<=``), ``scan_time_end`` false,
``run_deskew`` false, ``bug_compat_z``, an empty ego ring and an empty IMU
ring, an IMU window longer than w (truncated: no full cover) and a scan end
past the last ego entry (the pose extrapolated).

On the card (``cuda`` marker; skipped without one): kernel T on the same
inputs in float32 against ``scan_front_plain`` (masks, indices and flags
equal, floats within 1e-4: the plain version's cumsum is a parallel scan,
its rotation table a matmul and its 4x4 products go through cuBLAS), and
bit for bit against the chain it replaced (the gate and the scan times in
torch, kernel K, then kernel D). JAX is imported only inside the JAX cases,
so the card cases also run on a GPU host without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_scan_front.py``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elimaloc_tpu_torch import deskew as tdeskew
from elimaloc_tpu_torch import kernels
from elimaloc_tpu_torch.ops import lie as tlie
from elimaloc_tpu_torch.pipeline import rings as trings
from elimaloc_tpu_torch.pipeline import runtime as truntime

DTYPES = {"f64": 1e-12, "f32": 1e-5}
EGO_CAP, EGO_T0 = 24, 0.9
STAMP, DELAY, MAX_DIST = 1.08, 0.002, 70.0
#: a point whose norm is exactly MAX_DIST in float32 and float64
AT_MAX = (20.0, 30.0, 60.0)


@dataclasses.dataclass
class Case:
    n: int = 400
    valid: str = "random"     # "random", "none", "first_invalid"
    at_max: bool = False      # point 7 at exactly MAX_DIST, valid
    scan_time_end: bool = True
    run_deskew: bool = True
    bug_compat_z: bool = False
    ego_count: int = 16       # ego ring rows (t = 0.90, 0.91, ...)
    imu_count: int = 30
    imu_hz: float = 200.0     # 1 kHz: more samples in the window than w = 64
    imu_cap: int = 32


CASES = {
    "nominal": Case(),
    "none_valid": Case(valid="none"),
    "first_invalid": Case(valid="first_invalid"),
    "at_max_dist": Case(at_max=True),
    "scan_time_start": Case(scan_time_end=False),
    "no_deskew": Case(run_deskew=False),
    "bug_compat_z": Case(bug_compat_z=True),
    "empty_rings": Case(ego_count=0, imu_count=0),
    "imu_truncated": Case(imu_hz=1000.0, imu_count=128, imu_cap=128),
    "extrapolated": Case(ego_count=10),
}


def _inputs(case: Case):
    """NumPy inputs of one scan's front: points out to 90 m around the
    sensor (some beyond MAX_DIST), raw times in the scan_time_end
    convention (-0.1..0 s) or the start one (0..0.1 s), the valid mask, the
    rings and the calibration."""
    rng = np.random.default_rng(31)
    n = case.n
    r = rng.uniform(2.0, 90.0, n)
    az = rng.uniform(-np.pi, np.pi, n)
    pts = np.c_[r * np.cos(az), r * np.sin(az), rng.normal(0, 1.0, n)]
    valid = rng.uniform(size=n) > 0.1
    if case.valid == "none":
        valid[:] = False
    elif case.valid == "first_invalid":
        valid[:5] = False
    if case.at_max:
        pts[7] = AT_MAX
        valid[7] = True
    times = np.sort(rng.uniform(-0.1, 0.0, n)) + (0.0 if case.scan_time_end else 0.1)

    t = EGO_T0 + 0.01 * np.arange(EGO_CAP)
    ego = {"t": t, "pos": np.c_[60 + 8.0 * (t - EGO_T0), 0.5 * (t - EGO_T0), np.zeros(EGO_CAP)],
           "rpy": np.c_[rng.normal(0, 0.01, EGO_CAP), rng.normal(0, 0.01, EGO_CAP),
                        1.5 + 0.1 * (t - EGO_T0)],
           "vel_local": np.c_[np.full(EGO_CAP, 8.0), rng.normal(0, 0.1, EGO_CAP),
                              np.zeros(EGO_CAP)],
           "gyro": np.c_[np.zeros((EGO_CAP, 2)), np.full(EGO_CAP, 0.1)],
           "count": np.array(case.ego_count, np.int32)}
    m = case.imu_cap
    imu = {"t": 0.96 + np.arange(m) / case.imu_hz,
           "gyro": np.c_[rng.normal(0, 0.02, (m, 2)), 0.3 + rng.normal(0, 0.02, m)],
           "acc": rng.normal(0, 0.1, (m, 3)), "count": np.array(case.imu_count, np.int32)}
    tf = np.eye(4)
    tf[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    tf[:3, 3] = [1.0, 0.2, 1.5]
    return {"points": pts, "times": times, "valid": valid, "ego": ego, "imu": imu, "tf": tf}


def _port(inp, case: Case, dtype, device="cpu"):
    """``scan_front_plain``'s arguments: (state, stamp, points, times, valid,
    params, static), the state, params and static as the fields it reads."""
    def t(a):
        a = np.asarray(a)
        kw = {"dtype": dtype} if a.dtype.kind == "f" else {}
        return torch.as_tensor(a, device=device, **kw)

    state = SimpleNamespace(imu_ring=trings.ImuRing(**{k: t(v) for k, v in inp["imu"].items()}),
                            ego_ring=trings.EgoRing(**{k: t(v) for k, v in inp["ego"].items()}))
    pp = SimpleNamespace(lidar_time_delay=t(DELAY), input_max_dist=t(MAX_DIST),
                         tf_ego_to_lidar=t(inp["tf"]))
    ps = SimpleNamespace(scan_time_end=case.scan_time_end, run_deskew=case.run_deskew,
                         bug_compat_deskew_z=case.bug_compat_z)
    return (state, t(STAMP), t(inp["points"]), t(inp["times"]), t(inp["valid"]), pp, ps)


def _jax_front(inp, case: Case, jdt):
    """JAX's scan front on the same inputs (runtime.py:299-338), as a dict of
    the port's ``ScanFront`` fields, the deskew info flattened."""
    import jax.numpy as jnp

    from elimaloc_tpu import deskew as jdeskew
    from elimaloc_tpu.ops import lie as jlie
    from elimaloc_tpu.pipeline import rings as jrings

    def j(a):
        a = np.asarray(a)
        return jnp.asarray(a, jdt if a.dtype.kind == "f" else None)

    ego = jrings.EgoRing(**{k: j(v) for k, v in inp["ego"].items()})
    imu = jrings.ImuRing(**{k: j(v) for k, v in inp["imu"].items()})
    points = j(inp["points"])
    stamp = j(STAMP) - j(DELAY)
    valid = j(inp["valid"]) & (jnp.linalg.norm(points, axis=1) <= j(MAX_DIST))
    rel, cur, end = jdeskew.normalize_scan_times(j(inp["times"]), valid, stamp,
                                                 case.scan_time_end)
    info = jdeskew.make_deskew_info(imu.t, imu.gyro, imu.valid_mask(), ego.t, ego.pos, ego.rpy,
                                    ego.vel_local, ego.gyro, ego.valid_mask(), cur, end)
    pts_d, desk_ok = jdeskew.deskew_points(points, rel, valid, info,
                                           run_deskew=case.run_deskew,
                                           bug_compat_z=case.bug_compat_z)
    usable = desk_ok if case.run_deskew else jnp.asarray(True)
    sync_pose, found = jrings.get_interpolated_pose(ego, end)
    usable = usable & found & (ego.count > 0)
    out = {"valid": valid, "points": pts_d, "scan_cur": cur, "scan_end": end,
           "init_guess": jlie.compose(sync_pose, j(inp["tf"])), "found": found,
           "usable": usable, "deskew_ok": desk_ok}
    out.update({f"info.{f.name}": getattr(info, f.name) for f in dataclasses.fields(info)})
    return out


def _fields(front):
    out = {f.name: getattr(front, f.name) for f in dataclasses.fields(front) if f.name != "info"}
    out.update({f"info.{f.name}": getattr(front.info, f.name)
                for f in dataclasses.fields(front.info)})
    return out


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_scan_front_plain_matches_jax(dt_name, name):
    import jax.numpy as jnp

    case = CASES[name]
    atol = DTYPES[dt_name]
    tdt, jdt = ((torch.float64, jnp.float64) if dt_name == "f64"
                else (torch.float32, jnp.float32))
    inp = _inputs(case)
    got = _fields(truntime.scan_front_plain(*_port(inp, case, tdt)))
    want = _jax_front(inp, case, jdt)
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)

    valid = got["valid"].numpy()
    first = int(np.argmax(valid)) if valid.any() else 0
    if name == "none_valid":
        assert not valid.any()
    if name == "first_invalid":
        assert first >= 5
    if name == "at_max_dist":
        assert valid[7]
    # the scan's times: the first (last) valid point's time, 0 (n - 1) if none
    if case.scan_time_end:
        assert float(got["scan_end"]) == pytest.approx(STAMP - DELAY, abs=1e-6)
        assert float(got["scan_cur"] - got["scan_end"]) == pytest.approx(
            inp["times"][first], abs=1e-6)
    else:
        assert float(got["scan_cur"]) == pytest.approx(STAMP - DELAY, abs=1e-6)
    pts = got["points"].numpy()
    if not case.run_deskew:
        np.testing.assert_array_equal(pts, inp["points"].astype(pts.dtype))
    else:
        # the invalid points pass through; the valid ones move (those near
        # the scan's end barely), unless the deskew info is unavailable
        np.testing.assert_array_equal(pts[~valid], inp["points"][~valid].astype(pts.dtype))
        moved = np.abs(pts - inp["points"]).max(axis=1) > 1e-3
        assert moved.any() == (name not in ("empty_rings", "none_valid"))
    assert bool(got["usable"]) == (name != "empty_rings")
    assert bool(got["info.imu_covers_start"]) == (name not in ("empty_rings", "imu_truncated"))
    if name == "extrapolated":
        # an entry before the scan's end, none after it: the pose extrapolated
        assert bool(got["found"])
        assert inp["ego"]["t"][case.ego_count - 1] < float(got["scan_end"])


def test_scan_front_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    """On CPU tensors ``runtime.scan_front`` is ``scan_front_plain``: no
    library, no launch."""
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_library)
    case = CASES["nominal"]
    args = _port(_inputs(case), case, torch.float32)
    kernels.reset_launches()
    got = _fields(truntime.scan_front(*args))
    ref = _fields(truntime.scan_front_plain(*args))
    assert all(v == 0 for v in kernels.launches.values())
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_scan_front_constants_match_the_source():
    """The wrapper's copies of kernel T's flag bits and of the float scalars
    after kernel K's outputs are csrc/scan_front.cu's, and K's output layout
    (scan_ring.cuh) is the one the wrapper splits."""
    import re

    from elimaloc_tpu_torch.kernels import build

    src = (build.SRC_DIR / "scan_front.cu").read_text()
    bits = re.search(r"constexpr int kScanTimeEnd = (\d+), kRunDeskew = (\d+), "
                     r"kBugCompatZ = (\d+);", src).groups()
    assert tuple(map(int, bits)) == (kernels._SCAN_TIME_END, kernels._RUN_DESKEW,
                                     kernels._BUG_COMPAT_Z)
    assert re.search(r"constexpr int kFrontScalars = (\d+);", src).group(1) == \
        str(kernels.FRONT_SCALARS)
    ring = (build.SRC_DIR / "scan_ring.cuh").read_text()
    assert "constexpr int query_floats(int w) { return 4 * w + 19; }" in ring
    assert re.search(r"constexpr int kQueryFlags = (\d+);", ring).group(1) == "5"


def test_scan_front_wrapper_refuses_cpu_tensors():
    case = CASES["nominal"]
    st, stamp, points, times, valid, pp, ps = _port(_inputs(case), case, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor required"):
        kernels.scan_front(points, times, valid, stamp, pp.lidar_time_delay,
                           pp.input_max_dist, st.imu_ring, st.ego_ring, pp.tf_ego_to_lidar,
                           ps.scan_time_end, ps.run_deskew, ps.bug_compat_deskew_z)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda")


def _chain(state, stamp, points, times, valid, pp, ps):
    """The launches kernel T replaced, on the same inputs: the delayed stamp,
    the gate and the scan times in torch, kernel K, then kernel D."""
    stamp = stamp - pp.lidar_time_delay
    valid = valid & (tlie.norm(points) <= pp.input_max_dist)
    rel, cur, end = tdeskew.normalize_scan_times(times, valid, stamp, ps.scan_time_end)
    info, guess, found, usable = tdeskew.scan_ring_query(
        state.imu_ring, state.ego_ring, cur, end, pp.tf_ego_to_lidar, run_deskew=ps.run_deskew)
    pts, ok = tdeskew.deskew_points(points, rel, valid, info, run_deskew=ps.run_deskew,
                                    bug_compat_z=ps.bug_compat_deskew_z)
    return truntime.ScanFront(valid=valid, points=pts, scan_cur=cur, scan_end=end,
                              init_guess=guess, found=found, usable=usable, deskew_ok=ok,
                              info=info)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_front_matches_plain_on_card(cuda, name):
    case = CASES[name]
    args = _port(_inputs(case), case, torch.float32, cuda)
    kernels.reset_launches()
    got = _fields(truntime.scan_front(*args))
    torch.cuda.synchronize()
    assert kernels.launches["scan_front"] == 1
    assert sum(kernels.launches.values()) == 1, kernels.launches
    ref = _fields(truntime.scan_front_plain(*args))
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if v.dtype == torch.float32:
            assert float((got[k] - v).abs().max()) <= 1e-4, k
        else:
            assert torch.equal(got[k], v), k
    if not case.run_deskew:
        assert got["points"] is args[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_front_is_the_chain_on_card(cuda, name):
    """Kernel T is bit-equal to the gate and scan times in torch, then kernel
    K, then kernel D, on the same inputs; its workspace is clean after each
    call, so a second call gives the same bits."""
    case = CASES[name]
    args = _port(_inputs(case), case, torch.float32, cuda)
    for _ in range(2):
        got = _fields(truntime.scan_front(*args))
        ref = _fields(_chain(*args))
        torch.cuda.synchronize()
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
