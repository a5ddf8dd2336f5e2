"""The port's utilities (``elimaloc_tpu_torch.utils``) against the JAX
package's, on the inputs of JAX's tests/test_utils_cli.py.

* ``save_state`` / ``load_state``: a file saved by either package loads in
  the other (``EkfState`` and ``PipelineState``, float64 exact); a packed
  ``EkfState`` saves field by field; ``like``'s dtypes decide the load's.
* ``save_built_map`` / ``load_built_map`` across the packages.
* ``state_dashboard``'s text, ``scan_metrics``, the TUM / JSONL / PLY
  exports and the covariance markers (quaternions within 1e-12, float64)
  equal to JAX's; ``export_viz_html``'s page byte for byte JAX's.
* ``StageTimers``, ``device_trace`` and ``LiveViz``.
* ``debug_print`` on a CPU ``run``: one dashboard a simulated second, the
  first equal to JAX's ``state_dashboard`` of the converted state.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elimaloc_tpu import config as jconfig
from elimaloc_tpu import ekf as jekf
from elimaloc_tpu import utils as jutils
from elimaloc_tpu.map import build_voxel_map as j_build
from elimaloc_tpu.pipeline import rings as jrings
from elimaloc_tpu.pipeline import runtime as jruntime
from elimaloc_tpu.utils import viz as jviz
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import convert
from elimaloc_tpu_torch import ekf as tekf
from elimaloc_tpu_torch import utils as tutils
from elimaloc_tpu_torch.ekf.state import RecordState
from elimaloc_tpu_torch.map import TileQueryBudget as TBudget
from elimaloc_tpu_torch.pipeline import LocalizationPipeline as TPipeline
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import runtime as truntime
from elimaloc_tpu_torch.utils import viz as tviz
from torch_parity import flatten, one_torch_thread, tiny_cfg, tiny_world_and_log  # noqa: F401

RNG = np.random.default_rng(71)


def jax_ekf_state(port_state):
    return jekf.EkfState(**{k: jnp.asarray(v) for k, v in flatten(port_state).items()})


def _jax_pipeline_state(seed):
    """A JAX float64 PipelineState off its initial values: a moved filter
    state and rings with pushes."""
    params = jekf.make_params(jconfig.EkfConfig(), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    st = jekf.init_state(params, dtype=jnp.float64).replace(
        pos=jnp.asarray(rng.normal(size=3)), prev_timestamp=jnp.float64(12.5),
        state_initialized=jnp.asarray(True), pcm_update_count=jnp.int32(4),
        P=jnp.asarray(np.diag(rng.uniform(0.01, 4.0, 27))))
    ego, imu = jrings.make_ego_ring(16, jnp.float64), jrings.make_imu_ring(8, jnp.float64)
    for k in range(20):
        v = [jnp.asarray(rng.normal(size=3)) for _ in range(4)]
        ego = jrings.push_ego(ego, jnp.float64(0.01 * k), *v)
        imu = jrings.push_imu(imu, jnp.float64(0.01 * k), v[0], v[1])
    return jruntime.PipelineState(ekf=st, ego_ring=ego, imu_ring=imu)


def assert_same_record(port, ref):
    """Every field of a port record equal to the JAX (or port) record's."""
    got, want = flatten(port), flatten(ref)

    def walk(g, w, path):
        assert g.keys() == w.keys(), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}.{k}")
            else:
                a, b = np.asarray(g[k]), np.asarray(w[k])
                assert a.dtype == b.dtype and a.shape == b.shape, (path, k, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=f"{path}.{k}")

    walk(got, want, "")


@pytest.mark.parametrize("what", ["ekf", "pipeline"])
def test_save_state_files_load_across_packages(tmp_path, what):
    jstate = _jax_pipeline_state(3)
    if what == "ekf":
        jstate = jstate.ekf
        port = convert.ekf_state(flatten(jstate), dtype=torch.float64)
        like_j = jekf.init_state(jekf.make_params(jconfig.EkfConfig(), jnp.float64),
                                 dtype=jnp.float64)
        like_t = tekf.init_state(tekf.make_params(tconfig.EkfConfig(), torch.float64),
                                 dtype=torch.float64)
        assert isinstance(like_t, RecordState)   # packed: loaded field by field
    else:
        port = convert.pipeline_state(flatten(jstate), dtype=torch.float64)
        like_j = _jax_pipeline_state(4)
        like_t = convert.pipeline_state(flatten(like_j), dtype=torch.float64)
    # JAX's file into the port
    jutils.save_state(str(tmp_path / "jax.npz"), jstate)
    got = tutils.load_state(str(tmp_path / "jax.npz"), like_t)
    assert_same_record(got, port)
    # the port's file into JAX
    tutils.save_state(str(tmp_path / "port.npz"), port)
    back = jutils.load_state(str(tmp_path / "port.npz"), like_j)
    assert_same_record(convert.ekf_state(flatten(back), dtype=torch.float64) if what == "ekf"
                       else convert.pipeline_state(flatten(back), dtype=torch.float64), port)
    # the same leaves, the same order, as JAX writes them
    z, zj = np.load(str(tmp_path / "port.npz")), np.load(str(tmp_path / "jax.npz"))
    leaves = sorted(k for k in z.files if k.startswith("leaf_"))
    assert leaves == sorted(k for k in zj.files if k.startswith("leaf_"))
    for k in leaves:
        assert z[k].dtype == zj[k].dtype and np.array_equal(z[k], zj[k]), k


def test_load_state_takes_likes_dtypes_and_refuses_other_records(tmp_path):
    port64 = convert.pipeline_state(flatten(_jax_pipeline_state(5)), dtype=torch.float64)
    path = str(tmp_path / "s.npz")
    tutils.save_state(path, port64)
    like32 = convert.pipeline_state(flatten(_jax_pipeline_state(6)), dtype=torch.float32)
    got = tutils.load_state(path, like32)
    assert got.ekf.P.dtype == torch.float32 and got.ego_ring.count.dtype == torch.int32
    assert got.ekf.state_initialized.dtype == torch.bool
    assert torch.equal(got.ekf.pos, port64.ekf.pos.float())
    with pytest.raises(ValueError, match="arrays saved"):
        tutils.load_state(path, like32.ekf)
    # a packed state from the port's own filter round-trips as a plain EkfState
    st = tekf.init_state(tekf.make_params(tconfig.EkfConfig(), torch.float64), torch.float64)
    tutils.save_state(path, st)
    got = tutils.load_state(path, st)
    assert type(got) is tekf.EkfState
    assert_same_record(got, st)


def test_built_map_files_load_across_packages(tmp_path):
    pts = RNG.uniform(-10, 10, (2000, 3))
    built = j_build(pts, 1.0, 10, compute_voxel_cov=True, compute_point_cov=True,
                    use_native=False)
    tutils.save_built_map(str(tmp_path / "port.npz"), built)
    jutils.save_built_map(str(tmp_path / "jax.npz"), built)
    port_read = tutils.load_built_map(str(tmp_path / "jax.npz"))
    jax_read = jutils.load_built_map(str(tmp_path / "port.npz"))
    for f in dataclasses.fields(built):
        r = np.asarray(getattr(built, f.name))
        np.testing.assert_array_equal(np.asarray(getattr(port_read, f.name)), r, err_msg=f.name)
        np.testing.assert_array_equal(np.asarray(getattr(jax_read, f.name)), r, err_msg=f.name)
    plain = j_build(pts, 1.0, 10, use_native=False)
    tutils.save_built_map(str(tmp_path / "p2p.npz"), plain)
    assert tutils.load_built_map(str(tmp_path / "p2p.npz")).point_cov is None


def _dashboard_states():
    """JAX float64 states the dashboard prints differently: initial, GNSS
    stale and stabilized, PCM warm-up with a negative diagonal entry."""
    params = jekf.make_params(jconfig.EkfConfig(), dtype=jnp.float64)
    s0 = jekf.init_state(params, dtype=jnp.float64)
    P = np.diag(np.linspace(0.001, 3.0, 27))
    P[4, 4] = -1e-9
    s1 = s0.replace(prev_timestamp=jnp.float64(5.5), prev_gnss_timestamp=jnp.float64(1.0),
                    state_initialized=jnp.asarray(True), state_stabilized=jnp.asarray(True),
                    P=jnp.asarray(P))
    s2 = s1.replace(pcm_init_on_going=jnp.asarray(True), pcm_update_count=jnp.int32(7),
                    prev_gnss_timestamp=jnp.float64(5.0))
    return [s0, s1, s2]


def _ekf_cfgs(cfg_mod):
    a = cfg_mod.EkfConfig()
    b = cfg_mod.EkfConfig()
    b.use_gps, b.use_can, b.gps_type, b.use_pcm_matching = True, True, cfg_mod.GpsType(1), False
    return [None, a, b]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_state_dashboard_text_matches_jax(dtype):
    for js in _dashboard_states():
        ts = convert.ekf_state(flatten(js), dtype=dtype)
        ref_state = js if dtype == torch.float64 else jax_ekf_state(ts)
        for tc, jc in zip(_ekf_cfgs(tconfig), _ekf_cfgs(jconfig)):
            assert tutils.state_dashboard(ts, tc) == jutils.state_dashboard(ref_state, jc)


def _scan_out(rng, as_torch):
    pose = np.eye(4)
    pose[:3, 3] = rng.normal(size=3) * 50
    out = {"icp_pose": pose.astype(np.float32), "scan_end": np.float32(rng.uniform(0, 9)),
           "applied": np.bool_(rng.random() > 0.5), "icp_success": np.bool_(True),
           "deskew_ok": np.bool_(True), "pose_sync_ok": np.bool_(False),
           "fitness": np.float32(rng.uniform()), "overlap": np.float32(rng.uniform()),
           "iterations": np.int32(rng.integers(1, 10))}
    if as_torch:
        out = {k: torch.as_tensor(np.asarray(v)) for k, v in out.items()}
    return out


def test_metrics_and_file_exports_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    outs = [_scan_out(rng, False) for _ in range(5)]
    for o in outs:
        t_o = {k: torch.as_tensor(np.asarray(v)) for k, v in o.items()}
        assert tutils.scan_metrics(t_o) == jutils.scan_metrics(o) == tutils.scan_metrics(o)

    def same_file(name, port_fn, jax_fn):
        a, b = str(tmp_path / f"p_{name}"), str(tmp_path / f"j_{name}")
        port_fn(a)
        jax_fn(b)
        assert open(a, "rb").read() == open(b, "rb").read(), name

    same_file("m.jsonl", lambda p: tutils.export_metrics_jsonl(p, outs),
              lambda p: jutils.export_metrics_jsonl(p, outs))
    t = 1e6 + np.arange(6) * 0.1
    pos = rng.normal(size=(6, 3)) * 30
    q = rng.normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    same_file("t.tum", lambda p: tutils.export_trajectory_tum(p, t, pos, q),
              lambda p: jutils.export_trajectory_tum(p, t, pos, q))
    pts = rng.normal(size=(40, 3))
    pts[3] = np.inf
    pts[9, 1] = np.nan
    same_file("c.ply", lambda p: tutils.export_cloud_ply(p, torch.from_numpy(pts)),
              lambda p: jutils.export_cloud_ply(p, pts))
    assert "element vertex 38" in open(str(tmp_path / "p_c.ply")).read()


def _plane_covs(n, seed):
    from elimaloc_tpu.ops import lie as jlie

    rng = np.random.default_rng(seed)
    covs = []
    for _ in range(n):
        R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3))))
        covs.append(R @ np.diag(rng.uniform(0.2, 2.0, 3) * [1, 1, 1e-3]) @ R.T)
    return rng.normal(size=(n, 3)), np.stack(covs)


def test_cov_markers_match_jax(tmp_path):
    means, covs = _plane_covs(32, 4)
    covs = np.r_[covs, np.diag([4.0, 1.0, 0.25])[None]]
    means = np.r_[means, [[1.0, 2.0, 3.0]]]
    got, ref = tutils.cov_ellipsoid_markers(means, covs), jutils.cov_ellipsoid_markers(means,
                                                                                       covs)
    for k, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 if k == 1 else 0.0)
    np.testing.assert_allclose(np.linalg.norm(got[1], axis=1), 1.0, atol=1e-12)
    a, b = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    tutils.export_cov_markers_jsonl(a, means, covs)
    jutils.export_cov_markers_jsonl(b, means, covs)
    for x, y in zip(open(a), open(b)):
        x, y = json.loads(x), json.loads(y)
        assert {k: v for k, v in x.items() if k != "quat_wxyz"} == {
            k: v for k, v in y.items() if k != "quat_wxyz"}
        np.testing.assert_allclose(x["quat_wxyz"], y["quat_wxyz"], rtol=0, atol=1.1e-6)


def test_stage_timers_and_device_trace(tmp_path):
    t = tutils.StageTimers()
    x = torch.ones(4)
    with t.stage("a"):
        pass
    with t.stage("a", sync=x):
        x = x * 2
    with t.stage("b"):
        t.sync({"x": x, "nested": [x]})
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert set(t.totals) == {"a", "b"} and all(v >= 0 for v in t.totals.values())
    lines = t.report().splitlines()
    assert lines[0] == "stage                      total_ms    calls   ms/call"
    assert {ln.split()[0] for ln in lines[1:]} == {"a", "b"}
    off = tutils.StageTimers(enabled=False)
    with off.stage("a"):
        pass
    assert not off.counts
    t.reset()
    assert not t.counts and not t.totals
    with tutils.device_trace(None):
        pass
    with tutils.device_trace(str(tmp_path / "trace")):
        with t.stage("traced"):
            torch.ones(8).sum()
    trace = open(str(tmp_path / "trace" / "trace.json")).read()
    assert "traced" in trace


def test_viz_html_matches_jax_and_live_viz(tmp_path):
    rng = np.random.default_rng(2)
    est = np.cumsum(rng.normal(size=(30, 3)), axis=0)
    kw = dict(map_points=rng.normal(size=(70_000, 3)) * 40, truth_pos=est + 0.1,
              scans=[{"fitness": 0.1 * k, "iterations": k, "overlap": 0.9, "applied": True}
                     for k in range(30)], cov=rng.uniform(size=(30, 5)))
    a, b = str(tmp_path / "p.html"), str(tmp_path / "j.html")
    tviz.export_viz_html(a, est, **kw, live_refresh_s=0.5)
    jviz.export_viz_html(b, est, **kw, live_refresh_s=0.5)
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="empty estimated trajectory"):
        tviz.export_viz_html(a, np.zeros((0, 3)))

    path = tmp_path / "live.html"
    lv = tviz.LiveViz(str(path), refresh_s=0.0, map_points=kw["map_points"])
    for k in range(3):
        lv.on_scan({"ego_pos": np.array([float(k), 0.0, 0.0]), "ego_t": float(k),
                    "fitness": 0.1 * k, "iterations": k, "overlap": 0.9, "applied": True})
    html = path.read_text()
    assert 'http-equiv="refresh"' in html and len(lv.positions) == 3
    lv.finish()
    html = path.read_text()
    assert 'http-equiv="refresh"' not in html and "ICP fitness" in html


def test_debug_print_prints_jax_dashboard_once_a_simulated_second(monkeypatch, capsys):
    world, log = tiny_world_and_log(tlog, duration=2.6)
    cfg = tiny_cfg(tconfig)
    cfg.ekf.debug_print = True
    pipe = TPipeline(cfg, world, device="cpu", use_native=False,
                     tile_budget=TBudget(qb=8, max_slots=1024))
    shown = []
    real = truntime.state_dashboard

    def spy(state, ekf_cfg):
        shown.append(convert.ekf_state(flatten(state), dtype=torch.float32))
        return real(state, ekf_cfg)

    monkeypatch.setattr(truntime, "state_dashboard", spy)
    _, traj = pipe.run(log)
    text = capsys.readouterr().out
    assert len(shown) == text.count("State Std") >= 3
    times = [float(s.prev_timestamp) for s in shown]
    assert all(b - a >= 1.0 for a, b in zip(times, times[1:]))
    first = jutils.state_dashboard(jax_ekf_state(shown[0]), tiny_cfg(jconfig).ekf)
    assert text.startswith(first + "\n"), (text[:400], first)
    assert len(traj["pos"]) == len(log.scan_t)
