"""``python -m elimaloc_tpu_torch.cli`` against ``elimaloc_tpu.cli``, on
tests/test_utils_cli.py's sizes, the replays with ``--device cpu``.

* ``synth`` and ``build-map`` write npz files bit for bit JAX's CLI's;
  ``bag-import`` the replay log JAX's writes from the same bag.
* ``replay``'s configuration and pipeline arguments equal JAX's CLI's;
  ``replay --fused --traj``: the TUM file equal, line for line, to the one
  written from ``run_fused`` on ``cli.replay_pipeline``'s; the event loop with
  ``--metrics --viz --viz-live --traj`` writes complete files.
* A ``.pcd`` map whose filename carries the geodetic origin sets it;
  ``--site`` with an explicit ``--map`` applies the preset; the argument
  errors (``--ref-lat`` alone, ``--viz-live`` with ``--fused``, a site
  whose map is absent) raise ``SystemExit`` as JAX's do.
"""

import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

from elimaloc_tpu import cli as jcli
from elimaloc_tpu_torch import cli as tcli
from elimaloc_tpu_torch import pipeline as tpipeline
from elimaloc_tpu_torch.map import write_pcd
from elimaloc_tpu_torch.ops import lie
from elimaloc_tpu_torch.pipeline import ReplayLog
from elimaloc_tpu_torch.utils import export_trajectory_tum, load_built_map
from test_rosbag import (CAN, CONNS, GPS, IMU, SCAN, _bag, _chunk, _connection, _enc_imu,
                         _enc_navsatfix, _enc_pointcloud2, _enc_twist_stamped, _message)
from torch_parity import one_torch_thread  # noqa: F401

SYNTH = ["--duration", "1.5", "--points", "512", "--seed", "2"]
REPLAY = ["--ds-points", "512", "--max-slots", "512", "--device", "cpu"]


def same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes(), k


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """JAX's and the port's ``synth`` outputs, and a GICP map of the world
    thinned 1/60 built by the port's ``build-map``."""
    d = tmp_path_factory.mktemp("cli")
    for cli, tag in ((jcli, "jax"), (tcli, "port")):
        cli.main(["synth", "--out", str(d / f"{tag}.npz"), "--map-out", str(d / f"{tag}_w"),
                  *SYNTH])
    world = np.load(str(d / "port_w.npy"))
    np.save(str(d / "thin.npy"), world[::60])
    tcli.main(["build-map", "--points", str(d / "thin.npy"), "--out", str(d / "map.npz"),
               "--icp-method", "1"])
    return d


def test_synth_writes_jax_files(drive, capsys):
    same_npz(str(drive / "jax.npz"), str(drive / "port.npz"))
    assert np.load(str(drive / "jax_w.npy")).tobytes() == np.load(
        str(drive / "port_w.npy")).tobytes()


@pytest.mark.parametrize("method", ["0", "1", "2"])
def test_build_map_writes_jax_files(tmp_path, capsys, method):
    pts = str(tmp_path / "pts.npy")
    np.save(pts, np.random.default_rng(71).uniform(-10, 10, (3000, 3)))
    out = []
    for cli, tag in ((jcli, "jax"), (tcli, "port")):
        cli.main(["build-map", "--points", pts, "--out", str(tmp_path / f"{tag}.npz"),
                  "--icp-method", method])
        out.append(capsys.readouterr().out.split(" in ")[0])
    same_npz(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"))
    assert out[0] == out[1] and load_built_map(str(tmp_path / "port.npz")).num_voxels > 100


def _bag_file(path, log):
    """A bag of the log's IMU samples and scans, two fixes and two CAN
    samples (tests/test_rosbag.py's wire format)."""
    t0 = float(log.imu_t[0])
    inner = b"".join(_connection(cid, topic, mtype) for topic, (cid, mtype) in CONNS.items())
    events = [(t, _message(CONNS[IMU][0], t, _enc_imu(t, (0, 0, 0, 1), gyro, acc)))
              for t, acc, gyro in zip(log.imu_t, log.imu_acc, log.imu_gyro)]
    for i, t in enumerate(log.scan_t):
        v = log.scan_valid[i]
        events.append((t, _message(CONNS[SCAN][0], t, _enc_pointcloud2(
            t, log.scan_points[i][v], log.scan_times[i][v]))))
    events += [(t0 + 0.1, _message(CONNS[GPS][0], t0 + 0.1, _enc_navsatfix(
                   t0 + 0.1, 37.3, 127.0, 40.0, (2.0, 2.5, 9.0)))),
               (t0 + 0.6, _message(CONNS[GPS][0], t0 + 0.6, _enc_navsatfix(
                   t0 + 0.6, 37.3005, 127.0004, 41.0, (1.0, 1.0, 4.0)))),
               (t0 + 0.2, _message(CONNS[CAN][0], t0 + 0.2, _enc_twist_stamped(t0 + 0.2, 5.0,
                                                                                0.1)))]
    events.sort(key=lambda e: e[0])
    inner += b"".join(r for _, r in events)
    path.write_bytes(_bag([_chunk(inner, "bz2")]))


@pytest.mark.parametrize("extra", [[], ["--ref-lat", "37.3", "--ref-lon", "127.0",
                                        "--projection-mode", "UTM"]])
def test_bag_import_writes_jax_log(drive, tmp_path, capsys, extra):
    log = ReplayLog.load(str(drive / "port.npz"))
    bag = tmp_path / "d.bag"
    _bag_file(bag, log)
    printed = []
    for cli, tag in ((jcli, "jax"), (tcli, "port")):
        cli.main(["bag-import", "--bag", str(bag), "--out", str(tmp_path / f"{tag}.npz"),
                  "--scan-topic", SCAN, "--imu-topic", IMU, "--gps-topic", GPS,
                  "--can-topic", CAN, *extra])
        printed.append(capsys.readouterr().out.replace(str(tmp_path / f"{tag}.npz"), "OUT"))
    same_npz(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"))
    assert printed[0] == printed[1] and "+gps/can" in printed[1]


def test_ref_lat_without_ref_lon_exits_as_jax(tmp_path):
    args = ["bag-import", "--bag", str(tmp_path / "none.bag"), "--scan-topic", SCAN,
            "--imu-topic", IMU, "--ref-lat", "37.3"]
    msgs = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            cli.main(args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "--ref-lon" in msgs[1]


def test_replay_fused_writes_run_fuseds_trajectory(drive, tmp_path, capsys):
    tum = str(tmp_path / "cli.tum")
    tcli.main(["replay", "--log", str(drive / "port.npz"), "--map", str(drive / "map.npz"),
               "--fused", "--traj", tum, *REPLAY])
    out = capsys.readouterr().out
    assert "fused replay: 13 scans" in out and "ATE RMSE" in out and "State Std" in out
    log = ReplayLog.load(str(drive / "port.npz"))
    args = tcli.parser().parse_args(["replay", "--log", str(drive / "port.npz"), "--map",
                                     str(drive / "map.npz"), *REPLAY])
    pipe = tcli.replay_pipeline(args, log, load_built_map(str(drive / "map.npz")))
    _, outs = pipe.run_fused(log)
    quats = lie.rot_to_quat(lie.euler_to_rot(torch.as_tensor(outs["ego_rpy"]))).numpy()
    ref = str(tmp_path / "ref.tum")
    export_trajectory_tum(ref, outs["ego_t_abs"], outs["ego_pos"], quats)
    lines = open(tum).read().splitlines()
    assert lines == open(ref).read().splitlines() and len(lines) == len(log.scan_t)


def test_replay_event_loop_writes_every_file(drive, tmp_path, capsys):
    p = {k: str(tmp_path / v) for k, v in (("traj", "t.tum"), ("metrics", "m.jsonl"),
                                           ("viz", "v.html"), ("viz_live", "live.html"))}
    tcli.main(["replay", "--log", str(drive / "port.npz"), "--map", str(drive / "map.npz"),
               "--traj", p["traj"], "--metrics", p["metrics"], "--viz", p["viz"],
               "--viz-live", p["viz_live"], *REPLAY])
    out = capsys.readouterr().out
    assert "replay: 13 scans" in out and "live view" in out
    assert len(open(p["metrics"]).read().splitlines()) == 13
    tum = np.loadtxt(p["traj"], ndmin=2)
    assert tum.shape == (13, 8) and np.isfinite(tum).all()
    for k in ("viz", "viz_live"):
        html = open(p[k]).read()
        assert "ICP fitness" in html and 'http-equiv="refresh"' not in html


class Stop(Exception):
    pass


def _spy(monkeypatch, pkg):
    """The (configuration, map, keywords) ``replay`` of the CLI over ``pkg``
    builds its pipeline with; the replay itself is stopped there."""
    seen = []

    def spy(cfg, map_obj, **kw):
        seen.append((cfg, map_obj, kw))
        raise Stop

    monkeypatch.setattr(pkg, "LocalizationPipeline", spy)
    return seen


@pytest.fixture
def seen_cfg(monkeypatch):
    return _spy(monkeypatch, tpipeline), Stop


def _plain(v):
    """A configuration as nested plain values (enums by value, tuples as
    lists), so JAX's and the port's compare."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("extra", [[], ["--site", "pangyo"], ["pcd"]])
def test_replay_builds_jax_clis_configuration(drive, tmp_path, monkeypatch, extra):
    """``replay`` (through ``cli.replay_pipeline``) hands the pipeline the
    configuration, map and budgets JAX's CLI hands its own: a synthetic log,
    with a site preset, and a .pcd map whose filename carries the origin."""
    from elimaloc_tpu import pipeline as jpipeline

    map_path = str(drive / "map.npz")
    if extra == ["pcd"]:
        map_path, extra = str(tmp_path / "37.558200_127.044500_66.000000_x.pcd"), []
        write_pcd(map_path, np.load(str(drive / "thin.npy")))
    args = ["replay", "--log", str(drive / "port.npz"), "--map", map_path, "--ds-points",
            "512", "--max-slots", "512", *extra]
    seen = {}
    for cli, pkg, dev in ((jcli, jpipeline, []), (tcli, tpipeline, ["--device", "cpu"])):
        got = _spy(monkeypatch, pkg)
        with pytest.raises(Stop):
            cli.main(args + dev)
        seen[cli] = got[0]
    (jcfg, jmap, jkw), (cfg, map_obj, kw) = seen[jcli], seen[tcli]
    assert _plain(cfg) == _plain(jcfg)
    assert kw.pop("device") == "cpu" and kw["ds_points"] == jkw["ds_points"] == 512
    budget = {k: (getattr(kw["tile_budget"], k), getattr(jkw["tile_budget"], k))
              for k in ("qb", "max_slots")}
    assert budget == {"qb": (32, 32), "max_slots": (512, 512)}
    assert type(map_obj).__name__ == type(jmap).__name__


def test_pcd_map_filename_sets_the_origin(drive, tmp_path, seen_cfg):
    seen, stop = seen_cfg
    world = np.load(str(drive / "thin.npy"))
    path = str(tmp_path / "37.558200_127.044500_66.000000_hanyang_02m.pcd")
    write_pcd(path, world)
    with pytest.raises(stop):
        tcli.main(["replay", "--log", str(drive / "port.npz"), "--map", path, *REPLAY])
    cfg, map_obj, kw = seen[0]
    assert (cfg.ekf.ref_latitude, cfg.ekf.ref_longitude, cfg.ekf.ref_height) == (
        37.5582, 127.0445, 66.0)
    assert np.array_equal(map_obj, world.astype(np.float32).astype(np.float64))
    assert kw["device"] == "cpu" and kw["ds_points"] == 512


def test_site_with_an_explicit_map(drive, seen_cfg):
    seen, stop = seen_cfg
    with pytest.raises(stop):
        tcli.main(["replay", "--log", str(drive / "port.npz"), "--map",
                   str(drive / "map.npz"), "--site", "pangyo", *REPLAY])
    cfg = seen[0][0]
    assert (cfg.ekf.ref_latitude, cfg.ekf.ref_longitude, cfg.ekf.ref_height) == (
        37.394776, 127.111158, 40.0)


@pytest.mark.parametrize("case", ["site_map_absent", "viz_live_fused", "no_map"])
def test_replay_argument_errors_exit_as_jax(drive, tmp_path, case, monkeypatch):
    monkeypatch.chdir(tmp_path)   # no preset map under resources/ here
    args = ["replay", "--log", str(drive / "port.npz")]
    args += {"site_map_absent": ["--site", "kcity"],
             "viz_live_fused": ["--map", str(drive / "map.npz"), "--fused", "--viz-live",
                                "x.html"],
             "no_map": []}[case]
    msgs = []
    for cli, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            cli.main(args + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and not os.path.exists("x.html")
