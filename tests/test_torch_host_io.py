"""The port's host I/O against the JAX package's, on the inputs of JAX's
tests/test_pcd.py, test_rosbag.py and test_pointcloud.py (their byte
builders imported; those tests are not edited).

* ``map.pcd``: ``write_pcd`` writes the bytes JAX's writes (ascii,
  binary); ``read_pcd`` / ``read_pcd_points`` read ascii, binary (extra
  fields) and binary_compressed (LZF, the pure-Python decoder and the
  native one) as JAX's do; ``parse_origin_from_filename``.
* ``map.native_builder``: ``lzf_decompress`` and ``insert_points`` bound on
  a library compiled from native/src/voxel_builder.cpp.
* ``pipeline.lz4f``, ``pipeline.pointcloud``: equal to JAX's outputs.
* ``pipeline.rosbag``: ``read_bag`` and ``bag_to_replay_log`` on bags with
  none / bz2 / lz4 chunks, GPS and CAN, Cartesian and UTM projections:
  every array bit for bit JAX's.
* ``sites``: every preset, ``apply_site`` equal to JAX's.
"""

import dataclasses
import shutil
import struct
import subprocess

import numpy as np
import pytest

from elimaloc_tpu import config as jconfig
from elimaloc_tpu import sites as jsites
from elimaloc_tpu.map import pcd as jpcd
from elimaloc_tpu.map.builder import _insert_points_numpy
from elimaloc_tpu.pipeline import lz4f as jlz4f
from elimaloc_tpu.pipeline import pointcloud as jpc
from elimaloc_tpu.pipeline import rosbag as jrosbag
from elimaloc_tpu_torch import config as tconfig
from elimaloc_tpu_torch import sites as tsites
from elimaloc_tpu_torch.map import native_builder as tnative
from elimaloc_tpu_torch.map import pcd as tpcd
from elimaloc_tpu_torch.pipeline import log as tlog
from elimaloc_tpu_torch.pipeline import lz4f as tlz4f
from elimaloc_tpu_torch.pipeline import pointcloud as tpc
from elimaloc_tpu_torch.pipeline import rosbag as trosbag
from test_pcd import _cloud, _lzf_compress_literal
from test_pointcloud import _pack_ouster, _pack_velodyne
from test_rosbag import (CAN, CONNS, GPS, IMU, SCAN, _bag, _chunk, _connection, _enc_imu,
                         _enc_navsatfix, _enc_pointcloud2, _enc_twist_stamped, _fields,
                         _lz4_frame, _lz4_literal_block, _message, _record)
from torch_parity import one_torch_thread  # noqa: F401


def same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def same_fields(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k in ref:
        same(got[k], ref[k], k)


# ---- PCD -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ascii", "binary"])
def test_write_pcd_bytes_and_reads_match_jax(tmp_path, mode):
    pts = _cloud()
    pts[7] = np.nan
    a, b = str(tmp_path / "port.pcd"), str(tmp_path / "jax.pcd")
    tpcd.write_pcd(a, pts, mode=mode)
    jpcd.write_pcd(b, pts, mode=mode)
    assert open(a, "rb").read() == open(b, "rb").read()
    same_fields(tpcd.read_pcd(a), jpcd.read_pcd(b))
    same(tpcd.read_pcd_points(a), jpcd.read_pcd_points(b))
    assert len(tpcd.read_pcd_points(a)) == len(pts) - 1
    with pytest.raises(ValueError, match="unsupported write mode"):
        tpcd.write_pcd(a, pts, mode="binary_compressed")


def _compressed_pcd(path, pts, extra=None):
    """binary_compressed (fields SoA), as tests/test_pcd.py builds it; with
    ``extra`` an intensity field after z."""
    cols = [pts.T.astype(np.float32)] + ([extra[None].astype(np.float32)] if extra is not None
                                         else [])
    raw = np.concatenate(cols).tobytes()
    comp = _lzf_compress_literal(raw)
    names = "x y z" + (" intensity" if extra is not None else "")
    k = len(names.split())
    hdr = (f"VERSION 0.7\nFIELDS {names}\nSIZE {' '.join(['4'] * k)}\n"
           f"TYPE {' '.join(['F'] * k)}\nCOUNT {' '.join(['1'] * k)}\nWIDTH {len(pts)}\n"
           f"HEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(pts)}\nDATA binary_compressed\n")
    with open(path, "wb") as fh:
        fh.write(hdr.encode())
        fh.write(np.array([len(comp), len(raw)], np.uint32).tobytes())
        fh.write(comp)


@pytest.mark.parametrize("extra", [False, True])
def test_read_binary_compressed_matches_jax(tmp_path, monkeypatch, extra):
    pts = _cloud(64, seed=5)
    inten = np.random.default_rng(2).normal(size=64) if extra else None
    path = str(tmp_path / "c.pcd")
    _compressed_pcd(path, pts, inten)
    ref = jpcd.read_pcd(path)
    same_fields(tpcd.read_pcd(path), ref)
    same(tpcd.read_pcd_points(path), jpcd.read_pcd_points(path))
    # the pure-Python LZF of the port, as the JAX reader's falls back to it
    monkeypatch.setattr(tnative, "maybe_load", lambda: None)
    same_fields(tpcd.read_pcd(path), ref)


def test_read_ascii_with_comments_and_extra_fields_matches_jax(tmp_path):
    path = str(tmp_path / "a.pcd")
    body = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
            "WIDTH 3\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 3\n"
            "DATA ascii\n1.0 2.0 3.0 7\n-4.5 0.25 9.0 8\nnan 1 2 9\n")
    with open(path, "wb") as fh:
        fh.write(body.encode())
    same_fields(tpcd.read_pcd(path), jpcd.read_pcd(path))
    same(tpcd.read_pcd_points(path), jpcd.read_pcd_points(path))


@pytest.mark.parametrize("stream,n", [
    (bytes([2]) + b"abc" + bytes([(4 << 5), 2]), 9),
    (bytes([2]) + b"xyz" + bytes([(7 << 5), 200, 2]), 3 + 7 + 200 + 2),
    (_lzf_compress_literal(bytes(range(256)) * 3), 768),
])
def test_lzf_python_decoder_matches_jax(monkeypatch, stream, n):
    monkeypatch.setattr(tnative, "maybe_load", lambda: None)
    assert tpcd._lzf_decompress(stream, n) == jpcd._lzf_decompress(stream, n)
    with pytest.raises(ValueError, match="size mismatch"):
        tpcd._lzf_decompress(stream, n + 1)


def test_parse_origin_from_filename_matches_jax():
    for name in ("/maps/37.558200_127.044500_66.000000_hanyang_02m.pcd",
                 "-12.500000_-77.100000_0.000000_lima.pcd", "hanyang_map.pcd", "plain.npy",
                 "37_127_0_x.pcd"):
        assert tpcd.parse_origin_from_filename(name) == jpcd.parse_origin_from_filename(name)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The map builder's native library compiled from native/src (the
    LZF decoder and the two-phase build; no scan step)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile native/src/voxel_builder.cpp")
    so = tmp_path_factory.mktemp("native") / "libelimaloc_native.so"
    subprocess.run([gxx, "-O1", "-fPIC", "-std=c++17", "-shared", "-o", str(so),
                    "native/src/voxel_builder.cpp"], check=True, timeout=300)
    return tnative._NativeBuilder(str(so))


def test_native_lzf_and_insert_points_bindings(native_lib):
    raw = np.random.default_rng(1).integers(0, 7, size=5000, dtype=np.uint8).tobytes()
    stream = _lzf_compress_literal(raw)
    assert native_lib._has_lzf
    assert native_lib.lzf_decompress(stream, len(raw)) == raw
    assert native_lib.lzf_decompress(stream, len(raw) + 1) is None
    # the PCD reader takes the native decoder when the library loads
    rng = np.random.default_rng(5)
    pts = rng.uniform(-20, 20, size=(20000, 3))
    vc, blk, cnt = native_lib.insert_points(pts, 1.0, 10)
    vc_p, blk_p, cnt_p = _insert_points_numpy(pts, 1.0, 10)

    def canon(v, b, c):
        order = np.lexsort((v[:, 2], v[:, 1], v[:, 0]))
        return v[order], b[order], c[order]

    vc, blk, cnt = canon(vc, blk, cnt)
    vc_p, blk_p, cnt_p = canon(vc_p, blk_p, cnt_p)
    np.testing.assert_array_equal(vc, vc_p)
    np.testing.assert_array_equal(cnt, cnt_p)
    mask = np.arange(10)[None, :] < cnt[:, None]
    np.testing.assert_allclose(blk[mask], blk_p[mask].astype(np.float32), rtol=0, atol=0)
    assert np.isinf(blk[~mask]).all()


def test_pcd_reader_uses_the_native_lzf(tmp_path, monkeypatch, native_lib):
    pts = _cloud(40, seed=8)
    path = str(tmp_path / "n.pcd")
    _compressed_pcd(path, pts)
    calls = []
    orig = native_lib.lzf_decompress

    def counted(src, n):
        calls.append(n)
        return orig(src, n)

    monkeypatch.setattr(native_lib, "lzf_decompress", counted)
    monkeypatch.setattr(tnative, "maybe_load", lambda: native_lib)
    same(tpcd.read_pcd_points(path), jpcd.read_pcd_points(path))
    assert calls == [40 * 12]


# ---- LZ4 frames and the PointCloud2 decoders ----------------------------------

LZ4_FRAMES = {
    "raw_and_compressed": _lz4_frame([(True, b"RAWBYTES"),
                                      (False, bytes([0x35]) + b"abc" + struct.pack("<H", 3))]),
    "cross_block_match": _lz4_frame([(False, _lz4_literal_block(b"abcdef")),
                                     (False, bytes([0x08]) + struct.pack("<H", 6)
                                      + _lz4_literal_block(b""))]),
    "checksums_content_size": _lz4_frame([(True, b"payload")], flg_extra=0x10 | 0x04,
                                         content_size=7),
    "long_literals_rle": _lz4_frame([(False, _lz4_literal_block(bytes(range(256)) * 2)),
                                     (False, bytes([0x1F]) + b"x" + struct.pack("<H", 1)
                                      + bytes([0]))]),
}


@pytest.mark.parametrize("name", sorted(LZ4_FRAMES))
def test_lz4_frames_match_jax(name):
    data = LZ4_FRAMES[name]
    assert tlz4f.frame_decompress(data) == jlz4f.frame_decompress(data)


def test_lz4_errors_match_jax():
    for fn in (tlz4f.frame_decompress, jlz4f.frame_decompress):
        with pytest.raises(ValueError, match="magic"):
            fn(b"\x00\x00\x00\x00rest")
    bad = bytes([0x10]) + b"a" + struct.pack("<H", 0)     # zero match offset
    for fn in (tlz4f.block_decompress, jlz4f.block_decompress):
        with pytest.raises(ValueError, match="zero match offset"):
            fn(bad, bytearray())


@pytest.mark.parametrize("n,stride", [(37, 1), (37, 3), (36, 3), (200, 8)])
def test_pointcloud_decoders_match_jax(n, stride):
    rec, buf = _pack_ouster(n)
    same_fields(tpc.decode_cloud(buf, tpc.OUSTER_FIELDS, tpc.OUSTER_POINT_STEP),
                jpc.decode_cloud(buf, jpc.OUSTER_FIELDS, jpc.OUSTER_POINT_STEP))
    for got, ref in zip(tpc.ouster_to_xyzit(buf, stride), jpc.ouster_to_xyzit(buf, stride)):
        same(got, ref)
    for got, ref in zip(tpc.convert_scan("ouster", buf, stride),
                        jpc.convert_scan("ouster", buf, stride)):
        same(got, ref)
    _, vbuf = _pack_velodyne(n)
    for got, ref in zip(tpc.velodyne_to_xyzit(vbuf), jpc.velodyne_to_xyzit(vbuf)):
        same(got, ref)
    for got, ref in zip(tpc.convert_scan("velodyne", vbuf, stride),
                        jpc.convert_scan("velodyne", vbuf, stride)):
        same(got, ref)
    assert tpc.VELODYNE_FIELDS == jpc.VELODYNE_FIELDS
    assert tpc.OUSTER_FIELDS == jpc.OUSTER_FIELDS


# ---- rosbag ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_log():
    """tests/test_rosbag.py's log, from the port's generator (bit-identical
    to JAX's, tests/test_torch_guards.py)."""
    world = tlog.make_world(seed=5, extent=60.0, n_ground=20_000, n_wall=8_000)
    return tlog.synthesize_log(world, duration=1.0, points_per_scan=256, max_range=40.0,
                               seed=6)


def _bag_bytes(log, compression, gps, can):
    """tests/test_rosbag.py's ``_write_synth_bag`` bag (the connections and
    the messages in time order in one chunk), with an lz4 chunk too: one
    frame of literal blocks, as roslz4 may write it."""
    inner = b"".join(_connection(cid, topic, mtype) for topic, (cid, mtype) in CONNS.items())
    events = [(t, _message(CONNS[IMU][0], t, _enc_imu(t, (0, 0, 0, 1), gyro, acc)))
              for t, acc, gyro in zip(log.imu_t, log.imu_acc, log.imu_gyro)]
    for i, t in enumerate(log.scan_t):
        v = log.scan_valid[i]
        events.append((t, _message(CONNS[SCAN][0], t, _enc_pointcloud2(
            t, log.scan_points[i][v], log.scan_times[i][v]))))
    events += [(t, _message(CONNS[GPS][0], t, _enc_navsatfix(t, la, lo, al, cd)))
               for t, la, lo, al, cd in gps]
    events += [(t, _message(CONNS[CAN][0], t, _enc_twist_stamped(t, vx, wz)))
               for t, vx, wz in can]
    events.sort(key=lambda e: e[0])
    inner += b"".join(r for _, r in events)
    if compression == "lz4":
        hdr = _fields(op=b"\x05", compression=b"lz4", size=struct.pack("<I", len(inner)))
        return _bag([_record(hdr, _lz4_frame([(False, _lz4_literal_block(inner))]))])
    return _bag([_chunk(inner, compression)])


@pytest.mark.parametrize("compression,projection,origin", [
    ("none", "Cartesian", (37.3, 127.0, 40.0)), ("bz2", "Cartesian", None),
    ("lz4", "UTM", (37.3, 127.0, 40.0)), ("none", "UTM", None)])
def test_bag_to_replay_log_matches_jax(tmp_path, tiny_log, compression, projection, origin):
    t0 = float(tiny_log.imu_t[0])
    gps = [(t0 + 0.1, 37.3, 127.0, 40.0, (2.0, 2.5, 9.0)),
           (t0 + 0.6, 37.3005, 127.0004, 41.0, (1.0, 1.0, 4.0))]
    can = [(t0 + 0.2, 5.0, 0.1), (t0 + 0.7, 5.5, -0.2)]
    path = tmp_path / "drive.bag"
    path.write_bytes(_bag_bytes(tiny_log, compression, gps, can))
    kw = dict(gps_topic=GPS, can_topic=CAN, ref_origin=origin, projection_mode=projection)
    got = trosbag.bag_to_replay_log(str(path), SCAN, IMU, **kw)
    ref = jrosbag.bag_to_replay_log(str(path), SCAN, IMU, **kw)
    for f in dataclasses.fields(ref):
        r = getattr(ref, f.name)
        if r is None:
            assert getattr(got, f.name) is None, f.name
        else:
            same(getattr(got, f.name), r, f.name)
    assert np.abs(got.gps_pos).max() > 1.0   # the second fix projected away from the first
    msgs, jmsgs = list(trosbag.read_bag(str(path))), list(jrosbag.read_bag(str(path)))
    assert [dataclasses.astuple(m) for m in msgs] == [dataclasses.astuple(m) for m in jmsgs]
    only_imu = list(trosbag.read_bag(str(path), topics=[IMU]))
    assert len(only_imu) == len(tiny_log.imu_t)


def test_rosbag_errors_match_jax(tmp_path):
    path = tmp_path / "bad.bag"
    path.write_bytes(b"#ROSBAG V1.2\n")
    for mod in (trosbag, jrosbag):
        with pytest.raises(ValueError, match="not a rosbag v2.0"):
            list(mod.read_bag(str(path)))
    empty = tmp_path / "empty.bag"
    empty.write_bytes(_bag([_chunk(b"".join(_connection(c, t, m)
                                            for t, (c, m) in CONNS.items()))]))
    for mod in (trosbag, jrosbag):
        with pytest.raises(ValueError, match="no messages on scan topic"):
            mod.bag_to_replay_log(str(empty), SCAN, IMU)


# ---- sites -------------------------------------------------------------------

def test_sites_match_jax():
    assert tsites.SITES.keys() == jsites.SITES.keys()
    for name, preset in jsites.SITES.items():
        assert dataclasses.astuple(tsites.SITES[name]) == dataclasses.astuple(preset)
        tcfg, jcfg = tconfig.ElimalocConfig(), jconfig.ElimalocConfig()
        assert dataclasses.astuple(tsites.apply_site(tcfg, name)) == dataclasses.astuple(
            jsites.apply_site(jcfg, name))
        assert dataclasses.asdict(tcfg.ekf) == dataclasses.asdict(jcfg.ekf)
    with pytest.raises(ValueError, match="unknown site"):
        tsites.apply_site(tconfig.ElimalocConfig(), "nowhere")
