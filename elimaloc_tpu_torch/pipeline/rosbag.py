"""Pure-Python rosbag (v2.0) ingest — drop-in for the reference's bag replay;
a copy of ``elimaloc_tpu.pipeline.rosbag`` on the port's own modules.

The reference is validated exclusively by rosbag replay (`README.md:87-90`,
datasets at `README.md:226-249`); its nodes subscribe `sensor_msgs/Imu`,
`sensor_msgs/NavSatFix`, `geometry_msgs/TwistStamped` (CAN),
`sensor_msgs/PointCloud2` (`ekf_localization.hpp:78-80`,
`pcm_matching.hpp:125-126`). This module reads those bags directly — record
framing, chunk decompression, and hand-written little-endian message
deserializers — with no ROS installation, and assembles a
:class:`~elimaloc_tpu_torch.pipeline.log.ReplayLog` so an ELiMaLoc user's
existing `.bag` + `.pcd` datasets replay through the pipeline unchanged.

Bag format: http://wiki.ros.org/Bags/Format/2.0 — a `#ROSBAG V2.0` banner
followed by length-prefixed records, each a header (length-prefixed
`name=value` fields) plus a data blob. Messages live inside chunk records
(op 0x05), compressed with ``none``, ``bz2`` (stdlib), or ``lz4``
(roslz4 writes standard LZ4 frames — decoded by the pure-Python
:mod:`.lz4f`).

Timestamps: assembly uses each message's HEADER stamp, matching the
reference callbacks (`ekf_localization.cpp:132`, `pcm_matching.cpp:216`),
not the bag receipt time.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .log import ReplayLog

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONNECTION = 0x07

_U32 = struct.Struct("<I")


# --------------------------------------------------------------------------- #
# Record layer
# --------------------------------------------------------------------------- #

def _parse_fields(buf: bytes) -> Dict[bytes, bytes]:
    """A record header: [u32 len][name=value] repeated."""
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = _U32.unpack_from(buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    end = len(buf)
    while off < end:
        (hlen,) = _U32.unpack_from(buf, off)
        off += 4
        header = _parse_fields(buf[off:off + hlen])
        off += hlen
        (dlen,) = _U32.unpack_from(buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def _iter_records_file(f) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    """Stream length-prefixed records from an open file — the bag is never
    held in memory whole (reference datasets are multi-GB; only one record,
    i.e. at most one ~1 MB chunk, is resident at a time)."""
    while True:
        head = f.read(4)
        if len(head) < 4:
            return
        (hlen,) = _U32.unpack(head)
        header = _parse_fields(f.read(hlen))
        (dlen,) = _U32.unpack(f.read(4))
        data = f.read(dlen)
        if len(data) < dlen:
            raise ValueError("truncated rosbag record")
        yield header, data


@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str          # e.g. "sensor_msgs/Imu"
    t_recv: float          # bag receipt time (header stamps live in .raw)
    raw: bytes             # serialized message body


def read_bag(path: str, topics: Optional[Sequence[str]] = None
             ) -> Iterator[BagMessage]:
    """Stream messages from a rosbag 2.0 file in record order.

    ``topics`` filters (None = all). Connections may appear at top level or
    inside chunks; both are handled. Message order follows the file (rosbag
    record writes receipt order); downstream assembly re-sorts by header
    stamp anyway.
    """
    want = set(topics) if topics is not None else None
    conns: Dict[int, Tuple[str, str]] = {}

    def handle(header: Dict[bytes, bytes], data: bytes
               ) -> Iterator[BagMessage]:
        op = header[b"op"][0]
        if op == _OP_CONNECTION:
            cid = _U32.unpack(header[b"conn"])[0]
            topic = header[b"topic"].decode()
            sub = _parse_fields(data)
            conns[cid] = (topic, sub.get(b"type", b"?").decode())
        elif op == _OP_MSG:
            cid = _U32.unpack(header[b"conn"])[0]
            topic, mtype = conns.get(cid, ("?", "?"))
            if want is None or topic in want:
                secs, nsecs = struct.unpack("<II", header[b"time"])
                yield BagMessage(topic, mtype, secs + nsecs * 1e-9, data)
        elif op == _OP_CHUNK:
            comp = header.get(b"compression", b"none")
            if comp == b"none":
                inner = data
            elif comp == b"bz2":
                inner = bz2.decompress(data)
            elif comp == b"lz4":
                from .lz4f import frame_decompress

                inner = frame_decompress(data)
            else:
                raise NotImplementedError(
                    f"chunk compression {comp.decode()!r}"
                )
            for h2, d2 in _iter_records(inner):
                yield from handle(h2, d2)
        # bag header / index / chunk-info records carry no messages

    with open(path, "rb") as f:
        banner = f.readline()
        if not banner.startswith(b"#ROSBAG V2.0"):
            raise ValueError(
                f"not a rosbag v2.0 file (banner {banner[:20]!r}); "
                "v1.x bags predate 2010 and are unsupported"
            )
        for header, data in _iter_records_file(f):
            yield from handle(header, data)


# --------------------------------------------------------------------------- #
# Message deserializers (little-endian; ROS serialization has no padding)
# --------------------------------------------------------------------------- #

class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def i8(self) -> int:
        (v,) = struct.unpack_from("<b", self.buf, self.off)
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self, n: int = 1):
        vals = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return vals[0] if n == 1 else np.array(vals)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def bytes_(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def header_stamp(self) -> float:
        """std_msgs/Header: u32 seq, time stamp, string frame_id -> stamp."""
        self.u32()
        secs, nsecs = self.u32(), self.u32()
        self.string()
        return secs + nsecs * 1e-9


def parse_imu(raw: bytes) -> dict:
    """sensor_msgs/Imu (used at ekf_localization.cpp:139-145 via
    ImuStructConverter: angular_velocity + linear_acceleration)."""
    c = _Cursor(raw)
    t = c.header_stamp()
    quat = c.f64(4)          # x y z w
    c.f64(9)
    gyro = c.f64(3)
    c.f64(9)
    acc = c.f64(3)
    c.f64(9)
    return dict(t=t, quat_xyzw=quat, gyro=gyro, acc=acc)


def parse_navsatfix(raw: bytes) -> dict:
    """sensor_msgs/NavSatFix (ekf_localization.cpp:92-125)."""
    c = _Cursor(raw)
    t = c.header_stamp()
    status = c.i8()
    service = c.u16()
    lat, lon, alt = c.f64(), c.f64(), c.f64()
    cov = c.f64(9)
    cov_type = c.u8()
    return dict(t=t, status=status, service=service, lat=lat, lon=lon,
                alt=alt, cov=np.asarray(cov).reshape(3, 3),
                cov_type=cov_type)


def parse_twist_stamped(raw: bytes) -> dict:
    """geometry_msgs/TwistStamped — the CAN topic
    (ekf_localization.cpp:127-137: twist.linear.x, twist.angular.z)."""
    c = _Cursor(raw)
    t = c.header_stamp()
    linear = c.f64(3)
    angular = c.f64(3)
    return dict(t=t, linear=linear, angular=angular)


def parse_pointcloud2(raw: bytes) -> dict:
    """sensor_msgs/PointCloud2 -> its own field table + packed bytes,
    ready for :func:`~elimaloc_tpu_torch.pipeline.pointcloud.convert_scan`."""
    c = _Cursor(raw)
    t = c.header_stamp()
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        if count != 1:
            raise NotImplementedError(
                f"PointField count={count} on {name!r} (neither supported "
                "driver emits count>1, pointcloud.py)"
            )
        fields.append((name, offset, datatype))
    is_bigendian = bool(c.u8())
    if is_bigendian:
        raise NotImplementedError("big-endian PointCloud2")
    point_step, row_step = c.u32(), c.u32()
    data = c.bytes_(c.u32())
    c.u8()  # is_dense
    return dict(t=t, height=height, width=width, fields=fields,
                point_step=point_step, row_step=row_step, data=data)


def parse_pose_with_cov_stamped(raw: bytes) -> dict:
    """geometry_msgs/PoseWithCovarianceStamped — the /initialpose click
    (pcm_matching.cpp:356-447)."""
    c = _Cursor(raw)
    t = c.header_stamp()
    pos = c.f64(3)
    quat = c.f64(4)          # x y z w
    cov = c.f64(36)
    return dict(t=t, pos=pos, quat_xyzw=quat,
                cov=np.asarray(cov).reshape(6, 6))


_PARSERS = {
    "sensor_msgs/Imu": parse_imu,
    "sensor_msgs/NavSatFix": parse_navsatfix,
    "geometry_msgs/TwistStamped": parse_twist_stamped,
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "geometry_msgs/PoseWithCovarianceStamped": parse_pose_with_cov_stamped,
}


# --------------------------------------------------------------------------- #
# ReplayLog assembly
# --------------------------------------------------------------------------- #

def bag_to_replay_log(
    path: str,
    scan_topic: str,
    imu_topic: str,
    gps_topic: Optional[str] = None,
    can_topic: Optional[str] = None,
    *,
    lidar_type: str = "velodyne",
    index_sampling: int = 1,
    ref_origin: Optional[Tuple[float, float, float]] = None,
    projection_mode: str = "Cartesian",
) -> ReplayLog:
    """Read a reference-style bag into a ReplayLog.

    * scans decode with the PointCloud2 message's OWN field table through
      the lidar_type converters (``ouster`` applies ``index_sampling``,
      everything else is the velodyne pass-through — pcm_matching.cpp:
      218-224) and pad to the densest scan (validity-masked).
    * NavSatFix projects to local ENU with ``ref_origin``
      (lat, lon, height), the launch-file per-site origin
      (`ekf_localization/launch/ekf_localization.launch:6-38`); default =
      the first fix. ``gps_cov`` carries the position_covariance diagonal
      (the reference's double-squaring quirk is applied downstream).
    * TwistStamped CAN maps linear.x -> can_vel, angular.z -> can_yaw_rate.

    Streams are sorted by header stamp; the replay runtime owns event
    ordering from there.
    """
    topics = [scan_topic, imu_topic] + [
        t for t in (gps_topic, can_topic) if t
    ]
    per: Dict[str, List[dict]] = {t: [] for t in topics}
    for msg in read_bag(path, topics=topics):
        parser = _PARSERS.get(msg.msg_type)
        if parser is None:
            raise ValueError(
                f"topic {msg.topic!r} has unsupported type {msg.msg_type!r}"
            )
        per[msg.topic].append(parser(msg.raw))

    if not per[scan_topic]:
        raise ValueError(f"no messages on scan topic {scan_topic!r}")
    if not per[imu_topic]:
        raise ValueError(f"no messages on imu topic {imu_topic!r}")

    from .pointcloud import convert_scan

    scans = sorted(per[scan_topic], key=lambda m: m["t"])
    decoded = []
    for m in scans:
        # Organized clouds (height>1, e.g. Ouster ring-major) may pad each
        # row to row_step > width*point_step (allowed by the PointCloud2
        # spec); the decoders infer the point count as len(data)//point_step,
        # so strip the padding and any trailing slack first.
        w, h, ps = m["width"], m["height"], m["point_step"]
        rs = m["row_step"] or w * ps
        data = m["data"]
        if h >= 1 and rs != w * ps:
            data = b"".join(
                data[r * rs:r * rs + w * ps] for r in range(h)
            )
        else:
            data = data[:h * w * ps]
        fields = [(nm, off, dt) for nm, off, dt in m["fields"]]
        names = {nm for nm, _, _ in fields}
        no_time = lidar_type != "ouster" and "time" not in names
        if no_time:
            # older velodyne drivers emit no per-point time: deskew then
            # sees zero offsets (a no-op), matching the reference fed the
            # same cloud
            from .pointcloud import FLOAT32

            fields = fields + [("time", 0, FLOAT32)]
        xyz, _inten, ptime = convert_scan(
            lidar_type, data, index_sampling,
            fields=fields, point_step=ps,
        )
        if no_time:
            ptime = np.zeros_like(ptime)
        decoded.append((m["t"], xyz, ptime))
    cap = max(len(x) for _, x, _ in decoded)
    ns = len(decoded)
    scan_t = np.array([t for t, _, _ in decoded], np.float64)
    scan_points = np.zeros((ns, cap, 3), np.float32)
    scan_times = np.zeros((ns, cap), np.float32)
    scan_valid = np.zeros((ns, cap), bool)
    for i, (_, xyz, ptime) in enumerate(decoded):
        k = len(xyz)
        scan_points[i, :k] = xyz
        scan_times[i, :k] = ptime
        scan_valid[i, :k] = np.isfinite(xyz).all(axis=1)

    imu = sorted(per[imu_topic], key=lambda m: m["t"])
    kw: dict = dict(
        imu_t=np.array([m["t"] for m in imu], np.float64),
        imu_acc=np.array([m["acc"] for m in imu], np.float64),
        imu_gyro=np.array([m["gyro"] for m in imu], np.float64),
        scan_t=scan_t, scan_points=scan_points, scan_times=scan_times,
        scan_valid=scan_valid,
    )

    if gps_topic and per[gps_topic]:
        from ..ops import geo

        fixes = sorted(per[gps_topic], key=lambda m: m["t"])
        if ref_origin is None:
            ref_origin = (fixes[0]["lat"], fixes[0]["lon"], fixes[0]["alt"])
        fwd = (geo.project_gps_point_utm
               if projection_mode.upper() == "UTM"
               else geo.project_gps_point)
        lat = np.array([m["lat"] for m in fixes])
        lon = np.array([m["lon"] for m in fixes])
        alt = np.array([m["alt"] for m in fixes])
        # host-side ingest projects in f64: in f32 the ~6.4e6 m ECEF
        # cancellation corrupts positions by ~0.8 m (geo module docstring)
        enu = np.asarray(fwd(lat, lon, alt, *ref_origin, xp=np))
        kw.update(
            gps_t=np.array([m["t"] for m in fixes], np.float64),
            gps_pos=np.asarray(enu, np.float64),
            gps_cov=np.array([np.diag(m["cov"]) for m in fixes], np.float64),
        )

    if can_topic and per[can_topic]:
        can = sorted(per[can_topic], key=lambda m: m["t"])
        kw.update(
            can_t=np.array([m["t"] for m in can], np.float64),
            can_vel=np.array([m["linear"][0] for m in can], np.float64),
            can_yaw_rate=np.array([m["angular"][2] for m in can], np.float64),
        )

    return ReplayLog(**kw)
