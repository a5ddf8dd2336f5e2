"""Sensor point-cloud decoding — the PointCloud2-converter equivalent; a
NumPy copy of ``elimaloc_tpu.pipeline.pointcloud`` (the port imports
nothing of the JAX package).

The reference ingests ``sensor_msgs/PointCloud2`` and converts to its
``PointXYZIT`` working layout per lidar type (reference: pcm_matching.hpp:81-106
point structs; pcm_matching.cpp:900-930 converters; dispatch on
``lidar_type`` at cpp:218-224). Here the wire format is the same idea without
ROS: a raw byte buffer + field descriptors (name/offset/datatype/count +
point_step), decoded with NumPy structured dtypes on the host, then handed to
the pipeline as dense arrays.

Behavioral parity notes:
  * ``input_index_sampling`` stride-subsamples ONLY on the ouster path
    (cpp:908-918); the velodyne/default path converts every point
    (``Cloudmsg2cloud``, cpp:925-929).
  * ouster: ``intensity`` is taken from ``reflectivity`` and ``time`` from
    ``t * 1e-9`` (ns -> s), cpp:916-918.
  * ouster quirk (preserved): the output is resized to ``n // stride + 1``
    and filled for ``ceil(n / stride)`` points, so when ``n % stride == 0``
    one trailing default point (x=y=z=0, time=0) remains (cpp:908-911).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# sensor_msgs/PointField datatype codes
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

_FIELD_NP = {
    INT8: np.int8, UINT8: np.uint8,
    INT16: np.int16, UINT16: np.uint16,
    INT32: np.int32, UINT32: np.uint32,
    FLOAT32: np.float32, FLOAT64: np.float64,
}

# Field layouts of the two supported drivers, as (name, offset, datatype).
# Offsets follow the common driver wire formats (velodyne_pointcloud
# organized cloud: 22-byte points; ouster_ros: 48-byte points).
VELODYNE_FIELDS = (
    ("x", 0, FLOAT32), ("y", 4, FLOAT32), ("z", 8, FLOAT32),
    ("intensity", 12, FLOAT32), ("ring", 16, UINT16), ("time", 18, FLOAT32),
)
VELODYNE_POINT_STEP = 22

OUSTER_FIELDS = (
    ("x", 0, FLOAT32), ("y", 4, FLOAT32), ("z", 8, FLOAT32),
    ("intensity", 16, FLOAT32), ("t", 20, UINT32),
    ("reflectivity", 24, UINT16), ("ring", 26, UINT16),
    ("ambient", 28, UINT16), ("range", 32, UINT32),
)
OUSTER_POINT_STEP = 48


def decode_cloud(data: bytes, fields: Sequence[Tuple[str, int, int]],
                 point_step: int, n_points: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
    """Decode a packed point buffer into per-field arrays.

    ``fields`` is (name, byte_offset, datatype) per field — the
    PointCloud2 field table. Count>1 fields are not used by either
    supported driver and are unsupported.
    """
    if n_points is None:
        n_points = len(data) // point_step
    rec = np.dtype({
        "names": [f[0] for f in fields],
        "offsets": [f[1] for f in fields],
        "formats": [_FIELD_NP[f[2]] for f in fields],
        "itemsize": point_step,
    })
    arr = np.frombuffer(data[: n_points * point_step], dtype=rec)
    return {name: np.ascontiguousarray(arr[name]) for name, _, _ in fields}


def ouster_to_xyzit(data: bytes, index_sampling: int = 1,
                    fields: Sequence[Tuple[str, int, int]] = OUSTER_FIELDS,
                    point_step: int = OUSTER_POINT_STEP):
    """OusterCloudmsg2cloud equivalent (pcm_matching.cpp:900-923): stride
    subsample, intensity <- reflectivity, time <- t * 1e-9 s."""
    f = decode_cloud(data, fields, point_step)
    n = len(f["x"])
    stride = max(int(index_sampling), 1)
    out_n = n // stride + 1  # reference resize quirk, cpp:908-911
    xyz = np.zeros((out_n, 3), np.float32)
    intensity = np.zeros(out_n, np.float32)
    time = np.zeros(out_n, np.float32)
    idx = np.arange(0, n, stride)
    k = len(idx)
    xyz[:k, 0] = f["x"][idx]
    xyz[:k, 1] = f["y"][idx]
    xyz[:k, 2] = f["z"][idx]
    intensity[:k] = f["reflectivity"][idx].astype(np.float32)
    time[:k] = f["t"][idx].astype(np.float64) * 1e-9
    if k == out_n - 1:  # n % stride == 0: one trailing default point remains
        pass
    else:  # n % stride != 0: ceil(n/stride) == out_n, fully filled
        xyz = xyz[:k]
        intensity = intensity[:k]
        time = time[:k]
    return xyz, intensity, time


def velodyne_to_xyzit(data: bytes,
                      fields: Sequence[Tuple[str, int, int]] = VELODYNE_FIELDS,
                      point_step: int = VELODYNE_POINT_STEP):
    """Cloudmsg2cloud equivalent (pcm_matching.cpp:925-929): direct PointXYZIT
    conversion, every point (no index subsampling on this path)."""
    f = decode_cloud(data, fields, point_step)
    xyz = np.stack([f["x"], f["y"], f["z"]], axis=1).astype(np.float32)
    return xyz, f["intensity"].astype(np.float32), f["time"].astype(np.float32)


def convert_scan(lidar_type: str, data: bytes, index_sampling: int = 1,
                 fields: Optional[Sequence[Tuple[str, int, int]]] = None,
                 point_step: Optional[int] = None):
    """lidar_type dispatch (pcm_matching.cpp:218-224): "ouster" takes the
    subsampling converter; everything else the velodyne pass-through."""
    if lidar_type == "ouster":
        kw = {}
        if fields is not None:
            kw["fields"] = fields
        if point_step is not None:
            kw["point_step"] = point_step
        return ouster_to_xyzit(data, index_sampling, **kw)
    kw = {}
    if fields is not None:
        kw["fields"] = fields
    if point_step is not None:
        kw["point_step"] = point_step
    return velodyne_to_xyzit(data, **kw)
