"""PCD point-cloud file I/O (the reference's map format); a copy of
``elimaloc_tpu.map.pcd`` on the port's native bridge.

The reference loads its prebuilt maps with ``pcl::io::loadPCDFile``
(reference: pcm_matching.cpp:69-79; launch files name per-site .pcd maps
whose filenames encode the geodetic origin, e.g.
``37.558200_127.044500_66.000000_hanyang_02m.pcd``). This module reads and
writes PCD v0.7 in ``ascii``, ``binary``, and ``binary_compressed`` form
(LZF decompression via the native library, with a pure-Python fallback) and
parses the origin-encoding filename convention.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

_PCD_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


def _parse_header(fh) -> Dict:
    hdr = {}
    while True:
        line = fh.readline().decode("ascii", errors="replace")
        if not line:
            raise ValueError("truncated PCD header")
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        hdr[key.upper()] = rest.split()
        if key.upper() == "DATA":
            hdr["_data_offset"] = fh.tell()
            return hdr


def _lzf_decompress(src: bytes, expected: int) -> bytes:
    """LZF decompression — native fast path, Python fallback."""
    from . import native_builder

    lib = native_builder.maybe_load()
    if lib is not None and hasattr(lib, "lzf_decompress"):
        out = lib.lzf_decompress(src, expected)
        if out is not None:
            return out
    # Pure-Python LZF (reference algorithm: Marc Lehmann's liblzf format,
    # as written by PCL's binary_compressed writer).
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            cnt = ctrl + 1
            out += src[i:i + cnt]
            i += cnt
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += src[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - src[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected:
        raise ValueError(
            f"LZF decompression size mismatch: {len(out)} != {expected}"
        )
    return bytes(out)


def read_pcd(path: str, fields: Tuple[str, ...] = ("x", "y", "z")):
    """Read a PCD file -> dict of field arrays (at least the requested
    ``fields``; all stored fields are returned)."""
    with open(path, "rb") as fh:
        hdr = _parse_header(fh)
        data = fh.read()

    names = hdr["FIELDS"]
    sizes = [int(v) for v in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(v) for v in hdr.get("COUNT", ["1"] * len(names))]
    n_pts = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0].lower()

    np_fields = []
    for name, size, typ, cnt in zip(names, sizes, types, counts):
        base = _PCD_DTYPES[(typ, size)]
        if cnt == 1:
            np_fields.append((name, base))
        else:
            np_fields.append((name, base, (cnt,)))
    rec = np.dtype(np_fields)

    if mode == "ascii":
        flat = np.loadtxt(
            path, skiprows=_count_header_lines(path), dtype=np.float64,
            ndmin=2,
        )
        out = {}
        col = 0
        for name, size, typ, cnt in zip(names, sizes, types, counts):
            base = _PCD_DTYPES[(typ, size)]
            out[name] = flat[:, col:col + cnt].astype(base).squeeze(-1) \
                if cnt == 1 else flat[:, col:col + cnt].astype(base)
            col += cnt
        return out
    if mode == "binary":
        arr = np.frombuffer(data[: n_pts * rec.itemsize], dtype=rec)
        return {name: np.ascontiguousarray(arr[name]) for name in names}
    if mode == "binary_compressed":
        comp_size, uncomp_size = np.frombuffer(data[:8], dtype=np.uint32)
        raw = _lzf_decompress(data[8:8 + comp_size], int(uncomp_size))
        # binary_compressed stores fields contiguously (SoA), not interleaved
        out = {}
        off = 0
        for name, size, typ, cnt in zip(names, sizes, types, counts):
            base = _PCD_DTYPES[(typ, size)]
            nbytes = n_pts * size * cnt
            block = np.frombuffer(raw[off:off + nbytes], dtype=base)
            out[name] = block.reshape(n_pts, cnt).squeeze(-1) if cnt == 1 \
                else block.reshape(n_pts, cnt)
            off += nbytes
        return out
    raise ValueError(f"unsupported PCD DATA mode: {mode}")


def _count_header_lines(path: str) -> int:
    with open(path, "rb") as fh:
        for i, line in enumerate(fh):
            if line.strip().upper().startswith(b"DATA"):
                return i + 1
    raise ValueError("no DATA line in PCD")


def read_pcd_points(path: str) -> np.ndarray:
    """Read a PCD map -> [N,3] float64 xyz (NaN rows dropped, matching PCL's
    is_dense handling)."""
    f = read_pcd(path)
    pts = np.stack([np.asarray(f["x"], np.float64),
                    np.asarray(f["y"], np.float64),
                    np.asarray(f["z"], np.float64)], axis=1)
    return pts[np.isfinite(pts).all(axis=1)]


def write_pcd(path: str, points: np.ndarray, mode: str = "binary") -> None:
    """Write an [N,3] xyz cloud as PCD v0.7 (ascii or binary)."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    hdr = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {mode}\n"
    )
    with open(path, "wb") as fh:
        fh.write(hdr.encode("ascii"))
        if mode == "binary":
            fh.write(np.ascontiguousarray(pts).tobytes())
        elif mode == "ascii":
            np.savetxt(fh, pts, fmt="%.6f")
        else:
            raise ValueError(f"unsupported write mode {mode}")


def parse_origin_from_filename(path: str) -> Optional[Tuple[float, float, float]]:
    """Extract (lat, lon, height) from the reference's map-filename convention
    ``<lat>_<lon>_<height>_<name>.pcd`` (pcm_matching launch files)."""
    base = os.path.basename(path)
    m = re.match(r"^(-?\d+\.\d+)_(-?\d+\.\d+)_(-?\d+\.\d+)_", base)
    if not m:
        return None
    return float(m.group(1)), float(m.group(2)), float(m.group(3))
