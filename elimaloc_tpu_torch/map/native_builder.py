"""ctypes bridge to the C++ map-builder fast path (native/src/voxel_builder.cpp)
— a copy of ``elimaloc_tpu.map.native_builder`` (jax-free). It loads the
same ``native/build/libelimaloc_native.so`` through the same repo-relative
path; without it the NumPy builder runs. Bound here: the map build, its
insertion-only view and the LZF decompressor the PCD reader
(``map/pcd.py``) takes for ``binary_compressed`` files. The native scan
step serves the JAX package's bench and is not bound (ROADMAP Queue 1,
the port's bench).

The voxel insertion with min-spacing is an inherently sequential, hash-heavy
host job (the reference does it in C++ at node startup, pcm_matching.cpp:86-89)
— the one part of this framework that stays native. Built via native/Makefile
into ``libelimaloc_native.so``; when absent, builder.py silently falls back to
the NumPy implementation with identical semantics.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_SO_NAMES = ("libelimaloc_native.so",)
_lib = None
_checked = False


def _candidate_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    for name in _SO_NAMES:
        yield os.path.join(root, "native", "build", name)
        yield os.path.join(root, name)


def maybe_load(force_recheck: bool = False):
    """Return the native module wrapper or None if the .so isn't built.

    ``force_recheck`` drops the cached miss and probes the filesystem again,
    for callers that just built the .so themselves."""
    global _lib, _checked
    if _checked and not force_recheck:
        return _lib
    _checked = True
    _lib = None
    for path in _candidate_paths():
        if os.path.exists(path):
            try:
                _lib = _NativeBuilder(path)
                break
            except OSError:
                _lib = None
            except AttributeError:
                # a stale .so from before the two-phase build API: honor the
                # documented NumPy fallback instead of crashing, but say why
                import warnings

                warnings.warn(
                    f"{path} predates the elm_build_begin/finish API — "
                    "falling back to the NumPy builder; rebuild with "
                    "`make -C native`",
                    RuntimeWarning,
                    stacklevel=2,
                )
                _lib = None
    return _lib


class _NativeBuilder:
    def __init__(self, path):
        self._c = ctypes.CDLL(path)
        self._c.elm_build_begin.restype = ctypes.c_void_p
        self._c.elm_build_begin.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # points [N*3]
            ctypes.c_int64,                   # N
            ctypes.c_double,                  # voxel_size
            ctypes.c_int64,                   # max_points_per_voxel
        ]
        self._c.elm_build_num_voxels.restype = ctypes.c_int64
        self._c.elm_build_num_voxels.argtypes = [ctypes.c_void_p]
        self._c.elm_build_free.restype = None
        self._c.elm_build_free.argtypes = [ctypes.c_void_p]
        self._c.elm_build_finish.restype = None
        self._c.elm_build_finish.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),   # out vox_coords [V*3]
            ctypes.POINTER(ctypes.c_double),  # out block [V*M*3]
            ctypes.POINTER(ctypes.c_int64),   # out counts [V]
            ctypes.POINTER(ctypes.c_double),  # out mean [V*3]
            ctypes.POINTER(ctypes.c_double),  # out raw cov [V*9]
        ]
        try:
            self._c.elm_lzf_decompress.restype = ctypes.c_int64
            self._c.elm_lzf_decompress.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64,
            ]
            self._has_lzf = True
        except AttributeError:
            self._has_lzf = False

    def build_map(self, points: np.ndarray, voxel_size: float, max_pts: int):
        """Two-phase build (voxel_builder.cpp): begin hashes + groups point
        coords by voxel, then finish writes min-spacing-accepted points
        straight into exact-size output arrays — no worst-case [N, M, 3]
        padding block (15 GB at 21M points in the old single-call design).

        Returns ``(vox_coords, block, counts, mean, raw_cov)``: block values
        are f32-rounded with +inf pad rows; mean/raw_cov are accumulated from
        the rounded points in f64 (plane regularization is the caller's)."""
        pts = np.ascontiguousarray(points, dtype=np.float64)
        n = pts.shape[0]
        pts_p = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        handle = self._c.elm_build_begin(pts_p, n, voxel_size, max_pts)
        if not handle:
            raise MemoryError(
                "native elm_build_begin could not allocate its scratch "
                f"(~32 bytes/point for {n} points)"
            )
        try:
            v = self._c.elm_build_num_voxels(handle)
            vox_coords = np.empty((v, 3), dtype=np.int64)
            block = np.empty((v, max_pts, 3), dtype=np.float64)
            counts = np.empty(v, dtype=np.int64)
            mean = np.empty((v, 3), dtype=np.float64)
            raw_cov = np.empty((v, 3, 3), dtype=np.float64)
        except BaseException:
            # finish() consumes the handle; on any failure before it runs
            # (e.g. MemoryError on the [V, M, 3] block) free it explicitly
            self._c.elm_build_free(handle)
            raise
        self._c.elm_build_finish(
            handle,
            vox_coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            block.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            raw_cov.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return vox_coords, block, counts, mean, raw_cov

    def insert_points(self, points: np.ndarray, voxel_size: float, max_pts: int):
        """Insertion-only view of :meth:`build_map` (block is f32-rounded
        with +inf pads, unlike the raw-f64 NumPy fallback)."""
        vox_coords, block, counts, _, _ = self.build_map(points, voxel_size, max_pts)
        return vox_coords, block, counts

    def lzf_decompress(self, src: bytes, expected: int):
        """LZF decompression; returns bytes or None when unavailable/failed."""
        if not self._has_lzf:
            return None
        out = (ctypes.c_ubyte * expected)()
        src_buf = (ctypes.c_ubyte * len(src)).from_buffer_copy(src)
        n = self._c.elm_lzf_decompress(src_buf, len(src), out, expected)
        if n != expected:
            return None
        return bytes(out)
