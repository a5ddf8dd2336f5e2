"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``.

The library lands in ``elimaloc_tpu_torch/build/<hash>/`` (git-ignored),
keyed by a hash of the sources and the flags, and is built at first use —
never at import, so the package imports on hosts without a CUDA toolkit.
Each ``.cu`` compiles to an object in its own ``nvcc`` process, all started
together, then one link makes the library. ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside it as
``nvcc.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "elm_deskew": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                   _P, _P],
    "elm_voxel_downsample": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    "elm_assign_slots": [_P, _P, _I, _F, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P],
    "elm_p2p_search_reduce": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _F, _F, _I,
                              _I, _I, _P, _P, _P, _P, _P],
    "elm_gicp_search_reduce": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _F,
                               _F, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "elm_vgicp_search_reduce": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _F,
                                _F, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "elm_avgicp_search_reduce": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _F,
                                 _P, _P, _P, _P, _P, _P, _P],
    "elm_imu_stage": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _PP, _I, _PP, _I, _I, _P,
                      _P],
    "elm_ekf_update": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                       _I, _P, _P, _P, _P, _P, _P, _I, _P],
    "elm_ca_tick": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "elm_tick_stage": [_P, _P, _P, _P, _PP, _I, _P, _P],
    "elm_imu_intake": [_PP, _I, _P, _P, _P, _P, _P, _P],
    "elm_radar_cov": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "elm_radar_rows": [_P, _I, _P, _P, _I, _P, _PP, _I, _P, _P],
    "elm_can_gps_update": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I,
                           _I, _P],
    "elm_ring_push": [_PP, _I, _PP, _I, _I, _P, _P],
    "elm_scan_ring_query": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                            _P, _P, _P, _P],
    "elm_scan_front": [_P, _P, _P, _I, _P, _P, _P, _PP, _I, _PP, _I, _P, _I, _I, _I, _P, _P,
                       _P, _P],
    "elm_pcm_measurement": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
    "elm_pcm_stage": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P,
                      _P, _I, _I, _I, _P],
    "elm_gn_step": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "elm_p2p_register": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                         _F, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "elm_p2p_register_capacity": [ctypes.POINTER(_I)],
    "elm_avgicp_register": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I, _F, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "elm_avgicp_register_capacity": [_I, _I, _I, ctypes.POINTER(_I)],
    "elm_gicp_register": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P, _I, _F, _F, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "elm_gicp_register_capacity": [_I, _I, _I, ctypes.POINTER(_I)],
    "elm_vgicp_register": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _F, _F, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "elm_vgicp_register_capacity": [_I, _I, _I, ctypes.POINTER(_I)],
    "elm_hash_register": [_P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _F, _P, _P, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P,
                          _P, _P, _P],
    "elm_hash_register_capacity": [_I, _I, _I, ctypes.POINTER(_I)],
    "elm_shift_window": [_PP, _PP, _PP, ctypes.POINTER(_I), _I, _I, _I, _I, _I, _P, _I, _P],
    "elm_hash_search_reduce": [_P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _F, _P, _P,
                               _I, _P, _P, _P, _I, _P, _P, _P],
    "elm_hash_query": [_P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _F, _P, _I, _P, _I,
                       _P, _P, _P, _P, _P, _P, _P],
    "elm_hash_lookup": [_P, _P, _I, _I, _I, _P, _I, _P, _P],
    "elm_ground_height": [_P, ctypes.c_longlong, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P],
    "elm_grid_query": [_P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _F, _P, _I, _P, _I,
                       _P, _P, _P, _P, _P, _P, _P],
    "elm_launch_floor": [_P],
    "elm_ground_probe": [_P, _P, _I, _I, _F, _F, _F, _I, _P, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libelimaloc_kernels.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    jobs = []
    for src in (s for s in sources() if s.suffix == ".cu"):
        obj = so.parent / f".{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-4000:]}")
    tmp = so.with_name(f".{so.name}.{tag}")
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *(str(obj) for _, obj, _ in jobs)],
                             capture_output=True, text=True)
        log.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (so.parent / "nvcc.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
