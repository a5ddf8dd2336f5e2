"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``.

The library lands in ``elimaloc_tpu_torch/build/<hash>/`` (git-ignored),
keyed by a hash of the sources and the flags, and is built at first use —
never at import, so the package imports on hosts without a CUDA toolkit.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside it as ``nvcc.log``.
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
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "elm_deskew": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                   _P, _P],
    "elm_voxel_keys": [_P, _P, _I, _P, _P, _P, _P],
    "elm_voxel_compact": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "elm_tile_keys": [_P, _P, _I, _F, _F, _I, _I, _I, _I, _I, _P, _P, _P],
    "elm_assign_scatter": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong,
                           _P, _P, _P, _P, _P, _P, _P],
    "elm_p2p_search_reduce": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _F, _F, _I,
                              _I, _I, _P, _P, _P, _P, _P],
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
    tmp = so.with_name(f".{so.name}.{os.getpid()}")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp),
           *(str(s) for s in sources() if s.suffix == ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (so.parent / "nvcc.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
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
