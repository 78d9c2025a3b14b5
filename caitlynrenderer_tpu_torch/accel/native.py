"""ctypes loader for the native (C++) BVH builder (copy of
caitlynrenderer_tpu/accel/native.py, with its own source and build place).

Compiles `csrc/bvh_builder.cpp` (a copy of the reference's
native/bvh_builder.cpp) with g++ on first use into this package's
git-ignored `build/` directory, as `libbvh-<hash>.so` (the hash covers the
source and the flags, so an edited source is rebuilt), and exposes the
same FlatBVH contract as the NumPy builder.  The NumPy builder remains the
reference implementation and the fallback when no toolchain is available
(set CAITLYN_NO_NATIVE=1 to force the fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
_BUILD_DIR = os.path.join(_PKG, "build")
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libbvh-{digest}.so")


def _compile_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CAITLYN_NO_NATIVE"):
        return None
    try:
        so = _library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True, capture_output=True)
            os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
        lib = ctypes.CDLL(so)
        lib.build_bvh_sah.restype = ctypes.c_int
        lib.build_bvh_sah.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # bmin
            ctypes.POINTER(ctypes.c_float),  # bmax
            ctypes.POINTER(ctypes.c_float),  # cent
            ctypes.c_int,  # num_tris
            ctypes.c_int,  # max_leaf
            ctypes.POINTER(ctypes.c_float),  # node_bounds
            ctypes.POINTER(ctypes.c_int),  # node_meta
            ctypes.POINTER(ctypes.c_int),  # tri_order
            ctypes.c_int,  # cap
        ]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):  # no g++, a failed build or load
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _compile_and_load() is not None


def build_bvh_native(tri_bmin, tri_bmax, cent, max_leaf: int):
    """Run the C++ builder; returns (node_bounds, node_meta, tri_order)
    or None when the native library is unavailable."""
    lib = _compile_and_load()
    if lib is None:
        return None
    t = tri_bmin.shape[0]
    cap = 2 * t + 2
    bmin = np.ascontiguousarray(tri_bmin, np.float32)
    bmax = np.ascontiguousarray(tri_bmax, np.float32)
    cen = np.ascontiguousarray(cent, np.float32)
    node_bounds = np.empty((cap, 6), np.float32)
    node_meta = np.empty((cap, 2), np.int32)
    tri_order = np.empty(t, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = lib.build_bvh_sah(
        bmin.ctypes.data_as(fp),
        bmax.ctypes.data_as(fp),
        cen.ctypes.data_as(fp),
        t,
        max_leaf,
        node_bounds.ctypes.data_as(fp),
        node_meta.ctypes.data_as(ip),
        tri_order.ctypes.data_as(ip),
        cap,
    )
    if n < 0:
        return None
    return node_bounds[:n].copy(), node_meta[:n].copy(), tri_order
