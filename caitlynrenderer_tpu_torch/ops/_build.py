"""Lazy builder and loader for the hand-written CUDA kernels, and the checks
their wrappers share.

Each `csrc/<name>.cu` has a plain C interface.  At first use it is compiled
with nvcc into `build/lib<name>-<hash>.so` inside this package (the hash
covers the source and the flags, so an edited source is never served from
a stale library) and loaded with ctypes.  Nothing is compiled or loaded at
import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# sm_90a: Hopper with its architecture-specific instructions.  --fmad=false
# keeps every multiply and add separately rounded, as in the plain twins;
# fast math is never on.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, else /usr/local/cuda/bin/nvcc,
    else the first on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str, force: bool = False) -> dict:
    """Compile csrc/<name>.cu unless the library for this source is built
    (or always, with force).  Returns {"path", "seconds", "log"}: seconds is
    0.0 and log empty when the library was already there."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out) and not force:
        return {"path": out, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(log)
    return {"path": out, "seconds": seconds, "log": log}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>; `signatures` maps each C
    function to its ctypes (restype, argtypes)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        _loaded[name] = lib
    return lib


def is_cpu(*xs) -> bool:
    """True when every tensor is on the CPU, False when every one is on a
    CUDA device; raises on a mix or any other device."""
    types = {x.device.type for x in xs if isinstance(x, torch.Tensor)}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {sorted(types)}")


def check_tensor(name, x, dtype, shape, device) -> None:
    """Raise unless x is a contiguous tensor of this dtype, shape and device."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(rc: int, error_string, fn: str) -> None:
    """Raise if a C launcher returned a CUDA error; error_string is the
    library's code -> message function."""
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} ({error_string(rc).decode()})")
