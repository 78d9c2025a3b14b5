"""Lazy builder and loader for the hand-written CUDA kernels, and the checks
their wrappers share.

Each `csrc/<name>.cu` has a plain C interface.  At first use it is compiled
with nvcc into `build/lib<name>-<hash>.so` inside this package (the hash
covers the source and the flags, so an edited source is never served from
a stale library) and loaded with ctypes.  Nothing is compiled or loaded at
import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import collections
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


# --------------------------------------------------------------------------
# Launch counters
# --------------------------------------------------------------------------

# Each kernel module's launch counter, by module: (counts, kernels), where
# kernels maps a counter key to a fragment of its kernel's mangled name.
COUNTERS: dict = {}


def launch_counter(module: str, kernels: dict) -> dict:
    """The launch counter of kernel module `module`, registered here: for
    each key of `kernels` the launches of the kernel whose mangled name
    contains kernels[key], and under key + "_twin" the calls of its plain
    twin.  The wrapper adds one where it launches."""
    counts = {k: 0 for k in kernels}
    counts.update({f"{k}_twin": 0 for k in kernels})
    COUNTERS[module] = (counts, dict(kernels))
    return counts


def launch_counts() -> dict:
    """A copy of every registered counter, {module: {key: n}}."""
    return {m: dict(counts) for m, (counts, _) in COUNTERS.items()}


def set_launch_counts(saved: dict) -> None:
    """Put the counters back to `saved` (from `launch_counts`)."""
    for m, (counts, _) in COUNTERS.items():
        counts.update(saved[m])


def add_launches(added: dict) -> None:
    """Add {module: {key: n}} to the counters."""
    for m, row in added.items():
        for k, n in row.items():
            COUNTERS[m][0][k] += n


def count_kernels(names) -> dict:
    """{module: {key: n}} over every registered counter: the kernels among
    the mangled names `names`, one per launch, by the fragment each key
    stands for (twin keys 0)."""
    out = {m: dict.fromkeys(counts, 0) for m, (counts, _) in COUNTERS.items()}
    for name, n in collections.Counter(names).items():
        for m, (_, kernels) in COUNTERS.items():
            for key, fragment in kernels.items():
                if fragment in name:
                    out[m][key] += n
    return out


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h (libcuda's interface)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


# CUgraphNodeType values of the nodes that run on the device, and the name
# a memcpy or memset node goes by (the profiler's names begin so).
_KERNEL, _MEMCPY, _MEMSET = 0, 1, 2
_COPY_NAMES = {_MEMCPY: "Memcpy", _MEMSET: "Memset"}
_libcuda = None


def _cu(fn, *args) -> None:
    """Call libcuda's `fn`; raise on an error."""
    global _libcuda
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
    rc = getattr(_libcuda, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUresult {rc}")


def _handles(fn, graph) -> list:
    """The node handles libcuda's `fn` (cuGraphGetNodes or
    cuGraphGetRootNodes) lists for `graph`."""
    count = ctypes.c_size_t(0)
    _cu(fn, graph, None, ctypes.byref(count))
    if count.value == 0:
        return []
    nodes = (ctypes.c_void_p * count.value)()
    _cu(fn, graph, nodes, ctypes.byref(count))
    return list(nodes)


def _run_order(graph, nodes: list):
    """`nodes` in the order they run where the graph is one chain (one
    root, each node followed by at most one), else None."""
    count = ctypes.c_size_t(0)
    _cu("cuGraphGetEdges", graph, None, None, ctypes.byref(count))
    if count.value != max(len(nodes) - 1, 0):
        return None
    src, dst = (ctypes.c_void_p * count.value)(), (ctypes.c_void_p * count.value)()
    if count.value:
        _cu("cuGraphGetEdges", graph, src, dst, ctypes.byref(count))
    after = dict(zip(src, dst))
    roots = _handles("cuGraphGetRootNodes", graph)
    if len(after) != count.value or len(roots) != 1:
        return None
    order = roots
    while order[-1] in after:
        order.append(after[order[-1]])
    return order if len(order) == len(nodes) else None


def graph_nodes(raw_graph: int):
    """(nodes, chain) of a captured CUDA graph, given its cudaGraph_t
    handle, read through libcuda.  nodes: one (handle, kernel, name) for
    each node, in the order they run where the graph is one chain (`chain`
    True), else in libcuda's order; kernel tells a kernel node, and name is
    its kernel's mangled name, "Memcpy" or "Memset" for a copy node, None
    for a node that runs nothing on the device."""
    graph = ctypes.c_void_p(raw_graph)
    handles = _handles("cuGraphGetNodes", graph)
    order = _run_order(graph, handles)
    chain = order is not None
    out, by_func = [], {}
    kind, params = ctypes.c_int(0), _KernelNodeParams()
    for node in order if chain else handles:
        _cu("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != _KERNEL:
            out.append((node, False, _COPY_NAMES.get(kind.value)))
            continue
        _cu("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
        handle = ("cuFuncGetName", params.func) if params.func else ("cuKernelGetName",
                                                                    params.kern)
        if handle not in by_func:
            name = ctypes.c_char_p()
            _cu(handle[0], ctypes.byref(name), ctypes.c_void_p(handle[1]))
            by_func[handle] = name.value.decode()
        out.append((node, True, by_func[handle]))
    return out, chain


def capture_tail(stream: int):
    """The node that the next node captured on `stream` (a cudaStream_t
    handle, capturing) will follow: its handle, 0 before the first node,
    None where it would follow several (the capture has forked)."""
    status, ident, graph = ctypes.c_int(0), ctypes.c_uint64(0), ctypes.c_void_p()
    deps, count = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t(0)
    _cu("cuStreamGetCaptureInfo_v2", ctypes.c_void_p(stream), ctypes.byref(status),
        ctypes.byref(ident), ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(count))
    if count.value > 1:
        return None
    return deps[0] if count.value else 0
