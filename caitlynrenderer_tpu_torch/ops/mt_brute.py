"""Brute-force closest-hit and any-hit queries over a (T, 9) triangle slab
(counterpart of caitlynrenderer_tpu/ops/pallas_mt.py:154-178).

`brute_closest` and `brute_anyhit` launch the hand-written CUDA kernel
(csrc/mt_brute.cu) for CUDA tensors and run the plain PyTorch twin for CPU
tensors; there is no fallback from one to the other.  The twins
(`brute_closest_plain`, `brute_anyhit_plain`) compute the kernel's result
with the same arithmetic: they are the CPU path, and the oracle the kernel
is held against on the card.

`launches` counts kernel launches and twin calls, so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes

import torch

from caitlynrenderer_tpu_torch.ops import _build
from caitlynrenderer_tpu_torch.ops.intersect import INF, mt_uvt

SOURCE = "caitlynrenderer_tpu_torch/csrc/mt_brute.cu"
REPLACES = "caitlynrenderer_tpu/ops/pallas_mt.py:41"

launches = {"closest": 0, "anyhit": 0, "closest_twin": 0, "anyhit_twin": 0}

# The twins materialize (rays, triangles) temporaries; rays are processed in
# chunks of about this many pairs to bound their memory.
_PAIRS_PER_CHUNK = 1 << 24

_SIGNATURES = {
    "mt_brute_closest": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_float]
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                         + [ctypes.c_int, ctypes.c_void_p]),
    "mt_brute_anyhit": (ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "mt_brute_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --------------------------------------------------------------------------
# Plain twins
# --------------------------------------------------------------------------


def _accepted(o, d, t_in, tris9):
    """Yield (start, ok, t, u, v) per ray chunk: ok[i, s] is the kernel's
    acceptance of triangle s by ray i against t_in[i] (t < t_best without
    the running update; the nearest accepted t is the same)."""
    n, tcount = o.shape[0], tris9.shape[0]
    v0, e1, e2 = tris9[None, :, 0:3], tris9[None, :, 3:6], tris9[None, :, 6:9]
    step = max(1, _PAIRS_PER_CHUNK // max(tcount, 1))
    for s in range(0, n, step):
        det, t, u, v = mt_uvt(o[s : s + step, None, :], d[s : s + step, None, :], v0, e1, e2)
        ok = (
            (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0)
            & (t >= 0.0) & (t < t_in[s : s + step, None]) & (det != 0.0)
        )
        yield s, ok, t, u, v


def brute_closest_plain(o, d, active, tris9, t_max=INF):
    """Plain PyTorch twin of the closest-hit kernel.  o, d: (N, 3) f32;
    active: (N,) bool; tris9: (T, 9) f32; t_max: scalar or (N,).  Returns
    (t, tri, u, v): t = INF, tri = -1, u = v = 0 on a miss or an inactive
    lane; ties go to the first-indexed triangle."""
    launches["closest_twin"] += 1
    n, dev = o.shape[0], o.device
    t_in = torch.where(active, torch.as_tensor(t_max, dtype=torch.float32, device=dev), -INF)
    t_out = torch.full((n,), INF, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    if tris9.shape[0] == 0:
        return t_out, tri, u_out, v_out
    for s, ok, t, u, v in _accepted(o, d, t_in, tris9):
        best, idx = torch.where(ok, t, torch.inf).min(dim=1)  # first index of the min
        hit = ok.any(dim=1)
        e = s + ok.shape[0]
        t_out[s:e] = torch.where(hit, best, INF)
        tri[s:e] = torch.where(hit, idx, -1).to(torch.int32)
        u_out[s:e] = torch.where(hit, u.gather(1, idx[:, None])[:, 0], 0.0)
        v_out[s:e] = torch.where(hit, v.gather(1, idx[:, None])[:, 0], 0.0)
    return t_out, tri, u_out, v_out


def brute_anyhit_plain(o, d, t_max, active, tris9):
    """Plain PyTorch twin of the any-hit kernel: (N,) bool, true where an
    active ray hits some triangle at 0 <= t < t_max."""
    launches["anyhit_twin"] += 1
    n, dev = o.shape[0], o.device
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if tris9.shape[0] == 0:
        return occ
    t_in = torch.where(active, t_max, -INF)
    for s, ok, _, _, _ in _accepted(o, d, t_in, tris9):
        occ[s : s + ok.shape[0]] = ok.any(dim=1)
    return occ


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_rays(o, d, active, tris9, t_max=None):
    n, tcount, dev = o.shape[0], tris9.shape[0], o.device
    _build.check_tensor("o", o, torch.float32, (n, 3), dev)
    _build.check_tensor("d", d, torch.float32, (n, 3), dev)
    _build.check_tensor("active", active, torch.bool, (n,), dev)
    _build.check_tensor("tris9", tris9, torch.float32, (tcount, 9), dev)
    if t_max is not None:
        _build.check_tensor("t_max", t_max, torch.float32, (n,), dev)
    if n >= 2**31 or tcount * 9 >= 2**31:
        raise ValueError(f"too many rays ({n}) or triangles ({tcount}) for int32 indexing")
    return n, tcount, dev


def brute_closest(o, d, active, tris9, t_max: float = INF):
    """Closest hit of every active ray over all triangles of `tris9`
    ((T, 9) v0|e1|e2 in scene order).  Returns (t, tri, u, v), see
    `brute_closest_plain`.  CUDA tensors launch the kernel."""
    if _build.is_cpu(o, d, active, tris9):
        return brute_closest_plain(o, d, active, tris9, t_max)
    if not isinstance(t_max, (int, float)):
        raise TypeError("the closest-hit kernel takes a scalar t_max")
    n, tcount, dev = _check_rays(o, d, active, tris9)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, tri, u, v
    lib = _build.load("mt_brute", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.mt_brute_closest(
            o.data_ptr(), d.data_ptr(), active.data_ptr(), tris9.data_ptr(),
            float(t_max), n, tcount, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(rc, lib.mt_brute_error_string, "mt_brute_closest")
    launches["closest"] += 1
    return t, tri, u, v


def brute_anyhit(o, d, t_max, active, tris9):
    """Occlusion of every active ray by any triangle at 0 <= t < t_max
    ((N,) f32).  Returns (N,) bool.  CUDA tensors launch the kernel."""
    if _build.is_cpu(o, d, t_max, active, tris9):
        return brute_anyhit_plain(o, d, t_max, active, tris9)
    n, tcount, dev = _check_rays(o, d, active, tris9, t_max)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    lib = _build.load("mt_brute", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.mt_brute_anyhit(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), active.data_ptr(),
            tris9.data_ptr(), n, tcount, occ.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(rc, lib.mt_brute_error_string, "mt_brute_anyhit")
    launches["anyhit"] += 1
    return occ
