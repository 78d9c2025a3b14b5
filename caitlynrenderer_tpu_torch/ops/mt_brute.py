"""Brute-force closest-hit and any-hit queries over a (T, 9) triangle slab
(counterpart of caitlynrenderer_tpu/ops/pallas_mt.py:154-178).

`brute_closest` and `brute_anyhit` launch the hand-written CUDA kernel
(csrc/mt_brute.cu) for CUDA tensors and run the plain PyTorch twin for CPU
tensors; there is no fallback from one to the other.  The twins
(`brute_closest_plain`, `brute_anyhit_plain`) compute the kernel's result
with the same arithmetic: they are the CPU path, and the oracle the kernel
is held against on the card.

`mt_cull_plain` is the kernel's conservative pre-test in torch (the pairs
it lets through to the exact test), and `lanes_per_ray` the wrapper's
choice of lanes per ray; the CPU tests hold both against the twins.

`launches` counts kernel launches and twin calls, so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from caitlynrenderer_tpu_torch.core import math as cm
from caitlynrenderer_tpu_torch.ops import _build
from caitlynrenderer_tpu_torch.ops.intersect import INF, mt_uvt

SOURCE = "caitlynrenderer_tpu_torch/csrc/mt_brute.cu"
REPLACES = "caitlynrenderer_tpu/ops/pallas_mt.py:41"

launches = _build.launch_counter("mt_brute", {"closest": "mt_brute_kernelILb0E",
                                              "anyhit": "mt_brute_kernelILb1E"})

# The twins materialize (rays, triangles) temporaries; rays are processed in
# chunks of about this many pairs to bound their memory.
_PAIRS_PER_CHUNK = 1 << 24

# The kernel's pre-test constants (csrc/mt_brute.cu): K per unit of each
# error scale, numerators within NUM_EPS (beyond K's margin) of 0 and
# determinants outside (DET_TINY, DET_HUGE) decide no sign, u + v > 1 is
# decided only beyond SUM_MARGIN, and nothing where a term may reach MAG_MAX.
ERR_K = 2.0 ** -19
NUM_EPS = 1e-14
DET_TINY = 1e-20
DET_HUGE = 1e29
MAG_MAX = 1e37
SUM_MARGIN = 1.0001
CHUNK = 256  # rows the kernel stages at once, each chunk relative to its first v0

_SIGNATURES = {
    # o, d, active, tris, t_max, n, t_count, lanes, out_t, out_tri, out_u,
    # out_v, device, stream
    "mt_brute_closest": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_float]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                         + [ctypes.c_int, ctypes.c_void_p]),
    # o, d, t_max, active, tris, n, t_count, lanes, out_occ, device, stream
    "mt_brute_anyhit": (ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
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


def _fma(a, b, c):
    """a * b + c rounded to float32 once in float64 and once more to
    float32: the kernel's __fmaf_rn up to that second rounding, which the
    pre-test's margin covers."""
    return (a.double() * b.double() + c.double()).float()


def mt_cull_plain(o, d, tris9):
    """The kernel's pre-test (csrc/mt_brute.cu:cull_keeps) in torch: (N, T)
    bool, False where it rejects ray i x triangle s before the division.
    As the kernel stages them, positions are relative to the first v0 of
    each CHUNK rows and the margins use the chunk's largest norms.  Every
    pair it rejects, the exact test rejects too, whatever t_best
    (tests/test_torch_mt_cull.py)."""
    f32 = torch.float32
    const = lambda x: torch.tensor(x, dtype=f32)  # noqa: E731
    count = tris9.shape[0]
    chunk = torch.arange(count) // CHUNK
    c = tris9[chunk * CHUNK, 0:3]  # (T, 3): each row's chunk origin
    v0, e1, e2 = tris9[:, 0:3] - c, tris9[:, 3:6], tris9[:, 6:9]

    def chunk_max(x):  # (T,) -> each row's chunk maximum, (1, T)
        out = torch.zeros(int(chunk.max()) + 1 if count else 0, dtype=f32)
        return out.scatter_reduce(0, chunk, x, "amax")[chunk][None]

    # The staged per-triangle constants, (1, T, 3) or (1, T).
    n = cm.cross(e2, e1)[None]
    p1, p2 = cm.cross(v0, e1)[None], cm.cross(v0, e2)[None]
    c2 = ((e2[:, 0] * p1[0, :, 0] + e2[:, 1] * p1[0, :, 1]) + e2[:, 2] * p1[0, :, 2])[None]
    ne1 = (e1[:, 0].abs() + e1[:, 1].abs()) + e1[:, 2].abs()
    ne2 = (e2[:, 0].abs() + e2[:, 1].abs()) + e2[:, 2].abs()
    nv0, pmax = chunk_max(v0.abs().amax(dim=1)), chunk_max(ne1 * ne2)
    ne1, ne2 = chunk_max(ne1), chunk_max(ne2)
    pk, ne = const(ERR_K) * pmax, torch.maximum(ne1, ne2)
    tri_mag = torch.maximum(torch.maximum(nv0 * ne, nv0 * pmax), pmax)
    e1, e2 = e1[None], e2[None]
    # The ray's terms for each row's chunk, (N, T, 3) or (N, T).
    dd = d[:, None, :]
    pos = o[:, None, :] - c[None]
    m = cm.cross(pos, dd.expand_as(pos))
    nd = ((d[:, 0].abs() + d[:, 1].abs()) + d[:, 2].abs())[:, None]
    no = pos.abs().amax(dim=2)
    s = no + nv0
    a = s * (nd * const(ERR_K))
    eu, ev = _fma(a, ne2, const(NUM_EPS)), _fma(a, ne1, const(NUM_EPS))
    et, ed = _fma(s, pk, const(NUM_EPS)), _fma(nd, pk, const(DET_TINY))
    # Where a term could overflow, the pre-test decides nothing.
    mag = torch.maximum(torch.maximum(torch.maximum(no * nd, s * nd * ne), s * pmax),
                        torch.maximum(nd * pmax, tri_mag))
    ed = torch.where(mag < MAG_MAX, ed, const(torch.inf))

    def chain(x, y, start):  # start + x.x y.x + x.y y.y + x.z y.z, fused in turn
        acc = start
        for ax in range(3):
            acc = _fma(x[..., ax], y[..., ax], acc)
        return acc

    det = _fma(dd[..., 2], n[..., 2], _fma(dd[..., 1], n[..., 1], dd[..., 0] * n[..., 0]))
    tneg = chain(pos, n, c2)
    unum = chain(dd, p2, _fma(e2[..., 2], m[..., 2], _fma(e2[..., 1], m[..., 1],
                                                          e2[..., 0] * m[..., 0])))
    vneg = chain(dd, p1, _fma(e1[..., 2], m[..., 2], _fma(e1[..., 1], m[..., 1],
                                                          e1[..., 0] * m[..., 0])))
    adet = det.abs()
    sg = torch.where(torch.signbit(det), const(-1.0), const(1.0))
    su, sv, st = unum * sg, vneg * -sg, tneg * -sg
    valid = (adet > ed) & (adet < DET_HUGE)
    out = ((su < -eu) | (sv < -ev) | (st < -et)
           | (su + sv > _fma(adet + ed, const(SUM_MARGIN), eu + ev)))
    return ~(valid & out)


def lanes_per_ray(n: int, tcount: int, threads: int = 132 * 2048) -> int:
    """Lanes the kernel gives each ray: the largest power of two up to 32
    that keeps n x lanes within about `threads` (the card's thread slots)
    and leaves each lane at least 16 rows."""
    lanes = 1
    while lanes < 32 and 2 * lanes * n <= threads and 2 * lanes * 16 <= tcount:
        lanes *= 2
    return lanes


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


@functools.lru_cache(maxsize=None)
def _thread_slots(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * getattr(props, "max_threads_per_multi_processor", 2048)


def _lanes(n, tcount, dev):
    return lanes_per_ray(n, tcount, _thread_slots(dev.index))


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
            float(t_max), n, tcount, _lanes(n, tcount, dev), t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
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
            tris9.data_ptr(), n, tcount, _lanes(n, tcount, dev), occ.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(rc, lib.mt_brute_error_string, "mt_brute_anyhit")
    launches["anyhit"] += 1
    return occ
