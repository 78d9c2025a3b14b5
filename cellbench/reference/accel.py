"""Closest-hit and any-hit ray queries of the plain reference, in torch.

Small scenes are swept by brute force; large ones walk a linear BVH that
this module builds itself in numpy (triangles sorted by the Morton code
of their centroid, four to a leaf, an implicit complete binary tree over
the leaves), so the reference shares no tree and no traversal with the
program under test.  The walk runs every ray in lockstep, a stack of node
ids a ray, popping one node a step, until every stack is empty.

Möller–Trumbore accepts a triangle where u >= 0, v >= 0, 1 - u - v >= 0,
0 <= t < t_best and det != 0; among triangles at the same t the first one
found wins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = 1e9
BRUTE_MAX_TRIS = 4096  # at most this many triangles: brute force, else the BVH
LEAF = 4
STACK = 64
BLOCK = 32  # walk steps between reads of whether any ray is still walking
# Box tests keep a hit within this relative slack of the box's far side,
# so rounding in the slab test never drops a triangle on the box's face.
SLAB_SLACK = 1e-6
_PAIRS = 1 << 23  # ray-triangle pairs a brute-force block evaluates at once


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def mt(o, d, v0, e1, e2):
    """(det, t, u, v) of rays against triangles, broadcast."""
    pv = cross(d, e2)
    det = dot(e1, pv)
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1e-20, det)
    tv = o - v0
    qv = cross(tv, e1)
    return det, dot(e2, qv) * inv_det, dot(tv, pv) * inv_det, dot(d, qv) * inv_det


def accepts(det, t, u, v, t_best):
    return (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= 0) & (t < t_best) & (det != 0)


class Geometry(NamedTuple):
    """Triangles as (T, 9) v0 | e1 | e2 rows in the query's order, and for
    the BVH its boxes and the triangle id of each row."""

    tris9: torch.Tensor  # (T, 9), in leaf order under the BVH
    tri_id: torch.Tensor  # (T,) int64 scene triangle id of each row
    boxes: torch.Tensor | None  # (2 * leaves, 6) lo | hi, node k's children 2k, 2k + 1
    leaves: int  # a power of two; node ids leaves .. 2 leaves - 1 are leaves


def build(vertices: np.ndarray, tri_v: np.ndarray, device, dtype=torch.float32) -> Geometry:
    """The query structure of a scene: brute force up to BRUTE_MAX_TRIS
    triangles, else the linear BVH."""
    v = vertices.astype(np.float32)
    idx = tri_v[:, :3].astype(np.int64)
    p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    tris9 = np.concatenate([p0, p1 - p0, p2 - p0], axis=1)
    t = len(tris9)
    if t <= BRUTE_MAX_TRIS:
        return Geometry(torch.tensor(tris9, dtype=dtype, device=device),
                        torch.arange(t, device=device), None, 0)
    cen = (p0 + p1 + p2) / 3.0
    lo, hi = cen.min(axis=0), cen.max(axis=0)
    q = np.clip(((cen - lo) / np.maximum(hi - lo, 1e-12) * 1023.0), 0, 1023).astype(np.uint64)
    order = np.argsort(_morton(q[:, 0]) << 2 | _morton(q[:, 1]) << 1 | _morton(q[:, 2]),
                       kind="stable")
    leaves = 1 << int(np.ceil(np.log2(max((t + LEAF - 1) // LEAF, 1))))
    tlo = np.full((leaves * LEAF, 3), np.inf, np.float32)
    thi = np.full((leaves * LEAF, 3), -np.inf, np.float32)
    tlo[:t] = np.minimum(np.minimum(p0, p1), p2)[order]
    thi[:t] = np.maximum(np.maximum(p0, p1), p2)[order]
    boxes = np.zeros((2 * leaves, 6), np.float32)
    boxes[leaves:, :3] = tlo.reshape(leaves, LEAF, 3).min(axis=1)
    boxes[leaves:, 3:] = thi.reshape(leaves, LEAF, 3).max(axis=1)
    n = leaves
    while n > 1:
        n //= 2
        kids = boxes[2 * n: 4 * n].reshape(n, 2, 6)
        boxes[n: 2 * n, :3] = kids[:, :, :3].min(axis=1)
        boxes[n: 2 * n, 3:] = kids[:, :, 3:].max(axis=1)
    rows = np.zeros((leaves * LEAF, 9), np.float32)
    rows[:t] = tris9[order]
    rows[t:, 3:] = 0.0  # padding: degenerate, det = 0, never accepted
    tri_id = np.full(leaves * LEAF, -1, np.int64)
    tri_id[:t] = order
    return Geometry(torch.tensor(rows, dtype=dtype, device=device),
                    torch.tensor(tri_id, device=device),
                    torch.tensor(boxes, dtype=dtype, device=device), leaves)


def _morton(x):
    """Spread the low 10 bits of x (uint64) two bits apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    return (x | (x << 2)) & 0x9249249


def closest(geo: Geometry, o, d, active):
    """(t, tri) of the nearest accepted triangle of each active ray;
    t = INF and tri = -1 where none is or the ray is inactive."""
    t_in = torch.where(active, INF, -INF).to(o.dtype)
    if geo.boxes is None:
        return _brute(geo, o, d, t_in, anyhit=False)
    return _walk(geo, o, d, t_in, anyhit=False)


def occluded(geo: Geometry, o, d, t_max, active):
    """(N,) bool: an active ray meets some triangle at 0 <= t < t_max."""
    t_in = torch.where(active, t_max, -INF)
    if geo.boxes is None:
        return _brute(geo, o, d, t_in, anyhit=True)
    return _walk(geo, o, d, t_in, anyhit=True)


def _brute(geo, o, d, t_in, anyhit):
    n, tc = o.shape[0], geo.tris9.shape[0]
    rows = geo.tris9[None]
    t_out = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    step = max(1, _PAIRS // max(tc, 1))
    for s in range(0, n, step):
        sl = slice(s, s + step)
        det, t, u, v = mt(o[sl, None], d[sl, None], rows[..., 0:3], rows[..., 3:6], rows[..., 6:9])
        ok = accepts(det, t, u, v, t_in[sl, None])
        if anyhit:
            occ[sl] = ok.any(dim=1)
            continue
        best, i = torch.where(ok, t, torch.inf).min(dim=1)
        hit = ok.any(dim=1)
        t_out[sl] = torch.where(hit, best, INF)
        tri[sl] = torch.where(hit, geo.tri_id[i], -1)
    return occ if anyhit else (t_out, tri)


def _slab(boxes, node, o, inv, t_best):
    """Entry distance of rays into boxes `node`, and whether they enter
    before t_best and leave at t >= 0."""
    b = boxes[node]
    t0 = (b[:, 0:3] - o) * inv
    t1 = (b[:, 3:6] - o) * inv
    near = torch.nan_to_num(torch.minimum(t0, t1), nan=-torch.inf).amax(dim=1)
    far = torch.nan_to_num(torch.maximum(t0, t1), nan=torch.inf).amin(dim=1)
    far = far * (1.0 + SLAB_SLACK)
    filled = b[:, 0] <= b[:, 3]  # the boxes of padding leaves are empty (lo > hi)
    return near, filled & (near <= far) & (far >= 0) & (near < t_best)


def _walk(geo, o, d, t_in, anyhit):
    n, dev = o.shape[0], o.device
    state = {"sp": (t_in > 0).to(torch.int64),  # inactive rays, or t_max <= 0, walk nothing
             "best_t": t_in.clone(),
             "best_tri": torch.full((n,), -1, dtype=torch.int64, device=dev),
             "occ": torch.zeros(n, dtype=torch.bool, device=dev)}
    stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    stack[:, 0] = 1
    inv = 1.0 / d
    lane = torch.arange(LEAF, device=dev)

    def step():
        out = _step(geo, o, d, inv, stack, *state.values(), anyhit, lane)
        for buf, new in zip(state.values(), out):
            buf.copy_(new)

    # On the card one step is some ninety small operations, so a step is
    # replayed as one CUDA graph; a ray whose stack is empty idles.
    run = _graph(step) if dev.type == "cuda" and n else step
    while bool((state["sp"] > 0).any()):
        for _ in range(BLOCK):
            run()
    if anyhit:
        return state["occ"]
    hit = state["best_tri"] >= 0
    return torch.where(hit, state["best_t"], INF), state["best_tri"]


def _graph(fn):
    """fn, run once now and captured as a CUDA graph: returns its replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _step(geo, o, d, inv, stack, sp, best_t, best_tri, occ, anyhit, lane):
    """One step of every ray: pop a node; test a leaf's triangles, or push
    the children of an inner node that the ray enters, the nearer last.
    `stack` is updated in place."""
    live = sp > 0
    top = torch.clamp(sp - 1, min=0)[:, None]
    node = stack.gather(1, top)[:, 0]
    sp = sp - live.to(sp.dtype)
    leaf = live & (node >= geo.leaves)
    inner = live & ~leaf
    rid = torch.where(leaf, node - geo.leaves, 0)[:, None] * LEAF + lane[None, :]
    rows = geo.tris9[rid]
    det, t, u, v = mt(o[:, None], d[:, None], rows[..., 0:3], rows[..., 3:6], rows[..., 6:9])
    ok = accepts(det, t, u, v, best_t[:, None]) & leaf[:, None]
    got = ok.any(dim=1)
    if anyhit:
        occ = occ | got
        sp = torch.where(got, 0, sp)
    else:
        tmin, k = torch.where(ok, t, torch.inf).min(dim=1)
        best_t = torch.where(got, tmin, best_t)
        best_tri = torch.where(got, geo.tri_id[rid.gather(1, k[:, None])[:, 0]], best_tri)
    c0 = 2 * torch.where(inner, node, 1)
    n0, h0 = _slab(geo.boxes, c0, o, inv, best_t)
    n1, h1 = _slab(geo.boxes, c0 + 1, o, inv, best_t)
    h0, h1 = h0 & inner, h1 & inner
    swap = n1 < n0
    for child, hit in ((torch.where(swap, c0, c0 + 1), torch.where(swap, h0, h1)),
                       (torch.where(swap, c0 + 1, c0), torch.where(swap, h1, h0))):
        pos = torch.clamp(sp, max=STACK - 1)[:, None]
        stack.scatter_(1, pos, torch.where(hit, child, stack.gather(1, pos)[:, 0])[:, None])
        sp = sp + hit.to(sp.dtype)
    return sp, best_t, best_tri, occ
