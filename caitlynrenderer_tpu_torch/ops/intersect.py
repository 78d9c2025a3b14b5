"""Ray-triangle intersection on tensors (counterpart of
caitlynrenderer_tpu/ops/intersect.py).

Möller–Trumbore with the reference's acceptance rule: accept iff u >= 0,
v >= 0, 1-u-v >= 0, t >= 0 and t < t_best.  The arithmetic is written out
component by component in the order of the Pallas kernel
(caitlynrenderer_tpu/ops/pallas_mt.py:58-77) and of csrc/mt_brute.cu, so the
plain twins and the CUDA kernel agree bit for bit.
"""

from __future__ import annotations

import torch

from caitlynrenderer_tpu_torch.core import math as cm

INF = cm.INF


def mt_uvt(o, d, v0, e1, e2):
    """(det, t, u, v) of rays (o, d) against triangles (v0, e1, e2); all
    inputs (..., 3) and broadcast against each other."""
    pv = cm.cross(d, e2)
    det = cm.dot(e1, pv)
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1e-20, det)
    tv = o - v0
    qv = cm.cross(tv, e1)
    u = cm.dot(tv, pv) * inv_det
    v = cm.dot(d, qv) * inv_det
    t = cm.dot(e2, qv) * inv_det
    return det, t, u, v


def moller_trumbore(o, d, v0, e1, e2, t_best):
    """Batched single-triangle test.  o, d, v0, e1, e2: (..., 3); t_best:
    (...,).  Returns (hit, t, u, v)."""
    _, t, u, v = mt_uvt(o, d, v0, e1, e2)
    hit = (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= 0) & (t < t_best)
    return hit, t, u, v


def pack_tris(verts, tri_v):
    """(T, 9) packed v0 | e1 | e2 rows: the slab the brute-force kernel reads."""
    tv = tri_v.long()
    v0 = verts[tv[:, 0]]
    return torch.cat([v0, verts[tv[:, 1]] - v0, verts[tv[:, 2]] - v0], dim=1)


def intersect_brute(o, d, verts, tri_v, t_max=INF):
    """Closest hit by brute force over all triangles; (t, tri, u, v) with
    tri = -1, t = INF on a miss.  Runs the plain twin of the kernel."""
    from caitlynrenderer_tpu_torch.ops.mt_brute import brute_closest_plain

    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    return brute_closest_plain(o, d, active, pack_tris(verts, tri_v), t_max)


def occluded_brute(o, d, t_max, verts, tri_v):
    """Any-hit by brute force.  o, d: (N, 3); t_max: (N,)."""
    from caitlynrenderer_tpu_torch.ops.mt_brute import brute_anyhit_plain

    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    return brute_anyhit_plain(o, d, t_max, active, pack_tris(verts, tri_v))


def refine_hit_tri(o, d, v0, e1, e2):
    """(t, u, v) given per-ray triangle data already gathered (v0, e1, e2),
    e.g. from the fused shading table."""
    _, t, u, v = mt_uvt(o, d, v0, e1, e2)
    return t, u, v


def refine_hit(o, d, tri, verts, tri_v):
    """(t, u, v) recomputed for a known hit triangle per ray (tri < 0 lanes
    read triangle 0; callers mask them)."""
    vid = tri_v.long()[torch.clamp(tri.long(), min=0)]
    v0 = verts[vid[:, 0]]
    return refine_hit_tri(o, d, v0, verts[vid[:, 1]] - v0, verts[vid[:, 2]] - v0)
