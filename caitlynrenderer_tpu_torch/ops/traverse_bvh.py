"""Binary-BVH closest-hit and any-hit traversal on tensors (counterpart of
caitlynrenderer_tpu/ops/traverse_xla.py), for the "bvh2" and "sbvh"
accelerators.

A vectorized per-ray stack machine: every ray carries its own node, stack
pointer and stack as rows of dense tensors, and a `while` loop steps the
whole batch with masked updates until every lane has finished.  Per step,
an inner node slab-tests both children with the reference's acceptance
(t_far > 0, t_far >= t_near, t_near < t_best), goes to the nearer hit child
and pushes the other; a leaf runs a `max_leaf`-wide Möller–Trumbore block
over its contiguous triangle range.  The reference computes this in XLA,
not in a Pallas kernel, so it runs as plain torch ops on every device.

The stack is `max_stack` deep and never clamped: a push past it raises
ValueError (the integrator sizes it from the build first, see
render/integrator._check_stack).
"""

from __future__ import annotations

import torch

from caitlynrenderer_tpu_torch.ops.intersect import moller_trumbore

INF = 1e9


def _slab(o, d_inv, b):
    """(t_near, t_far) of rays against boxes b (N, 6) = min | max."""
    t0 = (b[:, :3] - o) * d_inv
    t1 = (b[:, 3:] - o) * d_inv
    return torch.minimum(t0, t1).amax(dim=1), torch.maximum(t0, t1).amin(dim=1)


def _children(o, d_inv, t_limit, left, node_bounds):
    """Slab-test both children (left, left + 1) of each lane's node.
    Returns (hit_l, hit_r, near_l, near_r)."""
    last = node_bounds.shape[0] - 1
    tl_near, tl_far = _slab(o, d_inv, node_bounds[left.clamp(0, last)])
    tr_near, tr_far = _slab(o, d_inv, node_bounds[(left + 1).clamp(0, last)])
    hit_l = (tl_far > 0) & (tl_far >= tl_near) & (tl_near < t_limit)
    hit_r = (tr_far > 0) & (tr_far >= tr_near) & (tr_near < t_limit)
    return hit_l, hit_r, tl_near, tr_near


def _leaf_triangles(left, rng, is_leaf, max_leaf, verts, tri_v):
    """(tri_idx, valid, v0, e1, e2) of each lane's leaf block, (N, K, ...)."""
    k = torch.arange(max_leaf, device=left.device)
    tri_idx = left[:, None] + k[None, :]
    valid = is_leaf[:, None] & (k[None, :] < rng[:, None])
    vid = tri_v[tri_idx.clamp(0, tri_v.shape[0] - 1)].long()
    v0 = verts[vid[..., 0]]
    return tri_idx, valid, v0, verts[vid[..., 1]] - v0, verts[vid[..., 2]] - v0


class _Walk:
    """Per-lane walk state and its step: near-child-first descent, push the
    far child, pop at leaves and at inner nodes that hit nothing."""

    def __init__(self, active, max_stack):
        n, dev = active.shape[0], active.device
        self.rows = torch.arange(n, device=dev)
        self.ind = torch.where(active, 0, -1)
        self.ptr = torch.zeros(n, dtype=torch.int64, device=dev)
        self.stack = torch.full((n, max_stack), -1, dtype=torch.int64, device=dev)
        self.overflow = torch.zeros((), dtype=torch.bool, device=dev)

    def live(self):
        return self.ind > -1

    def running(self) -> bool:
        """True while some lane walks; raises once a push went past the
        stack (one host sync per step)."""
        live, overflow = torch.stack([self.live().any(), self.overflow]).tolist()
        if overflow:
            raise ValueError(f"BVH traversal stack overflow (max_stack={self.stack.shape[1]}); "
                             "size it with scene.required_stack(ds)")
        return live

    def node(self, node_meta):
        """(lane, left, rng, is_leaf, is_inner) of each lane's node."""
        lane = self.live()
        meta = node_meta[self.ind.clamp(min=0)].long()
        left, rng = meta[:, 0], meta[:, 1]
        return lane, left, rng, lane & (rng > 0), lane & (rng == 0)

    def advance(self, lane, left, is_inner, hit_l, hit_r, near_l, near_r):
        hit_l = hit_l & is_inner
        hit_r = hit_r & is_inner
        both = hit_l & hit_r
        go_right_first = both & (near_l > near_r)
        next_inner = torch.where(hit_l & ~go_right_first, left,
                                 torch.where(hit_r, left + 1, -1))
        push_val = torch.where(go_right_first, left, left + 1)
        max_stack = self.stack.shape[1]
        self.overflow |= (both & (self.ptr >= max_stack)).any()
        # An overflowing push lands on the top slot, and running() raises
        # before the walk goes on.
        slot = self.ptr.clamp(max=max_stack - 1)
        cur = self.stack[self.rows, slot]
        self.stack[self.rows, slot] = torch.where(both, push_val, cur)
        ptr = torch.where(both, self.ptr + 1, self.ptr)
        descend = is_inner & (next_inner >= 0)
        need_pop = lane & ~descend
        popped = torch.where(ptr > 0, self.stack[self.rows, (ptr - 1).clamp(0, max_stack - 1)], -1)
        self.ind = torch.where(descend, next_inner, torch.where(need_pop, popped, self.ind))
        self.ptr = torch.where(need_pop & (ptr > 0), ptr - 1, ptr)


def traverse_closest(o, d, active, node_bounds, node_meta, verts, tri_v,
                     max_leaf: int = 4, max_stack: int = 32):
    """Closest hit of every active ray.  o, d: (N, 3) f32; active: (N,)
    bool; node_bounds (Nn, 6) f32 and node_meta (Nn, 2) i32 (a FlatBVH);
    verts (V, 3) f32 and tri_v (T, 4) i32 in the tree's leaf order.
    Returns (t, tri, u, v): t = INF, tri = -1 on a miss; ties within a leaf
    go to its first triangle."""
    n, dev = o.shape[0], o.device
    t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    if tri_v.shape[0] == 0:
        return t, tri.int(), u, v
    d_inv = 1.0 / d
    walk = _Walk(active, max_stack)
    while walk.running():
        lane, left, rng, is_leaf, is_inner = walk.node(node_meta)
        hits = _children(o, d_inv, t, left, node_bounds)
        tri_idx, valid, v0, e1, e2 = _leaf_triangles(left, rng, is_leaf, max_leaf, verts, tri_v)
        hit, tc, uc, vc = moller_trumbore(o[:, None, :], d[:, None, :], v0, e1, e2, t[:, None])
        t_cand = torch.where(hit & valid, tc, INF)
        k_best = t_cand.argmin(dim=1)  # first index of the minimum
        t_new = t_cand[walk.rows, k_best]
        improved = t_new < t
        t = torch.where(improved, t_new, t)
        tri = torch.where(improved, tri_idx[walk.rows, k_best], tri)
        u = torch.where(improved, uc[walk.rows, k_best], u)
        v = torch.where(improved, vc[walk.rows, k_best], v)
        walk.advance(lane, left, is_inner, *hits)
    return t, torch.where(t >= INF, -1, tri).int(), u, v


def traverse_anyhit(o, d, t_max, active, node_bounds, node_meta, verts, tri_v,
                    max_leaf: int = 4, max_stack: int = 32):
    """Occlusion of every active ray by any triangle at 0 <= t < t_max
    ((N,) f32): (N,) bool.  A lane stops at its first hit."""
    n, dev = o.shape[0], o.device
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    if tri_v.shape[0] == 0:
        return occluded
    d_inv = 1.0 / d
    walk = _Walk(active, max_stack)
    while walk.running():
        lane, left, rng, is_leaf, is_inner = walk.node(node_meta)
        hits = _children(o, d_inv, t_max, left, node_bounds)
        _, valid, v0, e1, e2 = _leaf_triangles(left, rng, is_leaf, max_leaf, verts, tri_v)
        hit, _, _, _ = moller_trumbore(o[:, None, :], d[:, None, :], v0, e1, e2, t_max[:, None])
        occluded = occluded | (hit & valid).any(dim=1)
        walk.advance(lane, left, is_inner, *hits)
        walk.ind = torch.where(occluded, -1, walk.ind)
    return occluded
