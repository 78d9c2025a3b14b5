"""CWBVH node8 walk in plain torch ops (counterpart of
caitlynrenderer_tpu/ops/traverse_cwbvh.py, the reference's XLA walk).

This is not a kernel: it is the walk the reference runs where it does not
launch its Pallas kernel, a masked whole-batch stack machine that loops
while any lane is live, as ops/traverse_bvh.py is for the binary tree.
The integrator runs it under options.traversal = "xla"; under "auto" the
CWBVH queries go to ops/traverse_cw8.py (kernel B3, or its twin).

Per lane, the reference's decode: octant-inverse mask, MSB-first child
pop, popcount relative indexing, byte-sliced quantized slab tests, and a
node's triangle group tested as one dense block of up to 24 triangles.
The node words arrive as int32 (scene.py keeps the uint32 words bit for
bit); every word is widened to int64 and masked to its 32 bits before a
byte is extracted or a bit counted, so a sign never reaches a child index.
"""

from __future__ import annotations

import torch

from caitlynrenderer_tpu_torch.ops.intersect import mt_uvt

INF = 1e9
STACK = 16  # the reference's stack slots
_M32 = 0xFFFFFFFF


def _byte(x, i: int):
    return (x >> (8 * i)) & 0xFF


def _find_msb(x):
    """Index of the highest set bit of each x (int64 holding a nonzero
    uint32): frexp of the exactly representable float64."""
    return torch.frexp(x.double()).exponent.long() - 1


def _bit(i):
    """1 << i of each i (int64)."""
    return torch.bitwise_left_shift(torch.ones_like(i), i)


def _popcount(x):
    """Set bits of each x (int64 holding a uint32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _oct_inv4(d):
    """Octant-inverse of each direction, replicated to the 4 bytes."""
    zero = torch.zeros((), dtype=torch.int64, device=d.device)
    return (torch.where(d[:, 0] < 0, zero, 0x04040404)
            | torch.where(d[:, 1] < 0, zero, 0x02020202)
            | torch.where(d[:, 2] < 0, zero, 0x01010101))


def _node_intersect(o, d, d_inv, oct_inv4, max_t, node):
    """Every lane against its fetched node8: node (N, 20) int32 words.
    Returns hit_mask (N,) int64 holding a uint32: the high byte, the inner
    children hit (by slot ^ octant), the low 24 bits, the triangles of the
    leaf children hit."""
    p = node[:, 0:3].contiguous().view(torch.float32)
    w = node.long() & _M32
    e_imask = w[:, 3]
    adj_inv = torch.stack([(_byte(e_imask, i) << 23).to(torch.int32).view(torch.float32)
                           for i in range(3)], dim=-1) * d_inv
    adj_org = (p - o) * d_inv
    neg = [d[:, a] < 0 for a in range(3)]

    hit_mask = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for half in range(2):  # children 0-3, then 4-7
        meta4 = w[:, 6 + half]
        is_inner4 = (meta4 & (meta4 << 1)) & 0x10101010
        inner_mask4 = (((is_inner4 << 3) >> 7) & 0x01010101) * 0xFF
        bit_index4 = (meta4 ^ (oct_inv4 & inner_mask4)) & 0x1F1F1F1F
        child_bits4 = (meta4 >> 5) & 0x07070707
        lo = [w[:, 8 + 4 * a + half] for a in range(3)]
        hi = [w[:, 10 + 4 * a + half] for a in range(3)]
        q_min = [torch.where(neg[a], hi[a], lo[a]) for a in range(3)]
        q_max = [torch.where(neg[a], lo[a], hi[a]) for a in range(3)]
        for j in range(4):
            near = [_byte(q_min[a], j).to(torch.float32) * adj_inv[:, a] + adj_org[:, a]
                    for a in range(3)]
            far = [_byte(q_max[a], j).to(torch.float32) * adj_inv[:, a] + adj_org[:, a]
                   for a in range(3)]
            tmin = torch.maximum(torch.maximum(near[0], near[1]), near[2])
            tmax = torch.minimum(torch.minimum(far[0], far[1]), far[2])
            # The exact overlap of [tmin, tmax] with [0, max_t), as the
            # reference's walk (not its GLSL original's culling quirks).
            hit = (tmax >= 0.0) & (tmin < max_t) & (tmin <= tmax)
            bits = (_byte(child_bits4, j) << _byte(bit_index4, j)) & _M32
            hit_mask = hit_mask | torch.where(hit, bits, 0)
    return hit_mask


def _mt24(o, d, tri_base, tri_mask, packed_tris, t_best):
    """Triangles tri_base + j for every set bit j of tri_mask (up to 24),
    densely: the nearest accepted (t, slot, u, v) per lane, t = INF where
    none is."""
    n = o.shape[0]
    k = torch.arange(24, dtype=torch.int64, device=o.device)
    idx = torch.clamp(tri_base[:, None] + k[None, :], 0, packed_tris.shape[0] - 1)
    tris = packed_tris[idx]  # (N, 24, 9)
    valid = ((tri_mask[:, None] >> k[None, :]) & 1) == 1
    _, t, u, v = mt_uvt(o[:, None, :], d[:, None, :], tris[..., 0:3], tris[..., 3:6],
                        tris[..., 6:9])
    ok = (valid & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= 0)
          & (t < t_best[:, None]))
    t_cand = torch.where(ok, t, INF)
    slot = torch.argmin(t_cand, dim=1)  # the first index of the minimum
    rows = torch.arange(n, device=o.device)
    return t_cand[rows, slot], idx[rows, slot], u[rows, slot], v[rows, slot]


def _traverse(o, d, active, cw_nodes, packed_tris, depth: int, t_limit, any_hit: bool):
    """The walk of every lane; t_limit (N,) is each ray's upper bound.
    Returns (t, tri, u, v, occluded)."""
    if depth - 1 > STACK:
        raise ValueError(f"node8 tree of depth {depth} needs {depth - 1} stack slots; the "
                         f"walk has {STACK}")
    n, dev = o.shape[0], o.device
    i64 = torch.int64
    rows = torch.arange(n, device=dev)
    d_inv = 1.0 / d
    oct_inv4 = _oct_inv4(d)
    oct_byte = oct_inv4 & 0xFF

    cg_x = torch.zeros(n, dtype=i64, device=dev)
    cg_y = torch.where(active, 0x80000000, torch.zeros((), dtype=i64, device=dev))
    stack = torch.zeros((n, STACK, 2), dtype=i64, device=dev)
    sp = torch.zeros(n, dtype=i64, device=dev)
    t = t_limit.clone()
    tri = torch.full((n,), -1, dtype=i64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if cw_nodes.shape[0] == 0:
        cg_y.zero_()

    while True:
        lane = (sp > 0) | (cg_y != 0)
        if any_hit:
            lane = lane & ~occ
        if not bool(lane.any()):
            break
        is_node_group = (cg_y & 0xFF000000) != 0

        # A node group: pop its highest child, push the rest.
        safe_imask = torch.where(is_node_group, cg_y, 0x80000000)
        child_off = _find_msb(safe_imask)
        cleared_y = cg_y & ~_bit(child_off) & _M32
        push = is_node_group & ((cleared_y & 0xFF000000) != 0) & lane
        slot_i = torch.clamp(sp, max=STACK - 1)
        stack[rows, slot_i, 0] = torch.where(push, cg_x, stack[rows, slot_i, 0])
        stack[rows, slot_i, 1] = torch.where(push, cleared_y, stack[rows, slot_i, 1])
        sp = torch.where(push, sp + 1, sp)

        slot_index = (child_off - 24) ^ oct_byte
        rel = _popcount(cg_y & (_bit(torch.clamp(slot_index, 0, 31)) - 1))
        fetch = torch.where(lane & is_node_group, cg_x + rel, 0)
        node = cw_nodes[torch.clamp(fetch, 0, cw_nodes.shape[0] - 1)]  # (N, 20) int32

        hit_mask = _node_intersect(o, d, d_inv, oct_inv4, t, node)
        w = node.long() & _M32
        ng_y = (hit_mask & 0xFF000000) | _byte(w[:, 3], 3)
        tg_x = torch.where(is_node_group, w[:, 5], cg_x)
        tg_y = torch.where(is_node_group, hit_mask & 0x00FFFFFF, cg_y)
        new_x = torch.where(is_node_group, w[:, 4], 0)
        new_y = torch.where(is_node_group, ng_y, 0)

        # The triangle group, in one dense block.
        do_tris = lane & (tg_y != 0)
        t_c, tri_c, u_c, v_c = _mt24(o, d, tg_x, torch.where(do_tris, tg_y, 0), packed_tris, t)
        better = do_tris & (t_c < t)
        t = torch.where(better, t_c, t)
        tri = torch.where(better, tri_c, tri)
        u = torch.where(better, u_c, u)
        v = torch.where(better, v_c, v)
        if any_hit:
            occ = occ | better

        # Pop where the new group has no child left; end where the stack is
        # empty too.
        empty = (new_y & 0xFF000000) == 0
        can_pop = empty & (sp > 0) & lane
        pop_slot = torch.clamp(sp - 1, min=0)
        new_x = torch.where(can_pop, stack[rows, pop_slot, 0], new_x)
        new_y = torch.where(can_pop, stack[rows, pop_slot, 1], new_y)
        sp = torch.where(can_pop, sp - 1, sp)
        new_y = torch.where(empty & ~can_pop, 0, new_y)

        cg_x = torch.where(lane, new_x, cg_x)
        cg_y = torch.where(lane, new_y, cg_y)
    return t, tri.to(torch.int32), u, v, occ


def cwbvh_closest(o, d, active, cw_nodes, packed_tris, depth: int):
    """Closest hit through the node8 tree.  o, d: (N, 3) f32; active: (N,)
    bool; cw_nodes: (N8, 20) int32 node words; packed_tris: (T, 9) f32 v0 |
    e1 | e2 rows in the tree's triangle order (DeviceScene.tris9 of a
    "cwbvh" upload); depth: the tree's levels (DeviceScene.cw_depth).
    Returns (t, tri, u, v): t = INF, tri = -1 on a miss or an inactive
    lane."""
    t_limit = torch.full((o.shape[0],), INF, dtype=torch.float32, device=o.device)
    t, tri, u, v, _ = _traverse(o, d, active, cw_nodes, packed_tris, depth, t_limit, False)
    return torch.where(tri >= 0, t, INF), tri, u, v


def cwbvh_anyhit(o, d, t_max, active, cw_nodes, packed_tris, depth: int):
    """Whether each active ray meets a triangle at 0 <= t < t_max (N,)."""
    return _traverse(o, d, active, cw_nodes, packed_tris, depth, t_max.to(torch.float32),
                     True)[4]
