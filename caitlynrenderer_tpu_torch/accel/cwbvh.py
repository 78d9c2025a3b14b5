"""CWBVH builder — 8-wide compressed BVH (Ylitie/Karras/Aila 2017 family).

A copy of caitlynrenderer_tpu/accel/cwbvh.py for the port, which imports
nothing of the JAX package; its outputs are held byte-equal to the
original's in tests/test_torch_host.py.

Produces nodes bit-exact to the reference's `node8` texture layout so the
traversal kernel mirrors a known-good decode (`Shader/
cwbvh.fs:355-446` is the layout spec; the reference's own builder
`cwbvh.h` is WIP with known defects — dropped slot assignment at
`cwbvh.h:257`, mis-nested recursion + dangling reference at
`cwbvh.h:296-410` — so this builder is written fresh from the format's
intent, per SURVEY.md §2.9).

Node = 20 uint32 words (5 vec4 texels):
  [0:3]   p.xyz — f32 quantization origin (node AABB min)
  [3]     e_x | e_y<<8 | e_z<<16 | imask<<24 — per-axis scale exponent
          bytes (value = 2^(e-127)) and the inner-child mask
  [4]     child_base — index of the first child node8
  [5]     tri_base — index of the first triangle of this node's leaves
  [6:8]   meta bytes, children 0-3 / 4-7:
            empty: 0
            inner: 0b001_00000 | (24 + slot)
            leaf:  unary-count<<5 | first-tri-offset (≤3 tris, offset ≤ 24)
  [8:10]  q_lo_x children 0-3 / 4-7   [10:12] q_hi_x
  [12:14] q_lo_y / q_hi_y             [16:20] likewise z (lo, hi)

Children are assigned to slots by the octant heuristic (the intent of
`order_children`, `cwbvh.h:206-272`): child k prefers the slot whose
octant direction best matches the child-centroid direction, so the
traversal's `slot ^ oct_inv` pop order approximates front-to-back.

The build is **wave-vectorized** (r2 verdict weak #5: the per-node Python
loops took 16.8 s at 100k tris — unusable for BASELINE config #4's 1M).
Every BFS wave of node8s is processed as dense numpy arrays: the ≤6
expand-largest collapse steps, the 8-round greedy octant slot assignment,
quantization, meta packing, and the triangle reorder are all whole-wave
array ops, so build time scales with tree depth × O(vector work), not
with Python-per-node dispatch (measured ~60× faster at 100k tris).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from caitlynrenderer_tpu_torch.accel.bvh import FlatBVH

MAX_LEAF_TRIS = 3
WIDTH = 8

# Slot octant directions: slot s → (±1, ±1, ±1) from its bits (+ when the
# bit is 0), matching the traversal's `slot ^ oct_inv` ordering intent.
_SLOT_DIRS = np.array(
    [
        [1 if (s & 4) == 0 else -1, 1 if (s & 2) == 0 else -1, 1 if (s & 1) == 0 else -1]
        for s in range(WIDTH)
    ],
    np.float32,
)


class CWBVH(NamedTuple):
    nodes: np.ndarray  # (N8, 20) uint32
    tri_order: np.ndarray  # gather list into the input triangle array


def _collect_children_wave(cur, meta, leaf, count):
    """Collapse every wave node's binary subtree into ≤8 entries at once.

    Returns E (W, 8) int64 binary-node ids (-1 = empty).  Greedy policy
    (the stand-in for the reference's 7-slot DP, `cwbvh.h:75-173`):
    repeatedly expand the entry with the most triangles among those that
    must become inner children anyway (count > MAX_LEAF_TRIS), until the
    node has 8 entries or nothing is expandable."""
    w = cur.shape[0]
    E = np.full((w, WIDTH), -1, np.int64)
    leaflike = leaf[cur] | (count[cur] <= MAX_LEAF_TRIS)
    E[:, 0] = np.where(leaflike, cur, meta[cur, 0])
    n_ent = np.ones(w, np.int64)
    inner_rows = ~leaflike
    E[inner_rows, 1] = meta[cur[inner_rows], 0] + 1
    n_ent[inner_rows] = 2

    rows = np.arange(w)
    for _ in range(WIDTH - 2):  # at most 6 more expansions per node
        valid = E >= 0
        Es = np.maximum(E, 0)
        cnts = np.where(valid, count[Es], -1)
        can_expand = valid & ~leaf[Es] & (cnts > MAX_LEAF_TRIS) & (
            n_ent[:, None] < WIDTH
        )
        any_exp = can_expand.any(axis=1)
        # fallback: any non-leaf entry (only reachable when the binary
        # builder emitted inner nodes with ≤3 tris)
        can_any = valid & ~leaf[Es] & (n_ent[:, None] < WIDTH)
        use_fb = ~any_exp & can_any.any(axis=1)
        act = any_exp | use_fb
        if not act.any():
            break
        # expandable rows: entry with max count (first on ties);
        # fallback rows: first non-leaf entry
        pick = np.where(
            any_exp,
            np.where(can_expand, cnts, -1).argmax(axis=1),
            can_any.argmax(axis=1),
        )
        e = E[rows, pick]
        l = meta[np.maximum(e, 0), 0]
        E[act, pick[act]] = l[act]
        E[act, n_ent[act]] = l[act] + 1
        n_ent[act] += 1
    return E


def _slot_assign_wave(E, bounds, cur):
    """Greedy octant slot assignment for the whole wave (intent of
    `order_children`, `cwbvh.h:206-272`).  Returns slots (W, 8) int64
    (-1 for empty entries): most-constrained child first, each taking its
    best free octant slot."""
    w = E.shape[0]
    valid = E >= 0
    Es = np.maximum(E, 0)
    cent = 0.5 * (bounds[Es, :3] + bounds[Es, 3:])
    pcent = 0.5 * (bounds[cur, :3] + bounds[cur, 3:])
    rel = cent - pcent[:, None, :]
    cost = -np.einsum("wkc,sc->wks", rel, _SLOT_DIRS)  # (W, 8 children, 8 slots)
    INF = np.float32(np.inf)
    cost = np.where(valid[:, :, None], cost, INF)

    order = np.argsort(np.where(valid, cost.min(axis=2), INF), axis=1, kind="stable")
    slots = np.full((w, WIDTH), -1, np.int64)
    used = np.zeros((w, WIDTH), bool)
    rows = np.arange(w)
    for r in range(WIDTH):
        c = order[:, r]
        ok = valid[rows, c]
        crow = np.where(used, INF, cost[rows, c])  # (W, 8 slots)
        s = crow.argmin(axis=1)
        slots[rows[ok], c[ok]] = s[ok]
        used[rows[ok], s[ok]] = True
    # Park invalid entries on the leftover slots so every row's slot
    # vector is a permutation of 0..7 — the packing scatters below can
    # then write whole rows without duplicate-index clobbering.
    free = np.argsort(used, axis=1, kind="stable")  # unused slots first
    inv_rank = np.cumsum(~valid, axis=1) - 1
    fill = np.take_along_axis(free, np.maximum(inv_rank, 0), axis=1)
    slots = np.where(valid, slots, fill)
    return slots


def build_cwbvh(bvh: FlatBVH, vertices: np.ndarray, tri_v: np.ndarray) -> CWBVH:
    """Compress a binary FlatBVH into the 8-wide node8 array.

    `tri_v` must be in `bvh` leaf order (after reorder_scene); the returned
    `tri_order` is a further gather list (node-contiguous leaf triangles).
    The binary tree must have leaves of ≤ 3 triangles (the format's unary
    count is 3 bits with max offset 24) — build with max_leaf <= 3.
    """
    assert bvh.node_meta[bvh.is_leaf(), 1].max(initial=0) <= MAX_LEAF_TRIS, (
        "cwbvh requires a binary BVH built with max_leaf <= 3"
    )
    from caitlynrenderer_tpu_torch.accel.wide import _subtree_ranges

    start, count = _subtree_ranges(bvh)
    meta = bvh.node_meta.astype(np.int64)
    leaf = bvh.is_leaf()
    bounds = bvh.node_bounds

    waves = []  # list of per-wave packed word arrays
    tri_chunks = []
    cur = np.array([0], np.int64)  # binary roots of this wave's node8s
    base8 = 0  # node8 index of this wave's first node
    tri_done = 0

    while cur.size:
        w = cur.shape[0]
        rows = np.arange(w)
        E = _collect_children_wave(cur, meta, leaf, count)
        valid = E >= 0
        Es = np.maximum(E, 0)
        slots = _slot_assign_wave(E, bounds, cur)

        p = bounds[cur, :3].astype(np.float32)
        extent = np.maximum(bounds[cur, 3:] - p, 1e-12)
        e = np.clip(np.ceil(np.log2(extent / 255.0)).astype(np.int64) + 127, 1, 254)
        scale = np.exp2((e - 127).astype(np.float64))  # (W, 3)

        is_leaf_child = valid & (leaf[Es] | (count[Es] <= MAX_LEAF_TRIS))
        is_inner = valid & ~is_leaf_child

        # --- triangle accounting (entry order within a node, node order
        # within the wave — must match the tri_order appends below)
        cnt = np.where(is_leaf_child, count[Es], 0)  # (W, 8)
        off = np.cumsum(cnt, axis=1) - cnt  # exclusive per-row
        row_tot = cnt.sum(axis=1)
        tri_base = tri_done + np.cumsum(row_tot) - row_tot  # (W,)

        # tri_order appends: for each leaf entry in (row, entry) order,
        # the range [start[e], start[e]+cnt).  Vectorized repeat+cumsum.
        flat_cnt = cnt.ravel()
        flat_start = np.where(is_leaf_child, start[Es], 0).ravel()
        reps = flat_cnt
        if reps.sum():
            starts_rep = np.repeat(flat_start, reps)
            # within-range offsets: arange per segment
            seg_end = np.cumsum(reps)
            idx = np.arange(seg_end[-1])
            seg_begin = np.repeat(seg_end - reps, reps)
            tri_chunks.append((starts_rep + idx - seg_begin).astype(np.int32))
        tri_done += int(row_tot.sum())

        # --- meta bytes
        meta8 = np.zeros((w, WIDTH), np.uint32)  # indexed by SLOT
        sl = np.maximum(slots, 0)
        leaf_meta = (((np.uint32(1) << cnt.astype(np.uint32)) - 1) << 5) | off.astype(
            np.uint32
        )
        inner_meta = np.uint32(0x20) | (24 + sl).astype(np.uint32)
        entry_meta = np.where(
            is_leaf_child, leaf_meta, np.where(is_inner, inner_meta, 0)
        ).astype(np.uint32)
        np.put_along_axis(meta8, sl, np.where(valid, entry_meta, 0), axis=1)
        imask = (
            (np.where(is_inner, np.uint32(1), np.uint32(0)) << sl.astype(np.uint32))
            .sum(axis=1)
            .astype(np.uint32)
        )

        # --- quantized child boxes, by slot
        blo = np.where(valid[:, :, None], bounds[Es, :3], 0.0)
        bhi = np.where(valid[:, :, None], bounds[Es, 3:], 0.0)
        q_lo_e = np.clip(
            np.floor((blo - p[:, None, :]) / scale[:, None, :]), 0, 255
        ).astype(np.uint32)
        q_hi_e = np.clip(
            np.ceil((bhi - p[:, None, :]) / scale[:, None, :]), 0, 255
        ).astype(np.uint32)
        q_lo = np.zeros((w, WIDTH, 3), np.uint32)
        q_hi = np.zeros((w, WIDTH, 3), np.uint32)
        np.put_along_axis(q_lo, sl[:, :, None], np.where(valid[:, :, None], q_lo_e, 0), axis=1)
        np.put_along_axis(q_hi, sl[:, :, None], np.where(valid[:, :, None], q_hi_e, 0), axis=1)

        # --- next wave: inner children in (row, slot) order; child_base
        n_inner = is_inner.sum(axis=1)
        next_base = base8 + w
        child_base = next_base + np.cumsum(n_inner) - n_inner
        # order inner entries of each row by slot
        slot_key = np.where(is_inner, slots, WIDTH + 1)
        ordr = np.argsort(slot_key, axis=1, kind="stable")
        E_by_slot = np.take_along_axis(E, ordr, axis=1)
        inner_sorted = np.take_along_axis(is_inner, ordr, axis=1)
        nxt = E_by_slot[inner_sorted]

        # --- pack words
        words = np.zeros((w, 20), np.uint32)
        words[:, 0:3] = p.view(np.uint32)
        words[:, 3] = (
            e[:, 0].astype(np.uint32)
            | (e[:, 1].astype(np.uint32) << 8)
            | (e[:, 2].astype(np.uint32) << 16)
            | (imask << 24)
        )
        words[:, 4] = np.where(n_inner > 0, child_base, 0).astype(np.uint32)
        words[:, 5] = tri_base.astype(np.uint32)
        words[:, 6] = (
            meta8[:, 0] | (meta8[:, 1] << 8) | (meta8[:, 2] << 16) | (meta8[:, 3] << 24)
        )
        words[:, 7] = (
            meta8[:, 4] | (meta8[:, 5] << 8) | (meta8[:, 6] << 16) | (meta8[:, 7] << 24)
        )

        def pack4(vals):  # (W, 4) uint32 bytes → (W,) uint32
            return vals[:, 0] | (vals[:, 1] << 8) | (vals[:, 2] << 16) | (vals[:, 3] << 24)

        for axis, wbase in ((0, 8), (1, 12), (2, 16)):
            words[:, wbase + 0] = pack4(q_lo[:, 0:4, axis])
            words[:, wbase + 1] = pack4(q_lo[:, 4:8, axis])
            words[:, wbase + 2] = pack4(q_hi[:, 0:4, axis])
            words[:, wbase + 3] = pack4(q_hi[:, 4:8, axis])

        waves.append(words)
        base8 = next_base
        cur = nxt

    nodes = np.concatenate(waves, axis=0).astype(np.uint32)
    tri_order = (
        np.concatenate(tri_chunks) if tri_chunks else np.zeros(0, np.int32)
    )
    return CWBVH(nodes=nodes, tri_order=tri_order)
