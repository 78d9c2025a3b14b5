"""Wide BVH: the binary SAH tree cut into groups (copy of
caitlynrenderer_tpu/accel/wide.py; outputs byte-equal, held against the
original in tests/test_torch_host.py; the reference's docstring keeps the
design history).

The structure is a single level of "groups" — contiguous cuts of the
binary SAH tree, each owning up to Kg triangles packed into one dense
block:

  group_bounds: (G, 6)      — one AABB per group
  packed_tris:  (G, Kg, 9)  — per group: v0, e1, e2 rows, padded
  tri_index:    (G, Kg)     — global (BVH-ordered) triangle id, -1 pad

ops/traverse_mega.pack_mega turns the blocks into Baldwin–Weber planes and
pack_octants the bounds into per-octant worklists for kernel B2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from caitlynrenderer_tpu_torch.accel.bvh import FlatBVH, build_bvh


class WideBVH(NamedTuple):
    """Flat arrays of the streaming wide BVH (all device-ready)."""

    group_bounds: np.ndarray  # (G, 6) f32
    packed_tris: np.ndarray  # (G, Kg, 9) f32
    tri_index: np.ndarray  # (G, Kg) i32

    @property
    def shape(self):
        g, kg, _ = self.packed_tris.shape
        return g, kg


def _subtree_ranges(bvh: FlatBVH):
    """Per-node triangle range (start, count) — each subtree of the SAH
    builder owns a contiguous slice of the reordered triangle array.

    Vectorized fixpoint sweep: children sit at higher BFS indices than
    their parent, so `depth` passes of a dense gather+select converge
    (loop exits at the fixpoint)."""
    meta = bvh.node_meta
    leaf = bvh.is_leaf()
    left = np.where(leaf, 0, meta[:, 0])
    start = np.where(leaf, meta[:, 0], 0).astype(np.int64)
    count = np.where(leaf, meta[:, 1], 0).astype(np.int64)
    for _ in range(256):
        new_start = np.where(leaf, start, start[left])
        new_count = np.where(leaf, count, count[left] + count[left + 1])
        if (new_count == count).all() and (new_start == start).all():
            break
        start, count = new_start, new_count
    return start, count


def _cut_groups(bvh: FlatBVH, max_tris: int):
    """Cut the binary tree into subtrees of ≤ max_tris triangles, in DFS
    order (spatially coherent, contiguous leaf ranges).  Returns
    (start, count, bmin, bmax) arrays."""
    start, count = _subtree_ranges(bvh)
    meta = bvh.node_meta
    leaf = bvh.is_leaf()
    out = []
    stack = [0]
    while stack:
        i = stack.pop()
        if count[i] <= max_tris or leaf[i]:
            out.append(i)
        else:
            l = meta[i, 0]
            stack.append(l + 1)
            stack.append(l)
    ids = np.asarray(out, np.int64)
    return (
        start[ids].astype(np.int32),
        count[ids].astype(np.int32),
        bvh.node_bounds[ids, :3],
        bvh.node_bounds[ids, 3:],
    )


def build_wide(
    vertices: np.ndarray,
    tri_v: np.ndarray,
    bvh: FlatBVH,
    group_tris: int = 256,
    max_g: int = 65536,
) -> WideBVH:
    """Build the streaming wide BVH from an existing binary SAH tree.

    `tri_v` must already be in `bvh.tri_order` order (call after
    `accel.bvh.reorder_scene`).  Raises if the scene exceeds G*Kg
    capacity — raise `group_tris` for bigger scenes."""
    # The reference's kernel streams blocks in 256-triangle slabs; the
    # block stays a multiple of that above one slab, as there.
    kg = group_tris if group_tris <= 256 else -(-group_tris // 256) * 256
    starts, counts, bmns, bmxs = _cut_groups(bvh, kg)
    g = len(starts)
    if g > max_g:
        raise ValueError(
            f"{g} groups exceeds capacity {max_g}; increase group_tris (= {kg})"
        )

    group_bounds = np.concatenate([bmns, bmxs], axis=1).astype(np.float32)

    # tri_index[gi, j] = starts[gi] + j for j < counts[gi], else -1.
    j = np.arange(kg, dtype=np.int32)[None, :]
    tri_index = np.where(j < counts[:, None], starts[:, None] + j, -1)

    # Packed triangles: v0, e1, e2 — padding slots get a degenerate
    # all-zero triangle (masked by tri_index < 0 in the kernel anyway).
    idx = np.maximum(tri_index, 0).reshape(-1)
    vid = tri_v[idx]
    v0 = vertices[vid[:, 0]]
    e1 = vertices[vid[:, 1]] - v0
    e2 = vertices[vid[:, 2]] - v0
    packed = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    packed[tri_index.reshape(-1) < 0] = 0.0

    return WideBVH(
        group_bounds=group_bounds,
        packed_tris=packed.reshape(g, kg, 9),
        tri_index=tri_index.astype(np.int32),
    )
