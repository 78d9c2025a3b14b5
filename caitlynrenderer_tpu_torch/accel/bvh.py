"""Binned SAH BVH builder + flat layout (host pass, vectorized NumPy).

A copy of caitlynrenderer_tpu/accel/bvh.py for the port, which imports
nothing of the JAX package; its outputs are held byte-equal to the
original's in tests/test_torch_host.py.

Capability-matched to the reference's object-split SAH path
(`Caitlyn/sbvh.h:338-389` full-sweep sweep-SAH) and its
flat layout (`sbvh.h:570-609`, `FlatNode.h:34-71`):

* SAH objective  cost = 2*A(node) + A(L)*N_L + A(R)*N_R  (the reference's
  node_sah/leaf_sah weighting, `sbvh.h:250-252`), evaluated over 32
  centroid bins per axis instead of the reference's O(N log N) per-node
  full sorts — same optimum family, far cheaper to build.
* Flat BFS layout with children adjacent (right = left + 1), leaf nodes
  carrying [tri_start, tri_range] and inner nodes [left_child, 0] — the
  exact decode rule the traversal kernels use (`path_trace.fs:536-544`).
* Triangles are reordered so each leaf's range is contiguous
  (`sbvh.h:130-141`).

The builder is iterative (explicit stack, like `sbvh.h:218-283`) and
vectorized per node: binning, bin bounds, and SAH sweeps are NumPy array
ops; only the node stack is Python.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NBINS = 32


class FlatBVH(NamedTuple):
    """Device-ready flat BVH.

    node_bounds: (N, 6) f32 — bmin.xyz, bmax.xyz
    node_meta:   (N, 2) i32 — [left_child, 0] inner / [tri_start, tri_range] leaf
    tri_order:   (T,)  i32 — permutation: new_tri[i] = old_tri[tri_order[i]]
    """

    node_bounds: np.ndarray
    node_meta: np.ndarray
    tri_order: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.node_bounds.shape[0])

    def is_leaf(self) -> np.ndarray:
        return self.node_meta[:, 1] > 0


class _Tree:
    """Pointer-free binary tree under construction (arrays grown append-only)."""

    def __init__(self):
        self.bmin = []
        self.bmax = []
        self.left = []  # child id, or -1 for leaf
        self.right = []
        self.start = []  # leaf triangle range
        self.range = []

    def add(self, bmin, bmax, left=-1, right=-1, start=0, rng=0) -> int:
        self.bmin.append(bmin)
        self.bmax.append(bmax)
        self.left.append(left)
        self.right.append(right)
        self.start.append(start)
        self.range.append(rng)
        return len(self.bmin) - 1


def _sah_split(cent, boxes_min, boxes_max, node_min, node_max):
    """Find the best binned SAH split for one node's references.

    cent: (n, 3) centroids; boxes_min/max: (n, 3) reference bounds;
    node bounds for the cost constant.  Returns (axis, threshold_mask, cost)
    or (None, None, inf) when no split separates the refs.
    """
    n = cent.shape[0]
    cmin = cent.min(axis=0)
    cmax = cent.max(axis=0)
    extent = cmax - cmin
    if not np.any(extent > 0):
        return None, None, np.inf

    # Bin ids per axis: (n, 3)
    scale = np.where(extent > 0, NBINS / np.maximum(extent, 1e-30), 0.0)
    bin_id = np.clip(((cent - cmin) * scale).astype(np.int32), 0, NBINS - 1)

    best = (None, None, np.inf)
    for axis in range(3):
        if extent[axis] <= 0:
            continue
        ids = bin_id[:, axis]
        counts = np.bincount(ids, minlength=NBINS)
        # Per-bin bounds via ufunc.at scatter reductions.
        bmn = np.full((NBINS, 3), np.inf, np.float32)
        bmx = np.full((NBINS, 3), -np.inf, np.float32)
        np.minimum.at(bmn, ids, boxes_min)
        np.maximum.at(bmx, ids, boxes_max)
        # Prefix/suffix bounds and counts for the NBINS-1 candidate planes.
        lmn = np.minimum.accumulate(bmn, axis=0)[:-1]
        lmx = np.maximum.accumulate(bmx, axis=0)[:-1]
        rmn = np.minimum.accumulate(bmn[::-1], axis=0)[::-1][1:]
        rmx = np.maximum.accumulate(bmx[::-1], axis=0)[::-1][1:]
        lcnt = np.cumsum(counts)[:-1]
        rcnt = n - lcnt

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

        cost = area(lmn, lmx) * lcnt + area(rmn, rmx) * rcnt
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if cost[k] < best[2]:
            best = (axis, ids <= k, float(cost[k]))
    return best


def build_bvh(
    vertices: np.ndarray,
    tri_v: np.ndarray,
    max_leaf: int = 4,
    use_native: bool = True,
) -> FlatBVH:
    """Build a binned-SAH BVH over the triangles; returns the flat layout.

    max_leaf: maximum triangles per leaf (the reference splits down to
    1-triangle leaves via `convert_to_bvh1`, `sbvh.h:285-324`; wider leaves
    amortize better on the TPU's vector units, where a leaf's whole
    triangle block is intersected in one masked batched step).

    Uses the native C++ builder (csrc/bvh_builder.cpp) when available —
    same algorithm and layout, ~50× faster on large scenes; the NumPy path
    below is the reference implementation and fallback.
    """
    t = tri_v.shape[0]
    v0 = vertices[tri_v[:, 0]]
    v1 = vertices[tri_v[:, 1]]
    v2 = vertices[tri_v[:, 2]]
    boxes_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    boxes_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    cent = ((boxes_min + boxes_max) * 0.5).astype(np.float32)

    if use_native and t > 1024:
        from caitlynrenderer_tpu_torch.accel.native import build_bvh_native

        out = build_bvh_native(boxes_min, boxes_max, cent, max_leaf)
        if out is not None:
            nb, nm, order = out
            return FlatBVH(node_bounds=nb, node_meta=nm, tri_order=order)

    order = np.arange(t, dtype=np.int32)  # permutation under construction
    tree = _Tree()
    root = tree.add(
        boxes_min.min(axis=0) if t else np.zeros(3, np.float32),
        boxes_max.max(axis=0) if t else np.zeros(3, np.float32),
    )
    # Stack of (node_id, start, end) ranges into `order`.
    stack = [(root, 0, t)]
    leaf_ranges = []  # (node_id, start, count) to fill after ordering is final

    while stack:
        node_id, start, end = stack.pop()
        n = end - start
        ids = order[start:end]
        nb_min = boxes_min[ids].min(axis=0)
        nb_max = boxes_max[ids].max(axis=0)
        tree.bmin[node_id] = nb_min
        tree.bmax[node_id] = nb_max

        if n <= max_leaf:
            tree.start[node_id] = start
            tree.range[node_id] = n
            continue

        axis, go_left, cost = _sah_split(
            cent[ids], boxes_min[ids], boxes_max[ids], nb_min, nb_max
        )
        if axis is None:
            # Degenerate (all centroids equal): median split by index.
            mid = start + n // 2
        else:
            nl = int(go_left.sum())
            order[start:end] = np.concatenate([ids[go_left], ids[~go_left]])
            mid = start + nl

        left_id = tree.add(None, None)
        right_id = tree.add(None, None)
        tree.left[node_id] = left_id
        tree.right[node_id] = right_id
        stack.append((right_id, mid, end))
        stack.append((left_id, start, mid))

    return _flatten(tree, order)


def _flatten(tree: _Tree, order: np.ndarray) -> FlatBVH:
    """BFS flatten with children adjacent (right = left + 1), like the
    reference (`sbvh.h:570-609`); leaves index the reordered triangle
    array contiguously."""
    n_nodes = len(tree.bmin)
    node_bounds = np.zeros((n_nodes, 6), np.float32)
    node_meta = np.zeros((n_nodes, 2), np.int32)

    # BFS order assignment.
    flat_id = {}
    bfs = [0]
    head = 0
    while head < len(bfs):
        nid = bfs[head]
        flat_id[nid] = head
        head += 1
        if tree.left[nid] != -1:
            bfs.append(tree.left[nid])
            bfs.append(tree.right[nid])

    for new_i, nid in enumerate(bfs):
        node_bounds[new_i, :3] = tree.bmin[nid]
        node_bounds[new_i, 3:] = tree.bmax[nid]
        if tree.left[nid] == -1:
            node_meta[new_i] = (tree.start[nid], tree.range[nid])
        else:
            node_meta[new_i] = (flat_id[tree.left[nid]], 0)

    return FlatBVH(node_bounds=node_bounds, node_meta=node_meta, tri_order=order)


def reorder_scene(scene, bvh: FlatBVH):
    """Apply the BVH's triangle permutation to the scene arrays so leaves
    index contiguously (reference reorder, `sbvh.h:130-141`)."""
    p = bvh.tri_order
    return scene._replace(
        tri_v=scene.tri_v[p],
        tri_vn=scene.tri_vn[p],
        tri_vt=scene.tri_vt[p],
    )


def tree_depth(node_meta: np.ndarray) -> int:
    """Depth of the flat tree (nodes on the longest root→leaf path).

    The vectorized traversal's per-ray stack holds at most one entry per
    inner level, so `max_stack = tree_depth(meta)` can never overflow —
    callers size the (static) stack from the actual build instead of the
    reference's fixed 12/16-deep arrays (`path_trace.fs:513,674`), which
    silently corrupt on deeper trees.  Level-order frontier sweep: O(depth)
    vectorized iterations, no per-node Python loop."""
    meta = np.asarray(node_meta)
    if meta.shape[0] == 0:
        return 0
    frontier = np.array([0], np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        inner = frontier[meta[frontier, 1] == 0]
        left = meta[inner, 0].astype(np.int64)
        frontier = np.concatenate([left, left + 1])
    return depth


def sah_cost(bvh: FlatBVH) -> float:
    """Total SAH cost of the tree (for build-quality logging/metrics)."""
    d = np.maximum(bvh.node_bounds[:, 3:] - bvh.node_bounds[:, :3], 0.0)
    area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    root_area = max(float(area[0]), 1e-20)
    leaf = bvh.is_leaf()
    cost_inner = float(area[~leaf].sum()) / root_area
    cost_leaf = float((area[leaf] * bvh.node_meta[leaf, 1]).sum()) / root_area
    return cost_inner + cost_leaf
