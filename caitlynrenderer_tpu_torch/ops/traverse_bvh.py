"""Binary-BVH closest-hit and any-hit queries (counterpart of
caitlynrenderer_tpu/ops/traverse_xla.py), for the "bvh2" and "sbvh"
accelerators: kernel B4.

`traverse_closest` and `traverse_anyhit` launch the hand-written CUDA kernel
(csrc/traverse_bvh.cu, v2: one thread per ray with its own stack, over
child-pair records and the tris9 slab) for CUDA tensors and run the plain
PyTorch twin for CPU tensors; there is no fallback from one to the other.
The kernel reads nothing back to the host, so a CUDA graph captures it like
the other kernels.

`pack_bvh_pairs` packs a FlatBVH into the kernel's records at upload
(scene.DeviceScene.bvh_pairs): record k holds nodes 2k - 1 and 2k, both
boxes then both (left, count) metas, 64 bytes, so the two children (left,
left + 1) of an inner node are one record, (left + 1) // 2, and record 0
holds the root in its second slot.  It raises on a tree whose children do
not come in such pairs.

The twins (`traverse_closest_plain`, `traverse_anyhit_plain`) are a
vectorized per-ray stack machine over the FlatBVH itself: every ray carries
its own node, stack pointer and stack as rows of dense tensors, and a
`while` loop steps the whole batch with masked updates until every lane has
finished, reading the live lane count on the host at every step.  Per step,
an inner node slab-tests both children with the reference's acceptance
(t_far > 0, t_far >= t_near, t_near < t_best), goes to the nearer hit child
and pushes the other; a leaf runs a `max_leaf`-wide Möller–Trumbore block
over its contiguous triangle range.  They are the CPU path and the oracle
the kernel is held against on the card, bit for bit.

The stack is `max_stack` deep and never clamped: a push past it raises
ValueError in the twin and traps in the kernel (the integrator sizes it
from the build first, see render/integrator._check_stack).  The kernel
takes a stack of up to MAX_STACK (128) entries, a tree of depth 127; the
wrapper raises above that, and the integrator refuses such a tree on the
card before it launches anything.

`launches` counts kernel launches and twin calls, so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes

import torch

from caitlynrenderer_tpu_torch.ops import _build
from caitlynrenderer_tpu_torch.ops.intersect import moller_trumbore

SOURCE = "caitlynrenderer_tpu_torch/csrc/traverse_bvh.cu"
REPLACES = ("caitlynrenderer_tpu/ops/traverse_xla.py:52 traverse_closest and :160 "
            "traverse_anyhit (XLA lax.while_loop walks, not Pallas kernels)")

INF = 1e9
MAX_STACK = 128  # the deepest stack the kernel is instantiated for
launches = _build.launch_counter("traverse_bvh", {"closest": "bvh2_kernelILb0E",
                                                  "anyhit": "bvh2_kernelILb1E"})
# Launches of the stats variant, apart from `launches`.
stats_launches = {"closest": 0, "anyhit": 0}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # o, d, active, pairs, tris9, tri_v, n, n_recs, nt, max_leaf, max_stack,
    # out_t, out_tri, out_u, out_v, stats, device, stream
    "bvh_closest": (_INT, [_PTR] * 6 + [_INT] * 5 + [_PTR] * 5 + [_INT, _PTR]),
    # o, d, t_max, active, pairs, tris9, tri_v, n, n_recs, nt, max_leaf,
    # max_stack, out_occ, stats, device, stream
    "bvh_anyhit": (_INT, [_PTR] * 7 + [_INT] * 5 + [_PTR] * 2 + [_INT, _PTR]),
    "bvh_error_string": (ctypes.c_char_p, [_INT]),
}

# Per-ray counts of the stats variant, in column order.
STATS = ("inner", "tris", "stack")
# The stats variant's flags, one per row of the FlatBVH's own tables a walk
# over them reads: a node's meta (the walk stood on it), a node's bounds
# (slab-tested as a child), a tri_v row, a vertex.
SEEN = ("meta_seen", "bounds_seen", "tri_seen", "vert_seen")


class _Stats(ctypes.Structure):
    """csrc/traverse_bvh.cu's Stats: the stats variant's buffers."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("t_seed", "counts") + SEEN]


def reset_launches() -> None:
    for counter in (launches, stats_launches):
        for k in counter:
            counter[k] = 0


def _lib():
    return _build.load("traverse_bvh", _SIGNATURES)


def n_records(num_nodes: int) -> int:
    """Rows of `pack_bvh_pairs`' records for a tree of num_nodes nodes."""
    return num_nodes // 2 + 1


def pack_bvh_pairs(node_bounds, node_meta):
    """The kernel's child-pair records of a FlatBVH, on the tensors' device:
    (n_records(Nn), 16) f32.  Record k holds nodes 2k - 1 and 2k: their
    boxes (min | max) in columns 0:6 and 6:12, their (left, count) meta as
    int32 bits in 12:14 and 14:16; record 0's first slot and a last slot
    past the tree are zeros.  A copy, no arithmetic: the floats are the
    FlatBVH's.  Raises ValueError unless every inner node's children are
    a pair (left odd, left + 1 within the tree) after the node, as the BFS
    layout of accel/bvh.py and the native builder's make them (so the walk
    over the records is the walk over the tree, and ends)."""
    nn = node_meta.shape[0]
    meta = node_meta.to(torch.int32)
    left, inner = meta[:, 0].long(), meta[:, 1] == 0
    ids = torch.arange(nn, device=meta.device)
    bad = inner & ((left % 2 != 1) | (left <= ids) | (left + 1 >= nn))
    if bool(bad.any()):
        node = int(bad.nonzero()[0, 0])
        raise ValueError(f"node {node}'s children start at {int(left[node])}: the kernel's "
                         "records take a tree whose children are pairs (left odd, left + 1 "
                         f"< {nn} nodes) after their parent, as the BFS layout makes them")
    rows = 2 * n_records(nn)
    bounds = torch.zeros((rows, 6), dtype=torch.float32, device=meta.device)
    bounds[1:nn + 1] = node_bounds
    metas = torch.zeros((rows, 2), dtype=torch.int32, device=meta.device)
    metas[1:nn + 1] = meta
    return torch.cat([bounds.view(-1, 12), metas.view(torch.float32).view(-1, 4)],
                     dim=1).contiguous()


# --------------------------------------------------------------------------
# Plain twins
# --------------------------------------------------------------------------


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


def traverse_closest_plain(o, d, active, node_bounds, node_meta, verts, tri_v,
                           max_leaf: int = 4, max_stack: int = 32):
    """Plain PyTorch twin of the closest-hit kernel.  o, d: (N, 3) f32;
    active: (N,) bool; node_bounds (Nn, 6) f32 and node_meta (Nn, 2) i32 (a
    FlatBVH); verts (V, 3) f32 and tri_v (T, 4) i32 in the tree's leaf
    order.  Returns (t, tri, u, v): t = INF, tri = -1 on a miss or an
    inactive lane; ties within a leaf go to its first triangle."""
    launches["closest_twin"] += 1
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


def traverse_anyhit_plain(o, d, t_max, active, node_bounds, node_meta, verts, tri_v,
                          max_leaf: int = 4, max_stack: int = 32):
    """Plain PyTorch twin of the any-hit kernel: occlusion of every active
    ray by any triangle at 0 <= t < t_max ((N,) f32), (N,) bool.  A lane
    stops at its first hit."""
    launches["anyhit_twin"] += 1
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


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_query(o, d, active, tree, max_stack, t_max=None, t_seed=None):
    """Validate a CUDA query; returns (n, nn, nv, nt, device)."""
    node_bounds, node_meta, verts, tri_v, pairs, tris9 = tree
    n, dev = o.shape[0], o.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor("o", o, f32, (n, 3), dev)
    _build.check_tensor("d", d, f32, (n, 3), dev)
    _build.check_tensor("active", active, torch.bool, (n,), dev)
    if t_max is not None:
        _build.check_tensor("t_max", t_max, f32, (n,), dev)
    if t_seed is not None:
        _build.check_tensor("t_seed", t_seed, f32, (n,), dev)
    nn, nv, nt = (x.shape[0] if x.dim() == 2 else -1 for x in (node_bounds, verts, tri_v))
    _build.check_tensor("node_bounds", node_bounds, f32, (nn, 6), dev)
    _build.check_tensor("node_meta", node_meta, i32, (nn, 2), dev)
    _build.check_tensor("verts", verts, f32, (nv, 3), dev)
    _build.check_tensor("tri_v", tri_v, i32, (nt, 4), dev)
    _build.check_tensor("pairs", pairs, f32, (n_records(nn), 16), dev)
    _build.check_tensor("tris9", tris9, f32, (nt, 9), dev)
    if n >= 2**30 or nn * 8 >= 2**31 or nv * 3 >= 2**31 or nt * 9 >= 2**31:
        raise ValueError(f"too many rays ({n}), nodes ({nn}), vertices ({nv}) or triangles "
                         f"({nt}) for the kernel's indexing")
    if nt > 0 and nn == 0:
        raise ValueError("a scene with triangles needs a tree: node_bounds has no rows")
    if not 1 <= max_stack <= MAX_STACK:
        raise ValueError(f"max_stack={max_stack}: the kernel takes 1 to {MAX_STACK} entries")
    return n, nn, nv, nt, dev


def _stats_buffers(n, nn, nv, nt, dev, t_seed):
    """Zeroed outputs of the stats variant (see `traverse_closest`) and the
    kernel's Stats over them."""
    i32 = torch.int32
    st = {"counts": torch.zeros((n, len(STATS)), dtype=i32, device=dev)}
    for k, rows in zip(SEEN, (nn, nn, nt, nv)):
        st[k] = torch.zeros((rows,), dtype=i32, device=dev)
    seed = None if t_seed is None else t_seed.data_ptr()
    return st, _Stats(seed, *(st[k].data_ptr() for k in ("counts",) + SEEN))


def _stats_on_cpu(stats, t_seed, cpu):
    """Raise for what only the CUDA stats variant takes; returns cpu."""
    if t_seed is not None and not stats:
        raise ValueError("t_seed seeds the stats variant's walk: give stats=True")
    if stats and cpu:
        raise ValueError("stats=True counts the CUDA kernel's walk: give CUDA tensors")
    return cpu


def _kernel_args(tree, n, nt):
    """The kernel's tree arguments: pairs, tris9, tri_v (read by the stats
    variant's vertex flags), n, n_recs, nt."""
    _, _, _, tri_v, pairs, tris9 = tree
    return [x.data_ptr() for x in (pairs, tris9, tri_v)] + [n, pairs.shape[0], nt]


def _stats_ptr(st_arg):
    """The kernel's Stats* argument: null runs the plain kernel."""
    return None if st_arg is None else ctypes.addressof(st_arg)


def traverse_closest(o, d, active, node_bounds, node_meta, verts, tri_v, pairs, tris9,
                     max_leaf: int = 4, max_stack: int = 32, stats=False, t_seed=None):
    """Closest hit of every active ray over the binary BVH.  Arguments as
    `traverse_closest_plain`, plus the tree's records (`pack_bvh_pairs`)
    and the leaf-ordered (T, 9) v0 | e1 | e2 slab, both (scene.DeviceScene's
    bvh_pairs and tris9) what the kernel reads; result as the twin's.  CPU
    tensors run the twin; CUDA tensors launch the kernel, on the current
    stream, and read nothing back.

    stats=True (CUDA only) launches the stats variant, the same walk, and
    returns (t, tri, u, v, st): st["counts"] (N, 3) i32 per ray, columns
    STATS (inner nodes visited, leaf triangles tested, the stack's
    high-water mark); by FlatBVH row: st["meta_seen"] (Nn,) i32, 1 where
    some ray stood on the node; st["bounds_seen"] (Nn,), 1 where some ray
    slab-tested the node's box; st["tri_seen"] (T,), 1 where some ray tested
    the triangle (its tri_v row, in the FlatBVH's layout); st["vert_seen"]
    (V,), 1 where some ray tested a triangle of the vertex.
    t_seed ((N,) f32, stats only) also rejects a child box entered after the
    seed (relative margin 1e-5), acceptance unchanged: seeded with the
    closest t, the oracle walk, whose counts are the work the query needs."""
    tree = (node_bounds, node_meta, verts, tri_v, pairs, tris9)
    if _stats_on_cpu(stats, t_seed, _build.is_cpu(o, d, active, *tree, t_seed)):
        return traverse_closest_plain(o, d, active, *tree[:4], max_leaf=max_leaf,
                                      max_stack=max_stack)
    n, nn, nv, nt, dev = _check_query(o, d, active, tree, max_stack, t_seed=t_seed)
    st, st_arg = _stats_buffers(n, nn, nv, nt, dev, t_seed) if stats else (None, None)
    if n == 0 or nt == 0:
        t = torch.full((n,), INF, dtype=torch.float32, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
        zero = torch.zeros(n, dtype=torch.float32, device=dev)
        out = (t, tri, zero, zero.clone())
        return (*out, st) if stats else out
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.bvh_closest(
            o.data_ptr(), d.data_ptr(), active.data_ptr(), *_kernel_args(tree, n, nt), max_leaf,
            max_stack, t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            _stats_ptr(st_arg), dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(rc, lib.bvh_error_string, "bvh_closest")
    if stats:
        stats_launches["closest"] += 1
        return t, tri, u, v, st
    launches["closest"] += 1
    return t, tri, u, v


def traverse_anyhit(o, d, t_max, active, node_bounds, node_meta, verts, tri_v, pairs, tris9,
                    max_leaf: int = 4, max_stack: int = 32, stats=False, t_seed=None):
    """Occlusion of every active ray by any triangle at 0 <= t < t_max
    ((N,) f32) over the binary BVH: (N,) bool.  Tree arguments as in
    `traverse_closest`; CUDA tensors launch the kernel.  stats=True (CUDA
    only): returns (occ, st), st and t_seed as in `traverse_closest`."""
    tree = (node_bounds, node_meta, verts, tri_v, pairs, tris9)
    if _stats_on_cpu(stats, t_seed, _build.is_cpu(o, d, t_max, active, *tree, t_seed)):
        return traverse_anyhit_plain(o, d, t_max, active, *tree[:4], max_leaf=max_leaf,
                                     max_stack=max_stack)
    n, nn, nv, nt, dev = _check_query(o, d, active, tree, max_stack, t_max=t_max,
                                      t_seed=t_seed)
    st, st_arg = _stats_buffers(n, nn, nv, nt, dev, t_seed) if stats else (None, None)
    if n == 0 or nt == 0:
        occ = torch.zeros(n, dtype=torch.bool, device=dev)
        return (occ, st) if stats else occ
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.bvh_anyhit(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), active.data_ptr(),
            *_kernel_args(tree, n, nt), max_leaf, max_stack, occ.data_ptr(), _stats_ptr(st_arg),
            dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(rc, lib.bvh_error_string, "bvh_anyhit")
    if stats:
        stats_launches["anyhit"] += 1
        return occ, st
    launches["anyhit"] += 1
    return occ
