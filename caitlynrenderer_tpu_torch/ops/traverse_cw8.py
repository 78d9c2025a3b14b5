"""CWBVH closest-hit and any-hit queries (counterpart of
caitlynrenderer_tpu/ops/traverse_cw8.py).

The 8-wide compressed BVH (accel/cwbvh.py) lives on the device as its
node8 table, (N8, 20) int32 tensors holding accel/cwbvh.py's uint32 words bit
for bit (torch's uint32 supports few operations; the kernel reads the words
as uint32), and the Baldwin–Weber planes of the cwbvh-ordered triangles in
windows of 32 (`pack_cw8`).  `cw8_closest` and `cw8_anyhit` launch the
hand-written CUDA kernel (csrc/traverse_cw8.cu) for CUDA tensors and run
the plain PyTorch twin for CPU tensors; there is no fallback from one to
the other.  The twins (`cw8_closest_plain`, `cw8_anyhit_plain`) clamp each
ray to the scene box and sweep every window densely with the wide path's
plane expressions in its order (ops/traverse_mega.py): they are the CPU
path and the oracle the kernel is held against on the card.

`pack_cw8` is a JAX-free copy of the reference's (whose module imports
jax), byte-equal to it (tests/test_torch_cw8.py).  Two things differ from
the reference on purpose: a node8 tree deeper than the kernel's stack
raises ValueError (the reference's XLA walk overwrites its top stack slot),
and closest-hit keeps the exact lexicographic minimum of (t, tri) (the TPU
kernel keys its minimum on t with the low 8 bits replaced by the row).  The
TPU kernel's coherence sort, 128-ray consensus walk and chunking are not
carried over: the kernel walks each ray with eight lanes, one per child
slot of a node, and its results do not depend on the ray order.

`launches` counts kernel launches and twin calls, so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from caitlynrenderer_tpu_torch.ops import _build
from caitlynrenderer_tpu_torch.ops.traverse_mega import _scene_exit_bound, _sweep, pack_mega

SOURCE = "caitlynrenderer_tpu_torch/csrc/traverse_cw8.cu"
REPLACES = "caitlynrenderer_tpu/ops/traverse_cw8.py:153"

INF = 1e9
WIN = 32  # triangles per plane window
NROWS = 8  # padding rows of the reference's row-per-node table
STK = 24  # the reference kernel's stack levels
MAX_DEPTH = STK - 2  # deepest node8 tree the packer accepts
STACKS = (8, 16, 24)  # the kernel's stack sizes; a tree of depth D needs D - 1

launches = _build.launch_counter("traverse_cw8", {"closest": "cw8_kernelILb0E",
                                                  "anyhit": "cw8_kernelILb1E"})
# Launches of the stats variant, apart from `launches`.
stats_launches = {"closest": 0, "anyhit": 0}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # o, d, active, box, nodes, planes, n, n8, nwin, stack, out_t, out_tri,
    # out_win, device, stream
    "cw8_closest": (_INT, [_PTR] * 6 + [_INT] * 4 + [_PTR] * 3 + [_INT, _PTR]),
    # o, d, t_max, active, box, nodes, planes, n, n8, nwin, stack, out_occ,
    # device, stream
    "cw8_anyhit": (_INT, [_PTR] * 7 + [_INT] * 4 + [_PTR, _INT, _PTR]),
    # cw8_closest's arguments up to out_win, then t_seed, counts, node_seen,
    # col_seen, device, stream
    "cw8_closest_stats": (_INT, [_PTR] * 6 + [_INT] * 4 + [_PTR] * 7 + [_INT, _PTR]),
    # cw8_anyhit's arguments up to out_occ, then t_seed, counts, node_seen,
    # col_seen, device, stream
    "cw8_anyhit_stats": (_INT, [_PTR] * 7 + [_INT] * 4 + [_PTR] * 5 + [_INT, _PTR]),
    "cw8_error_string": (ctypes.c_char_p, [_INT]),
}

# Per-ray counts of the stats variant, in column order.
STATS = ("nodes", "boxes", "tris", "stack")


def reset_launches() -> None:
    for counter in (launches, stats_launches):
        for k in counter:
            counter[k] = 0


# --------------------------------------------------------------------------
# Host packing (copies of the reference's, numpy only)
# --------------------------------------------------------------------------


def node8_depth(cw_nodes) -> int:
    """Levels of the node8 tree (1 for a root-only tree, 0 for no nodes),
    by the reference packer's frontier sweep.  cw_nodes: (N8, 20) uint32
    words, or int32 holding the same bits."""
    nodes = np.ascontiguousarray(cw_nodes).view(np.uint32)
    if nodes.shape[0] == 0:
        return 0
    frontier = np.array([0], np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        im = ((nodes[frontier, 3] >> 24) & 0xFF).astype(np.uint8)
        cnt = np.unpackbits(im[:, None], axis=1).sum(axis=1)
        cb = nodes[frontier, 4].astype(np.int64)
        k = np.arange(8)
        frontier = (cb[:, None] + k[None, :])[k[None, :] < cnt[:, None]]
    return depth


def check_depth(depth: int) -> None:
    """Raise unless a node8 tree of `depth` levels fits the kernel's stack."""
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"node8 depth {depth} exceeds the kernel's stack "
                         f"(at most {MAX_DEPTH} levels)")


def pack_windows(cw_tris):
    """(planes32, bounds) of pack_cw8 from the (T, 9) v0 | e1 | e2 rows in
    cwbvh order:
      planes32: (W, 4, 128) f32 — Baldwin–Weber planes in windows of 32
                triangles: columns n 0:32 | u 32:64 | v 64:96 | zero 96:128,
                rows 0-2 plane xyz, row 3 offset; W = ceil(T / 32), at
                least 1.  Padding triangles get zero planes, which give NaN
                and are never accepted.
      bounds:   (1, 6) f32 — the scene box min | max (0 0 0 1 1 1 when
                empty), for the exit clamp."""
    cw_tris = np.asarray(cw_tris)
    t = cw_tris.shape[0]
    tp = max(WIN, -(-t // WIN) * WIN)
    tris_p = np.zeros((tp, 9), np.float32)
    tris_p[:t] = cw_tris
    ids = np.where(np.arange(tp) < t, np.arange(tp), -1).astype(np.int32)
    full = pack_mega(tris_p.reshape(-1, WIN, 9), ids.reshape(-1, WIN))
    kp = full.shape[2] // 3
    planes32 = np.zeros((full.shape[0], 4, 128), np.float32)
    planes32[:, :, 0:WIN] = full[:, 0:4, 0:WIN]
    planes32[:, :, WIN : 2 * WIN] = full[:, 0:4, kp : kp + WIN]
    planes32[:, :, 2 * WIN : 3 * WIN] = full[:, 0:4, 2 * kp : 2 * kp + WIN]
    if t:
        p0 = cw_tris[:, 0:3]
        v1 = p0 + cw_tris[:, 3:6]
        v2 = p0 + cw_tris[:, 6:9]
        lo = np.minimum(np.minimum(p0, v1), v2).min(axis=0)
        hi = np.maximum(np.maximum(p0, v1), v2).max(axis=0)
    else:
        lo = np.zeros(3, np.float32)
        hi = np.ones(3, np.float32)
    bounds = np.concatenate([lo, hi]).astype(np.float32)[None, :]
    return planes32, bounds


def pack_cw8(cw_nodes, cw_tris):
    """The reference's device layouts, byte for byte: (nodes1, planes32,
    bounds).  nodes1 is the TPU kernel's row-per-node table, (N8 + 8, 128)
    uint32 with node i's 20 words in row i, cols 0-19 (the port's kernel
    reads the (N8, 20) table itself); planes32 and bounds as
    `pack_windows`.  Raises ValueError for a tree deeper than MAX_DEPTH."""
    cw_nodes = np.asarray(cw_nodes)
    nodes1 = np.zeros((cw_nodes.shape[0] + NROWS, 128), np.uint32)
    nodes1[: cw_nodes.shape[0], :20] = cw_nodes
    check_depth(node8_depth(cw_nodes))
    return (nodes1, *pack_windows(cw_tris))


# --------------------------------------------------------------------------
# Plain twins
# --------------------------------------------------------------------------


def cw8_closest_plain(o, d, active, cw_nodes, cw_planes, cw_bounds, depth):
    """Plain PyTorch twin of the closest-hit kernel: every window, densely.
    Returns (t, tri, window): t = INF and tri = window = -1 on a miss or an
    inactive lane; ties go to the lowest triangle id; window = tri // 32."""
    launches["closest_twin"] += 1
    check_depth(depth)
    n, dev = o.shape[0], o.device
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if cw_nodes.shape[0] == 0 or n == 0:
        return best_t, tri, tri.clone()
    t_lim = _scene_exit_bound(o, d, torch.where(active, INF, -INF).to(torch.float32), cw_bounds)
    for r0, w0, ok, t in _sweep(o, d, t_lim, cw_planes[:, :, : 3 * WIN]):
        # First index of the minimum: lowest window, then lowest column.
        tc, idx = torch.where(ok, t, INF).flatten(1).min(dim=1)
        r1 = r0 + ok.shape[0]
        better = tc < best_t[r0:r1]  # strict: an earlier chunk keeps ties
        best_t[r0:r1] = torch.where(better, tc, best_t[r0:r1])
        tri[r0:r1] = torch.where(better, (w0 * WIN + idx).to(torch.int32), tri[r0:r1])
    return best_t, tri, torch.where(tri >= 0, tri // WIN, -1)


def cw8_anyhit_plain(o, d, t_max, active, cw_nodes, cw_planes, cw_bounds, depth):
    """Plain PyTorch twin of the any-hit kernel: (N,) bool, true where an
    active ray hits some triangle at 0 <= t < t_max."""
    launches["anyhit_twin"] += 1
    check_depth(depth)
    n, dev = o.shape[0], o.device
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if cw_nodes.shape[0] == 0 or n == 0:
        return occ
    t_lim = _scene_exit_bound(o, d, torch.where(active, t_max, -INF), cw_bounds)
    for r0, _, ok, _ in _sweep(o, d, t_lim, cw_planes[:, :, : 3 * WIN]):
        occ[r0 : r0 + ok.shape[0]] |= ok.flatten(1).any(dim=1)
    return occ


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_query(o, d, active, cw_nodes, cw_planes, cw_bounds, depth, t_max=None, t_seed=None):
    """Validate a CUDA query; returns (n, n8, nwin, stack, device)."""
    n, dev = o.shape[0], o.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor("o", o, f32, (n, 3), dev)
    _build.check_tensor("d", d, f32, (n, 3), dev)
    _build.check_tensor("active", active, torch.bool, (n,), dev)
    if t_max is not None:
        _build.check_tensor("t_max", t_max, f32, (n,), dev)
    if t_seed is not None:
        _build.check_tensor("t_seed", t_seed, f32, (n,), dev)
    n8 = cw_nodes.shape[0] if cw_nodes.dim() == 2 else -1
    nwin = cw_planes.shape[0] if cw_planes.dim() == 3 else -1
    _build.check_tensor("cw_nodes", cw_nodes, i32, (n8, 20), dev)
    _build.check_tensor("cw_planes", cw_planes, f32, (nwin, 4, 128), dev)
    _build.check_tensor("cw_bounds", cw_bounds, f32, (1, 6), dev)
    if cw_nodes.data_ptr() % 16:
        raise ValueError("cw_nodes must be 16-byte aligned (the kernel reads 16-byte words)")
    if n >= 2**31 or n8 * 20 >= 2**31 or nwin * 4 * 128 >= 2**31:
        raise ValueError(f"too many rays ({n}), nodes ({n8}) or windows ({nwin}) "
                         "for the kernel's indexing")
    check_depth(depth)
    stack = next(s for s in STACKS if s >= depth - 1)
    return n, n8, nwin, stack, dev


def _stats_buffers(n, n8, nwin, dev, t_seed):
    """Zeroed outputs of the stats variant and its argument pointers (see
    `cw8_closest`)."""
    i32 = torch.int32
    st = {"counts": torch.zeros((n, len(STATS)), dtype=i32, device=dev),
          "node_seen": torch.zeros((n8,), dtype=i32, device=dev),
          "col_seen": torch.zeros((32 * nwin,), dtype=i32, device=dev)}
    seed = 0 if t_seed is None else t_seed.data_ptr()
    return st, [seed] + [st[k].data_ptr() for k in ("counts", "node_seen", "col_seen")]


def _stats_on_cpu(stats, t_seed, cpu):
    """Raise for what only the CUDA stats variant takes; returns cpu."""
    if t_seed is not None and not stats:
        raise ValueError("t_seed seeds the stats variant's walk: give stats=True")
    if stats and cpu:
        raise ValueError("stats=True counts the CUDA kernel's walk: give CUDA tensors")
    return cpu


def cw8_closest(o, d, active, cw_nodes, cw_planes, cw_bounds, depth, stats=False, t_seed=None):
    """Closest hit of every active ray over the CWBVH.  Returns
    (t, tri, window), see `cw8_closest_plain`.  cw_nodes (N8, 20) int32 node
    words, cw_planes and cw_bounds from `pack_windows`, depth = the tree's
    `node8_depth`.  CUDA tensors launch the kernel.

    stats=True (CUDA only) launches the stats variant, the same walk, and
    returns (t, tri, window, st): st["counts"] (N, 4) i32 per ray, columns
    STATS (nodes visited, child boxes tested, leaf triangles tested, the
    stack's high-water mark); st["node_seen"] (N8,) i32, 1 where some ray
    visited the node; st["col_seen"] (32 W,) i32, 1 where some ray
    evaluated the triangle's t, 2 where also its u/v.  t_seed ((N,) f32,
    stats only) culls the walk's boxes against min(best t, t_seed) with
    acceptance unchanged: seeded with the closest t, the oracle walk, whose
    counts are the work the query needs."""
    args = (cw_nodes, cw_planes, cw_bounds)
    if _stats_on_cpu(stats, t_seed, _build.is_cpu(o, d, active, *args, t_seed)):
        return cw8_closest_plain(o, d, active, *args, depth)
    n, n8, nwin, stack, dev = _check_query(o, d, active, *args, depth, t_seed=t_seed)
    t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    win = torch.full((n,), -1, dtype=torch.int32, device=dev)
    st, st_ptrs = _stats_buffers(n, n8, nwin, dev, t_seed) if stats else (None, [])
    if n == 0 or n8 == 0:
        return (t, tri, win, st) if stats else (t, tri, win)
    lib = _build.load("traverse_cw8", _SIGNATURES)
    fn = "cw8_closest_stats" if stats else "cw8_closest"
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            o.data_ptr(), d.data_ptr(), active.data_ptr(), cw_bounds.data_ptr(),
            cw_nodes.data_ptr(), cw_planes.data_ptr(), n, n8, nwin, stack,
            t.data_ptr(), tri.data_ptr(), win.data_ptr(), *st_ptrs, dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(rc, lib.cw8_error_string, fn)
    if stats:
        stats_launches["closest"] += 1
        return t, tri, win, st
    launches["closest"] += 1
    return t, tri, win


def cw8_anyhit(o, d, t_max, active, cw_nodes, cw_planes, cw_bounds, depth, stats=False,
               t_seed=None):
    """Occlusion of every active ray by any triangle at 0 <= t < t_max
    ((N,) f32) over the CWBVH.  Returns (N,) bool.  CUDA tensors launch the
    kernel.  stats=True (CUDA only): returns (occ, st), st and t_seed as in
    `cw8_closest`."""
    args = (cw_nodes, cw_planes, cw_bounds)
    if _stats_on_cpu(stats, t_seed, _build.is_cpu(o, d, t_max, active, *args, t_seed)):
        return cw8_anyhit_plain(o, d, t_max, active, *args, depth)
    n, n8, nwin, stack, dev = _check_query(o, d, active, *args, depth, t_max=t_max,
                                           t_seed=t_seed)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    st, st_ptrs = _stats_buffers(n, n8, nwin, dev, t_seed) if stats else (None, [])
    if n == 0 or n8 == 0:
        return (occ, st) if stats else occ
    lib = _build.load("traverse_cw8", _SIGNATURES)
    fn = "cw8_anyhit_stats" if stats else "cw8_anyhit"
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), active.data_ptr(),
            cw_bounds.data_ptr(), cw_nodes.data_ptr(), cw_planes.data_ptr(), n, n8, nwin,
            stack, occ.data_ptr(), *st_ptrs, dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.raise_on(rc, lib.cw8_error_string, fn)
    if stats:
        stats_launches["anyhit"] += 1
        return occ, st
    launches["anyhit"] += 1
    return occ
