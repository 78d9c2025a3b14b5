"""Wide-BVH closest-hit and any-hit queries (counterpart of
caitlynrenderer_tpu/ops/traverse_mega.py).

The scene is cut into groups of up to Kg triangles (accel/wide.py), each
packed into a block of Baldwin–Weber planes (`pack_mega`), and every
direction octant has a static front-to-back worklist of the groups
(`pack_octants`).  `mega_closest` and `mega_anyhit` launch the
hand-written CUDA kernel (csrc/traverse_mega.cu) for CUDA tensors and run
the plain PyTorch twin for CPU tensors; there is no fallback from one to
the other.  The twins (`mega_closest_plain`, `mega_anyhit_plain`) sweep
every group densely with the kernel's expressions in the kernel's order:
they are the CPU path and the oracle the kernel is held against on the
card.

`pack_mega`, `pack_octants` and `_scene_exit_bound` are JAX-free copies of
the reference's (whose module imports jax); tests/test_torch_mega.py holds
each against the original.  The reference's coherence sort (`_sort_order`,
`_octants`) is not ported: the kernel gives each ray a warp of its own,
computes its ray's octant itself, and its results do not depend on the ray
order, so it takes no ray-order hint.

`stats=True` (never passed by the render path) launches the kernel's stats
variant: the same walk, which also returns what it touched (see
`mega_closest`).  It needs CUDA tensors.

`launches` counts kernel launches and twin calls, so a run can show which
path it took; `stats_launches` counts launches of the stats variant.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from caitlynrenderer_tpu_torch.ops import _build

SOURCE = "caitlynrenderer_tpu_torch/csrc/traverse_mega.cu"
REPLACES = "caitlynrenderer_tpu/ops/traverse_mega.py:205"

INF = 1e9

launches = _build.launch_counter("traverse_mega", {"closest": "mega_kernelILb0E",
                                                   "anyhit": "mega_kernelILb1E"})
stats_launches = {"closest": 0, "anyhit": 0}

# Columns of the stats variant's per-ray counts.
STATS = ("block_tests", "entry_tests", "groups", "columns", "uv_columns")

# The twins materialize (rays, groups, Kp) temporaries; the sweep is chunked
# over rays and groups to about this many pairs per chunk.
_PAIRS_PER_CHUNK = 1 << 24

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # o, d, active, box, planes, oct_bounds, oct_gid, oct_start, oct_blk,
    # n, g, kp, gpad, nblk, out_t, out_tri, out_grp, device, stream
    "mega_closest": (_INT, [_PTR] * 9 + [_INT] * 5 + [_PTR] * 3 + [_INT, _PTR]),
    # o, d, t_max, active, box, planes, oct_bounds, oct_gid, oct_start,
    # oct_blk, n, g, kp, gpad, nblk, out_occ, device, stream
    "mega_anyhit": (_INT, [_PTR] * 10 + [_INT] * 5 + [_PTR, _INT, _PTR]),
    # as mega_closest, then stats, grp_seen, ent_seen, blk_seen before device
    "mega_closest_stats": (_INT, [_PTR] * 9 + [_INT] * 5 + [_PTR] * 7 + [_INT, _PTR]),
    # as mega_anyhit, then stats, grp_seen, ent_seen, blk_seen before device
    "mega_anyhit_stats": (_INT, [_PTR] * 10 + [_INT] * 5 + [_PTR] * 5 + [_INT, _PTR]),
    "mega_error_string": (ctypes.c_char_p, [_INT]),
}


def reset_launches() -> None:
    for counts in (launches, stats_launches):
        for k in counts:
            counts[k] = 0


# --------------------------------------------------------------------------
# Host precompute (copies of the reference's, numpy only)
# --------------------------------------------------------------------------


def pack_mega(packed_tris, tri_index):
    """Host precompute: (G, Kg, 9) v0/e1/e2 blocks + (G, Kg) ids →
    (G, 8, 3·Kp) f32 Baldwin–Weber plane blocks (Kp = Kg padded to 128).

    Rows 0-2 = plane vector xyz, row 3 = plane offset, rows 4-7 = zero.
    Columns: [n-plane 0:Kp | u-plane Kp:2Kp | v-plane 2Kp:3Kp], one per
    triangle.  Planes are computed in float64 and cast to f32.  Degenerate
    and padding triangles get all-zero planes, so every ray evaluates them
    to NaN and fails the acceptance compares.
    """
    packed_tris = np.asarray(packed_tris, np.float64)
    tri_index = np.asarray(tri_index)
    g, kg, _ = packed_tris.shape
    kp = -(-kg // 128) * 128
    v0 = packed_tris[:, :, 0:3]
    e1 = packed_tris[:, :, 3:6]
    e2 = packed_tris[:, :, 6:9]
    n = np.cross(e1, e2)
    m = (n * n).sum(-1)
    bad = (m < 1e-30) | (tri_index < 0)
    m = np.where(bad, 1.0, m)
    pu = np.cross(e2, n) / m[..., None]
    pv = np.cross(n, e1) / m[..., None]
    dn = -(n * v0).sum(-1)
    du = -(pu * v0).sum(-1)
    dv = -(pv * v0).sum(-1)
    zero3 = bad[..., None]
    n = np.where(zero3, 0.0, n)
    pu = np.where(zero3, 0.0, pu)
    pv = np.where(zero3, 0.0, pv)
    dn = np.where(bad, 0.0, dn)
    du = np.where(bad, 0.0, du)
    dv = np.where(bad, 0.0, dv)

    out = np.zeros((g, 8, 3 * kp), np.float32)
    for base, vec, off in ((0, n, dn), (kp, pu, du), (2 * kp, pv, dv)):
        out[:, 0:3, base : base + kg] = vec.transpose(0, 2, 1)
        out[:, 3, base : base + kg] = off
    return out


def pack_octants(group_bounds, tri_starts):
    """Host precompute of the 8 static per-octant worklists.

    For direction octant o (bit 2/1/0 set = dx/dy/dz negative), groups are
    ordered front-to-back along the travel diagonal (ascending
    Σ_a sign_a · centroid_a, axes normalized by scene extent).  Returns
      oct_bounds: (8, gpad, 16) f32 — cols 0-5 = bmin/bmax per entry
                  (padding entries NaN),
      oct_gid:    (8, gpad) i32 — group id per entry,
      oct_start:  (8, gpad) i32 — the group's first global triangle id,
      oct_blk:    (8, nblk, 16) f32 — union bounds of each 128-entry block
                  of the worklist (NaN for empty blocks).
    gpad = G padded to a multiple of 128; nblk = gpad // 128."""
    group_bounds = np.asarray(group_bounds, np.float32)
    tri_starts = np.asarray(tri_starts, np.int32)
    g = group_bounds.shape[0]
    gpad = max(128, -(-g // 128) * 128)
    nblk = gpad // 128
    cen = 0.5 * (group_bounds[:, :3] + group_bounds[:, 3:])
    lo = cen.min(axis=0) if g else np.zeros(3)
    hi = cen.max(axis=0) if g else np.ones(3)
    cen_n = (cen - lo) / np.maximum(hi - lo, 1e-12)

    oct_bounds = np.full((8, gpad, 16), np.nan, np.float32)
    oct_gid = np.zeros((8, gpad), np.int32)
    oct_start = np.zeros((8, gpad), np.int32)
    oct_blk = np.full((8, nblk, 16), np.nan, np.float32)
    for o in range(8):
        sign = np.array(
            [-1.0 if o & 4 else 1.0, -1.0 if o & 2 else 1.0,
             -1.0 if o & 1 else 1.0],
            np.float32,
        )
        order = np.argsort(cen_n @ sign, kind="stable").astype(np.int32)
        oct_bounds[o, :g, 0:6] = group_bounds[order]
        oct_bounds[o, :g, 6:16] = 0.0
        oct_gid[o, :g] = order
        oct_start[o, :g] = tri_starts[order]
        for b in range(-(-g // 128)):
            blk = group_bounds[order[b * 128 : min((b + 1) * 128, g)]]
            oct_blk[o, b, 0:3] = blk[:, :3].min(axis=0)
            oct_blk[o, b, 3:6] = blk[:, 3:].max(axis=0)
            oct_blk[o, b, 6:16] = 0.0
    return oct_bounds, oct_gid, oct_start, oct_blk


# --------------------------------------------------------------------------
# Plain twins
# --------------------------------------------------------------------------


def _scene_exit_bound(o, d, t_lim, bounds):
    """Clamp each ray's acceptance bound to its scene-bbox exit t: no hit
    can exist past the exit.  Axis-aligned rays give inf and NaN here, as
    in the reference; a NaN slab makes the ray a miss."""
    smin = bounds[:, :3].amin(dim=0)
    smax = bounds[:, 3:].amax(dim=0)
    d_inv = 1.0 / d
    t0 = (smin[None, :] - o) * d_inv
    t1 = (smax[None, :] - o) * d_inv
    tn = torch.minimum(t0, t1).amax(dim=1)
    tf = torch.maximum(t0, t1).amin(dim=1)
    hit = (tf > 0) & (tf >= tn)
    exit_t = torch.where(hit, tf * (1.0 + 1e-5) + 1e-5, -INF)
    return torch.minimum(t_lim, exit_t)


def _plane(x, p, offset):
    """Dot products of rays x (R, 3) with plane columns p (Gc, 4, K) in the
    kernel's order, ((x·px + y·py) + z·pz) [+ offset]: (R, Gc, K)."""
    r = x[:, 0, None, None] * p[None, :, 0] + x[:, 1, None, None] * p[None, :, 1]
    r = r + x[:, 2, None, None] * p[None, :, 2]
    return r + p[None, :, 3] if offset else r


def _sweep(o, d, t_lim, planes):
    """Yield (r0, g0, ok, t) per (ray, group) chunk: ok[i, j, k] is the
    Baldwin–Weber acceptance of column k of group g0 + j by ray r0 + i."""
    n = o.shape[0]
    g, _, kp3 = planes.shape
    kp = kp3 // 3
    rs = min(n, max(1, _PAIRS_PER_CHUNK // kp))
    gs = max(1, _PAIRS_PER_CHUNK // (rs * kp))
    for r0 in range(0, n, rs):
        ro, rd, rt = o[r0 : r0 + rs], d[r0 : r0 + rs], t_lim[r0 : r0 + rs, None, None]
        for g0 in range(0, g, gs):
            p = planes[g0 : g0 + gs, 0:4]
            pn, pu, pv = p[..., 0:kp], p[..., kp : 2 * kp], p[..., 2 * kp :]
            t = -_plane(ro, pn, True) / _plane(rd, pn, False)
            u = _plane(ro, pu, True) + t * _plane(rd, pu, False)
            v = _plane(ro, pv, True) + t * _plane(rd, pv, False)
            ok = (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t >= 0) & (t < rt)
            yield r0, g0, ok, t


def _group_starts(oct_gid, oct_start, g):
    """First global triangle id of each group, by group id."""
    starts = torch.zeros(g, dtype=torch.int32, device=oct_gid.device)
    starts[oct_gid[0, :g].long()] = oct_start[0, :g]
    return starts


def mega_closest_plain(o, d, active, group_bounds, mega_blocks, oct_bounds,
                       oct_gid, oct_start, oct_blk):
    """Plain PyTorch twin of the closest-hit kernel: every group, densely.
    Returns (t, tri, group): t = INF and tri = group = -1 on a miss or an
    inactive lane; ties go to the lowest triangle id."""
    launches["closest_twin"] += 1
    n, dev = o.shape[0], o.device
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    grp = torch.full((n,), -1, dtype=torch.int32, device=dev)
    g = mega_blocks.shape[0]
    if g == 0 or n == 0:
        return best_t, tri, grp
    kp = mega_blocks.shape[2] // 3
    t_lim = torch.where(active, INF, -INF).to(torch.float32)
    t_lim = _scene_exit_bound(o, d, t_lim, group_bounds)
    starts = _group_starts(oct_gid, oct_start, g)
    for r0, g0, ok, t in _sweep(o, d, t_lim, mega_blocks):
        # First index of the minimum: lowest group, then lowest column.
        tc, idx = torch.where(ok, t, INF).flatten(1).min(dim=1)
        r1 = r0 + ok.shape[0]
        better = tc < best_t[r0:r1]  # strict: an earlier chunk keeps ties
        gi = g0 + torch.div(idx, kp, rounding_mode="floor")
        best_t[r0:r1] = torch.where(better, tc, best_t[r0:r1])
        tri[r0:r1] = torch.where(better, starts[gi] + idx % kp, tri[r0:r1])
        grp[r0:r1] = torch.where(better, gi.to(torch.int32), grp[r0:r1])
    return best_t, tri, grp


def mega_anyhit_plain(o, d, t_max, active, group_bounds, mega_blocks, oct_bounds,
                      oct_gid, oct_start, oct_blk):
    """Plain PyTorch twin of the any-hit kernel: (N,) bool, true where an
    active ray hits some triangle at 0 <= t < t_max."""
    launches["anyhit_twin"] += 1
    n, dev = o.shape[0], o.device
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if mega_blocks.shape[0] == 0 or n == 0:
        return occ
    t_lim = _scene_exit_bound(o, d, torch.where(active, t_max, -INF), group_bounds)
    for r0, _, ok, _ in _sweep(o, d, t_lim, mega_blocks):
        occ[r0 : r0 + ok.shape[0]] |= ok.flatten(1).any(dim=1)
    return occ


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_query(o, d, active, group_bounds, mega_blocks, oct_bounds, oct_gid,
                 oct_start, oct_blk, t_max=None):
    """Validate a CUDA query; returns (n, g, kp, gpad, nblk, device)."""
    n, dev = o.shape[0], o.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor("o", o, f32, (n, 3), dev)
    _build.check_tensor("d", d, f32, (n, 3), dev)
    _build.check_tensor("active", active, torch.bool, (n,), dev)
    if t_max is not None:
        _build.check_tensor("t_max", t_max, f32, (n,), dev)
    if mega_blocks.dim() != 3 or mega_blocks.shape[1] != 8 or mega_blocks.shape[2] % 384:
        raise ValueError(f"mega_blocks must be (G, 8, 3·Kp) with Kp % 128 == 0, "
                         f"got {tuple(mega_blocks.shape)}")
    g, kp = mega_blocks.shape[0], mega_blocks.shape[2] // 3
    gpad = oct_gid.shape[1] if oct_gid.dim() == 2 else -1
    if gpad < max(g, 128) or gpad % 128:
        raise ValueError(f"oct_gid must be (8, gpad) with gpad >= G = {g}, "
                         f"got {tuple(oct_gid.shape)}")
    nblk = gpad // 128
    _build.check_tensor("group_bounds", group_bounds, f32, (g, 6), dev)
    _build.check_tensor("mega_blocks", mega_blocks, f32, (g, 8, 3 * kp), dev)
    _build.check_tensor("oct_bounds", oct_bounds, f32, (8, gpad, 16), dev)
    _build.check_tensor("oct_gid", oct_gid, i32, (8, gpad), dev)
    _build.check_tensor("oct_start", oct_start, i32, (8, gpad), dev)
    _build.check_tensor("oct_blk", oct_blk, f32, (8, nblk, 16), dev)
    if oct_bounds.data_ptr() % 16 or oct_blk.data_ptr() % 16:
        raise ValueError("oct_bounds and oct_blk must be 16-byte aligned (the kernel reads "
                         "16-byte words)")
    if n >= 2**31 or mega_blocks.numel() >= 2**40:
        raise ValueError(f"too many rays ({n}) or plane columns for the kernel's indexing")
    return n, g, kp, gpad, nblk, dev


def _scene_box(group_bounds):
    """(6,) scene bbox min | max of the group bounds, for the exit clamp."""
    return torch.cat([group_bounds[:, :3].amin(dim=0), group_bounds[:, 3:].amax(dim=0)])


def _stats_buffers(n, g, gpad, nblk, dev):
    """Zeroed outputs of the stats variant (see `mega_closest`)."""
    i32 = torch.int32
    return {"counts": torch.zeros((n, len(STATS)), dtype=i32, device=dev),
            "grp_seen": torch.zeros((g,), dtype=i32, device=dev),
            "ent_seen": torch.zeros((8, gpad), dtype=i32, device=dev),
            "blk_seen": torch.zeros((8, nblk), dtype=i32, device=dev)}


def _stats_ptrs(st):
    return [st[k].data_ptr() for k in ("counts", "grp_seen", "ent_seen", "blk_seen")]


def mega_closest(o, d, active, group_bounds, mega_blocks, oct_bounds, oct_gid,
                 oct_start, oct_blk, stats=False):
    """Closest hit of every active ray over the wide BVH.  Returns
    (t, tri, group), see `mega_closest_plain`.  mega_blocks from
    `pack_mega`, oct_* from `pack_octants`.  CUDA tensors launch the
    kernel.

    stats=True (CUDA only) launches the stats variant, the same walk, and
    returns (t, tri, group, st): st["counts"] (N, 5) i32 per ray, columns
    STATS (block-box tests, entry-box tests, groups visited, plane columns
    evaluated, columns that reached u/v); st["grp_seen"] (G,),
    st["ent_seen"] (8, gpad) and st["blk_seen"] (8, nblk) i32, 1 where
    some ray visited the group or tested the entry's or block's box."""
    args = (group_bounds, mega_blocks, oct_bounds, oct_gid, oct_start, oct_blk)
    if _build.is_cpu(o, d, active, *args):
        if stats:
            raise ValueError("stats=True counts the CUDA kernel's walk: give CUDA tensors")
        return mega_closest_plain(o, d, active, *args)
    n, g, kp, gpad, nblk, dev = _check_query(o, d, active, *args)
    t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    grp = torch.full((n,), -1, dtype=torch.int32, device=dev)
    st = _stats_buffers(n, g, gpad, nblk, dev) if stats else None
    if n == 0 or g == 0:
        return (t, tri, grp, st) if stats else (t, tri, grp)
    box = _scene_box(group_bounds)
    lib = _build.load("traverse_mega", _SIGNATURES)
    ins = [o.data_ptr(), d.data_ptr(), active.data_ptr(), box.data_ptr(),
           mega_blocks.data_ptr(), oct_bounds.data_ptr(), oct_gid.data_ptr(),
           oct_start.data_ptr(), oct_blk.data_ptr(), n, g, kp, gpad, nblk,
           t.data_ptr(), tri.data_ptr(), grp.data_ptr()]
    fn = "mega_closest_stats" if stats else "mega_closest"
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(*ins, *(_stats_ptrs(st) if stats else ()), dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(rc, lib.mega_error_string, fn)
    if stats:
        stats_launches["closest"] += 1
        return t, tri, grp, st
    launches["closest"] += 1
    return t, tri, grp


def mega_anyhit(o, d, t_max, active, group_bounds, mega_blocks, oct_bounds,
                oct_gid, oct_start, oct_blk, stats=False):
    """Occlusion of every active ray by any triangle at 0 <= t < t_max
    ((N,) f32) over the wide BVH.  Returns (N,) bool.  CUDA tensors launch
    the kernel.  stats=True (CUDA only): returns (occ, st), st as in
    `mega_closest`."""
    args = (group_bounds, mega_blocks, oct_bounds, oct_gid, oct_start, oct_blk)
    if _build.is_cpu(o, d, t_max, active, *args):
        if stats:
            raise ValueError("stats=True counts the CUDA kernel's walk: give CUDA tensors")
        return mega_anyhit_plain(o, d, t_max, active, *args)
    n, g, kp, gpad, nblk, dev = _check_query(o, d, active, *args, t_max=t_max)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    st = _stats_buffers(n, g, gpad, nblk, dev) if stats else None
    if n == 0 or g == 0:
        return (occ, st) if stats else occ
    box = _scene_box(group_bounds)
    lib = _build.load("traverse_mega", _SIGNATURES)
    ins = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), active.data_ptr(),
           box.data_ptr(), mega_blocks.data_ptr(), oct_bounds.data_ptr(),
           oct_gid.data_ptr(), oct_start.data_ptr(), oct_blk.data_ptr(), n, g, kp,
           gpad, nblk, occ.data_ptr()]
    fn = "mega_anyhit_stats" if stats else "mega_anyhit"
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(*ins, *(_stats_ptrs(st) if stats else ()), dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(rc, lib.mega_error_string, fn)
    if stats:
        stats_launches["anyhit"] += 1
        return occ, st
    launches["anyhit"] += 1
    return occ
