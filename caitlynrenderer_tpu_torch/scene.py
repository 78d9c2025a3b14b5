"""Device scene: host SceneArrays uploaded to a torch device (counterpart of
caitlynrenderer_tpu/scene.py).

Every accelerator of the reference is ported.  "brute" keeps the scene in
its own triangle order and every query sweeps all triangles through the
mt_brute kernel.  The others build the binary SAH BVH (accel/bvh.py), or
the spatial-split SBVH (accel/sbvh.py) for "sbvh", and reorder the scene
into its leaf order: "bvh2" and "sbvh" walk that tree
(ops/traverse_bvh.py); "wide" cuts it into groups (accel/wide.py) and
packs the groups' Baldwin–Weber planes and per-octant worklists for the
traverse_mega kernel; "cwbvh" collapses it into the 8-wide node8 tree
(accel/cwbvh.py), reorders the triangles once more into the tree's leaf
order and packs their planes for the traverse_cw8 kernel.
`scene_families`, `validate_scene`, `BRUTE_MAX_TRIS`, `required_stack` and
the wide group-size policy are JAX-free copies of the reference's (whose
module imports jax); tests/test_torch_scene.py, test_torch_mega.py and
test_torch_bvh.py hold each copy against the original.  `auto_accel` is the
port's own policy: brute force up to BRUTE_MAX_TRIS triangles, the binary
BVH ("bvh2", kernel B4) above, where the reference takes the wide BVH;
its docstring gives the card's figures behind the choice.  "wide" and
"cwbvh" stay on request.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from caitlynrenderer_tpu_torch.accel.bvh import FlatBVH, build_bvh, reorder_scene, tree_depth
from caitlynrenderer_tpu_torch.accel.cwbvh import build_cwbvh
from caitlynrenderer_tpu_torch.accel.sbvh import build_sbvh
from caitlynrenderer_tpu_torch.accel.wide import build_wide
from caitlynrenderer_tpu_torch.core.types import (
    LAMBERT_TYPES,
    Lights,
    Materials,
    MaterialType,
    SceneArrays,
)
from caitlynrenderer_tpu_torch.ops.intersect import pack_tris
from caitlynrenderer_tpu_torch.ops.traverse_bvh import pack_bvh_pairs
from caitlynrenderer_tpu_torch.ops.traverse_cw8 import check_depth, node8_depth, pack_windows
from caitlynrenderer_tpu_torch.ops.traverse_mega import pack_mega, pack_octants
from caitlynrenderer_tpu_torch.utils import metrics

ACCELS = ("brute", "bvh2", "sbvh", "wide", "cwbvh")


# Each accelerator's arrays, by their names in both packages' DeviceScene
# (convert.device_scene_from_numpy carries them across).
BVH_FIELDS = ("node_bounds", "node_meta")
WIDE_FIELDS = (
    "wb_group_bounds", "wb_mega", "wb_oct_bounds", "wb_oct_gid", "wb_oct_start", "wb_oct_blk",
)
CW_FIELDS = ("cw_nodes", "cw_planes", "cw_bounds")


class DeviceScene(NamedTuple):
    """Scene tensors on one device.

    accel:      the accelerator the scene was built for (rendering with
                another one than this or "brute" raises)
    scene:      SceneArrays whose array fields are tensors (textures, the
                (K, H, W, 3) albedo atlas, and env_map, the (H, W, 3)
                equirect radiance map, are f32 tensors or None); under every
                accelerator but "brute" in its tree's leaf order, so
                triangle ids are the reference's
    tris9:      (T, 9) f32 — packed v0 | e1 | e2, the brute kernel's slab
    shade_tab:  (T, 50) f32 — fused per-triangle shading rows (column map
                at `build_shade_table`)
    light_tab:  (L, 17) f32 — p | u | v | n | e | area | selection pdf
    node_bounds, node_meta: the binary BVH, (Nn, 6) f32 and (Nn, 2) i32
                (accel/bvh.FlatBVH; one leaf of every triangle under
                "brute" and for an empty scene)
    tree_depth: levels of that binary tree (sizes the bvh2/sbvh stack)
    bvh_pairs:  under "bvh2" and "sbvh", that tree as kernel B4's child-pair
                records, (Nn // 2 + 1, 16) f32 (layout at
                ops/traverse_bvh.pack_bvh_pairs); an empty (0, 16) placeholder
                under the others
    wb_*:       the wide accelerator (empty placeholders under the others):
                group_bounds (G, 6) f32, mega (G, 8, 3·Kp) f32 plane blocks,
                oct_bounds (8, gpad, 16) f32, oct_gid and oct_start
                (8, gpad) i32, oct_blk (8, nblk, 16) f32 — layouts at
                ops/traverse_mega.pack_mega and pack_octants
    cw_*:       the CWBVH (empty placeholders under the others): cw_nodes
                (N8, 20) i32 — build_cwbvh's uint32 node8 words, the same
                bits viewed as int32 (torch's uint32 supports few
                operations; the kernel reads them as uint32), one node per
                row; cw_planes (W, 4, 128) f32 Baldwin–Weber windows of 32
                triangles and cw_bounds (1, 6) f32 scene box — layouts at
                ops/traverse_cw8.pack_windows
    cw_depth:   levels of the node8 tree (sizes the kernel's stack)
    """

    accel: str
    scene: SceneArrays
    tris9: torch.Tensor
    shade_tab: torch.Tensor
    light_tab: torch.Tensor
    node_bounds: torch.Tensor
    node_meta: torch.Tensor
    tree_depth: int
    bvh_pairs: torch.Tensor
    wb_group_bounds: torch.Tensor
    wb_mega: torch.Tensor
    wb_oct_bounds: torch.Tensor
    wb_oct_gid: torch.Tensor
    wb_oct_start: torch.Tensor
    wb_oct_blk: torch.Tensor
    cw_nodes: torch.Tensor
    cw_planes: torch.Tensor
    cw_bounds: torch.Tensor
    cw_depth: int

    @property
    def device(self) -> torch.device:
        return self.tris9.device


def scene_families(scene_np: SceneArrays) -> tuple:
    """The shading families the scene's materials use: "lambert", "disney"
    (everything microfacet), "mirror", "glass"."""
    types = set(int(t) for t in np.asarray(scene_np.materials.albedo[:, 3]))
    lambert_ids = {int(t) for t in LAMBERT_TYPES}
    glass_ids = {
        int(MaterialType.GLASS),
        int(MaterialType.GLASS_COLOR),
        int(MaterialType.GLASS_NO_REFRACT),
        int(MaterialType.ROUGH_DIELECTRIC),
        int(MaterialType.THIN_DIELECTRIC),
        int(MaterialType.THIN_SHEET),
    }
    mirror_ids = {int(MaterialType.MIRROR), int(MaterialType.CONDUCTOR)}
    fams = []
    if types & lambert_ids:
        fams.append("lambert")
    if types - lambert_ids - glass_ids - mirror_ids:
        fams.append("disney")
    if types & mirror_ids:
        fams.append("mirror")
    if types & glass_ids:
        fams.append("glass")
    return tuple(fams) if fams else ("lambert",)


def validate_scene(scene_np: SceneArrays) -> None:
    """Fail-fast structural validation of scene inputs: a malformed scene
    raises ValueError naming the problem before anything is uploaded."""
    v = np.asarray(scene_np.vertices)
    tv = np.asarray(scene_np.tri_v)
    if v.ndim != 2 or v.shape[1] != 3:
        raise ValueError(f"vertices must be (V, 3), got {v.shape}")
    if not np.isfinite(v).all():
        bad = np.argwhere(~np.isfinite(v).all(axis=1))[:5].ravel().tolist()
        raise ValueError(f"non-finite vertex coordinates at rows {bad}")
    if tv.ndim != 2 or tv.shape[1] != 4:
        raise ValueError(f"tri_v must be (T, 4), got {tv.shape}")
    if tv.shape[0]:
        idx = tv[:, :3]
        if idx.min() < 0 or idx.max() >= max(len(v), 1):
            raise ValueError(
                f"triangle vertex indices out of range [0, {len(v)}): "
                f"min {idx.min()}, max {idx.max()}"
            )
        m = np.asarray(scene_np.materials.albedo).shape[0]
        if tv[:, 3].min() < 0 or tv[:, 3].max() >= max(m, 1):
            raise ValueError(
                f"material indices out of range [0, {m}): "
                f"min {tv[:, 3].min()}, max {tv[:, 3].max()}"
            )
        vn = np.asarray(scene_np.normals)
        tn = np.asarray(scene_np.tri_vn)
        if len(vn) and len(tn):
            used = tn[tn[:, 3] == 1][:, :3]
            if used.size and (used.min() < 0 or used.max() >= len(vn)):
                raise ValueError(f"normal indices out of range [0, {len(vn)})")
    li = scene_np.lights
    if np.asarray(li.p).shape[0]:
        pdf = np.asarray(li.area_pdf)
        if not np.isfinite(pdf).all() or (pdf < 0).any():
            raise ValueError("light area/pdf table contains invalid values")


BRUTE_MAX_TRIS = 2048  # at most this many triangles: brute force, else the binary BVH


def auto_accel(scene_np: SceneArrays) -> str:
    """Production accelerator policy: brute force (kernel B1) up to
    BRUTE_MAX_TRIS triangles, the binary SAH BVH ("bvh2", kernel B4) above.

    On an H100 (80GB HBM3, 700 W), on the 999,700-triangle grid at
    1024x1024 and six bounces, a frame takes 5.09-5.11 ms through B4,
    8.18-8.25 ms through the CWBVH kernel B3 and 48.1 ms through the wide
    kernel B2; the upload takes 2.2-2.4 s under "bvh2" (nothing packed),
    6.0-6.6 s under "cwbvh" (its node8 collapse and window pack 3.7-4.2 s)
    and 3.9 s under "wide" (its pack 1.6 s).  B4 gives the cheapest
    converged image at both ends.  The caller sizes B4's stack from the
    build (`options._replace(max_stack=required_stack(ds))`).  On the card
    a tree deeper than B4 takes (127 levels) raises at the first query,
    naming "wide" and "cwbvh": the policy does not fall back to them,
    they stay on request."""
    return "brute" if scene_np.num_triangles <= BRUTE_MAX_TRIS else "bvh2"


def build_shade_table(sc: SceneArrays) -> torch.Tensor:
    """(T, 50) f32 fused shading table, the reference's column map
    (caitlynrenderer_tpu/render/integrator.py:_build_shade_table):

      0:3 p0 | 3:6 e1 | 6:9 e2 | 9:12 n0 | 12:15 n1 | 15:18 n2 | 18 n-interp
      19:21 t0 | 21:23 t1 | 23:25 t2 | 25 light idx
      26:30 albedo(rgb+type) | 30:34 emission(rgb+flag) | 34:38 specular(rgb+ior)
      38:42 disney | 42:46 disney2 | 46:50 tex_ind
    """
    tv = sc.tri_v.long()
    t = tv.shape[0]
    dev = sc.vertices.device
    p0 = sc.vertices[tv[:, 0]]
    e1 = sc.vertices[tv[:, 1]] - p0
    e2 = sc.vertices[tv[:, 2]] - p0
    if sc.normals.shape[0] > 0:
        nid = torch.clamp(sc.tri_vn[:, :3].long(), 0, sc.normals.shape[0] - 1)
        n0, n1, n2 = (sc.normals[nid[:, k]] for k in range(3))
        nflag = (sc.tri_vn[:, 3] == 1).to(torch.float32)[:, None]
    else:
        n0 = n1 = n2 = torch.zeros((t, 3), dtype=torch.float32, device=dev)
        nflag = torch.zeros((t, 1), dtype=torch.float32, device=dev)
    if sc.texcoords.shape[0] > 0:
        tid = torch.clamp(sc.tri_vt[:, :3].long(), 0, sc.texcoords.shape[0] - 1)
        t0, t1, t2 = (sc.texcoords[tid[:, k]] for k in range(3))
    else:
        t0 = t1 = t2 = torch.zeros((t, 2), dtype=torch.float32, device=dev)
    light_idx = sc.tri_vt[:, 3].to(torch.float32)[:, None]
    m = sc.materials
    mat_tab = torch.cat([m.albedo, m.emission, m.specular, m.disney, m.disney2, m.tex_ind], dim=1)
    mrows = mat_tab.index_select(0, tv[:, 3])  # backward: index_add (integrator.hit_frame)
    return torch.cat([p0, e1, e2, n0, n1, n2, nflag, t0, t1, t2, light_idx, mrows], dim=1)


def replace_scene(ds: DeviceScene, sc: SceneArrays) -> DeviceScene:
    """`ds` with its scene replaced by `sc`, the same triangles in the same
    order with other vertices or materials (grad/inverse.apply_params'
    overlay): the shading table rebuilt from `sc`, differentiably, and
    where the vertices changed the brute-force slab re-packed from them,
    detached, so that the brute query sees the moved geometry as the
    reference's does.  The BVH, wide and CWBVH arrays stay those of the
    upload, as in the reference."""
    tris9 = ds.tris9
    if sc.vertices is not ds.scene.vertices:
        tris9 = pack_tris(sc.vertices.detach(), sc.tri_v).contiguous()
    return ds._replace(scene=sc, tris9=tris9, shade_tab=build_shade_table(sc))


def build_light_table(lights: Lights) -> torch.Tensor:
    """(L, 17) f32: p | u | v | n | e | area | selection pdf."""
    return torch.cat([lights.p, lights.u, lights.v, lights.n, lights.e, lights.area_pdf], dim=1)


def required_stack(ds_or_meta) -> int:
    """Traversal stack size that provably cannot overflow for this build:
    the actual tree depth + 1 (floored at the historical default 32).  Size
    the bvh2/sbvh options with ``options._replace(max_stack=
    required_stack(ds))``.  Accepts a DeviceScene or a raw (Nn, 2)
    node_meta array."""
    if hasattr(ds_or_meta, "tree_depth"):
        return max(32, ds_or_meta.tree_depth + 1)
    return max(32, tree_depth(np.asarray(ds_or_meta)) + 1)


def wide_group_size(num_triangles: int, group_tris=None) -> int:
    """Triangles per wide-BVH group: an explicit `group_tris` as given
    (at least 1); by default 256, doubled while the scene would have more
    than 2000 groups, up to 1024."""
    if group_tris is not None:
        return max(group_tris, 1)
    gt = 256
    while num_triangles / gt > 2000 and gt < 1024:
        gt *= 2
    return gt


def _wide_arrays(ordered: SceneArrays, bvh: FlatBVH, group_tris: int) -> dict:
    """The wide accelerator of a scene in `bvh`'s leaf order."""
    wb = build_wide(np.asarray(ordered.vertices), np.asarray(ordered.tri_v), bvh,
                    group_tris=group_tris)
    octs = pack_octants(wb.group_bounds, wb.tri_index[:, 0])
    arrays = (wb.group_bounds, pack_mega(wb.packed_tris, wb.tri_index)) + octs
    return dict(zip(WIDE_FIELDS, arrays))


def empty_wide_arrays() -> dict:
    """The wide fields of a scene without groups: every query misses."""
    octs = pack_octants(np.zeros((0, 6), np.float32), np.zeros(0, np.int32))
    arrays = (np.zeros((0, 6), np.float32), np.zeros((0, 8, 384), np.float32)) + octs
    return dict(zip(WIDE_FIELDS, arrays))


def _cw_arrays(ordered: SceneArrays, bvh: FlatBVH):
    """The CWBVH of a scene in `bvh`'s leaf order.  Returns (the scene in
    the node8 tree's leaf order, {CW_FIELDS name: array})."""
    cw = build_cwbvh(bvh, ordered.vertices, ordered.tri_v)
    ordered = ordered._replace(
        tri_v=ordered.tri_v[cw.tri_order],
        tri_vn=ordered.tri_vn[cw.tri_order],
        tri_vt=ordered.tri_vt[cw.tri_order],
    )
    tv = ordered.tri_v
    p0 = ordered.vertices[tv[:, 0]]
    cw_tris = np.concatenate(
        [p0, ordered.vertices[tv[:, 1]] - p0, ordered.vertices[tv[:, 2]] - p0], axis=1
    ).astype(np.float32)
    return ordered, dict(zip(CW_FIELDS, (cw.nodes, *pack_windows(cw_tris))))


def empty_cw_arrays() -> dict:
    """The CWBVH fields of a scene without nodes: every query misses."""
    return dict(zip(CW_FIELDS, (np.zeros((0, 20), np.uint32), np.zeros((0, 4, 128), np.float32),
                                np.array([[0, 0, 0, 1, 1, 1]], np.float32))))


def one_leaf_bvh(num_triangles: int) -> FlatBVH:
    """The reference's binary "tree" of a scene without a BVH: one leaf of
    every triangle."""
    return FlatBVH(
        node_bounds=np.zeros((1, 6), np.float32),
        node_meta=np.array([[0, max(num_triangles, 1)]], np.int32),
        tri_order=np.arange(num_triangles, dtype=np.int32),
    )


# The steps of an upload its "upload" record times, in order.
UPLOAD_STEPS = ("validate_s", "tree_s", "reorder_s", "pack_s", "device_init_s", "copy_s")
# The CUDA devices an upload has started (its device_init_s).
_started: set = set()


def upload_scene(scene_np: SceneArrays, accel: str, device, max_leaf: int = 4,
                 wide_group_tris=None, bvh: FlatBVH | None = None) -> DeviceScene:
    """Validate the scene, build `accel` and move everything to `device` (a
    torch.device or name) with the tables the integrator reads every
    bounce.  `accel` is one of ACCELS, as in the reference: max_leaf is the
    binary BVH's leaf width (at most 3 under "cwbvh", whose leaves hold at
    most 3 triangles) and wide_group_tris the wide group size.  `bvh`, if
    given, is the binary tree this call would build (`build_sbvh` under
    "sbvh", else `build_bvh`, with this max_leaf), built ahead, for example
    in another process; it is used in place of the build.

    Logs an "upload" record of host seconds by step, each 0 where the step
    has nothing to do: validate_s; tree_s, the binary tree's build (the
    native or numpy SAH builder, or the SBVH); reorder_s; pack_s, the wide
    groups and their planes and octant lists, or the CWBVH's collapse and
    windows; device_init_s, the process's first touch of a CUDA device
    (the runtime's start and one allocation there); copy_s, the copy to
    `device` and the tables built there, ended by a synchronize on a CUDA
    device.  With them the accel and the triangle count."""
    if accel not in ACCELS:
        raise ValueError(f"unknown accel {accel!r} (expected one of {'/'.join(ACCELS)})")
    timer = metrics.StepTimer()
    with timer.span("validate_s"):
        validate_scene(scene_np)
    wide, cw = empty_wide_arrays(), empty_cw_arrays()
    if accel == "brute" or scene_np.num_triangles == 0:
        if bvh is not None:
            raise ValueError(f"accel {accel!r} on {scene_np.num_triangles} triangles builds no tree")
        bvh, ordered = one_leaf_bvh(scene_np.num_triangles), scene_np
    else:
        if accel == "cwbvh":
            max_leaf = min(max_leaf, 3)
        if bvh is None:
            build = build_sbvh if accel == "sbvh" else build_bvh
            with timer.span("tree_s"):
                bvh = build(scene_np.vertices, scene_np.tri_v, max_leaf=max_leaf)
        elif len(bvh.tri_order) != scene_np.num_triangles:
            raise ValueError(f"the tree given orders {len(bvh.tri_order)} triangles, the scene "
                             f"has {scene_np.num_triangles}")
        with timer.span("reorder_s"):
            ordered = reorder_scene(scene_np, bvh)
        if accel == "wide":
            with timer.span("pack_s"):
                wide = _wide_arrays(ordered, bvh,
                                    wide_group_size(scene_np.num_triangles, wide_group_tris))
        elif accel == "cwbvh":
            with timer.span("pack_s"):
                ordered, cw = _cw_arrays(ordered, bvh)
    device = torch.device(device)
    if device.type == "cuda" and str(device) not in _started:
        with timer.span("device_init_s"):
            torch.cuda.init()
            torch.empty(1, device=device)
        _started.add(str(device))
    with timer.span("copy_s"):
        ds = scene_to_device(ordered, accel, device, bvh=bvh, wide=wide, cw=cw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    metrics.log_record("upload", {
        "accel": accel, "triangles": int(scene_np.num_triangles),
        **{k: round(timer.spans.get(k, 0.0), 6) for k in UPLOAD_STEPS}})
    return ds


def scene_to_device(scene_np: SceneArrays, accel: str, device, bvh: FlatBVH, wide: dict,
                    cw: dict) -> DeviceScene:
    """DeviceScene of an already validated (and, but for "brute", already
    reordered) scene and its accelerator arrays: the binary `bvh`, `wide`
    ({WIDE_FIELDS name: array}) and `cw` ({CW_FIELDS name: array}, node
    words uint32 or int32).  Raises ValueError for a node8 tree deeper than
    the kernel's stack, and under "bvh2"/"sbvh" for a binary tree that
    `pack_bvh_pairs` refuses."""
    cw_depth = node8_depth(cw["cw_nodes"])
    check_depth(cw_depth)

    def put(x, dtype):  # copies: the caller's arrays stay the caller's
        return None if x is None else torch.tensor(np.asarray(x), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    sc = SceneArrays(
        vertices=put(scene_np.vertices, f32),
        normals=put(scene_np.normals, f32),
        texcoords=put(scene_np.texcoords, f32),
        tri_v=put(scene_np.tri_v, i32),
        tri_vn=put(scene_np.tri_vn, i32),
        tri_vt=put(scene_np.tri_vt, i32),
        materials=Materials(*(put(x, f32) for x in scene_np.materials)),
        lights=Lights(*(put(x, f32) for x in scene_np.lights)),
        textures=put(scene_np.textures, f32),
        env_map=put(scene_np.env_map, f32),
    )
    int_fields = ("wb_oct_gid", "wb_oct_start")
    node_bounds, node_meta = put(bvh.node_bounds, f32), put(bvh.node_meta, i32)
    if accel in ("bvh2", "sbvh"):
        pairs = pack_bvh_pairs(node_bounds, node_meta)
    else:
        pairs = torch.zeros((0, 16), dtype=f32, device=device)
    return DeviceScene(
        accel=accel,
        scene=sc,
        tris9=pack_tris(sc.vertices, sc.tri_v).contiguous(),
        shade_tab=build_shade_table(sc),
        light_tab=build_light_table(sc.lights),
        node_bounds=node_bounds,
        node_meta=node_meta,
        tree_depth=int(tree_depth(np.asarray(bvh.node_meta))),
        bvh_pairs=pairs,
        **{k: put(wide[k], i32 if k in int_fields else f32) for k in WIDE_FIELDS},
        cw_nodes=put(np.ascontiguousarray(cw["cw_nodes"]).view(np.int32), i32),
        cw_planes=put(cw["cw_planes"], f32),
        cw_bounds=put(cw["cw_bounds"], f32),
        cw_depth=cw_depth,
    )
