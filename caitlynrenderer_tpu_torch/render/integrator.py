"""Wavefront path-tracing integrator on tensors (counterpart of
caitlynrenderer_tpu/render/integrator.py:336-694).

The whole ray batch advances bounce by bounce as dense (N, ...) tensors,
with masked lanes for dead paths: `trace_paths` is one loop over bounces of
Russian roulette, the closest-hit query, the shading step (the previous
bounce's NEE added, the hit shaded, the NEE set up, the continuation
sampled) and the NEE's any-hit query.  The step is one launch of kernel B6
(ops/shade.py) where `fused_shading` holds, and its plain twin
`shade_bounce_plain` in every other case.  Both ray queries go through the
scene's accelerator: ops/mt_brute under "brute", ops/traverse_mega under
"wide", ops/traverse_cw8 under "cwbvh" and ops/traverse_bvh under "bvh2"
and "sbvh" (the reference's XLA walk, as kernel B4), each of which launches
its CUDA kernel for CUDA tensors.  options.traversal chooses, as in the
reference: "auto" takes those paths (the kernel on the card, its twin on
CPU tensors); "pallas" insists on the hand-written kernel and raises
ValueError for CPU tensors; "xla", for parity with the reference on CPU
tensors, runs the reference's plain walks where it has them, the dense
Möller–Trumbore of ops/intersect under "brute" and the node8 walk of
ops/traverse_cwbvh under "cwbvh" ("wide", "bvh2" and "sbvh" have one path
each), and raises ValueError for CUDA tensors, where it would walk past the
kernels.  The estimator, the uniform layout and the order of the arithmetic
are the reference's, so the tests can hold the two against each other per
pixel.  A vertex's steps (`hit_frame`, `surface`, `light_sample`,
`continuation`) are functions of their own, so that chip_smoke.py builds
the kernels' bounce and shadow ray sets with the integrator's code.

Shading: the four families of the reference (Lambert, the Disney BRDF
of ops/bsdf.py for every microfacet type, mirror, glass), textured albedo
(ops/texture.py), the environment map on a miss, NEE + MIS power
heuristic, `exact_reference_nee`, Russian roulette (`rr_start`), the
ray-count stats and the first-hit AOVs (`trace_aov`).  As in the
reference, CONDUCTOR is specular (no NEE) but not MIRROR (no reflection)
and not Disney, so it scatters as a Lambert bounce.  The reference's
ray-order hints (the origin group, `preorder`) have no counterpart: no
query's answer depends on the order of the rays.

Gradients (grad/inverse.py): the reference's detached-traversal
estimator.  Both ray queries and Russian roulette's survival probability
are detached; the hit's t, u and v are refined from the shading table's
rows, so radiance differentiates with respect to the camera, the vertices
and the materials through refinement and shading in torch autograd.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from caitlynrenderer_tpu_torch.core.types import (
    LAMBERT_TYPES,
    SPECULAR_TYPES,
    Camera,
    MaterialType,
    RenderOptions,
)
from caitlynrenderer_tpu_torch.core import math as cm
from caitlynrenderer_tpu_torch.core.camera import generate_rays, generate_rays_for_ids
from caitlynrenderer_tpu_torch.ops import bsdf, shade
from caitlynrenderer_tpu_torch.ops.intersect import intersect_brute, occluded_brute, refine_hit_tri
from caitlynrenderer_tpu_torch.ops.mt_brute import brute_anyhit, brute_closest
from caitlynrenderer_tpu_torch.ops.texture import sample_bilinear, sample_env
from caitlynrenderer_tpu_torch.ops.traverse_bvh import MAX_STACK, traverse_anyhit, traverse_closest
from caitlynrenderer_tpu_torch.ops.traverse_cw8 import cw8_anyhit, cw8_closest
from caitlynrenderer_tpu_torch.ops.traverse_cwbvh import cwbvh_anyhit, cwbvh_closest
from caitlynrenderer_tpu_torch.ops.traverse_mega import mega_anyhit, mega_closest
from caitlynrenderer_tpu_torch.scene import ACCELS, DeviceScene
from caitlynrenderer_tpu_torch.utils import metrics

EPS = cm.EPS
RAY_OFFSET = cm.RAY_OFFSET

_GLASS_IDS = (
    int(MaterialType.GLASS),
    int(MaterialType.GLASS_COLOR),
    int(MaterialType.GLASS_NO_REFRACT),
    int(MaterialType.ROUGH_DIELECTRIC),
    int(MaterialType.THIN_DIELECTRIC),
    int(MaterialType.THIN_SHEET),
)
_SPECULAR_IDS = tuple(int(t) for t in SPECULAR_TYPES)
_LAMBERT_IDS = tuple(int(t) for t in LAMBERT_TYPES)


def _type_is(mat_type, ids):
    """mat_type (int64 MaterialType values, all below 63) in `ids`: a bit
    test against a mask of the ids, which needs no id tensor on the device
    (`torch.isin` would copy one there, a copy that waits for the stream)."""
    mask = sum(1 << i for i in ids)
    return torch.bitwise_left_shift(torch.ones_like(mat_type), mat_type) & mask != 0


TRAVERSALS = ("auto", "xla", "pallas")


def check_supported(ds: DeviceScene, options: RenderOptions) -> None:
    """Raise ValueError for an unknown accelerator or one the scene was not
    uploaded for ("brute" runs on every upload), for an unknown traversal,
    for traversal "pallas" on a scene that is not on a CUDA device, and for
    traversal "xla" on one that is."""
    if options.accel not in ACCELS:
        raise ValueError(f"unknown accel {options.accel!r} (expected one of {'/'.join(ACCELS)})")
    if options.traversal not in TRAVERSALS:
        raise ValueError(f"unknown traversal {options.traversal!r} "
                         f"(expected one of {'/'.join(TRAVERSALS)})")
    on_card = ds.tris9.device.type == "cuda"
    if options.traversal == "pallas" and not on_card:
        raise ValueError('traversal "pallas" launches the hand-written kernels, which need '
                         f"CUDA tensors; the scene is on {ds.tris9.device}")
    if options.traversal == "xla" and on_card:
        raise ValueError('traversal "xla" runs the plain walks the reference runs off the TPU, '
                         'for parity on CPU tensors; on the card use "auto" or "pallas", '
                         "which launch the kernels")
    # bvh2 and sbvh differ only in how the binary tree was built.
    binary = {"sbvh": "bvh2"}
    same = binary.get(options.accel, options.accel) == binary.get(ds.accel, ds.accel)
    if options.accel != "brute" and not same and ds.tris9.shape[0] > 0:
        raise ValueError(f"options.accel is {options.accel!r} but the scene was uploaded "
                         f"without it (for {ds.accel!r}): "
                         f"upload_scene(scene, {options.accel!r}, device)")


def _check_stack(ds: DeviceScene, options: RenderOptions) -> None:
    """Stack guard of the binary-BVH walk: a stack the build can overflow
    raises here instead of being clamped.  Size options with
    `options._replace(max_stack=scene.required_stack(ds))`.  On the card
    the walk (kernel B4) takes a stack of at most MAX_STACK entries, so a
    deeper tree raises there too; the CPU walk takes any depth."""
    if ds.node_meta.device.type == "cuda" and ds.tree_depth + 1 > MAX_STACK:
        raise ValueError(
            f"BVH tree depth {ds.tree_depth} needs a traversal stack of {ds.tree_depth + 1} "
            f"slots, but the card's binary-BVH kernel takes at most {MAX_STACK} (a tree of "
            f"depth {MAX_STACK - 1}); render this scene with accel 'wide' or 'cwbvh' on the "
            "card, or on the CPU"
        )
    if ds.tree_depth + 1 > options.max_stack:
        raise ValueError(
            f"BVH tree depth {ds.tree_depth} needs a traversal stack of "
            f"{ds.tree_depth + 1} slots but options.max_stack={options.max_stack}; "
            "set options = options._replace(max_stack="
            "caitlynrenderer_tpu_torch.scene.required_stack(ds))"
        )


def _wide(ds: DeviceScene):
    return (ds.wb_group_bounds, ds.wb_mega, ds.wb_oct_bounds, ds.wb_oct_gid,
            ds.wb_oct_start, ds.wb_oct_blk)


def _cw(ds: DeviceScene):
    return ds.cw_nodes, ds.cw_planes, ds.cw_bounds, ds.cw_depth


def _bvh(ds: DeviceScene):
    """B4's tree arguments: the FlatBVH and the scene (the twin's), the
    child-pair records and the tris9 slab (the kernel's)."""
    return (ds.node_bounds, ds.node_meta, ds.scene.vertices, ds.scene.tri_v, ds.bvh_pairs,
            ds.tris9)


@torch.no_grad()
def _closest_hit_raw(ds: DeviceScene, o, d, active, options: RenderOptions):
    """Closest-hit dispatch on options.accel and options.traversal.  Returns
    (t, tri, u, v); the wide and CWBVH paths' u = v = 0 (the caller refines
    them from the triangle).  Traversal is detached, as the reference's
    stop_gradient makes it: nothing here records a graph, and the gradient
    reaches t, u and v through `hit_frame`'s refinement."""
    o, d = o.detach(), d.detach()
    if options.traversal == "xla" and options.accel == "brute":
        t, tri, u, v = intersect_brute(o, d, ds.scene.vertices, ds.scene.tri_v)
        return t, torch.where(active, tri, -1), u, v
    if options.traversal == "xla" and options.accel == "cwbvh":
        return cwbvh_closest(o, d, active, ds.cw_nodes, ds.tris9, ds.cw_depth)
    if options.accel in ("wide", "cwbvh"):
        query = mega_closest if options.accel == "wide" else cw8_closest
        args = _wide(ds) if options.accel == "wide" else _cw(ds)
        t, tri, _ = query(o, d, active, *args)
        zero = torch.zeros_like(t)
        return t, tri, zero, zero
    if options.accel in ("bvh2", "sbvh"):
        _check_stack(ds, options)
        return traverse_closest(o, d, active, *_bvh(ds), max_leaf=options.max_leaf,
                                max_stack=options.max_stack)
    return brute_closest(o, d, active, ds.tris9)


@torch.no_grad()
def _occluded(ds: DeviceScene, o, d, t_max, active, options: RenderOptions):
    """Any-hit visibility dispatch on options.accel and options.traversal;
    detached (visibility carries no gradient)."""
    o, d, t_max = o.detach(), d.detach(), t_max.detach()
    if options.traversal == "xla" and options.accel == "brute":
        return occluded_brute(o, d, torch.where(active, t_max, 0.0), ds.scene.vertices,
                              ds.scene.tri_v) & active
    if options.traversal == "xla" and options.accel == "cwbvh":
        return cwbvh_anyhit(o, d, t_max, active, ds.cw_nodes, ds.tris9, ds.cw_depth)
    if options.accel == "wide":
        return mega_anyhit(o, d, t_max, active, *_wide(ds))
    if options.accel == "cwbvh":
        return cw8_anyhit(o, d, t_max, active, *_cw(ds))
    if options.accel in ("bvh2", "sbvh"):
        _check_stack(ds, options)
        return traverse_anyhit(o, d, t_max, active, *_bvh(ds), max_leaf=options.max_leaf,
                               max_stack=options.max_stack)
    return brute_anyhit(o, d, t_max, active, ds.tris9)


def _power_heuristic(a, b):
    a = torch.clamp(a, 0.0, 1e12)
    b = torch.clamp(b, 0.0, 1e12)
    t = a * a
    return t / torch.clamp(b * b + t, min=1e-20)


def _light_pdf(dist, area, cos_light, pdf_select):
    """A light sample's pdf in solid angle, dist² / (area · cos), times
    the light's selection pdf; cos_light is the light's cosine toward the
    shaded point."""
    area_cos = torch.clamp(area * torch.clamp(cos_light, min=1e-8), min=1e-20)
    return dist * dist / area_cos * pdf_select


def _emitted(light_tab, d, hf, T, hit, prev_pdf, is_specular):
    """What the emissive hits `hit` add, T · emission · w_mis (0 elsewhere):
    w_mis = 1 on camera rays (prev_pdf None) and after a specular bounce
    (`is_specular`, None where there was none), else the power heuristic
    against the NEE.  prev_pdf is read as 1 off `hit`, where it is any
    lane's leftover: a NaN that a select drops still poisons the gradient."""
    e = T * hf.rows[:, 30:33]
    if prev_pdf is not None:
        num_lights = light_tab.shape[0]
        li_hit = torch.round(hf.rows[:, 25]).long()
        area = light_tab[torch.clamp(li_hit, 0, num_lights - 1), 15]
        pdf_light = _light_pdf(hf.t, area, -cm.dot(d, hf.n_flip), 1.0 / num_lights)
        w_mis = _power_heuristic(torch.where(hit, prev_pdf, 1.0), pdf_light)
        if is_specular is not None:
            w_mis = torch.where(is_specular, 1.0, w_mis)
        e = e * w_mis[:, None]
    return torch.where(hit[:, None], e, 0.0)


def _lambert_toward(albedo, cos_mtl, exact_reference_nee: bool):
    """The Lambert BSDF's value toward the light (cos-premultiplied; the
    reference shader's albedo under exact_reference_nee) and its pdf."""
    cos_pos = torch.clamp(cos_mtl, min=0.0)
    if exact_reference_nee:
        f_nee = albedo  # the reference shader's estimator (no cos/pi)
    else:
        f_nee = albedo * (cos_pos / math.pi)[:, None]
    return f_nee, cos_pos / math.pi


def bsdf_toward(surf, n_flip, d, ldir, cos_mtl, exact_reference_nee: bool,
                phase: str = "bsdf"):
    """The BSDF's value toward the light (cos-premultiplied) and its pdf,
    by family: Lambert's (`_lambert_toward`), and the Disney BRDF's
    `bsdf.eval_pdf` on Disney lanes (in span `phase`)."""
    f_nee, bsdf_pdf = _lambert_toward(surf.albedo, cos_mtl, exact_reference_nee)
    if surf.disney is not None:
        with metrics.span(phase):
            f_dis, pdf_dis = bsdf.eval_pdf(surf.dis_p, n_flip, -d, ldir)
            f_nee = torch.where(surf.disney[:, None], f_dis, f_nee)
            bsdf_pdf = torch.where(surf.disney, pdf_dis, bsdf_pdf)
    return f_nee, bsdf_pdf


def _nee_contrib(T, lrows, f_nee, pdf_light, bsdf_pdf):
    """A light sample's contribution T · Le · f · w_mis / pdf_light."""
    w_mis = _power_heuristic(pdf_light, bsdf_pdf)
    return T * lrows[:, 12:15] * f_nee * (w_mis / torch.clamp(pdf_light, min=1e-20))[:, None]


def _roulette(options: RenderOptions, bounce: int, alive, T, u_rr):
    """Russian roulette from rr_start on: survive with p = max throughput
    component (clamped to [0.05, 1]) and compensate T by 1/p.  The
    survival probability is a detached decision.  Returns (alive, T)."""
    if 0 <= options.rr_start <= bounce:
        p_surv = torch.clamp(T.max(dim=1).values, 0.05, 1.0).detach()
        alive = alive & (u_rr < p_surv)
        T = T / p_surv[:, None]
    return alive, T


def _shading_normal_from_rows(rows, u, v):
    geo_n = cm.normalize(cm.cross(rows[:, 3:6], rows[:, 6:9]))
    interp = cm.normalize(cm.interpolate(rows[:, 9:12], rows[:, 12:15], rows[:, 15:18], u, v))
    return torch.where((rows[:, 18] > 0.5)[:, None], interp, geo_n)


def _textured(sc) -> bool:
    """Whether the scene's albedo can come from its texture atlas."""
    return sc.textures is not None and sc.texcoords.shape[0] > 0


def _albedo_from_rows(sc, rows, u, v, phase: str = "texture"):
    """The material's albedo, sampled from the texture atlas where the
    material carries a layer (column 46); the lookup in span `phase`."""
    base = rows[:, 26:29]
    if not _textured(sc):
        return base
    with metrics.span(phase):
        layer_f = rows[:, 46]
        uv = cm.interpolate(rows[:, 19:21], rows[:, 21:23], rows[:, 23:25], u, v)
        sampled = sample_bilinear(sc.textures, torch.round(layer_f), uv)
        return torch.where((layer_f >= 0)[:, None], sampled, base)


def bounce_uniforms(uniforms, bounce: int):
    """A bounce's seven uniforms, render/sampling.py's layout: (light_pick,
    light_u1, light_u2, bsdf_u1, bsdf_u2, bsdf_lobe, rr)."""
    base = 4 + 7 * bounce
    return tuple(uniforms[:, base + k] for k in range(7))


class HitFrame(NamedTuple):
    """A closest-hit query's answer as the integrator shades it.

    rows:     (N, 50) the hit triangle's shading-table rows (triangle 0's
              where it missed)
    keep:     (N,) bool, where it hit
    t, u, v:  the hit refined from its triangle (the query's own where it
              missed)
    cos_incident: dot(ray direction, shading normal)
    n_flip:   the shading normal flipped against the incoming ray
    point:    the next rays' origin, RAY_OFFSET off the surface along n_flip
    """

    rows: torch.Tensor
    keep: torch.Tensor
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    cos_incident: torch.Tensor
    n_flip: torch.Tensor
    point: torch.Tensor


def hit_frame(ds: DeviceScene, o, d, raw_t, raw_tri, raw_u, raw_v) -> HitFrame:
    """The HitFrame of a closest-hit query's raw answer on rays (o, d); a
    miss keeps raw_t, raw_u and raw_v (tensors or numbers)."""
    # index_select, not indexing: its backward is an index_add, where
    # indexing's sorts the rows' many repeated ids (every lane that hit
    # one triangle) on the card.
    rows = ds.shade_tab.index_select(0, torch.clamp(raw_tri, min=0).long())
    t_r, u_r, v_r = refine_hit_tri(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    keep = raw_tri >= 0
    hit_t = torch.where(keep, t_r, raw_t)
    hit_u = torch.where(keep, u_r, raw_u)
    hit_v = torch.where(keep, v_r, raw_v)
    n_shade = _shading_normal_from_rows(rows, hit_u, hit_v)
    cos_incident = cm.dot(d, n_shade)
    n_flip = torch.where((cos_incident > 0)[:, None], -n_shade, n_shade)
    hit_point = o + d * hit_t[:, None] + n_flip * RAY_OFFSET
    return HitFrame(rows, keep, hit_t, hit_u, hit_v, cos_incident, n_flip, hit_point)


class Surface(NamedTuple):
    """The hit's material as the shading families see it.

    albedo:   (N, 3), texture-modulated where the material has a layer
    ior:      (N,) the specular row's ior (glass reads it unfloored)
    specular: (N,) bool, the reference's specular types (no NEE); all
              False unless the mirror or glass family is traced
    disney, mirror, glass: (N,) bool masks of the families, None where
              options.families leaves the family out
    dis_p:    bsdf.DisneyParams of every lane, None without "disney"
    """

    albedo: torch.Tensor
    ior: torch.Tensor
    specular: torch.Tensor
    disney: Optional[torch.Tensor]
    mirror: Optional[torch.Tensor]
    glass: Optional[torch.Tensor]
    dis_p: Optional[bsdf.DisneyParams]


def surface(ds: DeviceScene, hf: HitFrame, families, phase: str = "bsdf",
            spec_phase: str = "specular", tex_phase: str = "texture") -> Surface:
    """The Surface of a HitFrame's rows.  Only the families named in
    `families` are traced (the reference's static specialization); every
    type that is neither Lambert nor specular takes the Disney BRDF, whose
    mask and parameters are gathered in span `phase`; the specular, mirror
    and glass masks are made in span `spec_phase`; the texture atlas is
    read in span `tex_phase`."""
    rows = hf.rows
    mat_type = torch.round(rows[:, 29]).to(torch.int64)
    albedo = _albedo_from_rows(ds.scene, rows, hf.u, hf.v, tex_phase)
    has_mirror, has_glass = "mirror" in families, "glass" in families
    mirror = glass = None
    if has_mirror or has_glass:
        with metrics.span(spec_phase):
            specular = _type_is(mat_type, _SPECULAR_IDS)
            if has_mirror:
                mirror = mat_type == int(MaterialType.MIRROR)
            if has_glass:
                glass = _type_is(mat_type, _GLASS_IDS)
    else:
        specular = torch.zeros_like(hf.keep)
    disney = dis_p = None
    if "disney" in families:
        with metrics.span(phase):
            disney = ~specular & ~_type_is(mat_type, _LAMBERT_IDS)
            dis_p = bsdf.params_from_rows(rows, albedo)
    return Surface(
        albedo=albedo,
        ior=rows[:, 37],
        specular=specular,
        disney=disney,
        mirror=mirror,
        glass=glass,
        dis_p=dis_p,
    )


def light_sample(light_tab, hit_point, n_flip, u_lp, u_l1, u_l2, alive, specular):
    """NEE's light sample and shadow ray: a light picked by u_lp, a point on
    it by u_l1, u_l2, the unit direction from hit_point towards it and its
    distance.  The any-hit query is issued where `cand` (the path goes on,
    its material is not specular, the point lies above the surface and the
    light faces it), with t_max the distance less EPS (0 elsewhere).
    Returns (lrows, ldir, dist, cos_mtl, cos_light, cand, t_max)."""
    num_lights = light_tab.shape[0]
    li = torch.clamp((u_lp * num_lights).to(torch.int64), max=num_lights - 1)
    s = torch.sqrt(u_l1)
    b0 = 1.0 - s
    b1 = u_l2 * s
    lrows = light_tab[li]
    lpos = lrows[:, 0:3] + b0[:, None] * lrows[:, 3:6] + b1[:, None] * lrows[:, 6:9]
    ldir = lpos - hit_point
    dist = cm.norm(ldir)
    ldir = ldir / torch.clamp(dist[:, None], min=1e-20)
    cos_mtl = cm.dot(ldir, n_flip)
    cos_light = cm.dot(ldir, lrows[:, 9:12])
    cand = alive & ~specular & (cos_mtl > 0) & (cos_light < 0)
    return lrows, ldir, dist, cos_mtl, cos_light, cand, torch.where(cand, dist - EPS, 0.0)


def continuation(hf: HitFrame, surf: Surface, d, T, u_b1, u_b2, u_lobe, phase: str = "bsdf",
                 spec_phase: str = "specular"):
    """The continuation ray of every lane by its family: a cosine-weighted
    Lambert sample about n_flip, a Disney BRDF sample (in span `phase`), a
    mirror reflection, or a glass reflection or refraction chosen by u_lobe
    against Fresnel (both in span `spec_phase`).  Returns (d, T, pdf,
    is_specular, ok, origin): the unit direction, the throughput the path
    carries on with, the direction's pdf (1 for a delta lobe), whether it
    was a delta lobe, where the path survives (False where a Disney sample
    has no pdf), and the origin, moved through the surface for a refracted
    ray."""
    n_flip = hf.n_flip
    n = d.shape[0]
    local = cm.cosine_hemisphere_dir(u_b1, u_b2)
    diff_dir = cm.local_to_world(local, n_flip)
    diff_pdf = torch.clamp(local[:, 2], min=1e-8) / math.pi
    ok = torch.ones(n, dtype=torch.bool, device=d.device)

    if surf.disney is not None:
        disney = surf.disney
        lambert_T = T * surf.albedo
        with metrics.span(phase):
            dis_dir, dis_f, dis_pdf = bsdf.sample(surf.dis_p, n_flip, -d, u_lobe, u_b1, u_b2)
            dis_ok = dis_pdf > 1e-9
            dis_T = T * torch.where(dis_ok[:, None],
                                    dis_f / torch.clamp(dis_pdf, min=1e-9)[:, None], 0.0)
            new_d = torch.where(disney[:, None], dis_dir, diff_dir)
            new_T = torch.where(disney[:, None], dis_T, lambert_T)
            new_pdf = torch.where(disney, torch.clamp(dis_pdf, min=1e-9), diff_pdf)
            ok = ~disney | dis_ok
    else:
        new_d = diff_dir
        new_T = T * surf.albedo
        new_pdf = diff_pdf
    new_spec = torch.zeros(n, dtype=torch.bool, device=d.device)
    origin = hf.point

    if surf.mirror is None and surf.glass is None:
        return cm.normalize(new_d), new_T, new_pdf, new_spec, ok, origin
    with metrics.span(spec_phase):
        if surf.mirror is not None:
            mirror = surf.mirror
            new_d = torch.where(mirror[:, None], cm.reflect(d, n_flip), new_d)
            new_pdf = torch.where(mirror, 1.0, new_pdf)
            new_spec = new_spec | mirror

        if surf.glass is not None:
            glass, ior = surf.glass, surf.ior
            refl_dir = cm.reflect(d, n_flip)
            entering = hf.cos_incident <= 0
            eta = torch.where(entering, 1.0 / torch.clamp(ior, min=1e-6), ior)
            ci = torch.abs(cm.dot(d, n_flip))
            sin2_t = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
            # Floored strictly above 0 (sqrt'(0) = inf): at total internal
            # reflection the select below masks only the value.
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
            r_par = (ci - eta * cos_t) / torch.clamp(ci + eta * cos_t, min=1e-12)
            r_perp = (eta * ci - cos_t) / torch.clamp(eta * ci + cos_t, min=1e-12)
            tir = sin2_t >= 1.0
            fres = torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))
            refr_dir = cm.normalize(eta[:, None] * d + (eta * ci - cos_t)[:, None] * n_flip)
            choose_refl = (u_lobe < fres) | tir
            new_d = torch.where(glass[:, None],
                                torch.where(choose_refl[:, None], refl_dir, refr_dir), new_d)
            new_pdf = torch.where(glass, 1.0, new_pdf)
            new_spec = new_spec | glass
            # A refracted ray leaves from the other side of the surface.
            origin = origin + torch.where((glass & ~choose_refl)[:, None],
                                          -2.0 * RAY_OFFSET * n_flip, 0.0)

    return cm.normalize(new_d), new_T, new_pdf, new_spec, ok, origin


# The shading families kernel B6 takes: ("lambert", "disney", "mirror",
# "glass").
FUSED_FAMILIES = shade.FAMILIES


def fused_shading(ds: DeviceScene, o, d, uniforms, options: RenderOptions,
                  with_stats: bool = False) -> bool:
    """Whether `trace_paths` shades each bounce with kernel B6 (ops/shade.py)
    rather than its plain twin: the rays, the uniforms and the scene's
    tables on CUDA, families of FUSED_FAMILIES alone (Lambert with any of
    Disney, mirror and glass) and Lambert among them, no texture, no
    environment, at least one light, no ray-count stats, and nothing the
    bounce reads requiring grad while grad mode is on."""
    sc = ds.scene
    tensors = (o, d, uniforms, ds.shade_tab, ds.light_tab)
    return (all(x.device.type == "cuda" for x in tensors)
            and "lambert" in options.families
            and set(options.families) <= set(FUSED_FAMILIES)
            and not _textured(sc)
            and not options.use_env_map
            and ds.light_tab.shape[0] > 0
            and not with_stats
            and not (torch.is_grad_enabled() and any(x.requires_grad for x in tensors)))


def torch_families(options: RenderOptions) -> tuple:
    """The families of options.families that kernel B6 does not shade: each
    keeps `trace_paths` on the plain bounce (none of the four families of
    the reference since B6 took the delta lobes)."""
    return tuple(f for f in options.families if f not in FUSED_FAMILIES)


def _delta_mask(surf: Surface):
    """The lanes a mirror or glass shades; None where options.families
    holds neither."""
    if surf.mirror is None or surf.glass is None:
        return surf.mirror if surf.glass is None else surf.glass
    return surf.mirror | surf.glass


def shade_bounce_plain(ds: DeviceScene, o, d, tri, uniforms, bounce: int,
                       state: shade.PathState, options: RenderOptions, prev=None,
                       stats: Optional[dict] = None) -> shade.Shaded:
    """`trace_paths`' shading step in torch: kernel B6's plain twin
    (`ops/shade.shade_bounce`), widened to texture, the environment and
    scenes without a light (ldir, t_max, cand and pending None).  Returns new tensors, so autograd runs through it;
    Shaded.state.specular marks the delta lobes.  It equals B6 where the
    loop reads the outputs: ldir and pending where cand; o, d and prev_pdf
    where the lane went on shading (alive, a hit, not emissive); elsewhere
    they are what the arithmetic gives, where B6 holds the lane's values.
    Spans b<k>.hit, .nee and .bounce (.bsdf and .specular inside, and
    .sky and .texture inside hit) hold all its work; `stats`, a dict of
    lists, gets the live lanes the Disney BRDF shades under
    "disney_per_bounce", those a mirror or glass shades under
    "specular_per_bounce", the alive lanes that miss and take the
    environment map under "sky_per_bounce" and the live lanes whose albedo
    the atlas gives under "textured_per_bounce"."""
    b = f"b{bounce}."
    alive, T, L, prev_pdf, specular = state
    lit = ds.light_tab.shape[0] > 0
    if prev is not None:
        with metrics.span(b + "nee"):
            L = shade_finish_plain(L, *prev)
    with metrics.span(b + "hit"):
        u_lp, u_l1, u_l2, u_b1, u_b2, u_lobe, _ = bounce_uniforms(uniforms, bounce)
        hf = hit_frame(ds, o, d, 0.0, tri, 0.0, 0.0)
        live = alive & hf.keep
        if options.use_env_map:  # lit only through BSDF samples: w_mis = 1
            with metrics.span(b + "sky"):
                L = L + torch.where((alive & ~live)[:, None],
                                    T * sample_env(ds.scene.env_map, d), 0.0)
        surf = surface(ds, hf, options.families, b + "bsdf", b + "specular", b + "texture")
        if lit:
            hit_light = live & (hf.rows[:, 33] != -1)
            L = L + _emitted(ds.light_tab, d, hf, T, hit_light, prev_pdf if bounce else None,
                             specular)
            live = live & ~hit_light
        if stats is not None:
            zero = torch.zeros((), dtype=torch.int64, device=o.device)
            textured = (hf.rows[:, 46] >= 0) if _textured(ds.scene) else None
            for key, mask in (("disney_per_bounce", surf.disney),
                              ("specular_per_bounce", _delta_mask(surf)),
                              ("textured_per_bounce", textured)):
                stats[key].append((live & mask).sum() if mask is not None else zero)
            stats["sky_per_bounce"].append((alive & ~hf.keep).sum() if options.use_env_map
                                           else zero)
    with metrics.span(b + "nee"):
        ldir = t_max = cand = pending = None  # no light: no NEE and no any-hit query
        if lit:
            lrows, ldir, dist, cos_mtl, cos_light, cand, t_max = light_sample(
                ds.light_tab, hf.point, hf.n_flip, u_lp, u_l1, u_l2, live, surf.specular)
            pdf_light = _light_pdf(dist, lrows[:, 15], -cos_light, 1.0 / ds.light_tab.shape[0])
            f_nee, bsdf_pdf = bsdf_toward(surf, hf.n_flip, d, ldir, cos_mtl,
                                          options.exact_reference_nee, b + "bsdf")
            pending = _nee_contrib(T, lrows, f_nee, pdf_light, bsdf_pdf)
    with metrics.span(b + "bounce"):
        new_d, new_T, new_pdf, new_spec, ok, origin = continuation(
            hf, surf, d, T, u_b1, u_b2, u_lobe, b + "bsdf", b + "specular")
        after = shade.PathState(live & ok, torch.where((live & ok)[:, None], new_T, T), L,
                                new_pdf, new_spec)
        return shade.Shaded(origin, new_d, ldir, t_max, cand, pending, after)


def shade_finish_plain(L, cand, shadowed, pending):
    """Kernel B6's finishing step's twin: a new L + pending where cand & ~shadowed."""
    return L + torch.where((cand & ~shadowed)[:, None], pending, 0.0)


def trace_paths(ds: DeviceScene, o, d, uniforms, options: RenderOptions, with_stats: bool = False):
    """Trace one path per input ray; returns radiance (N, 3), or
    (radiance, stats) when with_stats.  stats counts the ray queries
    actually issued: "rays_closest", "rays_anyhit" (int tensors),
    "alive_per_bounce" ((max_depth,) tensor of live lanes entering each
    closest-hit query), "disney_per_bounce" ((max_depth,): the live lanes
    that shade their hit with the Disney BRDF, 0 where options.families
    leaves it out), "specular_per_bounce" (the same of the mirror and
    glass lanes), "sky_per_bounce" (the alive lanes that miss and take the
    environment map; 0 without one), "textured_per_bounce" (the live
    lanes whose albedo the texture atlas gives; 0 without one) and
    "anyhit_per_bounce" (the any-hit candidates of each bounce's NEE;
    empty without lights).

    uniforms: (N, 4 + 7*max_depth), layout in render/sampling.py; the first
    4 (raygen) entries are unused here.

    Each bounce's phases are spans b<k>.rr, .closest, .shade (which adds
    the last bounce's NEE too) and .anyhit (utils/metrics).
    """
    check_supported(ds, options)
    fused = fused_shading(ds, o, d, uniforms, options, with_stats)
    lit = ds.light_tab.shape[0] > 0
    n, dev = o.shape[0], o.device
    with metrics.span("raygen"):
        # prev_pdf, and B6's delta flag where the families hold a delta
        # lobe, are first read at bounce 1, on lanes bounce 0 wrote.
        delta = fused and shade.has_delta(options.families)
        state = shade.PathState(alive=torch.ones(n, dtype=torch.bool, device=dev),
                                T=torch.ones((n, 3), dtype=torch.float32, device=dev),
                                L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
                                prev_pdf=torch.empty(n, dtype=torch.float32, device=dev),
                                specular=(torch.empty(n, dtype=torch.bool, device=dev)
                                          if delta else None))
    alive_per_bounce, anyhit_per_bounce = [], []
    shaded = ({k: [] for k in ("disney_per_bounce", "specular_per_bounce", "sky_per_bounce",
                               "textured_per_bounce")} if with_stats else None)
    prev = None
    for bounce in range(options.max_depth):
        b = f"b{bounce}."
        with metrics.span(b + "rr"):
            alive, T = _roulette(options, bounce, state.alive, state.T,
                                 bounce_uniforms(uniforms, bounce)[6])
            state = state._replace(alive=alive, T=T)
            if with_stats:
                alive_per_bounce.append(alive.sum())
        with metrics.span(b + "closest"):
            tri = _closest_hit_raw(ds, o, d, state.alive, options)[1]
        with metrics.span(b + "shade"):
            if fused:
                # From bounce 1 on the next rays overwrite this bounce's,
                # which are the loop's own buffers.
                sh = shade.shade_bounce(ds.shade_tab, ds.light_tab, o, d, tri, uniforms, bounce,
                                        state, prev, options.exact_reference_nee,
                                        (o, d) if bounce else None, options.families)
            else:
                sh = shade_bounce_plain(ds, o, d, tri, uniforms, bounce, state, options, prev,
                                        shaded)
        o, d, state, prev = sh.o, sh.d, sh.state, None
        if lit:
            with metrics.span(b + "anyhit"):
                if with_stats:
                    anyhit_per_bounce.append(sh.cand.sum())
                shadowed = _occluded(ds, o, sh.ldir, sh.t_max, sh.cand, options)
            prev = (sh.cand, shadowed, sh.pending)
    L = state.L
    if prev is not None:
        with metrics.span(b + "shade"):
            if fused:
                L = shade.shade_finish(L, *prev)
            else:
                with metrics.span(b + "nee"):
                    L = shade_finish_plain(L, *prev)
    if not with_stats:
        return L
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return L, {
        "rays_closest": sum(alive_per_bounce, zero),
        "rays_anyhit": sum(anyhit_per_bounce, zero),
        "alive_per_bounce": torch.stack(alive_per_bounce),
        **{k: torch.stack(v) for k, v in shaded.items()},
        "anyhit_per_bounce": (torch.stack(anyhit_per_bounce) if anyhit_per_bounce
                              else torch.zeros(0, dtype=torch.int64, device=dev)),
    }


def trace_aov(ds: DeviceScene, o, d, options: RenderOptions):
    """The first-hit AOV of options.aov, from one closest-hit query and no
    sampling: "depth" (the hit's t, in every channel), "normal" (the
    shading normal mapped to [0, 1]) or "albedo" (emissive surfaces show
    their emission); 0 where the ray missed.  Returns (N, 3)."""
    check_supported(ds, options)
    n = o.shape[0]
    with metrics.span("b0.closest"):
        active = torch.ones(n, dtype=torch.bool, device=o.device)
        raw_t, raw_tri, raw_u, raw_v = _closest_hit_raw(ds, o, d, active, options)
    with metrics.span("b0.hit"):
        hf = hit_frame(ds, o, d, raw_t, raw_tri, raw_u, raw_v)
        got = hf.keep[:, None]
        if options.aov == "depth":
            return torch.where(got, hf.t[:, None], 0.0).expand(n, 3)
        if options.aov == "normal":
            n_shade = _shading_normal_from_rows(hf.rows, hf.u, hf.v)
            return torch.where(got, 0.5 * (n_shade + 1.0), 0.0)
        albedo = _albedo_from_rows(ds.scene, hf.rows, hf.u, hf.v, "b0.texture")
        emissive = (hf.rows[:, 33] != -1)[:, None]
        return torch.where(got, torch.where(emissive, hf.rows[:, 30:33], albedo), 0.0)


def render_sample(ds: DeviceScene, camera: Camera, uniforms, width: int, height: int,
                  options: RenderOptions, pixel_ids=None, lens=None):
    """One sample of every pixel, or of the global pixel ids `pixel_ids`
    ((N,) int32, one row of `uniforms` each): raygen, then the path trace
    (or the first-hit AOV unless options.aov is "beauty").  `lens` as in
    `generate_rays_for_ids`.  Returns (H*W, 3) or (N, 3) radiance on the
    uniforms' device."""
    with metrics.span("raygen"):
        if pixel_ids is None:
            o, d = generate_rays(camera, width, height, uniforms, lens)
        else:
            o, d = generate_rays_for_ids(camera, width, height, pixel_ids, uniforms, lens)
    if options.aov != "beauty":
        return trace_aov(ds, o, d, options)
    return trace_paths(ds, o, d, uniforms, options)
