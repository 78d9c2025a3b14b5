"""Wavefront path-tracing integrator on tensors (counterpart of
caitlynrenderer_tpu/render/integrator.py:376-694).

The whole ray batch advances bounce by bounce as dense (N, ...) tensors:
raygen → closest hit → shade (emission, NEE with a shadow any-hit, MIS) →
scatter, with masked lanes for dead paths.  Both ray queries go through
the scene's accelerator: ops/mt_brute under "brute", ops/traverse_mega
under "wide" and ops/traverse_cw8 under "cwbvh", each of which launches
its CUDA kernel for CUDA tensors, and ops/traverse_bvh (plain torch ops,
as the reference's XLA walk) under "bvh2" and "sbvh".  The estimator, the
uniform layout and the order of the arithmetic are the reference's, so the
tests can hold the two against each other per pixel.  A vertex's steps
(`hit_frame`, `light_sample`, `continuation`) are functions of their own,
so that chip_smoke.py builds the kernels' bounce and shadow ray sets with
the integrator's code.

Ported: the "lambert" family, NEE + MIS power heuristic,
`exact_reference_nee`, Russian roulette (`rr_start`) and the ray-count
stats.  Disney/mirror/glass, textures, the env map and AOVs raise
NotImplementedError (ROADMAP.md queue A).  The wide and cwbvh paths
thread the reference's origin-group (window) hint `og`; its `preorder` has
no counterpart, and `options.traversal` is not read (each accelerator has
one path per device).
"""

from __future__ import annotations

import math

import torch

from caitlynrenderer_tpu_torch.core.types import Camera, RenderOptions
from caitlynrenderer_tpu_torch.core import math as cm
from caitlynrenderer_tpu_torch.core.camera import generate_rays
from caitlynrenderer_tpu_torch.ops.intersect import refine_hit_tri
from caitlynrenderer_tpu_torch.ops.mt_brute import brute_anyhit, brute_closest
from caitlynrenderer_tpu_torch.ops.traverse_bvh import traverse_anyhit, traverse_closest
from caitlynrenderer_tpu_torch.ops.traverse_cw8 import cw8_anyhit, cw8_closest
from caitlynrenderer_tpu_torch.ops.traverse_mega import mega_anyhit, mega_closest
from caitlynrenderer_tpu_torch.scene import ACCELS, DeviceScene

EPS = cm.EPS
RAY_OFFSET = cm.RAY_OFFSET


def check_supported(ds: DeviceScene, options: RenderOptions) -> None:
    """Raise NotImplementedError for any option the port does not cover yet,
    naming the ROADMAP item that will, and ValueError for an accelerator
    the scene was not uploaded for ("brute" runs on every upload)."""
    extra = [f for f in options.families if f != "lambert"]
    if extra:
        raise NotImplementedError(
            f"shading families {extra} are not ported yet (ROADMAP A1); "
            "set options.families = scene.scene_families(scene)"
        )
    sc = ds.scene
    if options.use_env_map and sc.env_map is not None:
        raise NotImplementedError("environment maps are not ported yet (ROADMAP A2)")
    if sc.textures is not None and sc.texcoords.shape[0] > 0:
        raise NotImplementedError("textured albedo is not ported yet (ROADMAP A2)")
    if options.aov != "beauty":
        raise NotImplementedError(f"AOV {options.aov!r} is not ported yet (ROADMAP A3)")
    if options.accel not in ACCELS:
        raise ValueError(f"unknown accel {options.accel!r} (expected one of {'/'.join(ACCELS)})")
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
    `options._replace(max_stack=scene.required_stack(ds))`."""
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
    return ds.node_bounds, ds.node_meta, ds.scene.vertices, ds.scene.tri_v


def _closest_hit_raw(ds: DeviceScene, o, d, active, options: RenderOptions, og):
    """Closest-hit dispatch on options.accel.  Returns (t, tri, u, v, group):
    group is the wide BVH's winning group or the CWBVH's winning window
    (None under the others), and the wide and cwbvh paths' u = v = 0 (the
    caller refines them from the triangle)."""
    if options.accel in ("wide", "cwbvh"):
        query = mega_closest if options.accel == "wide" else cw8_closest
        args = _wide(ds) if options.accel == "wide" else _cw(ds)
        t, tri, grp = query(o, d, active, *args, og=og)
        zero = torch.zeros_like(t)
        return t, tri, zero, zero, grp
    if options.accel in ("bvh2", "sbvh"):
        _check_stack(ds, options)
        return (*traverse_closest(o, d, active, *_bvh(ds), max_leaf=options.max_leaf,
                                  max_stack=options.max_stack), None)
    return (*brute_closest(o, d, active, ds.tris9), None)


def _occluded(ds: DeviceScene, o, d, t_max, active, options: RenderOptions, og):
    """Any-hit visibility dispatch on options.accel."""
    if options.accel == "wide":
        return mega_anyhit(o, d, t_max, active, *_wide(ds), og=og)
    if options.accel == "cwbvh":
        return cw8_anyhit(o, d, t_max, active, *_cw(ds), og=og)
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


def _shading_normal_from_rows(rows, u, v):
    geo_n = cm.normalize(cm.cross(rows[:, 3:6], rows[:, 6:9]))
    interp = cm.normalize(cm.interpolate(rows[:, 9:12], rows[:, 12:15], rows[:, 15:18], u, v))
    return torch.where((rows[:, 18] > 0.5)[:, None], interp, geo_n)


def bounce_uniforms(uniforms, bounce: int):
    """A bounce's seven uniforms, render/sampling.py's layout: (light_pick,
    light_u1, light_u2, bsdf_u1, bsdf_u2, bsdf_lobe, rr)."""
    base = 4 + 7 * bounce
    return tuple(uniforms[:, base + k] for k in range(7))


def hit_frame(ds: DeviceScene, o, d, raw_t, raw_tri, raw_u, raw_v):
    """A closest-hit query's answer as the integrator shades it: the hit
    triangle's shading rows, where it hit, the hit's t refined from its
    triangle (the query's own where it missed), the shading normal flipped
    against the incoming ray, and the next rays' origin, RAY_OFFSET off
    the surface along that normal.  Returns (rows, keep, hit_t, n_flip,
    hit_point)."""
    rows = ds.shade_tab[torch.clamp(raw_tri, min=0).long()]
    t_r, u_r, v_r = refine_hit_tri(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    keep = raw_tri >= 0
    hit_t = torch.where(keep, t_r, raw_t)
    hit_u = torch.where(keep, u_r, raw_u)
    hit_v = torch.where(keep, v_r, raw_v)
    n_shade = _shading_normal_from_rows(rows, hit_u, hit_v)
    cos_incident = cm.dot(d, n_shade)
    n_flip = torch.where((cos_incident > 0)[:, None], -n_shade, n_shade)
    hit_point = o + d * hit_t[:, None] + n_flip * RAY_OFFSET
    return rows, keep, hit_t, n_flip, hit_point


def light_sample(light_tab, hit_point, n_flip, u_lp, u_l1, u_l2, alive):
    """NEE's light sample and shadow ray: a light picked by u_lp, a point on
    it by u_l1, u_l2, the unit direction from hit_point towards it and its
    distance.  The any-hit query is issued where `cand` (the path goes on,
    the point lies above the surface and the light faces it), with t_max
    the distance less EPS (0 elsewhere).  Returns (lrows, ldir, dist,
    cos_mtl, cos_light, cand, t_max)."""
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
    cand = alive & (cos_mtl > 0) & (cos_light < 0)
    return lrows, ldir, dist, cos_mtl, cos_light, cand, torch.where(cand, dist - EPS, 0.0)


def continuation(u_b1, u_b2, n_flip):
    """The continuation ray's cosine-weighted Lambert direction about
    n_flip.  Returns (local, d): the local-frame sample and the unit
    world-space direction."""
    local = cm.cosine_hemisphere_dir(u_b1, u_b2)
    return local, cm.normalize(cm.local_to_world(local, n_flip))


def trace_paths(ds: DeviceScene, o, d, uniforms, options: RenderOptions, with_stats: bool = False):
    """Trace one path per input ray; returns radiance (N, 3), or
    (radiance, stats) when with_stats.  stats counts the ray queries
    actually issued: "rays_closest", "rays_anyhit" (int tensors) and
    "alive_per_bounce" ((max_depth,) tensor of live lanes entering each
    closest-hit query).

    uniforms: (N, 4 + 7*max_depth), layout in render/sampling.py; the first
    4 (raygen) entries are unused here.
    """
    check_supported(ds, options)
    n, dev = o.shape[0], o.device
    num_lights = ds.light_tab.shape[0]
    light_tab = ds.light_tab

    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    T = torch.ones((n, 3), dtype=torch.float32, device=dev)
    prev_pdf = torch.ones(n, dtype=torch.float32, device=dev)
    is_specular = torch.ones(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    # The origin-group hint of the wide BVH (the CWBVH's: origin window):
    # the group that produced each ray's origin (0 for primary rays).
    og = torch.zeros(n, dtype=torch.int32, device=dev)
    alive_per_bounce, anyhit_per_bounce = [], []

    for bounce in range(options.max_depth):
        u_lp, u_l1, u_l2, u_b1, u_b2, _, u_rr = bounce_uniforms(uniforms, bounce)

        # Russian roulette from rr_start on: survive with p = max throughput
        # component (clamped to [0.05, 1]) and compensate T by 1/p.
        if 0 <= options.rr_start <= bounce:
            p_surv = torch.clamp(T.max(dim=1).values, 0.05, 1.0)
            alive = alive & (u_rr < p_surv)
            T = T / p_surv[:, None]

        if with_stats:
            alive_per_bounce.append(alive.sum())
        raw_t, raw_tri, raw_u, raw_v, grp = _closest_hit_raw(ds, o, d, alive, options, og)
        rows, keep, hit_t, n_flip, hit_point = hit_frame(ds, o, d, raw_t, raw_tri, raw_u, raw_v)
        got = alive & keep
        alive = got
        if grp is not None:
            og = torch.clamp(grp, min=0)

        albedo = rows[:, 26:29]
        emission = rows[:, 30:33]
        emissive = rows[:, 33] != -1
        li_hit = torch.round(rows[:, 25]).long()

        # Emissive hit, weighted against the NEE that could have sampled it.
        hit_light = got & emissive
        if num_lights > 0:
            area = light_tab[torch.clamp(li_hit, 0, num_lights - 1), 15]
            cos_light = -cm.dot(d, n_flip)
            pdf_select = 1.0 / num_lights
            pdf_light = (
                hit_t * hit_t
                / torch.clamp(area * torch.clamp(cos_light, min=1e-8), min=1e-20)
                * pdf_select
            )
            w_mis = torch.where(is_specular, 1.0, _power_heuristic(prev_pdf, pdf_light))
            L = L + torch.where(hit_light[:, None], T * emission * w_mis[:, None], 0.0)
            alive = alive & ~hit_light

        # NEE with MIS: one light sample per vertex, visibility by any-hit.
        if num_lights > 0:
            lrows, ldir, dist, cos_mtl, cos_light, cand, shadow_t = light_sample(
                light_tab, hit_point, n_flip, u_lp, u_l1, u_l2, alive)
            if with_stats:
                anyhit_per_bounce.append(cand.sum())
            shadowed = _occluded(ds, hit_point, ldir, shadow_t, cand, options, og)
            visible = cand & ~shadowed
            pdf_light = (
                dist * dist
                / torch.clamp(lrows[:, 15] * torch.clamp(-cos_light, min=1e-8), min=1e-20)
                * pdf_select
            )
            cos_pos = torch.clamp(cos_mtl, min=0.0)
            if options.exact_reference_nee:
                f_lam = albedo  # the reference shader's estimator (no cos/pi)
            else:
                f_lam = albedo * (cos_pos / math.pi)[:, None]
            w_mis = _power_heuristic(pdf_light, cos_pos / math.pi)
            contrib = T * lrows[:, 12:15] * f_lam * (
                w_mis / torch.clamp(pdf_light, min=1e-20)
            )[:, None]
            L = L + torch.where(visible[:, None], contrib, 0.0)

        # Continuation: cosine-weighted Lambert sample.
        local, d = continuation(u_b1, u_b2, n_flip)
        o = hit_point
        T = torch.where(alive[:, None], T * albedo, T)
        prev_pdf = torch.clamp(local[:, 2], min=1e-8) / math.pi
        is_specular = torch.zeros(n, dtype=torch.bool, device=dev)

    if not with_stats:
        return L
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return L, {
        "rays_closest": sum(alive_per_bounce, zero),
        "rays_anyhit": sum(anyhit_per_bounce, zero),
        "alive_per_bounce": torch.stack(alive_per_bounce),
    }


def render_sample(ds: DeviceScene, camera: Camera, uniforms, width: int, height: int,
                  options: RenderOptions):
    """One full sample of every pixel: raygen + path trace.  Returns
    (H*W, 3) radiance on the uniforms' device."""
    o, d = generate_rays(camera, width, height, uniforms)
    return trace_paths(ds, o, d, uniforms, options)
