"""The plain reference path tracer for scenes of Lambert, mirror and glass
surfaces under area lights, with interpolated vertex normals: `tracer`'s
estimator with the two delta lobes.

- Mirror (type 1): the reflection about the shading normal,
  r = d - 2 (d . n) n.
- Glass (type 2): a smooth dielectric of the material's ior.  Its
  reflectance is the unpolarised Fresnel term of PBRT's `FrDielectric`
  and its transmitted direction PBRT's `Refract`, both with cos(theta_i)
  taken about the shading normal on the incident side; a sine of the
  transmitted angle of 1 or more is total internal reflection.  The
  bounce's `bsdf_lobe` uniform picks reflection where it lies below the
  reflectance (always at total internal reflection), else refraction.
- At a delta vertex there is no next-event estimation (no light sample,
  no shadow ray), the continuation's pdf is 1, and emission reached
  after a delta bounce weighs 1 in multiple importance sampling, as on a
  camera ray.
- A refracted ray leaves from the other side of the surface: its origin
  is the hit point moved twice RAY_OFFSET against the offset normal.
- Where a triangle flags interpolated normals, the shading normal is the
  normalised barycentric blend of its vertex normals at the refined hit
  (u, v); the offset, the flip toward the incoming ray, the cosines of the
  light sample and the lobes all take it.  A flat triangle's is its
  geometric normal.

The Fresnel term is PBRT's with its numerators and denominators divided
by eta_t, in terms of eta = eta_i / eta_t:

    r_par  = (cos_i - eta cos_t) / (cos_i + eta cos_t)
    r_perp = (eta cos_i - cos_t) / (eta cos_i + cos_t)
    F      = (r_par^2 + r_perp^2) / 2

Departures from PBRT's description, each the program's:
- The delta lobes' throughput is T . albedo: a mirror's reflectance, and
  for glass T . albedo whichever lobe the Fresnel choice takes (PBRT's
  F / F and (1 - F) / (1 - F) with the albedo as its R and T), without
  PBRT's (eta_i / eta_t)^2 scaling of transported radiance.
- The reflectance and the direction use the shading normal, not the
  geometric one.
- The cosine of the transmitted angle is floored at 1e-6 (its square at
  1e-12) and the Fresnel denominators at 1e-12, so that no lane divides
  by zero; a floored lane is a total internal reflection, whose
  reflectance is 1 whatever the floor gives.

No Russian roulette; no environment map, Disney or other material, or
texture, which `load_scene` refuses, and no thin lens, which
`refuse_camera` refuses.  The arithmetic keeps the order of
the program's float32 expressions, so that on one device the two agree to
rounding; `dtype` is the precision it runs in, as in `tracer`.  The
camera, the display and the uniforms are `tracer`'s and `sampler`'s.
"""

from __future__ import annotations

import math
import types
from typing import NamedTuple

import numpy as np
import torch

from cellbench.reference import accel, tracer
from cellbench.reference.disney import _cosine, _reflect as reflect, _to_world
# refuse_camera, camera_rays and display are this reference's too (the
# interface of cellbench/reference/__init__.py).
from cellbench.reference.tracer import (EPS, RAY_OFFSET, _power, camera_rays,  # noqa: F401
                                        display, normalize, refuse_camera)

DIFFUSE, MIRROR, GLASS, LIGHT_DIFFUSE = 0, 1, 2, 16
TRACED = {DIFFUSE, MIRROR, GLASS, LIGHT_DIFFUSE}


class Scene(NamedTuple):
    geo: accel.Geometry
    rows: torch.Tensor  # (T, 15): v0 | e1 | e2 | albedo | emission, by scene triangle id
    normals: torch.Tensor  # (T, 9): n0 | n1 | n2, the vertex normals
    smooth: torch.Tensor  # (T,) bool: the triangle interpolates its vertex normals
    mirror: torch.Tensor  # (T,) bool
    glass: torch.Tensor  # (T,) bool
    ior: torch.Tensor  # (T,)
    emissive: torch.Tensor  # (T,) bool
    light_of: torch.Tensor  # (T,) int64 light index of an emissive triangle
    lights: torch.Tensor  # (L, 17): p | u | v | n | e | area | pdf
    dtype: torch.dtype


def load_scene(sc: dict, device, dtype=torch.float32) -> Scene:
    """The reference's tables of a scene dict (cellbench.scenes.builtin's
    layout).  Raises ValueError for what it does not trace: a material
    that is neither Lambert, mirror nor glass (the Disney BRDF, the
    coloured and thin glasses, the conductors), an environment map,
    textures."""
    mats = sc["materials"]
    tri_v = sc["tri_v"]
    types = set(np.unique(mats["albedo"][:, 3]).astype(int).tolist())
    if not types <= TRACED:
        raise ValueError(f"the reference traces Lambert, mirror and glass materials only; "
                         f"material types {sorted(types - TRACED)}")
    tracer.refuse_images(sc)
    v = sc["vertices"].astype(np.float32)
    p0, p1, p2 = (v[tri_v[:, k]] for k in range(3))
    m = tri_v[:, 3]
    rows = np.concatenate([p0, p1 - p0, p2 - p0, mats["albedo"][m, :3], mats["emission"][m, :3]],
                          axis=1)
    smooth = sc["tri_vn"][:, 3] == 1
    vn = sc["normals"].astype(np.float32)
    normals = np.zeros((len(tri_v), 9), np.float32)
    if smooth.any():
        ids = sc["tri_vn"][smooth, :3]
        normals[smooth] = np.concatenate([vn[ids[:, k]] for k in range(3)], axis=1)
    mtype = mats["albedo"][m, 3].astype(int)
    lt = sc["lights"]
    lights = np.concatenate([lt["p"], lt["u"], lt["v"], lt["n"], lt["e"], lt["area_pdf"]], axis=1)

    def put(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return Scene(accel.build(v, tri_v, device, dtype), put(rows), put(normals),
                 put(smooth, torch.bool), put(mtype == MIRROR, torch.bool),
                 put(mtype == GLASS, torch.bool), put(mats["specular"][m, 3]),
                 put(mats["emission"][m, 3] != -1, torch.bool),
                 put(sc["tri_vt"][:, 3], torch.int64), put(lights.reshape(-1, 17)), dtype)


# -- the delta lobes -------------------------------------------------------


def fresnel_dielectric(cos_i, eta):
    """(F, cos_t, tir): the unpolarised reflectance of a smooth dielectric
    for cos_i = |cos(theta_i)| and eta = eta_i / eta_t, the cosine of the
    transmitted angle (Snell: sin_t = eta sin_i) and where the transmission
    is totally internally reflected (F = 1 there)."""
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    r_par = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    r_perp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    tir = sin2_t >= 1.0
    return torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp)), cos_t, tir


def refract(d, n, eta, cos_i, cos_t):
    """The unit transmitted direction of d through a surface of unit normal
    n on the incident side: eta d + (eta cos_i - cos_t) n, PBRT's `Refract`
    with wi = -d."""
    return normalize(eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * n)


def glass_lobe(d, n_flip, cos_incident, ior, u_lobe):
    """(direction, refracted): the glass's continuation of d at a surface
    whose shading normal n_shade has dot(d, n_shade) = cos_incident and
    n_flip = n_shade turned toward the incoming ray.  Entering (cos_incident
    <= 0) eta = 1 / ior, leaving eta = ior; u_lobe below the reflectance
    (or total internal reflection) reflects (`reflect`, the mirror
    direction d - 2 (d . n) n), else the ray refracts.  The direction is
    not yet normalised, as the program's `continuation` gives it to its
    last normalisation."""
    entering = cos_incident <= 0
    eta = torch.where(entering, 1.0 / torch.clamp(ior, min=1e-6), ior)
    cos_i = torch.abs(accel.dot(d, n_flip))
    fres, cos_t, tir = fresnel_dielectric(cos_i, eta)
    choose_refl = (u_lobe < fres) | tir
    direction = torch.where(choose_refl[:, None], reflect(d, n_flip),
                            refract(d, n_flip, eta, cos_i, cos_t))
    return direction, ~choose_refl


def shading_normal(scene: Scene, tri, rows, u, v):
    """The shading normal of hits (tri, u, v): the interpolated vertex
    normal where the triangle flags it, else the geometric normal."""
    n_geo = normalize(accel.cross(rows[:, 3:6], rows[:, 6:9]))
    nv = scene.normals[tri]
    w = 1.0 - u - v
    blend = nv[:, 0:3] * w[:, None] + nv[:, 3:6] * u[:, None] + nv[:, 6:9] * v[:, None]
    return torch.where(scene.smooth[tri][:, None], normalize(blend), n_geo)


# -- the path tracer -------------------------------------------------------


def trace(scene: Scene, o, d, uni, max_depth: int, record=None):
    """Radiance (N, 3) of paths from rays (o, d) with uniforms `uni`
    ((N, 4 + 7 max_depth)).  `record`, if a list, receives each query's
    rays: ("closest", o, d, active) and ("anyhit", o, d, t_max, active)."""
    n, dev, dt = o.shape[0], o.device, scene.dtype
    lights = scene.lights
    num_lights = lights.shape[0]
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    T = torch.ones((n, 3), dtype=dt, device=dev)
    prev_pdf = torch.ones(n, dtype=dt, device=dev)
    specular = torch.ones(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for bounce in range(max_depth):
        base = 4 + 7 * bounce
        u_lp, u_l1, u_l2, u_b1, u_b2, u_lobe = (uni[:, base + k] for k in range(6))
        if record is not None:
            record.append(("closest", o, d, alive))
        raw_t, tri = accel.closest(scene.geo, o, d, alive)
        tri_c = torch.clamp(tri, min=0)
        rows = scene.rows[tri_c]
        _, t_r, u_r, v_r = accel.mt(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
        keep = tri >= 0
        hit_t = torch.where(keep, t_r, raw_t)
        n_shade = shading_normal(scene, tri_c, rows, torch.where(keep, u_r, 0.0),
                                 torch.where(keep, v_r, 0.0))
        cos_incident = accel.dot(d, n_shade)
        n_flip = torch.where((cos_incident > 0)[:, None], -n_shade, n_shade)
        point = o + d * hit_t[:, None] + n_flip * RAY_OFFSET
        alive = alive & keep
        albedo = rows[:, 9:12]
        mirror, glass = scene.mirror[tri_c], scene.glass[tri_c]
        delta = mirror | glass
        hit_light = alive & scene.emissive[tri_c]
        pdf_select = 1.0 / max(num_lights, 1)
        if num_lights > 0:
            area = lights[torch.clamp(scene.light_of[tri_c], 0, num_lights - 1), 15]
            cos_light = -accel.dot(d, n_flip)
            pdf_light = (hit_t * hit_t / torch.clamp(area * torch.clamp(cos_light, min=1e-8),
                                                      min=1e-20) * pdf_select)
            w_mis = torch.where(specular, 1.0, _power(prev_pdf, pdf_light))
            L = L + torch.where(hit_light[:, None], T * rows[:, 12:15] * w_mis[:, None], 0.0)
            alive = alive & ~hit_light

            # Next-event estimation off the Lambert vertices alone.
            li = torch.clamp((u_lp * num_lights).to(torch.int64), max=num_lights - 1)
            s = torch.sqrt(u_l1)
            lr = lights[li]
            lpos = lr[:, 0:3] + (1.0 - s)[:, None] * lr[:, 3:6] + (u_l2 * s)[:, None] * lr[:, 6:9]
            ldir = lpos - point
            dist = torch.sqrt(torch.clamp(accel.dot(ldir, ldir), min=0.0))
            ldir = ldir / torch.clamp(dist[:, None], min=1e-20)
            cos_mtl = accel.dot(ldir, n_flip)
            cos_l = accel.dot(ldir, lr[:, 9:12])
            cand = alive & ~delta & (cos_mtl > 0) & (cos_l < 0)
            shadow_t = torch.where(cand, dist - EPS, 0.0)
            if record is not None:
                record.append(("anyhit", point, ldir, shadow_t, cand))
            visible = cand & ~accel.occluded(scene.geo, point, ldir, shadow_t, cand)
            pdf_l = (dist * dist / torch.clamp(lr[:, 15] * torch.clamp(-cos_l, min=1e-8), min=1e-20)
                     * pdf_select)
            cos_pos = torch.clamp(cos_mtl, min=0.0)
            f_nee = albedo * (cos_pos / math.pi)[:, None]
            w = _power(pdf_l, cos_pos / math.pi)
            contrib = T * lr[:, 12:15] * f_nee * (w / torch.clamp(pdf_l, min=1e-20))[:, None]
            L = L + torch.where(visible[:, None], contrib, 0.0)

        # The continuation: cosine-weighted off a Lambert surface, the
        # mirror direction off a mirror, the Fresnel choice off glass.
        local = _cosine(u_b1, u_b2)
        l_lam = _to_world(local, n_flip)
        l_glass, refracted = glass_lobe(d, n_flip, cos_incident, scene.ior[tri_c], u_lobe)
        new_d = torch.where(glass[:, None], l_glass,
                            torch.where(mirror[:, None], reflect(d, n_flip), l_lam))
        prev_pdf = torch.where(delta, 1.0, torch.clamp(local[:, 2], min=1e-8) / math.pi)
        specular = delta
        d = normalize(new_d)
        o = point + torch.where((glass & refracted)[:, None], -2.0 * RAY_OFFSET * n_flip, 0.0)
        T = torch.where(alive[:, None], T * albedo, T)
    return L.float()


def _with_this_trace(fn):
    """`tracer`'s function `fn` run with this module's `trace`, `radiance`
    and `accumulate`: the sampling loops are written once, in `tracer`."""
    return types.FunctionType(fn.__code__, _TRACER_GLOBALS, fn.__name__, fn.__defaults__)


# radiance(scene, cam, width, height, max_depth, key, sample_idx, pixel_ids)
# and accumulate(scene, cam, width, height, max_depth, key, samples,
# pixel_ids, paths_per_block): `tracer`'s, through this module's `trace`.
_TRACER_GLOBALS = {**vars(tracer), "trace": trace}
radiance = _TRACER_GLOBALS["radiance"] = _with_this_trace(tracer.radiance)
accumulate = _TRACER_GLOBALS["accumulate"] = _with_this_trace(tracer.accumulate)
