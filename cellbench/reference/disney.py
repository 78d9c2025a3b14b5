"""The plain reference path tracer for scenes of Lambert and Disney
materials under area lights: `tracer`'s estimator with the Burley 2012
Disney BRDF ("Physically Based Shading at Disney", SIGGRAPH 2012 course
notes) at every hit whose material is neither Lambert nor specular.

The BRDF has five terms: the principled diffuse with its retro-reflection,
blended with the Hanrahan-Krueger-like subsurface approximation by
`subsurface`; sheen; GGX (GTR2) specular in the metallic workflow, its
F0 from the ior tinted by `spec_tint`, with the separable Smith-GGX
shadowing; and the GTR1 clearcoat (F0 0.04, shadowing at alpha 0.25).  A
direction is sampled from a mixture of three lobes, cosine-weighted
diffuse, GGX half-vectors and GTR1 half-vectors, weighted by
(1 - metallic) lum(base), lum(F0) + 0.08 and clearcoat / 4: the bounce's
`bsdf_lobe` uniform picks the lobe, (`bsdf_u1`, `bsdf_u2`) the direction
in it, and the mixture's pdf is the weighted sum of the three lobes'
pdfs, both toward a light sample (NEE under the power heuristic) and for
a continuation.  The BRDF's value is returned times cos(theta_l).  No
Russian roulette; no environment map, mirror, glass, texture or
interpolated normal, which `load_scene` refuses, and no thin lens, which
`refuse_camera` refuses.

The arithmetic keeps the order of the program's float32 expressions, so
that on one device the two agree to rounding; `dtype` is the precision it
runs in, as in `tracer`.  The camera, the display and the uniforms are
`tracer`'s and `sampler`'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cellbench.reference import accel, sampler, tracer
# refuse_camera, camera_rays and display are this reference's too (the
# interface of cellbench/reference/__init__.py).
from cellbench.reference.tracer import (EPS, RAY_OFFSET, _onb, _power, camera_rays,  # noqa: F401
                                        display, normalize, refuse_camera)

LAMBERT = {0, 16}  # DIFFUSE, LIGHT_DIFFUSE
# The types this reference does not trace: mirror, the glasses and
# dielectrics, the conductor (specular in the program: no NEE) and the thin
# sheets.  Every other type below 18 is the Disney BRDF.
REFUSED = {1, 2, 3, 4, 5, 6, 13, 14}
NUM_TYPES = 18


class Params(NamedTuple):
    """The Disney parameters of each lane: base (N, 3), the rest (N,)."""

    base: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    spec_tint: torch.Tensor
    sheen: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    subsurface: torch.Tensor
    ior: torch.Tensor


class Scene(NamedTuple):
    geo: accel.Geometry
    rows: torch.Tensor  # (T, 15): v0 | e1 | e2 | albedo | emission, by scene triangle id
    emissive: torch.Tensor  # (T,) bool
    light_of: torch.Tensor  # (T,) int64 light index of an emissive triangle
    lights: torch.Tensor  # (L, 17): p | u | v | n | e | area | pdf
    disney: torch.Tensor  # (T,) bool: the triangle's material takes the Disney BRDF
    params: torch.Tensor  # (T, 8): roughness, metallic, spec_tint, sheen, clearcoat,
    #                       clearcoat_gloss, subsurface, ior
    dtype: torch.dtype


def load_scene(sc: dict, device, dtype=torch.float32) -> Scene:
    """The reference's tables of a scene dict (cellbench.scenes.builtin's
    layout).  Raises ValueError for what it does not trace: mirror, glass
    and the other specular types, an environment map, textures,
    interpolated vertex normals."""
    mats = sc["materials"]
    tri_v = sc["tri_v"]
    types = set(np.unique(mats["albedo"][:, 3]).astype(int).tolist())
    bad = sorted(t for t in types if t in REFUSED or not 0 <= t < NUM_TYPES)
    if bad:
        raise ValueError(f"the reference traces Lambert and Disney materials only; "
                         f"material types {bad}")
    tracer.refuse_images(sc)
    if (sc["tri_vn"][:, 3] == 1).any():
        raise ValueError("the reference traces flat-shaded scenes only")
    v = sc["vertices"].astype(np.float32)
    p0, p1, p2 = (v[tri_v[:, k]] for k in range(3))
    m = tri_v[:, 3]
    rows = np.concatenate([p0, p1 - p0, p2 - p0, mats["albedo"][m, :3], mats["emission"][m, :3]],
                          axis=1)
    params = np.concatenate([mats["disney"][m], mats["disney2"][m, :3],
                             mats["specular"][m, 3:4]], axis=1)
    disney = ~np.isin(mats["albedo"][m, 3].astype(int), sorted(LAMBERT))
    lt = sc["lights"]
    lights = np.concatenate([lt["p"], lt["u"], lt["v"], lt["n"], lt["e"], lt["area_pdf"]], axis=1)

    def put(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return Scene(accel.build(v, tri_v, device, dtype), put(rows),
                 put(mats["emission"][m, 3] != -1, torch.bool),
                 put(sc["tri_vt"][:, 3], torch.int64), put(lights.reshape(-1, 17)),
                 put(disney, torch.bool), put(params), dtype)


def params_of(scene: Scene, tri, base) -> Params:
    """The Disney parameters of triangles `tri` with base color `base`:
    roughness floored at 0.02 and the ior at 1.01, as the program reads
    them."""
    q = scene.params[tri]
    return Params(base, torch.clamp(q[:, 0], 0.02, 1.0), q[:, 1], q[:, 2], q[:, 3], q[:, 4],
                  q[:, 5], q[:, 6], torch.clamp(q[:, 7], min=1.01))


# -- the BRDF --------------------------------------------------------------


def _lum(c):
    """Rec. 709 luminance."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _fresnel_weight(c):
    """Schlick's (1 - c)^5, c clamped to [0, 1]."""
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    m2 = m * m
    return m * (m2 * m2)


def _gtr2(ndh, a):
    """The GGX distribution D(h) of roughness alpha `a`."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return a2 / torch.clamp(math.pi * t * t, min=1e-12)


def _gtr1(ndh, a):
    """Burley's GTR1 (gamma 1) distribution, the clearcoat's."""
    a2 = torch.clamp(a * a, 1e-4, 0.9999)
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return (a2 - 1.0) / torch.clamp(math.pi * torch.log(a2) * t, max=-1e-12)


def _smith(ndx, a):
    """One direction's separable Smith-GGX factor, 1 / (n.x + sqrt(a^2 +
    n.x^2 - a^2 n.x^2)); two of them and a quarter are G / (4 ndl ndv)."""
    a2 = a * a
    b = ndx * ndx
    return 1.0 / torch.clamp(ndx + torch.sqrt(a2 + b - a2 * b), min=1e-8)


def _tint(p: Params):
    """White blended by spec_tint toward the base color's hue (the base
    over its luminance): the tint of the dielectric specular and the sheen."""
    lum = _lum(p.base)
    hue = torch.where((lum > 0)[:, None], p.base / torch.clamp(lum[:, None], min=1e-8),
                      torch.ones_like(p.base))
    return (1.0 - p.spec_tint[:, None]) + p.spec_tint[:, None] * hue


def _f0(p: Params):
    """The specular reflectance at normal incidence: the dielectric's from
    the ior, tinted, blended to the base color by metallic."""
    q = (p.ior - 1.0) / (p.ior + 1.0)
    r0 = q * q
    dielectric = r0[:, None] * _tint(p)
    return dielectric * (1.0 - p.metallic[:, None]) + p.base * p.metallic[:, None]


def lobe_weights(p: Params):
    """The mixture's weights of the diffuse, specular and clearcoat lobes."""
    w_d = (1.0 - p.metallic) * _lum(p.base)
    w_s = _lum(_f0(p)) + 0.08
    w_c = 0.25 * p.clearcoat
    total = torch.clamp(w_d + w_s + w_c, min=1e-8)
    return w_d / total, w_s / total, w_c / total


def _clearcoat_alpha(p: Params):
    return 0.1 + (0.001 - 0.1) * p.clearcoat_gloss


def eval_pdf(p: Params, n, v, l):
    """(f (N, 3), pdf (N,)): the BRDF times cos(theta_l) and the mixture's
    pdf of l, both 0 where l lies under the surface.  n is the normal on
    the viewer's side, v and l point away from the surface."""
    ndv = torch.clamp(accel.dot(n, v), min=1e-6)
    ndl_raw = accel.dot(n, l)
    above = ndl_raw > 1e-6
    ndl = torch.clamp(ndl_raw, min=1e-6)
    h = normalize(v + l)
    ndh = torch.clamp(accel.dot(n, h), 0.0, 1.0)
    ldh = torch.clamp(accel.dot(l, h), 0.0, 1.0)
    a = torch.clamp(p.roughness * p.roughness, min=1e-4)

    w_l, w_v, w_h = _fresnel_weight(ndl), _fresnel_weight(ndv), _fresnel_weight(ldh)
    # Diffuse: retro-reflection grazing factor fd90, blended with the
    # subsurface approximation (its 1 / (ndl + ndv) - 0.5 volume term).
    fd90 = 0.5 + 2.0 * ldh * ldh * p.roughness
    fd = (1.0 + (fd90 - 1.0) * w_l) * (1.0 + (fd90 - 1.0) * w_v)
    fss90 = ldh * ldh * p.roughness
    fss = (1.0 + (fss90 - 1.0) * w_l) * (1.0 + (fss90 - 1.0) * w_v)
    ss = 1.25 * (fss * (1.0 / torch.clamp(ndl + ndv, min=1e-6) - 0.5) + 0.5)
    diffuse = p.base / math.pi * (fd * (1.0 - p.subsurface) + ss * p.subsurface)[:, None]
    sheen = p.sheen[:, None] * _tint(p) * w_h[:, None]
    # Specular: D F G / (4 ndl ndv) with the 1 / (4 ndl ndv) in the Smith factors.
    d_s = _gtr2(ndh, a)
    f0 = _f0(p)
    fresnel = f0 + (1.0 - f0) * w_h[:, None]
    g_s = _smith(ndl, a) * _smith(ndv, a)
    specular = d_s[:, None] * fresnel * g_s[:, None] * 0.25
    # Clearcoat.
    d_c = _gtr1(ndh, _clearcoat_alpha(p))
    f_c = 0.04 + 0.96 * w_h
    g_c = _smith(ndl, 0.25) * _smith(ndv, 0.25)
    clearcoat = (0.25 * p.clearcoat * d_c * f_c * g_c)[:, None] * 0.25

    f = ((diffuse + sheen) * (1.0 - p.metallic[:, None]) + specular + clearcoat) * ndl[:, None]

    w_d, w_s, w_c = lobe_weights(p)
    # A half-vector lobe's pdf of l: D(h) ndh / (4 ldh).
    pdf = (w_d * (ndl / math.pi) + w_s * (d_s * ndh / torch.clamp(4.0 * ldh, min=1e-8))
           + w_c * (d_c * ndh / torch.clamp(4.0 * ldh, min=1e-8)))
    return torch.where(above[:, None], f, 0.0), torch.where(above, pdf, 0.0)


def _to_world(local, n):
    bu, bv = _onb(n)
    return bu * local[..., 0:1] + bv * local[..., 1:2] + n * local[..., 2:3]


def _cosine(u1, u2):
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], dim=-1)


def _half_vector(n, cos2, u1):
    """A unit half-vector about n at azimuth 2 pi u1 and cos^2(theta) `cos2`."""
    phi = 2.0 * math.pi * u1
    ct = torch.sqrt(torch.clamp(cos2, 1e-12, 1.0 - 1e-12))
    st = torch.sqrt(torch.clamp(1.0 - cos2, 1e-12, 1.0 - 1e-12))
    return _to_world(torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1), n)


def _reflect(d, h):
    return d - 2.0 * accel.dot(d, h)[:, None] * h


def sample(p: Params, n, v, u_lobe, u1, u2):
    """(l, f, pdf): a direction drawn from the lobe mixture (u_lobe against
    the cumulative weights picks diffuse, specular or clearcoat; (u1, u2)
    the direction in it), with `eval_pdf`'s value and pdf there."""
    w_d, w_s, _ = lobe_weights(p)
    a = torch.clamp(p.roughness * p.roughness, min=1e-4)
    l_d = _to_world(_cosine(u1, u2), n)
    # GGX: cos^2 theta_h = (1 - u) / (1 + (a^2 - 1) u).
    l_s = _reflect(-v, _half_vector(n, (1.0 - u2) / torch.clamp(1.0 + (a * a - 1.0) * u2,
                                                                     min=1e-12), u1))
    # GTR1: cos^2 theta_h = (1 - a^(2 (1 - u))) / (1 - a^2).
    a2 = torch.clamp(_clearcoat_alpha(p) * _clearcoat_alpha(p), 1e-4, 0.9999)
    l_c = _reflect(-v, _half_vector(n, (1.0 - torch.pow(a2, 1.0 - u2))
                                    / torch.clamp(1.0 - a2, min=1e-8), u1))
    spec = (u_lobe >= w_d) & (u_lobe < w_d + w_s)
    coat = u_lobe >= (w_d + w_s)
    l = normalize(torch.where(coat[:, None], l_c, torch.where(spec[:, None], l_s, l_d)))
    f, pdf = eval_pdf(p, n, v, l)
    return l, f, pdf


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
        _, t_r, _, _ = accel.mt(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
        keep = tri >= 0
        hit_t = torch.where(keep, t_r, raw_t)
        n_geo = normalize(accel.cross(rows[:, 3:6], rows[:, 6:9]))
        n_flip = torch.where((accel.dot(d, n_geo) > 0)[:, None], -n_geo, n_geo)
        point = o + d * hit_t[:, None] + n_flip * RAY_OFFSET
        alive = alive & keep
        albedo = rows[:, 9:12]
        disney = scene.disney[tri_c]
        p = params_of(scene, tri_c, albedo)
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

            # Next-event estimation: one point on one light, its shadow ray,
            # the BRDF toward it weighted against the BRDF's own pdf.
            li = torch.clamp((u_lp * num_lights).to(torch.int64), max=num_lights - 1)
            s = torch.sqrt(u_l1)
            lr = lights[li]
            lpos = lr[:, 0:3] + (1.0 - s)[:, None] * lr[:, 3:6] + (u_l2 * s)[:, None] * lr[:, 6:9]
            ldir = lpos - point
            dist = torch.sqrt(torch.clamp(accel.dot(ldir, ldir), min=0.0))
            ldir = ldir / torch.clamp(dist[:, None], min=1e-20)
            cos_mtl = accel.dot(ldir, n_flip)
            cos_l = accel.dot(ldir, lr[:, 9:12])
            cand = alive & (cos_mtl > 0) & (cos_l < 0)
            shadow_t = torch.where(cand, dist - EPS, 0.0)
            if record is not None:
                record.append(("anyhit", point, ldir, shadow_t, cand))
            visible = cand & ~accel.occluded(scene.geo, point, ldir, shadow_t, cand)
            pdf_l = (dist * dist / torch.clamp(lr[:, 15] * torch.clamp(-cos_l, min=1e-8), min=1e-20)
                     * pdf_select)
            cos_pos = torch.clamp(cos_mtl, min=0.0)
            f_dis, pdf_dis = eval_pdf(p, n_flip, -d, ldir)
            f_nee = torch.where(disney[:, None], f_dis, albedo * (cos_pos / math.pi)[:, None])
            pdf_bsdf = torch.where(disney, pdf_dis, cos_pos / math.pi)
            w = _power(pdf_l, pdf_bsdf)
            contrib = T * lr[:, 12:15] * f_nee * (w / torch.clamp(pdf_l, min=1e-20))[:, None]
            L = L + torch.where(visible[:, None], contrib, 0.0)

        # The continuation: cosine-weighted off a Lambert surface, the
        # mixture's sample off a Disney one (a sample without pdf ends the path).
        local = _cosine(u_b1, u_b2)
        l_lam = _to_world(local, n_flip)
        pdf_lam = torch.clamp(local[:, 2], min=1e-8) / math.pi
        l_dis, f_dis, pdf_dis = sample(p, n_flip, -d, u_lobe, u_b1, u_b2)
        ok = pdf_dis > 1e-9
        T_dis = T * torch.where(ok[:, None], f_dis / torch.clamp(pdf_dis, min=1e-9)[:, None], 0.0)
        new_T = torch.where(disney[:, None], T_dis, T * albedo)
        prev_pdf = torch.where(disney, torch.clamp(pdf_dis, min=1e-9), pdf_lam)
        specular = torch.zeros_like(alive)
        d = normalize(torch.where(disney[:, None], l_dis, l_lam))
        o = point
        alive = alive & (~disney | ok)
        T = torch.where(alive[:, None], new_T, T)
    return L.float()


def radiance(scene: Scene, cam: dict, width: int, height: int, max_depth: int, key,
             sample_idx, pixel_ids):
    """(S, P, 3) float32 radiance of samples `sample_idx` ((S,) int64) of
    pixels `pixel_ids` ((P,) int64) under base key `key`."""
    uni = sampler.uniforms(key, sample_idx, pixel_ids, max_depth).to(scene.dtype)
    s, p = uni.shape[:2]
    uni = uni.reshape(s * p, -1)
    ids = pixel_ids.repeat(s)
    o, d = camera_rays(cam, width, height, ids, uni[:, 0:4], scene.dtype)
    return trace(scene, o, d, uni, max_depth).reshape(s, p, 3)


def accumulate(scene: Scene, cam: dict, width: int, height: int, max_depth: int, key,
               samples: int, pixel_ids, paths_per_block: int = 1 << 18):
    """(P, 3) float32: samples 0 .. samples - 1 of pixels `pixel_ids` added
    one sample after another from zero, the order of the progressive
    accumulation."""
    dev = pixel_ids.device
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32, device=dev)
    step = max(1, paths_per_block // max(pixel_ids.shape[0], 1))
    for s0 in range(0, samples, step):
        idx = torch.arange(s0, min(samples, s0 + step), dtype=torch.int64, device=dev)
        rad = radiance(scene, cam, width, height, max_depth, key, idx, pixel_ids)
        for i in range(rad.shape[0]):
            acc = acc + rad[i]
    return acc
