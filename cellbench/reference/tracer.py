"""The plain reference path tracer: the estimator the program under test
computes, written out in torch for Lambert scenes lit by area lights.

A path starts at the camera's tent-filtered primary ray of its pixel and
takes `max_depth` bounces: closest hit, emission weighted by multiple
importance sampling (power heuristic) against next-event estimation, one
light sample with a shadow any-hit query, then a cosine-weighted
continuation.  No Russian roulette; no environment map, texture or thin
lens, which `load_scene` and `refuse_camera` refuse.  The arithmetic
follows the order of the reference renderer's integrator, so that on one
device the two agree to rounding, and every path is a function of (base
key, sample, pixel) alone: any set of pixels and samples is traced
without the rest of the frame.

`dtype` is the precision the arithmetic runs in: float32, the
configuration's, or a lower one for the control; the uniforms are drawn
in float32 and rounded to it, and radiance is returned in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cellbench.reference import accel, sampler

EPS = 1e-4
RAY_OFFSET = 2e-4
DIFFUSE, LIGHT_DIFFUSE = 0, 16  # the Lambert material types


class Scene(NamedTuple):
    geo: accel.Geometry
    rows: torch.Tensor  # (T, 15): v0 | e1 | e2 | albedo | emission, by scene triangle id
    emissive: torch.Tensor  # (T,) bool
    light_of: torch.Tensor  # (T,) int64 light index of an emissive triangle
    lights: torch.Tensor  # (L, 17): p | u | v | n | e | area | pdf
    dtype: torch.dtype


def refuse_images(sc: dict) -> None:
    """Raises ValueError where the scene dict `sc` holds what none of these
    references traces: an environment map (their misses are black), a
    texture atlas or a textured material (their albedo is the material's)."""
    if sc.get("env_map") is not None:
        raise ValueError("the reference traces no environment map; the scene has one")
    if sc.get("textures") is not None or (sc["materials"]["tex_ind"][:, 0] >= 0).any():
        raise ValueError("the reference traces untextured scenes only; the scene has "
                         "a texture atlas or a textured material")


def refuse_camera(cam: dict) -> None:
    """Raises ValueError for a thin lens (aperture > 0), which none of
    these references traces: their rays leave the pinhole."""
    if float(cam["aperture"]) > 0.0:
        raise ValueError(f"the reference traces a pinhole camera only; the camera's aperture "
                         f"is {float(cam['aperture'])!r}")


def load_scene(sc: dict, device, dtype=torch.float32) -> Scene:
    """The reference's tables of a scene dict (cellbench.scenes.builtin).
    Raises ValueError for what this reference does not trace: a material
    that is not Lambert, an environment map, textures, interpolated vertex
    normals."""
    mats = sc["materials"]
    tri_v = sc["tri_v"]
    types = set(np.unique(mats["albedo"][:, 3]).astype(int).tolist())
    if not types <= {DIFFUSE, LIGHT_DIFFUSE}:
        raise ValueError(f"the reference traces Lambert scenes only; material types {sorted(types)}")
    refuse_images(sc)
    if (sc["tri_vn"][:, 3] == 1).any():
        raise ValueError("the reference traces flat-shaded scenes only")
    v = sc["vertices"].astype(np.float32)
    p0, p1, p2 = (v[tri_v[:, k]] for k in range(3))
    m = tri_v[:, 3]
    rows = np.concatenate([p0, p1 - p0, p2 - p0, mats["albedo"][m, :3], mats["emission"][m, :3]],
                          axis=1)
    lt = sc["lights"]
    lights = np.concatenate([lt["p"], lt["u"], lt["v"], lt["n"], lt["e"], lt["area_pdf"]], axis=1)

    def put(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return Scene(accel.build(v, tri_v, device, dtype), put(rows),
                 put(mats["emission"][m, 3] != -1, torch.bool),
                 put(sc["tri_vt"][:, 3], torch.int64), put(lights.reshape(-1, 17)), dtype)


def normalize(v):
    return v * torch.reciprocal(torch.sqrt(torch.clamp(accel.dot(v, v)[..., None], min=1e-20)))


def camera_rays(cam: dict, width: int, height: int, pixel_ids, raygen, dtype):
    """Tent-filtered pinhole rays of pixels `pixel_ids` (row-major from
    the bottom row) from their raygen uniforms `raygen` ((N, 4): the
    tent jitter pair, then the lens pair, which a pinhole leaves unread).
    Raises ValueError for a thin lens, as `refuse_camera` does."""
    refuse_camera(cam)
    u0, u1 = raygen[:, 0], raygen[:, 1]
    dev = pixel_ids.device

    def vec(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev).to(dtype)

    xx = (pixel_ids % width).to(dtype)
    yy = torch.div(pixel_ids, width, rounding_mode="floor").to(dtype)
    u = (xx + 0.5) / width
    v = (yy + 0.5) / height
    jx, jy = _tent(2.0 * u0), _tent(2.0 * u1)
    dx = (2.0 * u - 1.0) + jx / (width * 0.5)
    dy = (2.0 * v - 1.0) + jy / (height * 0.5)
    tan_fov = torch.tan(vec(cam["fov"]) * 0.5)
    dx = dx * (width / height) * tan_fov
    dy = dy * tan_fov
    right, up, forward = vec(cam["right"]), vec(cam["up"]), vec(cam["forward"])
    d = normalize(dx[:, None] * right[None, :] + dy[:, None] * up[None, :] + forward[None, :])
    return vec(cam["position"]).expand_as(d).clone(), d


def _tent(r):
    return torch.where(r < 1.0, torch.sqrt(r) - 1.0, 1.0 - torch.sqrt(torch.clamp(2.0 - r, min=0.0)))


def _power(a, b):
    a = torch.clamp(a, 0.0, 1e12)
    b = torch.clamp(b, 0.0, 1e12)
    t = a * a
    return t / torch.clamp(b * b + t, min=1e-20)


def _onb(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    a = 1.0 / torch.clamp(1.0 + nz, min=1e-7)
    b = -nx * ny * a
    u = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    v = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    pole = (nz < -0.9999999)[..., None]
    axis = torch.arange(3, device=n.device)
    u_pole = torch.where(axis == 1, -1.0, 0.0).to(n.dtype)
    v_pole = torch.where(axis == 0, -1.0, 0.0).to(n.dtype)
    return torch.where(pole, u_pole, u), torch.where(pole, v_pole, v)


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
        u_lp, u_l1, u_l2, u_b1, u_b2 = (uni[:, base + k] for k in range(5))
        if record is not None:
            record.append(("closest", o, d, alive))
        raw_t, tri = accel.closest(scene.geo, o, d, alive)
        rows = scene.rows[torch.clamp(tri, min=0)]
        _, t_r, _, _ = accel.mt(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
        keep = tri >= 0
        hit_t = torch.where(keep, t_r, raw_t)
        n_geo = normalize(accel.cross(rows[:, 3:6], rows[:, 6:9]))
        cos_in = accel.dot(d, n_geo)
        n_flip = torch.where((cos_in > 0)[:, None], -n_geo, n_geo)
        point = o + d * hit_t[:, None] + n_flip * RAY_OFFSET
        got = alive & keep
        alive = got
        albedo = rows[:, 9:12]
        tri_c = torch.clamp(tri, min=0)
        hit_light = got & scene.emissive[tri_c]
        pdf_select = 1.0 / max(num_lights, 1)
        if num_lights > 0:
            area = lights[torch.clamp(scene.light_of[tri_c], 0, num_lights - 1), 15]
            cos_light = -accel.dot(d, n_flip)
            pdf_light = (hit_t * hit_t / torch.clamp(area * torch.clamp(cos_light, min=1e-8),
                                                      min=1e-20) * pdf_select)
            w_mis = torch.where(specular, 1.0, _power(prev_pdf, pdf_light))
            L = L + torch.where(hit_light[:, None], T * rows[:, 12:15] * w_mis[:, None], 0.0)
            alive = alive & ~hit_light

            li = torch.clamp((u_lp * num_lights).to(torch.int64), max=num_lights - 1)
            s = torch.sqrt(u_l1)
            b0 = 1.0 - s
            b1 = u_l2 * s
            lr = lights[li]
            lpos = lr[:, 0:3] + b0[:, None] * lr[:, 3:6] + b1[:, None] * lr[:, 6:9]
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
            f_nee = albedo * (cos_pos / math.pi)[:, None]
            w = _power(pdf_l, cos_pos / math.pi)
            contrib = T * lr[:, 12:15] * f_nee * (w / torch.clamp(pdf_l, min=1e-20))[:, None]
            L = L + torch.where(visible[:, None], contrib, 0.0)

        r = torch.sqrt(u_b1)
        phi = 2.0 * math.pi * u_b2
        local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                             torch.sqrt(torch.clamp(1.0 - u_b1, min=0.0))], dim=-1)
        bu, bv = _onb(n_flip)
        new_d = bu * local[..., 0:1] + bv * local[..., 1:2] + n_flip * local[..., 2:3]
        prev_pdf = torch.clamp(local[:, 2], min=1e-8) / math.pi
        specular = torch.zeros_like(alive)
        d = normalize(new_d)
        o = point
        T = torch.where(alive[:, None], T * albedo, T)
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


def tonemap(rgb, limit: float = 2.0):
    """Luminance-limited Reinhard, then gamma 1/2.2: the display image of a
    mean radiance."""
    lum = 0.3 * rgb[..., 0] + 0.6 * rgb[..., 1] + 0.1 * rgb[..., 2]
    c = rgb / (1.0 + lum / limit)[..., None]
    return torch.clamp(c, 0.0, 1.0) ** (1.0 / 2.2)


def display(acc, samples: int):
    """The display values of an accumulation of `samples` samples."""
    return tonemap(acc * (1.0 / max(float(samples), 1.0)) * 1.0)
