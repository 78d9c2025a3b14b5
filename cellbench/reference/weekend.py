"""The plain reference path tracer of sky-lit scenes: no area light, the
environment map on every miss, a thin-lens camera, a texture atlas, and
Lambert, Disney, mirror and glass surfaces with interpolated vertex
normals.  The estimator of the final scene of Shirley's "Ray Tracing in
One Weekend" (v3.2.3, section 13: `ray_color`, `random_scene`, the
camera's `defocus`), as the program computes it.

- The camera: `tracer`'s tent-filtered pinhole ray through the pixel,
  then the thin lens written out here from the two lens uniforms: a point
  of the aperture disk at radius sqrt(u) aperture / 2 and angle 2 pi u'
  in the camera's right / up plane, the ray re-aimed from it through the
  pinhole ray's point on the focal plane (at `focal_dist` along the view
  axis).
- A path takes `max_depth` closest-hit queries.  A live ray that meets
  nothing adds T times the environment map in its direction (weight 1:
  there is no light to sample, so nothing else reaches that radiance)
  and ends; no next-event estimation, no any-hit query.
- At a hit the albedo is the material's, or, where the material names an
  atlas layer, that layer's bilinear lookup at the hit's interpolated
  texture coordinates, wrapping (GL_REPEAT); texel (x, y) centred at
  ((x + 0.5) / W, (y + 0.5) / H).  The lookup and the sky's are written
  here, apart from the program's.
- The continuation by family: cosine-weighted off Lambert; the Disney
  BRDF's lobe mixture (`disney.sample`); the mirror direction; glass's
  Fresnel choice and refraction (`specular.glass_lobe`), a refracted ray
  leaving from the far side.  T is multiplied by the albedo on the
  Lambert and delta lobes and by f / pdf on the Disney lobe (a sample
  without pdf ends the path).
- The environment map is equirectangular: longitude atan2(z, x) / 2 pi +
  1 / 2 across its columns (wrapping), polar angle acos(y) / pi down its
  rows from the zenith (clamped as the program clamps them), bilinear.

Departures from the book, each the program's or the configuration's:
- triangles (UV spheres with interpolated normals) in place of analytic
  spheres;
- a flat ground square in place of the sphere of radius 1000;
- the sky as an equirectangular map of the book's gradient, in place of
  the gradient computed from the direction;
- the Disney BRDF (metallic 1, roughness the fuzz) in place of the fuzzed
  metal's perturbed reflection;
- exact Fresnel (PBRT's `FrDielectric`) in place of Schlick's
  approximation, and T . albedo on both glass lobes;
- the tent pixel filter and the program's sampler (the uniforms of
  `sampler`) in place of a box filter and a global generator.

No Russian roulette: the reference interface hands a reference no
configuration, and the benchmark's program adapter leaves roulette off.
`load_scene` refuses a scene with an area light or an emissive material,
and what no lobe here traces (the coloured and thin glasses, the
conductor).  The arithmetic keeps the order of the program's float32
expressions where a path's direction depends on it (the lens, the hit,
the shading normal, the lobes), so that on one device the two agree to
rounding; `dtype` is the precision it runs in, as in `tracer`.
"""

from __future__ import annotations

import math
import types
from typing import NamedTuple

import numpy as np
import torch

from cellbench.reference import accel, disney, specular, tracer
from cellbench.reference.disney import _cosine, _reflect as reflect, _to_world
# display is this reference's too (the interface of
# cellbench/reference/__init__.py).
from cellbench.reference.tracer import RAY_OFFSET, display, normalize  # noqa: F401

DIFFUSE, MIRROR, GLASS, LIGHT_DIFFUSE = 0, 1, 2, 16
LAMBERT = {DIFFUSE, LIGHT_DIFFUSE}
NUM_TYPES = 18


class Scene(NamedTuple):
    geo: accel.Geometry
    rows: torch.Tensor  # (T, 12): v0 | e1 | e2 | albedo, by scene triangle id
    normals: torch.Tensor  # (T, 9): n0 | n1 | n2, the vertex normals
    smooth: torch.Tensor  # (T,) bool: the triangle interpolates its vertex normals
    mirror: torch.Tensor  # (T,) bool
    glass: torch.Tensor  # (T,) bool
    disney: torch.Tensor  # (T,) bool: the Disney BRDF
    ior: torch.Tensor  # (T,)
    params: torch.Tensor  # (T, 8): disney.Scene's Disney parameters
    layer: torch.Tensor  # (T,) int64 atlas layer, -1 untextured
    uv: torch.Tensor  # (T, 6): the texture coordinates of the three corners
    atlas: torch.Tensor | None  # (K, H, W, 3)
    sky: torch.Tensor | None  # (He, We, 3); black misses where None
    dtype: torch.dtype


def refuse_camera(cam: dict) -> None:
    """Every camera of the layout is traced: pinhole and thin lens."""


def load_scene(sc: dict, device, dtype=torch.float32) -> Scene:
    """The reference's tables of a scene dict (cellbench.scenes.builtin's
    layout).  Raises ValueError for what it does not trace: an area light
    or an emissive material, and the coloured and thin glasses and the
    conductor."""
    mats = sc["materials"]
    tri_v = sc["tri_v"]
    if len(sc["lights"]["p"]) or (mats["emission"][:, 3] != -1).any():
        raise ValueError("the reference traces scenes lit by their environment map alone; "
                         "the scene has an area light or an emissive material")
    types_ = set(np.unique(mats["albedo"][:, 3]).astype(int).tolist())
    bad = sorted(t for t in types_ if t in disney.REFUSED - {MIRROR, GLASS}
                 or not 0 <= t < NUM_TYPES)
    if bad:
        raise ValueError(f"the reference traces Lambert, Disney, mirror and glass materials "
                         f"only; material types {bad}")
    v = sc["vertices"].astype(np.float32)
    p0, p1, p2 = (v[tri_v[:, k]] for k in range(3))
    m = tri_v[:, 3]
    rows = np.concatenate([p0, p1 - p0, p2 - p0, mats["albedo"][m, :3]], axis=1)
    smooth = sc["tri_vn"][:, 3] == 1
    normals = np.zeros((len(tri_v), 9), np.float32)
    if smooth.any():
        ids = sc["tri_vn"][smooth, :3]
        normals[smooth] = np.concatenate([sc["normals"][ids[:, k]] for k in range(3)], axis=1)
    mtype = mats["albedo"][m, 3].astype(int)
    params = np.concatenate([mats["disney"][m], mats["disney2"][m, :3],
                             mats["specular"][m, 3:4]], axis=1)
    layer = mats["tex_ind"][m, 0].astype(np.int64)
    uv = np.zeros((len(tri_v), 6), np.float32)
    textured = layer >= 0
    if textured.any():
        ids = sc["tri_vt"][textured, :3]
        uv[textured] = np.concatenate([sc["texcoords"][ids[:, k]] for k in range(3)], axis=1)

    def put(x, dt=dtype):
        return None if x is None else torch.tensor(np.asarray(x), dtype=dt, device=device)

    return Scene(accel.build(v, tri_v, device, dtype), put(rows), put(normals),
                 put(smooth, torch.bool), put(mtype == MIRROR, torch.bool),
                 put(mtype == GLASS, torch.bool),
                 put(~np.isin(mtype, sorted(LAMBERT | disney.REFUSED)), torch.bool),
                 put(mats["specular"][m, 3]), put(params), put(layer, torch.int64), put(uv),
                 put(sc.get("textures")), put(sc.get("env_map")), dtype)


# -- the camera ------------------------------------------------------------


def camera_rays(cam: dict, width: int, height: int, pixel_ids, raygen, dtype):
    """(o, d) of pixels `pixel_ids` from their raygen uniforms `raygen`
    ((N, 4): the tent jitter pair, the lens pair): `tracer`'s pinhole ray,
    then the thin lens where the aperture is above 0."""
    o, d = tracer.camera_rays(dict(cam, aperture=np.float32(0.0)), width, height, pixel_ids,
                              raygen, dtype)
    if not float(cam["aperture"]) > 0.0:
        return o, d

    def vec(x):
        return torch.tensor(np.asarray(x, np.float32), device=pixel_ids.device).to(dtype)

    right, up, forward = vec(cam["right"]), vec(cam["up"]), vec(cam["forward"])
    radius = torch.sqrt(raygen[:, 2]) * (vec(cam["aperture"]) * 0.5)
    angle = 2.0 * math.pi * raygen[:, 3]
    across, upward = radius * torch.cos(angle), radius * torch.sin(angle)
    along = vec(cam["focal_dist"]) / torch.clamp(accel.dot(d, forward[None, :]), min=1e-6)
    on_focal_plane = o + d * along[:, None]
    o = o + (across[:, None] * right[None, :] + upward[:, None] * up[None, :])
    return o, normalize(on_focal_plane - o)


# -- the two images ----------------------------------------------------------


def _bilinear(fetch, h: int, w: int, x, y, wrap_rows: bool):
    """(N, 3): an image of h x w texels at continuous texel coordinates
    (x, y), texel (i, j) centred at (i, j), `fetch(j, i)` giving the (N, 3)
    texels of rows j and columns i, weighted by the fractions of x and y.
    Columns wrap.  Rows wrap, or are clamped as the program addresses
    them: the upper row clamped into the image and the lower one the next
    row of it, clamped, so that within half a texel of the first row's
    centre the first two rows are blended."""
    fx, fy = x - torch.floor(x), y - torch.floor(y)
    i0 = torch.remainder(torch.floor(x).to(torch.int64), w)
    i1 = torch.remainder(i0 + 1, w)
    j0 = torch.floor(y).to(torch.int64)
    if wrap_rows:
        j0 = torch.remainder(j0, h)
        j1 = torch.remainder(j0 + 1, h)
    else:
        j0 = torch.clamp(j0, 0, h - 1)
        j1 = torch.clamp(j0 + 1, 0, h - 1)
    out = 0.0
    for j, wy in ((j0, 1.0 - fy), (j1, fy)):
        for i, wx in ((i0, 1.0 - fx), (i1, fx)):
            out = out + (wx * wy)[:, None] * fetch(j, i)
    return out


def albedo_of(scene: Scene, tri, rows, u, v):
    """The albedo of hits (tri, u, v): the atlas layer's repeating bilinear
    lookup at the interpolated texture coordinates where the material
    names one, else the material's."""
    base = rows[:, 9:12]
    if scene.atlas is None:
        return base
    layer = scene.layer[tri]
    c = scene.uv[tri]
    w = 1.0 - u - v
    tu = c[:, 0] * w + c[:, 2] * u + c[:, 4] * v
    tv = c[:, 1] * w + c[:, 3] * u + c[:, 5] * v
    k, h, wd = scene.atlas.shape[:3]
    sheet = torch.clamp(layer, 0, k - 1)
    lookup = _bilinear(lambda j, i: scene.atlas[sheet, j, i], h, wd, tu * wd - 0.5,
                       tv * h - 0.5, wrap_rows=True)
    return torch.where((layer >= 0)[:, None], lookup, base)


def sky(scene: Scene, d):
    """(N, 3): the environment map toward unit directions d; black where
    the scene has none."""
    if scene.sky is None:
        return torch.zeros_like(d)
    h, w = scene.sky.shape[:2]
    longitude = torch.atan2(d[:, 2], d[:, 0]) / (2.0 * math.pi) + 0.5
    polar = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    return _bilinear(lambda j, i: scene.sky[j, i], h, w, longitude * w - 0.5, polar * h - 0.5,
                     wrap_rows=False)


# -- the path tracer -------------------------------------------------------


def trace(scene: Scene, o, d, uni, max_depth: int, record=None):
    """Radiance (N, 3) of paths from rays (o, d) with uniforms `uni`
    ((N, 4 + 7 max_depth)).  `record`, if a list, receives each query's
    rays: ("closest", o, d, active); there is no any-hit query."""
    n, dev, dt = o.shape[0], o.device, scene.dtype
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    T = torch.ones((n, 3), dtype=dt, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for bounce in range(max_depth):
        base = 4 + 7 * bounce
        u_b1, u_b2, u_lobe = (uni[:, base + k] for k in (3, 4, 5))
        if record is not None:
            record.append(("closest", o, d, alive))
        raw_t, tri = accel.closest(scene.geo, o, d, alive)
        tri_c = torch.clamp(tri, min=0)
        rows = scene.rows[tri_c]
        _, t_r, u_r, v_r = accel.mt(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
        keep = tri >= 0
        hit_t = torch.where(keep, t_r, raw_t)
        u = torch.where(keep, u_r, 0.0)
        v = torch.where(keep, v_r, 0.0)
        n_shade = specular.shading_normal(scene, tri_c, rows, u, v)
        cos_incident = accel.dot(d, n_shade)
        n_flip = torch.where((cos_incident > 0)[:, None], -n_shade, n_shade)
        point = o + d * hit_t[:, None] + n_flip * RAY_OFFSET
        L = L + torch.where((alive & ~keep)[:, None], T * sky(scene, d), 0.0)
        alive = alive & keep
        albedo = albedo_of(scene, tri_c, rows, u, v)
        mirror, glass, dis = scene.mirror[tri_c], scene.glass[tri_c], scene.disney[tri_c]

        local = _cosine(u_b1, u_b2)
        l_lam = _to_world(local, n_flip)
        p = disney.params_of(scene, tri_c, albedo)
        l_dis, f_dis, pdf_dis = disney.sample(p, n_flip, -d, u_lobe, u_b1, u_b2)
        ok = pdf_dis > 1e-9
        T_dis = T * torch.where(ok[:, None], f_dis / torch.clamp(pdf_dis, min=1e-9)[:, None], 0.0)
        l_glass, refracted = specular.glass_lobe(d, n_flip, cos_incident, scene.ior[tri_c],
                                                 u_lobe)
        new_d = torch.where(glass[:, None], l_glass,
                            torch.where(mirror[:, None], reflect(d, n_flip),
                                        torch.where(dis[:, None], l_dis, l_lam)))
        new_T = torch.where(dis[:, None], T_dis, T * albedo)
        d = normalize(new_d)
        o = point + torch.where((glass & refracted)[:, None], -2.0 * RAY_OFFSET * n_flip, 0.0)
        alive = alive & (~dis | ok)
        T = torch.where(alive[:, None], new_T, T)
    return L.float()


def _with_this_trace(fn):
    """`tracer`'s function `fn` run with this module's `trace`,
    `camera_rays`, `radiance` and `accumulate`: the sampling loops are
    written once, in `tracer`."""
    return types.FunctionType(fn.__code__, _TRACER_GLOBALS, fn.__name__, fn.__defaults__)


# radiance(scene, cam, width, height, max_depth, key, sample_idx, pixel_ids)
# and accumulate(scene, cam, width, height, max_depth, key, samples,
# pixel_ids, paths_per_block): `tracer`'s, through this module's `trace`
# and `camera_rays`.
_TRACER_GLOBALS = {**vars(tracer), "trace": trace, "camera_rays": camera_rays}
radiance = _TRACER_GLOBALS["radiance"] = _with_this_trace(tracer.radiance)
accumulate = _TRACER_GLOBALS["accumulate"] = _with_this_trace(tracer.accumulate)
