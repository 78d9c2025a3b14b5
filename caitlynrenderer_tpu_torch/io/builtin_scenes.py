"""Procedurally generated test/benchmark scenes (no assets required).

A copy of caitlynrenderer_tpu/io/builtin_scenes.py for the port, which
imports nothing of the JAX package; its outputs are held byte-equal to the
original's in tests/test_torch_host.py.

The reference ships only `Models/cornell-box.obj`; benchmark configs 3 and 4
need ~100k and ~1M triangle scenes (BASELINE.md).  These constructors build
SceneArrays directly — a cornell-box twin, plus parametric high-poly meshes
for the BVH-heavy configs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from caitlynrenderer_tpu_torch.core.types import (
    Lights,
    Materials,
    MaterialType,
    SceneArrays,
)


class _SceneBuilder:
    """Accumulates triangles + materials into SceneArrays."""

    def __init__(self):
        self.vertices = []
        self.tri_v = []
        self.tri_light = []
        self.mats = []  # dicts
        self.lights = []

    def add_material(
        self,
        albedo=(0.8, 0.8, 0.8),
        emission=(0.0, 0.0, 0.0),
        mat_type: int = int(MaterialType.DIFFUSE),
        ior: float = 1.5,
        roughness: float = 0.5,
        metallic: float = 0.0,
        specular=(1.0, 1.0, 1.0),
    ) -> int:
        emissive = any(e > 0 for e in emission)
        self.mats.append(
            dict(
                albedo=albedo,
                emission=emission,
                mat_type=mat_type,
                ior=ior,
                roughness=roughness,
                metallic=metallic,
                specular=specular,
                emissive=emissive,
            )
        )
        return len(self.mats) - 1

    def add_triangle(self, p0, p1, p2, mtl: int):
        base = len(self.vertices)
        self.vertices += [tuple(p0), tuple(p1), tuple(p2)]
        self.tri_v.append((base, base + 1, base + 2, mtl))
        m = self.mats[mtl]
        if m["emissive"]:
            p0 = np.asarray(p0, np.float32)
            u = np.asarray(p1, np.float32) - p0
            v = np.asarray(p2, np.float32) - p0
            n = np.cross(u, v)
            two_area = float(np.linalg.norm(n))
            self.tri_light.append(len(self.lights))
            self.lights.append(
                (p0, u, v, n / max(two_area, 1e-20), np.asarray(m["emission"], np.float32), 0.5 * two_area)
            )
        else:
            self.tri_light.append(-1)

    def add_quad(self, p0, p1, p2, p3, mtl: int):
        """Two triangles with consistent winding (p0,p1,p2) (p0,p2,p3)."""
        self.add_triangle(p0, p1, p2, mtl)
        self.add_triangle(p0, p2, p3, mtl)

    def add_box(self, lo, hi, mtl: int):
        """Axis-aligned box with outward-facing quads."""
        x0, y0, z0 = lo
        x1, y1, z1 = hi
        self.add_quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), mtl)  # +z
        self.add_quad((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0), mtl)  # -z
        self.add_quad((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), mtl)  # +x
        self.add_quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), mtl)  # -x
        self.add_quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mtl)  # +y
        self.add_quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), mtl)  # -y

    def build(self) -> SceneArrays:
        t = len(self.tri_v)
        mats = _pack(self.mats)
        lights = _pack_lights(self.lights)
        tri_vt = np.full((t, 4), -1, np.int32)
        tri_vt[:, 3] = np.asarray(self.tri_light, np.int32)
        return SceneArrays(
            vertices=np.asarray(self.vertices, np.float32).reshape(-1, 3),
            normals=np.zeros((0, 3), np.float32),
            texcoords=np.zeros((0, 2), np.float32),
            tri_v=np.asarray(self.tri_v, np.int32).reshape(-1, 4),
            tri_vn=np.full((t, 4), 0, np.int32),
            tri_vt=tri_vt,
            materials=mats,
            lights=lights,
            textures=None,
        )


def _pack(mats) -> Materials:
    m = len(mats)
    albedo = np.zeros((m, 4), np.float32)
    emission = np.zeros((m, 4), np.float32)
    specular = np.zeros((m, 4), np.float32)
    disney = np.zeros((m, 4), np.float32)
    disney2 = np.zeros((m, 4), np.float32)
    disney2[:, 1] = 1.0  # clearcoat_gloss default
    tex_ind = np.full((m, 4), -1.0, np.float32)
    light_count = 0
    for i, d in enumerate(mats):
        albedo[i, :3] = d["albedo"]
        albedo[i, 3] = d["mat_type"]
        emission[i, :3] = d["emission"]
        if d["emissive"]:
            emission[i, 3] = light_count
            light_count += 1
        else:
            emission[i, 3] = -1
        specular[i, :3] = d["specular"]
        specular[i, 3] = d["ior"]
        disney[i, 0] = d["roughness"]
        disney[i, 1] = d["metallic"]
    return Materials(albedo, emission, specular, disney, disney2, tex_ind)


def _pack_lights(rows) -> Lights:
    if not rows:
        z = np.zeros((0, 3), np.float32)
        return Lights(z, z, z, z, z, np.zeros((0, 2), np.float32))
    p = np.stack([np.asarray(r[0], np.float32) for r in rows])
    u = np.stack([np.asarray(r[1], np.float32) for r in rows])
    v = np.stack([np.asarray(r[2], np.float32) for r in rows])
    n = np.stack([np.asarray(r[3], np.float32) for r in rows])
    e = np.stack([np.asarray(r[4], np.float32) for r in rows])
    area = np.asarray([r[5] for r in rows], np.float32)
    pdf = area / max(float(area.sum()), 1e-20)
    return Lights(p, u, v, n, e, np.stack([area, pdf], 1).astype(np.float32))


def cornell_box(
    albedo=(0.73, 0.73, 0.73),
    emission=(15.0, 15.0, 15.0),
    floor_type: int = int(MaterialType.DIFFUSE),
    with_boxes: bool = True,
) -> Tuple[SceneArrays, np.ndarray]:
    """A classic cornell box in [0, 5.56]³-ish units, light in the ceiling.

    Returns (scene, translation) with translation == 0 (already at origin)
    so it is a drop-in for `io.obj.load_obj`.
    """
    b = _SceneBuilder()
    white = b.add_material(albedo=albedo)
    red = b.add_material(albedo=(0.65, 0.05, 0.05))
    green = b.add_material(albedo=(0.12, 0.45, 0.15))
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emission=emission)
    floor_m = (
        white
        if floor_type == int(MaterialType.DIFFUSE)
        else b.add_material(albedo=(0.9, 0.9, 0.9), mat_type=floor_type)
    )

    s = 5.56  # box size
    # Floor (+y up), normals inward.
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), floor_m)
    # Ceiling.
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)
    # Back wall (z = 0).
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), white)
    # Left wall (x = 0): red.
    b.add_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), red)
    # Right wall: green.
    b.add_quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0), green)
    # Ceiling light: 1.3-unit quad slightly below the ceiling.
    lx0, lx1 = s / 2 - 0.65, s / 2 + 0.65
    lz0, lz1 = s / 2 - 0.55, s / 2 + 0.55
    ly = s - 0.01
    b.add_quad((lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1), light)

    if with_boxes:
        b.add_box((1.1, 0.0, 1.2), (2.7, 3.3, 2.8), white)  # tall-ish box
        b.add_box((3.1, 0.0, 2.9), (4.4, 1.3, 4.2), white)  # short box

    return b.build(), np.zeros(3, np.float32)


def random_triangle_soup(num_triangles: int, seed: int = 0, extent: float = 10.0, tri_size: float = 0.1):
    """Random small triangles in a cube — worst-case BVH stress scene."""
    rng = np.random.default_rng(seed)
    centers = rng.random((num_triangles, 1, 3), np.float32) * extent
    offsets = rng.standard_normal((num_triangles, 3, 3)).astype(np.float32) * tri_size
    verts = (centers + offsets).reshape(-1, 3)
    b = _SceneBuilder()
    white = b.add_material(albedo=(0.7, 0.7, 0.7))
    light = b.add_material(emission=(20.0, 20.0, 20.0))
    scene_tris = np.arange(num_triangles * 3, dtype=np.int32).reshape(-1, 3)
    tri_v = np.concatenate(
        [scene_tris, np.full((num_triangles, 1), white, np.int32)], axis=1
    )
    # One light quad above the soup.
    b.add_quad(
        (extent * 0.4, extent * 1.2, extent * 0.4),
        (extent * 0.6, extent * 1.2, extent * 0.4),
        (extent * 0.6, extent * 1.2, extent * 0.6),
        (extent * 0.4, extent * 1.2, extent * 0.6),
        light,
    )
    base = b.build()
    t = num_triangles
    scene = base._replace(
        vertices=np.concatenate([base.vertices, verts], axis=0),
        tri_v=np.concatenate(
            [base.tri_v, tri_v + np.array([len(base.vertices)] * 3 + [0], np.int32)],
            axis=0,
        ),
        tri_vn=np.concatenate([base.tri_vn, np.zeros((t, 4), np.int32)], axis=0),
        tri_vt=np.concatenate([base.tri_vt, np.full((t, 4), -1, np.int32)], axis=0),
    )
    return scene, np.zeros(3, np.float32)


def displaced_grid(resolution: int = 224, seed: int = 0, extent: float = 10.0):
    """A sinusoidally displaced heightfield grid: 2*(res-1)² coherent
    triangles — the '~100k/~1M triangle mesh' benchmark scene family
    (res=224 → ~100k tris, res=708 → ~1M tris)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, extent, resolution, dtype=np.float32)
    zs = np.linspace(0, extent, resolution, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = (
        np.sin(xx * 1.7) * np.cos(zz * 1.3) * 0.8
        + np.sin(xx * 5.1 + 1.0) * np.cos(zz * 4.7) * 0.2
        + 2.0
    ).astype(np.float32)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)

    i, j = np.meshgrid(np.arange(resolution - 1), np.arange(resolution - 1), indexing="ij")
    v00 = (i * resolution + j).reshape(-1)
    v01 = v00 + 1
    v10 = v00 + resolution
    v11 = v10 + 1
    t1 = np.stack([v00, v10, v01], axis=1)
    t2 = np.stack([v01, v10, v11], axis=1)
    tris = np.concatenate([t1, t2], axis=0).astype(np.int32)

    b = _SceneBuilder()
    white = b.add_material(albedo=(0.75, 0.72, 0.68))
    light = b.add_material(emission=(30.0, 30.0, 30.0))
    b.add_quad(
        (extent * 0.3, extent * 0.9, extent * 0.3),
        (extent * 0.7, extent * 0.9, extent * 0.3),
        (extent * 0.7, extent * 0.9, extent * 0.7),
        (extent * 0.3, extent * 0.9, extent * 0.7),
        light,
    )
    base = b.build()
    t = tris.shape[0]
    tri_v = np.concatenate(
        [tris + len(base.vertices), np.full((t, 1), white, np.int32)], axis=1
    )
    scene = base._replace(
        vertices=np.concatenate([base.vertices, verts], axis=0),
        tri_v=np.concatenate([base.tri_v, tri_v], axis=0),
        tri_vn=np.concatenate([base.tri_vn, np.zeros((t, 4), np.int32)], axis=0),
        tri_vt=np.concatenate([base.tri_vt, np.full((t, 4), -1, np.int32)], axis=0),
    )
    return scene, np.zeros(3, np.float32)


def procedural_sky(height: int = 64, width: int = 128, sun_dir=(0.35, 0.8, 0.2),
                   sun_intensity: float = 20.0) -> np.ndarray:
    """Procedural equirect sky env map: zenith-to-horizon gradient, dark
    ground, and a smooth sun disk.  A dependency-free HDR stand-in for
    the reference's `useEnvMap` assets (`Scene.h:57-58`); real HDR files
    can be loaded with io.image and passed as SceneArrays.env_map."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height  # 0=zenith
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = v * np.pi  # polar angle from +y
    phi = (u - 0.5) * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack(
        [
            st * np.cos(phi)[None, :],
            np.cos(theta)[:, None] * np.ones_like(phi)[None, :],
            st * np.sin(phi)[None, :],
        ],
        axis=-1,
    )  # (H, W, 3) unit directions
    y = d[..., 1]
    zenith = np.array([0.25, 0.45, 0.95], np.float32)
    horizon = np.array([0.85, 0.85, 0.95], np.float32)
    ground = np.array([0.25, 0.22, 0.20], np.float32)
    tsky = np.clip(y, 0.0, 1.0)[..., None] ** 0.6
    sky = horizon * (1.0 - tsky) + zenith * tsky
    img = np.where((y >= 0.0)[..., None], sky, ground)
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / np.linalg.norm(sd)
    cos = np.clip((d * sd).sum(-1), 0.0, 1.0)
    img = img + sun_intensity * (cos[..., None] ** 400.0)
    return img.astype(np.float32)
