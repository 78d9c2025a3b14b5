"""The Cornell box with a mirror sphere and a glass sphere, frozen: the
layout of Kevin Beason's smallpt ("Global Illumination in 99 lines of
C++"), the caustics test scene of Jensen's "Realistic Image Synthesis
Using Photon Mapping" (2001), in `builtin.cornell_box`'s box.

The box is `builtin.cornell_box`'s without its two inner boxes: the
floor, the ceiling, the back wall, the red and the green wall and the
15-unit ceiling light, its first 12 triangles.  smallpt's box spans x 1-99
with its back wall at z = 0; its two spheres of radius 16.5, the mirror
`Mirr` at (27, 16.5, 47) and the glass `Glas` at (73, 16.5, 78), are
scaled into this box by s = 5.56 / 98 and rest on its floor (y = r):

    mirror  centre ((27 - 1) s, r, 47 s), radius r = 16.5 s
    glass   centre ((73 - 1) s, r, 78 s), radius r

Each sphere is a UV sphere of SEGMENTS x BANDS (a fan of triangles at
each pole, two triangles a cell between), 3,968 triangles on 1,986
shared vertices, wound so that cross(e1, e2) points out of the sphere.
Every vertex carries its unit radial normal, and the sphere's triangles
interpolate them (`tri_vn` flag 1): the first benchmark scene with
per-vertex normals.  The materials are smallpt's: MIRROR (type 1) and
GLASS (type 2, ior 1.5), both of albedo 0.999.  The scene holds 7,948
triangles: the box's 12, then the mirror's, then the glass's."""

from __future__ import annotations

import numpy as np

from cellbench.scenes import builtin

MIRROR, GLASS = 1, 2  # the material type ids
ALBEDO = 0.999  # smallpt's reflectance of both spheres
IOR = 1.5
SEGMENTS, BANDS = 64, 32
BOX_TRIANGLES = 12  # builtin.cornell_box's walls and light, before its inner boxes
SCALE = 5.56 / 98.0  # smallpt's box (x 1-99) into the builtin box's 5.56
RADIUS = 16.5 * SCALE
MIRROR_CENTRE = ((27.0 - 1.0) * SCALE, RADIUS, 47.0 * SCALE)
GLASS_CENTRE = ((73.0 - 1.0) * SCALE, RADIUS, 78.0 * SCALE)


def uv_sphere(centre, radius: float, segments: int = SEGMENTS, bands: int = BANDS):
    """(vertices (V, 3), unit normals (V, 3), triangles (T, 3)) of a UV
    sphere: the north pole, bands - 1 rings of `segments` vertices, the
    south pole; triangles wound outward."""
    theta = np.pi * np.arange(1, bands) / bands
    phi = 2.0 * np.pi * np.arange(segments) / segments
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi), ct * np.ones_like(phi), st * np.sin(phi)],
                    axis=-1).reshape(-1, 3)
    normals = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    verts = np.asarray(centre, np.float64) + radius * normals
    south = len(normals) - 1

    def at(band, seg):  # vertex id of ring `band` (0 .. bands - 2), segment `seg`
        return 1 + band * segments + seg % segments

    tris = []
    for j in range(segments):
        tris.append((0, at(0, j + 1), at(0, j)))
    for i in range(bands - 2):
        for j in range(segments):
            a, b = at(i, j), at(i, j + 1)
            c, d = at(i + 1, j + 1), at(i + 1, j)
            tris += [(a, b, c), (a, c, d)]
    for j in range(segments):
        tris.append((south, at(bands - 2, j), at(bands - 2, j + 1)))
    return verts.astype(np.float32), normals.astype(np.float32), np.asarray(tris, np.int32)


def make() -> dict:
    box = builtin.cornell_box()
    keep = 3 * BOX_TRIANGLES  # the box's triangles own three vertices each
    b = builtin.SceneBuilder()
    b.add_material(albedo=(ALBEDO,) * 3, mat_type=MIRROR, ior=IOR)
    b.add_material(albedo=(ALBEDO,) * 3, mat_type=GLASS, ior=IOR)
    spheres = b.build()["materials"]
    mats = box["materials"]
    num_mats = len(mats["albedo"])
    vertices = [box["vertices"][:keep]]
    normals = []
    tri_v = [box["tri_v"][:BOX_TRIANGLES]]
    tri_vn = [box["tri_vn"][:BOX_TRIANGLES]]
    for k, centre in enumerate((MIRROR_CENTRE, GLASS_CENTRE)):
        v, n, t = uv_sphere(centre, RADIUS)
        vbase = sum(len(x) for x in vertices)
        nbase = sum(len(x) for x in normals)
        mtl = np.full((len(t), 1), num_mats + k, np.int32)
        tri_v.append(np.concatenate([t + vbase, mtl], axis=1))
        tri_vn.append(np.concatenate([t + nbase, np.ones((len(t), 1), np.int32)], axis=1))
        vertices.append(v)
        normals.append(n)
    t = sum(len(x) for x in tri_v)
    tri_vt = np.full((t, 4), -1, np.int32)
    tri_vt[:BOX_TRIANGLES] = box["tri_vt"][:BOX_TRIANGLES]
    return dict(
        vertices=np.concatenate(vertices).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        texcoords=box["texcoords"],
        tri_v=np.concatenate(tri_v).astype(np.int32),
        tri_vn=np.concatenate(tri_vn).astype(np.int32),
        tri_vt=tri_vt,
        materials={k: np.concatenate([mats[k], spheres[k]]) for k in builtin.MATERIAL_FIELDS},
        lights=box["lights"],
    )
