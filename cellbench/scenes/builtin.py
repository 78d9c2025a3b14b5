"""Frozen copies, in plain numpy, of the two procedural scenes the cells
render: the Cornell box and the displaced heightfield grid.

The benchmark makes every triangle itself from a configuration's `scene`
entry and hands the same arrays to the program under test and to the
plain reference, so a change to the program's own scene generators cannot
move the yardstick.  A scene is a dict of numpy arrays with the layout of
the program's `SceneArrays`: vertices, normals, texcoords, tri_v, tri_vn,
tri_vt, and `materials` and `lights` as dicts of arrays (`lights` may
have no rows), and two optional keys:

    textures   (K, H, W, 3) float32 albedo atlas, K >= 1, finite and >= 0;
               a material's layer `tex_ind[:, 0]` is -1 (untextured) or an
               integer below K, and the triangles of a textured material
               index `texcoords` within range
    env_map    (He, We, 3) float32 equirectangular radiance map, finite and
               >= 0, which the program samples on a miss wherever the scene
               carries one

A configuration's scene names a generator: one of `GENERATORS` below, or
the module cellbench/scenes/<generator>.py, whose `make(**args)` returns
such a dict (it may build one with `SceneBuilder` and set any column of
the material arrays itself); `make_scene` holds it to the layout.
"""

from __future__ import annotations

import numpy as np

from cellbench import manifest

DIFFUSE = 0  # the material type id of a Lambert surface

MATERIAL_FIELDS = ("albedo", "emission", "specular", "disney", "disney2", "tex_ind")
LIGHT_FIELDS = ("p", "u", "v", "n", "e", "area_pdf")
# The geometry's arrays: columns and dtype.
GEOMETRY = {"vertices": (3, np.float32), "normals": (3, np.float32),
            "texcoords": (2, np.float32), "tri_v": (4, np.int32), "tri_vn": (4, np.int32),
            "tri_vt": (4, np.int32)}
# The optional images: their rank (the last axis rgb).
IMAGES = {"textures": 4, "env_map": 3}


class SceneBuilder:
    """Accumulates triangles and materials into a scene dict."""

    def __init__(self):
        self.vertices = []
        self.tri_v = []
        self.tri_light = []
        self.mats = []
        self.lights = []

    def add_material(self, albedo=(0.8, 0.8, 0.8), emission=(0.0, 0.0, 0.0),
                     mat_type: int = DIFFUSE, ior: float = 1.5, roughness: float = 0.5,
                     metallic: float = 0.0, specular=(1.0, 1.0, 1.0)) -> int:
        emissive = any(e > 0 for e in emission)
        self.mats.append(dict(albedo=albedo, emission=emission, mat_type=mat_type, ior=ior,
                              roughness=roughness, metallic=metallic, specular=specular,
                              emissive=emissive))
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
            self.lights.append((p0, u, v, n / max(two_area, 1e-20),
                                np.asarray(m["emission"], np.float32), 0.5 * two_area))
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
        self.add_quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), mtl)
        self.add_quad((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0), mtl)
        self.add_quad((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), mtl)
        self.add_quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), mtl)
        self.add_quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mtl)
        self.add_quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), mtl)

    def build(self) -> dict:
        t = len(self.tri_v)
        tri_vt = np.full((t, 4), -1, np.int32)
        tri_vt[:, 3] = np.asarray(self.tri_light, np.int32)
        return dict(
            vertices=np.asarray(self.vertices, np.float32).reshape(-1, 3),
            normals=np.zeros((0, 3), np.float32),
            texcoords=np.zeros((0, 2), np.float32),
            tri_v=np.asarray(self.tri_v, np.int32).reshape(-1, 4),
            tri_vn=np.full((t, 4), 0, np.int32),
            tri_vt=tri_vt,
            materials=_pack(self.mats),
            lights=_pack_lights(self.lights),
        )


def _pack(mats) -> dict:
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
    return dict(albedo=albedo, emission=emission, specular=specular, disney=disney,
                disney2=disney2, tex_ind=tex_ind)


def _pack_lights(rows) -> dict:
    if not rows:
        z = np.zeros((0, 3), np.float32)
        return dict(p=z, u=z, v=z, n=z, e=z, area_pdf=np.zeros((0, 2), np.float32))
    p, u, v, n, e = (np.stack([np.asarray(r[k], np.float32) for r in rows]) for k in range(5))
    area = np.asarray([r[5] for r in rows], np.float32)
    pdf = area / max(float(area.sum()), 1e-20)
    return dict(p=p, u=u, v=v, n=n, e=e, area_pdf=np.stack([area, pdf], 1).astype(np.float32))


def cornell_box() -> dict:
    """The classic Cornell box in [0, 5.56]^3, its light a 1.3 x 1.1 quad
    just below the ceiling, with the tall and the short box: 36 Lambert
    triangles."""
    b = SceneBuilder()
    white = b.add_material(albedo=(0.73, 0.73, 0.73))
    red = b.add_material(albedo=(0.65, 0.05, 0.05))
    green = b.add_material(albedo=(0.12, 0.45, 0.15))
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emission=(15.0, 15.0, 15.0))
    s = 5.56
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), white)  # floor
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)  # ceiling
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), white)  # back wall
    b.add_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), red)  # left wall
    b.add_quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0), green)  # right wall
    lx0, lx1 = s / 2 - 0.65, s / 2 + 0.65
    lz0, lz1 = s / 2 - 0.55, s / 2 + 0.55
    ly = s - 0.01
    b.add_quad((lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1), light)
    b.add_box((1.1, 0.0, 1.2), (2.7, 3.3, 2.8), white)
    b.add_box((3.1, 0.0, 2.9), (4.4, 1.3, 4.2), white)
    return b.build()


def displaced_grid(resolution: int = 224, extent: float = 10.0) -> dict:
    """A sinusoidally displaced heightfield of resolution^2 vertices,
    2 (resolution - 1)^2 coherent Lambert triangles, under one square
    light: resolution 708 gives 999,700 triangles (999,702 with the
    light)."""
    xs = np.linspace(0, extent, resolution, dtype=np.float32)
    zs = np.linspace(0, extent, resolution, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = (np.sin(xx * 1.7) * np.cos(zz * 1.3) * 0.8
          + np.sin(xx * 5.1 + 1.0) * np.cos(zz * 4.7) * 0.2 + 2.0).astype(np.float32)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(resolution - 1), np.arange(resolution - 1), indexing="ij")
    v00 = (i * resolution + j).reshape(-1)
    v01 = v00 + 1
    v10 = v00 + resolution
    v11 = v10 + 1
    tris = np.concatenate([np.stack([v00, v10, v01], axis=1),
                           np.stack([v01, v10, v11], axis=1)], axis=0).astype(np.int32)
    b = SceneBuilder()
    white = b.add_material(albedo=(0.75, 0.72, 0.68))
    light = b.add_material(emission=(30.0, 30.0, 30.0))
    b.add_quad((extent * 0.3, extent * 0.9, extent * 0.3), (extent * 0.7, extent * 0.9, extent * 0.3),
               (extent * 0.7, extent * 0.9, extent * 0.7), (extent * 0.3, extent * 0.9, extent * 0.7),
               light)
    base = b.build()
    t = tris.shape[0]
    tri_v = np.concatenate([tris + len(base["vertices"]), np.full((t, 1), white, np.int32)], axis=1)
    base.update(
        vertices=np.concatenate([base["vertices"], verts], axis=0),
        tri_v=np.concatenate([base["tri_v"], tri_v], axis=0),
        tri_vn=np.concatenate([base["tri_vn"], np.zeros((t, 4), np.int32)], axis=0),
        tri_vt=np.concatenate([base["tri_vt"], np.full((t, 4), -1, np.int32)], axis=0),
    )
    return base


GENERATORS = {"cornell_box": cornell_box, "displaced_grid": displaced_grid}


def make_scene(spec: dict) -> dict:
    """The scene of a configuration's `scene` entry: {"generator": name,
    "args": {keyword: value}}, a generator of `GENERATORS` or else of
    cellbench/scenes/<name>.py (FileNotFoundError naming the file where
    there is none)."""
    name, args = spec["generator"], spec.get("args", {})
    if name in GENERATORS:
        return GENERATORS[name](**args)
    sc = manifest.by_file("scenes", name, "scene generator").make(**args)
    problems = layout_problems(sc)
    if problems:
        raise ValueError(f"scene generator {name!r}: " + "; ".join(problems))
    return sc


def layout_problems(sc: dict) -> list:
    """How `sc` departs from the layout: its keys, the materials' and
    lights' fields, each array's columns, dtype and rows, the optional
    `textures` and `env_map` (module docstring) and the texture layers and
    texture coordinates the materials use; empty where it keeps to it."""
    groups = {"materials": MATERIAL_FIELDS, "lights": LIGHT_FIELDS}
    required = set(GEOMETRY) | set(groups)
    if not required <= set(sc) <= required | set(IMAGES):
        return [f"keys {sorted(sc)}"]
    bad = [f"{g} fields {sorted(sc[g])}" for g, fields in groups.items()
           if set(sc[g]) != set(fields)]
    if bad:
        return bad
    # (name, array, columns, dtype, the arrays whose rows it shares)
    arrays = [(k, sc[k], cols, dt, "triangles" if k.startswith("tri_") else k)
              for k, (cols, dt) in GEOMETRY.items()]
    arrays += [(f"materials.{k}", sc["materials"][k], 4, np.float32, "materials")
               for k in MATERIAL_FIELDS]
    arrays += [(f"lights.{k}", sc["lights"][k], 2 if k == "area_pdf" else 3, np.float32,
                "lights") for k in LIGHT_FIELDS]
    rows = {}
    for name, a, cols, dt, shared in arrays:
        if not (isinstance(a, np.ndarray) and a.dtype == dt and a.shape[1:] == (cols,)):
            bad.append(f"{name} is not an array of {cols} {np.dtype(dt).name} columns")
        else:
            rows.setdefault(shared, set()).add(len(a))
    bad += [f"{shared} of unequal rows {sorted(n)}" for shared, n in rows.items() if len(n) > 1]
    for name, rank in IMAGES.items():
        a = sc.get(name)
        if a is None:
            continue
        if not (isinstance(a, np.ndarray) and a.dtype == np.float32 and a.ndim == rank
                and a.shape[-1] == 3 and a.size):
            bad.append(f"{name} is not a non-empty float32 array of rank {rank} and 3 channels")
        elif not (np.isfinite(a).all() and (a >= 0).all()):
            bad.append(f"{name} holds values that are not finite or are below 0")
    return bad or _texture_problems(sc)


def _texture_problems(sc: dict) -> list:
    """How the materials' texture layers and the textured triangles'
    texture coordinates depart from the atlas and `texcoords`."""
    atlas = sc.get("textures")
    k = 0 if atlas is None else atlas.shape[0]
    layer = sc["materials"]["tex_ind"][:, 0]
    wrong = ~((layer == -1) | ((layer == np.floor(layer)) & (layer >= 0) & (layer < k)))
    if wrong.any():
        return [f"materials {np.flatnonzero(wrong)[:5].tolist()} have texture layers "
                f"{layer[wrong][:5].tolist()}, not -1 or an integer below the atlas's {k}"]
    mtl = sc["tri_v"][:, 3]
    textured = np.zeros(len(mtl), bool)  # a material index out of range is the program's to refuse
    known = (mtl >= 0) & (mtl < len(layer))
    textured[known] = layer[mtl[known]] >= 0
    vt = sc["tri_vt"][textured, :3]
    n = len(sc["texcoords"])
    if vt.size and (vt.min() < 0 or vt.max() >= n):
        return [f"textured triangles index texcoords {int(vt.min())}..{int(vt.max())}, "
                f"outside [0, {n})"]
    return []


def make_camera(position, look_at, fov_degrees: float = 40.0, up_hint=(0.0, 1.0, 0.0),
                focal_dist: float = 0.1, aperture: float = 0.0) -> dict:
    """A fly camera as an explicit basis from position and look-at, the
    field order of the program's `Camera`: position, forward, right, up,
    fov (radians), focal_dist, aperture."""
    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    forward = look_at - position
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up_hint, np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    return dict(position=position, forward=forward.astype(np.float32),
                right=right.astype(np.float32), up=up.astype(np.float32),
                fov=np.float32(np.deg2rad(fov_degrees)), focal_dist=np.float32(focal_dist),
                aperture=np.float32(aperture))


CAMERA_FIELDS = ("position", "forward", "right", "up", "fov", "focal_dist", "aperture")
