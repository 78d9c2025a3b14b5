"""The final scene of Peter Shirley's "Ray Tracing in One Weekend"
(v3.2.3, section 13, `random_scene()`), frozen and made in code: no
downloaded file.

Spheres, by the book's rules, drawn from a numpy generator seeded by the
configuration (`make(seed=...)`), not by the run, so that the scene is
fixed:

- for a, b in -11 .. 10: `choose_mat` = U(0, 1), then a centre
  (a + 0.9 U, 0.2, b + 0.9 U) of radius 0.2, skipped where it lies within
  0.9 of (4, 0.2, 0); a kept sphere draws its material: `choose_mat` below
  0.8 Lambert of albedo U * U per channel (six draws, the first three
  times the last three), below 0.95 metal of albedo U(0.5, 1) per channel
  and fuzz U(0, 0.5), else glass (no draw);
- three large spheres of radius 1: glass at (0, 1, 0), Lambert (0.4, 0.2,
  0.1) at (-4, 1, 0), metal (0.7, 0.6, 0.5) of fuzz 0 at (4, 1, 0).

Each sphere is `cornell_specular.uv_sphere(centre, r)` at 64 x 32 (3,968
triangles) whose triangles interpolate its unit radial vertex normals
(`tri_vn` flag 1).  Materials: Lambert DIFFUSE; a fuzzed metal DISNEY
(type 17) of metallic 1, roughness the fuzz (the program floors it at
0.02) and base its albedo, the program having no fuzz lobe; the fuzz-0
metal MIRROR of its albedo; glass GLASS of ior 1.5 and albedo 1.

The ground is a flat square of side GROUND_SIDE at y = 0 (the book's
sphere of radius 1000 lies within 0.06 of it within 11 of the origin, and
within 0.12 at the sphere grid's corners), GROUND_QUADS x GROUND_QUADS
quads of two triangles each, so that no triangle spans the scene in a
BVH.  Its texture coordinates are (x, z) / CHECKER_PERIOD and its
material reads layer 0 of the atlas: CHECKER x CHECKER texels holding 2 x
2 checker cells of "The Next Week" (v3.2.3, section 4.3) colours, ODD
where both cell indices are equal, EVEN elsewhere.  Repeated, a cell is
pi / 10 wide, the book's `sin(10 x) sin(10 z)` checker as it falls on the
ground just below y = 0.

The only light is the sky of the book's `ray_color` on a miss, (1 - t)
(1, 1, 1) + t (0.5, 0.7, 1.0) with t = (y + 1) / 2: the environment map, SKY
x 2 SKY texels of equirectangular latitude rows (row 0 at the zenith),
each row's value at the cosine of its centre's polar angle.  `lights` has
no rows.

The scene holds the small spheres in the order drawn, then the three
large ones, then the ground; one material a sphere, then the ground's.
"""

from __future__ import annotations

import math

import numpy as np

from cellbench.scenes import builtin
from cellbench.scenes.cornell_specular import BANDS, GLASS, MIRROR, SEGMENTS, uv_sphere

DISNEY = 17  # the material type of the Disney BRDF
IOR = 1.5
SMALL_RADIUS = 0.2
CLEARANCE_CENTRE, CLEARANCE = (4.0, 0.2, 0.0), 0.9
GRID = range(-11, 11)
LARGE = (  # centre, material kind, albedo (a metal's fuzz 0)
    ((0.0, 1.0, 0.0), "glass", (1.0, 1.0, 1.0)),
    ((-4.0, 1.0, 0.0), "lambert", (0.4, 0.2, 0.1)),
    ((4.0, 1.0, 0.0), "mirror", (0.7, 0.6, 0.5)),
)
GROUND_SIDE, GROUND_QUADS = 2000.0, 32
GROUND_ALBEDO = (0.5, 0.5, 0.5)  # the book's untextured ground, under the atlas
CHECKER_PERIOD = 2.0 * math.pi / 10.0  # two checker cells a period
CHECKER = 512  # the atlas layer's texels a side
ODD, EVEN = (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)
SKY = 512  # the environment map's rows (twice as many columns)
ZENITH, HORIZON = (0.5, 0.7, 1.0), (1.0, 1.0, 1.0)


def draw_spheres(rng: np.random.Generator) -> list:
    """[(centre, radius, kind, albedo, fuzz)] of the book's `random_scene`:
    the small spheres in the order drawn, then the three large ones; kind
    is "lambert", "metal", "glass" or "mirror"."""
    out = []
    for a in GRID:
        for b in GRID:
            choose_mat = rng.random()
            centre = (a + 0.9 * rng.random(), SMALL_RADIUS, b + 0.9 * rng.random())
            if math.dist(centre, CLEARANCE_CENTRE) <= CLEARANCE:
                continue
            if choose_mat < 0.8:
                c1, c2 = rng.random(3), rng.random(3)
                out.append((centre, SMALL_RADIUS, "lambert", tuple(c1 * c2), 0.0))
            elif choose_mat < 0.95:
                albedo = tuple(rng.uniform(0.5, 1.0, 3))
                out.append((centre, SMALL_RADIUS, "metal", albedo, rng.uniform(0.0, 0.5)))
            else:
                out.append((centre, SMALL_RADIUS, "glass", (1.0, 1.0, 1.0), 0.0))
    out += [(centre, 1.0, kind, albedo, 0.0) for centre, kind, albedo in LARGE]
    return out


def checker_layer(texels: int = CHECKER) -> np.ndarray:
    """(texels, texels, 3) float32: 2 x 2 cells, ODD on the diagonal."""
    cell = np.arange(texels) * 2 // texels
    diagonal = (cell[:, None] == cell[None, :])[..., None]
    return np.where(diagonal, np.float32(ODD), np.float32(EVEN)).astype(np.float32)


def sky_map(rows: int = SKY) -> np.ndarray:
    """(rows, 2 rows, 3) float32: the book's sky gradient by latitude."""
    y = np.cos(np.pi * (np.arange(rows) + 0.5) / rows)
    t = 0.5 * (y + 1.0)
    row = (1.0 - t)[:, None] * np.asarray(HORIZON) + t[:, None] * np.asarray(ZENITH)
    return np.repeat(row[:, None, :], 2 * rows, axis=1).astype(np.float32)


def _ground(quads: int):
    """(vertices, texcoords, triangles) of the ground square at y = 0,
    wound so that cross(e1, e2) points up."""
    xs = np.linspace(-GROUND_SIDE / 2, GROUND_SIDE / 2, quads + 1)
    xx, zz = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([xx, np.zeros_like(xx), zz], -1).reshape(-1, 3)
    uv = verts[:, [0, 2]] / CHECKER_PERIOD
    i, j = np.meshgrid(np.arange(quads), np.arange(quads), indexing="ij")
    v00 = (i * (quads + 1) + j).reshape(-1)
    v01, v10 = v00 + 1, v00 + quads + 1
    v11 = v10 + 1
    tris = np.concatenate([np.stack([v00, v01, v11], 1), np.stack([v00, v11, v10], 1)])
    return verts.astype(np.float32), uv.astype(np.float32), tris.astype(np.int32)


def make(seed: int, segments: int = SEGMENTS, bands: int = BANDS, spheres=None,
         ground_quads: int = GROUND_QUADS, checker: int = CHECKER, sky: int = SKY) -> dict:
    """The scene dict (builtin's layout) of generator seed `seed`; a test
    may cut the tessellation, keep some of the spheres (`spheres`, indices
    into `draw_spheres`' list) and shrink the ground's grid and the two
    images."""
    drawn = draw_spheres(np.random.default_rng(seed))
    if spheres is not None:
        drawn = [drawn[k] for k in spheres]
    b = builtin.SceneBuilder()
    for _, _, kind, albedo, fuzz in drawn:
        if kind == "metal":
            b.add_material(albedo=albedo, mat_type=DISNEY, roughness=fuzz, metallic=1.0, ior=IOR)
        else:
            b.add_material(albedo=albedo, mat_type={"lambert": builtin.DIFFUSE, "glass": GLASS,
                                                     "mirror": MIRROR}[kind], ior=IOR)
    ground_mtl = b.add_material(albedo=GROUND_ALBEDO)
    built = b.build()  # materials, and lights of no rows: nothing emits
    mats = built["materials"]
    mats["tex_ind"][ground_mtl, 0] = 0
    vertices, tri_v, tri_vn = [], [], []
    normals = [np.zeros((0, 3), np.float32)]
    nv = 0
    for k, (centre, radius, _, _, _) in enumerate(drawn):
        v, n, t = uv_sphere(centre, radius, segments, bands)
        mtl = np.full((len(t), 1), k, np.int32)
        tri_v.append(np.concatenate([t + nv, mtl], axis=1))
        tri_vn.append(np.concatenate([t + nv, np.ones((len(t), 1), np.int32)], axis=1))
        vertices.append(v)
        normals.append(n)
        nv += len(v)
    gv, guv, gt = _ground(ground_quads)
    tri_v.append(np.concatenate([gt + nv, np.full((len(gt), 1), ground_mtl, np.int32)], 1))
    tri_vn.append(np.zeros((len(gt), 4), np.int32))
    vertices.append(gv)
    tri_v = np.concatenate(tri_v).astype(np.int32)
    tri_vt = np.full((len(tri_v), 4), -1, np.int32)
    tri_vt[-len(gt):, :3] = gt
    return dict(
        vertices=np.concatenate(vertices).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        texcoords=guv,
        tri_v=tri_v,
        tri_vn=np.concatenate(tri_vn).astype(np.int32),
        tri_vt=tri_vt,
        materials=mats,
        lights=built["lights"],
        textures=checker_layer(checker)[None],
        env_map=sky_map(sky),
    )
