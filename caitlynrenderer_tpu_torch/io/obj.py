"""OBJ/MTL scene loader (host side, NumPy).

A copy of caitlynrenderer_tpu/io/obj.py for the port, which imports
nothing of the JAX package; its outputs are held byte-equal to the
original's in tests/test_torch_host.py.

Capability-matched to the reference's streaming parser
(`Caitlyn/Scene.h:742-926` Read_Object,
`Scene.h:507-740` ReadMtl, `Scene.h:186-315` get_face_index):

* v / vt / vn records; vt.y is flipped to 1-y (`Scene.h:801`).
* Polygon faces fan-triangulated; all of `v`, `v/vt`, `v//vn`, `v/vt/vn`
  index forms; 1-based and negative indices fixed up like `fixIndex`
  (`Scene.h:135-138`).
* `usemtl` binds a material index per face; `mtllib` triggers MTL parsing.
* MTL: `newmtl`, `Kd` (albedo), `Ke` (emission; any positive channel makes
  the material a light), `Ks`, `Ns`, `Ni`, `d`, `map_Kd` (albedo texture →
  fixed-size atlas like the reference's 256² texture array), and the
  non-standard `type <Name>` directive.  The reference only honors
  `type Mirror` (`Scene.h:576-581`); we accept every name in the 18-entry
  `MaterialType` enum (`Scene.h:111-133`) since that enum is the declared
  capability surface.
* Emissive faces become per-triangle area lights {p, u, v, n, e, area, pdf}
  (`Scene.h:856-878`, pdf normalization `Scene.h:902-913`).  Deviations
  from the reference, chosen for correctness and documented here:
    - stored area is the true triangle area 0.5*|u×v| (the reference stores
      the parallelogram area |u×v|, `Scene.h:869-871`, which double-counts);
    - each triangle knows its own light index (`tri_light`), where the
      reference reuses the material's first light index for MIS pdf lookup
      (`path_trace.fs:913-915`), which is only correct for equal-area lights.
* The scene is translated so its bbox minimum sits at the origin
  (`Scene.h:915-925`); cameras defined in the original space must be
  translated by the returned `translation`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from caitlynrenderer_tpu_torch.core.types import (
    Lights,
    Materials,
    MaterialType,
    SceneArrays,
)

_TYPE_NAMES = {
    "Diffuse": MaterialType.DIFFUSE,
    "Mirror": MaterialType.MIRROR,
    "Glass": MaterialType.GLASS,
    "Glass_Color": MaterialType.GLASS_COLOR,
    "Glass_No_Refract": MaterialType.GLASS_NO_REFRACT,
    "Rough_Dielectric": MaterialType.ROUGH_DIELECTRIC,
    "RoughDielectric": MaterialType.ROUGH_DIELECTRIC,
    "Conductor": MaterialType.CONDUCTOR,
    "RoughConductor": MaterialType.ROUGH_CONDUCTOR,
    "RoughConductorComplex": MaterialType.ROUGH_CONDUCTOR_COMPLEX,
    "RoughConductorSimple": MaterialType.ROUGH_CONDUCTOR_SIMPLE,
    "Plastic": MaterialType.PLASTIC,
    "RoughPlastic": MaterialType.ROUGH_PLASTIC,
    "RoughPlastic_Specular": MaterialType.ROUGH_PLASTIC_SPECULAR,
    "ThinSheet": MaterialType.THIN_SHEET,
    "ThinDielectric": MaterialType.THIN_DIELECTRIC,
    "SmoothCoat": MaterialType.SMOOTH_COAT,
    "Light_Diffuse": MaterialType.LIGHT_DIFFUSE,
    "Disney": MaterialType.DISNEY,
}


@dataclass
class _Mtl:
    name: str
    albedo: np.ndarray = field(default_factory=lambda: np.array([0.8, 0.8, 0.8], np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    specular: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    mat_type: int = int(MaterialType.DIFFUSE)
    light_index: int = -1  # per-material light id like the reference's count_light
    ior: float = 1.5
    alpha: float = 1.0
    roughness: float = 0.5
    metallic: float = 0.0
    spec_tint: float = 0.0
    sheen: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    subsurface: float = 0.0
    anisotropic: float = 0.0
    tex_albedo: int = -1

    @property
    def is_emissive(self) -> bool:
        return bool(np.any(self.emission > 0.0))


def _fix_index(v: int, n: int) -> int:
    """1-based / negative OBJ index fixup (`Scene.h:135-138`)."""
    if v < 0:
        return v + n
    if v > 0:
        return v - 1
    return -1


def _parse_face_vertex(tok: str, nv: int, nvt: int, nvn: int) -> Tuple[int, int, int]:
    """Parse one face-vertex token into (v, vt, vn) 0-based indices, -1 absent."""
    parts = tok.split("/")
    v = _fix_index(int(parts[0]), nv)
    vt = -1
    vn = -1
    if len(parts) >= 2 and parts[1] != "":
        vt = _fix_index(int(parts[1]), nvt)
    if len(parts) >= 3 and parts[2] != "":
        vn = _fix_index(int(parts[2]), nvn)
    return v, vt, vn


def _ns_to_roughness(ns: float) -> float:
    """Map Phong exponent Ns to a GGX-ish roughness (standard conversion)."""
    return float(np.clip(np.sqrt(2.0 / (ns + 2.0)), 0.0, 1.0))


def parse_mtl(path: str, tex_size: int = 256) -> Tuple[List[_Mtl], List[np.ndarray]]:
    """Parse an MTL file; returns materials plus a list of tex_size² RGB
    float textures (linearized like `path_trace.fs:482`'s pow 2.2 sample)."""
    materials: List[_Mtl] = []
    textures: List[np.ndarray] = []
    tex_map: Dict[str, int] = {}
    count_light = 0
    cur: Optional[_Mtl] = None
    direction = os.path.dirname(path)

    if not os.path.exists(path):
        # Reference prints "Mtl file not exist" and carries on (Scene.h:510).
        return materials, textures

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            tok = line.split()
            key = tok[0]
            if key == "newmtl":
                cur = _Mtl(name=tok[1] if len(tok) > 1 else f"mtl{len(materials)}")
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur.albedo = np.array([float(x) for x in tok[1:4]], np.float32)
            elif key == "Ke":
                e = np.array([float(x) for x in tok[1:4]], np.float32)
                if np.any(e > 0):
                    cur.emission = e
                    cur.light_index = count_light
                    count_light += 1
            elif key == "Ks":
                cur.specular = np.array([float(x) for x in tok[1:4]], np.float32)
            elif key == "Ns":
                cur.roughness = _ns_to_roughness(float(tok[1]))
            elif key == "Ni":
                cur.ior = float(tok[1])
            elif key == "d":
                cur.alpha = float(tok[1])
            elif key == "type":
                cur.mat_type = int(_TYPE_NAMES.get(tok[1], MaterialType.DIFFUSE))
            elif key == "metallic":
                cur.metallic = float(tok[1])
            elif key == "roughness":
                cur.roughness = float(tok[1])
            elif key == "clearcoat":
                cur.clearcoat = float(tok[1])
            elif key == "sheen":
                cur.sheen = float(tok[1])
            elif key == "subsurface":
                cur.subsurface = float(tok[1])
            elif key == "anisotropic":
                cur.anisotropic = float(tok[1])
            elif key == "map_Kd":
                name = os.path.basename(tok[-1].replace("\\", "/"))
                if name not in tex_map:
                    tex_path = os.path.join(direction, name)
                    img = _load_texture(tex_path, tex_size)
                    if img is not None:
                        tex_map[name] = len(textures)
                        textures.append(img)
                if name in tex_map:
                    cur.tex_albedo = tex_map[name]
    return materials, textures


def _load_texture(path: str, tex_size: int) -> Optional[np.ndarray]:
    """Load + bilinear-resize an image to tex_size² linear-RGB float32,
    like the reference's stb load + hand-rolled resize (`Scene.h:321-371`)
    and shader-side 2.2 linearization (`path_trace.fs:482`)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    if not os.path.exists(path):
        return None
    img = Image.open(path).convert("RGB").resize((tex_size, tex_size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr**2.2


def load_obj(
    path: str,
    tex_size: int = 256,
    translate_to_origin: bool = True,
) -> Tuple[SceneArrays, np.ndarray]:
    """Parse an OBJ file into flat SceneArrays.

    Returns (scene, translation) where `translation` is the vector that was
    added to all vertices (so callers can translate cameras the same way the
    reference translates its camera, `Scene.h:922-925`).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    vertices: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    tri_v: List[Tuple[int, int, int, int]] = []
    tri_vn: List[Tuple[int, int, int, int]] = []
    tri_vt: List[Tuple[int, int, int, int]] = []
    tri_light: List[int] = []
    light_rows: List[Tuple[np.ndarray, ...]] = []

    mtls: List[_Mtl] = []
    textures: List[np.ndarray] = []
    mtl_map: Dict[str, int] = {}
    mtl_ind = 0
    read_mtl = False

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            key = tok[0]
            if key == "v":
                vertices.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vt":
                # Reference flips v: vec2(x, 1-y) (Scene.h:801).
                texcoords.append((float(tok[1]), 1.0 - float(tok[2])))
            elif key == "vn":
                normals.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "f":
                idx = [
                    _parse_face_vertex(t, len(vertices), len(texcoords), len(normals))
                    for t in tok[1:]
                ]
                # Fan triangulation (get_face_index, Scene.h:186-315).
                for i in range(1, len(idx) - 1):
                    corners = (idx[0], idx[i], idx[i + 1])
                    vs = tuple(c[0] for c in corners)
                    vts = tuple(c[1] for c in corners)
                    vns = tuple(c[2] for c in corners)
                    interp = 1 if vns[0] != -1 else 0
                    tri_v.append((*vs, mtl_ind))
                    tri_vn.append((*vns, interp))
                    tri_vt.append((*vts, -1))
                    # Emissive face → area light (Scene.h:856-878).
                    m = mtls[mtl_ind] if mtl_ind < len(mtls) else None
                    if m is not None and m.is_emissive:
                        p0 = np.array(vertices[vs[0]], np.float32)
                        p1 = np.array(vertices[vs[1]], np.float32)
                        p2 = np.array(vertices[vs[2]], np.float32)
                        u = p1 - p0
                        v = p2 - p0
                        n = np.cross(u, v)
                        two_area = float(np.linalg.norm(n))
                        n = n / max(two_area, 1e-20)
                        tri_light.append(len(light_rows))
                        light_rows.append((p0, u, v, n, m.emission.copy(), 0.5 * two_area))
                    else:
                        tri_light.append(-1)
            elif key == "usemtl":
                mtl_ind = mtl_map.get(tok[1], 0)
            elif key == "mtllib" and not read_mtl:
                mtl_path = os.path.join(os.path.dirname(path), " ".join(tok[1:]))
                mtls, textures = parse_mtl(mtl_path, tex_size)
                mtl_map = {m.name: i for i, m in enumerate(mtls)}
                read_mtl = True

    if not mtls:
        mtls = [_Mtl(name="default")]
    for m in mtls:
        _apply_type_defaults(m)

    verts = np.asarray(vertices, np.float32).reshape(-1, 3)
    translation = np.zeros(3, np.float32)
    if translate_to_origin and len(verts):
        translation = -verts.min(axis=0)
        verts = verts + translation

    lights = _pack_lights(light_rows, translation)
    materials = _pack_materials(mtls)

    scene = SceneArrays(
        vertices=verts,
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, np.float32).reshape(-1, 2),
        tri_v=np.asarray(tri_v, np.int32).reshape(-1, 4),
        tri_vn=np.asarray(tri_vn, np.int32).reshape(-1, 4),
        tri_vt=np.asarray(tri_vt, np.int32).reshape(-1, 4),
        materials=materials,
        lights=lights,
        textures=np.stack(textures) if textures else None,
    )
    # Per-triangle light id rides in tri_vt.w (the reference reserved that
    # slot for exactly this, commented at Scene.h:873).
    scene = scene._replace(
        tri_vt=np.concatenate(
            [scene.tri_vt[:, :3], np.asarray(tri_light, np.int32).reshape(-1, 1)],
            axis=1,
        )
    )
    return scene, translation


def _apply_type_defaults(m: _Mtl) -> None:
    """Map the material-type families onto Disney/dielectric parameters
    (the reference's 18-type enum is the capability surface but carries no
    parameter storage — these defaults realize each family's intent)."""
    t = m.mat_type
    if t in (
        int(MaterialType.ROUGH_CONDUCTOR),
        int(MaterialType.ROUGH_CONDUCTOR_COMPLEX),
        int(MaterialType.ROUGH_CONDUCTOR_SIMPLE),
    ):
        m.metallic = 1.0
    elif t == int(MaterialType.PLASTIC):
        m.roughness = min(m.roughness, 0.15)
    elif t == int(MaterialType.SMOOTH_COAT):
        m.clearcoat = max(m.clearcoat, 1.0)
        m.clearcoat_gloss = 1.0
    elif t == int(MaterialType.GLASS_NO_REFRACT):
        m.ior = 1.0001  # straight-through transmission


def _pack_lights(rows, translation: np.ndarray) -> Lights:
    if not rows:
        z = np.zeros((0, 3), np.float32)
        return Lights(p=z, u=z, v=z, n=z, e=z, area_pdf=np.zeros((0, 2), np.float32))
    p = np.stack([r[0] for r in rows]) + translation
    u = np.stack([r[1] for r in rows])
    v = np.stack([r[2] for r in rows])
    n = np.stack([r[3] for r in rows])
    e = np.stack([r[4] for r in rows])
    area = np.asarray([r[5] for r in rows], np.float32)
    pdf = area / max(float(area.sum()), 1e-20)
    return Lights(
        p=p.astype(np.float32),
        u=u.astype(np.float32),
        v=v.astype(np.float32),
        n=n.astype(np.float32),
        e=e.astype(np.float32),
        area_pdf=np.stack([area, pdf], axis=1).astype(np.float32),
    )


def _pack_materials(mtls: List[_Mtl]) -> Materials:
    m = len(mtls)
    albedo = np.zeros((m, 4), np.float32)
    emission = np.zeros((m, 4), np.float32)
    specular = np.zeros((m, 4), np.float32)
    disney = np.zeros((m, 4), np.float32)
    disney2 = np.zeros((m, 4), np.float32)
    tex_ind = np.full((m, 4), -1.0, np.float32)
    for i, mt in enumerate(mtls):
        albedo[i, :3] = mt.albedo
        albedo[i, 3] = mt.mat_type
        emission[i, :3] = mt.emission
        emission[i, 3] = mt.light_index if mt.is_emissive else -1
        specular[i, :3] = mt.specular
        specular[i, 3] = mt.ior
        disney[i] = [mt.roughness, mt.metallic, mt.spec_tint, mt.sheen]
        disney2[i] = [mt.clearcoat, mt.clearcoat_gloss, mt.subsurface, mt.anisotropic]
        tex_ind[i, 0] = mt.tex_albedo
    return Materials(
        albedo=albedo,
        emission=emission,
        specular=specular,
        disney=disney,
        disney2=disney2,
        tex_ind=tex_ind,
    )
