"""Core datatypes, struct-of-arrays throughout.

A copy of caitlynrenderer_tpu/core/types.py for the port, which imports
nothing of the JAX package; tests/test_torch_host.py holds the builders
and loaders that fill these containers against the originals.

The reference keeps scene data as C++ AoS structs uploaded to GL texture
buffers (`Caitlyn/Scene.h:75-166`, `Scene.h:1000-1156`).  Here each field
is a dense `(N, k)` array: numpy on the host, a tensor once
scene.upload_scene has moved it to a device.  Every container is a
NamedTuple, so the port's functions accept the reference's containers
too: they read fields, never classes.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np

Array = np.ndarray  # host- or device-side; fields accept either


class MaterialType(enum.IntEnum):
    """Material type ids, capability-matched to the reference's 18-entry enum
    (`Caitlyn/Scene.h:111-133`).  Stored in `Materials.albedo[:, 3]`
    exactly as the reference stores the parsed `type` there
    (`Scene.h:576-581`)."""

    DIFFUSE = 0
    MIRROR = 1
    GLASS = 2
    GLASS_COLOR = 3
    GLASS_NO_REFRACT = 4
    ROUGH_DIELECTRIC = 5
    CONDUCTOR = 6
    ROUGH_CONDUCTOR = 7
    ROUGH_CONDUCTOR_COMPLEX = 8
    ROUGH_CONDUCTOR_SIMPLE = 9
    PLASTIC = 10
    ROUGH_PLASTIC = 11
    ROUGH_PLASTIC_SPECULAR = 12
    THIN_SHEET = 13
    THIN_DIELECTRIC = 14
    SMOOTH_COAT = 15
    LIGHT_DIFFUSE = 16
    DISNEY = 17


class Materials(NamedTuple):
    """SoA material table.

    Rows mirror the reference's 4×vec4 `Material` layout
    (`Caitlyn/Scene.h:75-85`) plus one extra row of Disney
    parameters (the reference README claims Disney BSDF but the snapshot has
    no parameter storage for it; we make it first-class).

    albedo:   (M, 4) f32 — rgb + w = MaterialType id
    emission: (M, 4) f32 — rgb + w = light index, or -1 if not emissive
    specular: (M, 4) f32 — rgb tint + w = ior (dielectrics) / unused
    disney:   (M, 4) f32 — roughness, metallic, spec_tint, sheen
    disney2:  (M, 4) f32 — clearcoat, clearcoat_gloss, subsurface, anisotropic
    tex_ind:  (M, 4) f32 — albedo / normal / specular / metallic-roughness
                            texture indices, -1 = untextured
    """

    albedo: Array
    emission: Array
    specular: Array
    disney: Array
    disney2: Array
    tex_ind: Array

    @property
    def count(self) -> int:
        return int(self.albedo.shape[0])


class Lights(NamedTuple):
    """Area lights extracted from emissive triangles, SoA.

    Mirrors the reference `Light {p,u,v,n,e,area_pdf}` struct
    (`Caitlyn/Scene.h:151-166`): a light is the parallelogram
    ``p + b0*u + b1*v`` restricted to the triangle (b0 = 1-sqrt(r1),
    b1 = r2*sqrt(r1)), normal `n`, emission `e`.

    p, u, v, n, e: (L, 3) f32
    area_pdf:      (L, 2) f32 — [triangle area, selection pdf = area/Σarea]
    """

    p: Array
    u: Array
    v: Array
    n: Array
    e: Array
    area_pdf: Array

    @property
    def count(self) -> int:
        return int(self.p.shape[0])


class SceneArrays(NamedTuple):
    """The whole scene as flat device-ready arrays.

    vertices:  (V, 3) f32
    normals:   (VN, 3) f32 (may be empty)
    texcoords: (VT, 2) f32 (may be empty)
    tri_v:     (T, 4) i32 — v0, v1, v2, material index
               (reference packs the same quad per triangle, `Triangle.h:19-27`)
    tri_vn:    (T, 4) i32 — n0, n1, n2, flag: 1 = interpolate vertex normals,
               0 = use the geometric face normal (the reference bakes integer
               face normals into the index slot when unavailable,
               `path_trace.fs:440-454`; we recompute them in float instead)
    tri_vt:    (T, 4) i32 — t0, t1, t2, unused (-1 when untextured)
    materials: Materials
    lights:    Lights
    textures:  optional (K, H, W, 3) f32 albedo atlas, all resized to one
               size like the reference's 256² GL_TEXTURE_2D_ARRAY
               (`Scene.h:1063-1078`)
    env_map:   optional (He, We, 3) f32 equirect environment map, sampled
               on ray miss when RenderOptions.use_env_map (the reference's
               `useEnvMap`/`hdrMultiplier` options, `Scene.h:57-58`)
    """

    vertices: Array
    normals: Array
    texcoords: Array
    tri_v: Array
    tri_vn: Array
    tri_vt: Array
    materials: Materials
    lights: Lights
    textures: Optional[Array] = None
    env_map: Optional[Array] = None

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v.shape[0])


class Camera(NamedTuple):
    """Fly camera as an explicit basis, differentiable by construction.

    Capability-matched to the reference camera (`Caitlyn/
    Camera.h:4-66`): position + orthonormal basis + vertical fov (radians).
    `focal_dist`/`aperture` exist in the reference but its ray-gen ignores
    them (`path_trace.fs:1041-1047`); here aperture > 0 enables real
    thin-lens depth of field.
    """

    position: Array  # (3,)
    forward: Array  # (3,)
    right: Array  # (3,)
    up: Array  # (3,)
    fov: Array  # scalar, radians
    focal_dist: Array  # scalar
    aperture: Array  # scalar


class RenderOptions(NamedTuple):
    """Render configuration, mirroring the reference `RenderOptions`
    (`Caitlyn/Scene.h:45-71`) with TPU-specific additions.

    All fields are static Python values (hashable) so the options object can
    be passed as a `static_argnum` to jit.
    """

    width: int = 700
    height: int = 700
    max_depth: int = 3  # bounces per path (reference hardcodes 3)
    max_samples: int = 1024  # progressive sample budget
    num_tiles_x: int = 1  # tiled rendering grid
    num_tiles_y: int = 1
    hdr_multiplier: float = 1.0
    use_env_map: bool = False
    accel: str = "bvh2"  # {"brute", "bvh2", "sbvh", "wide", "cwbvh"}
    traversal: str = "auto"  # {"auto", "xla", "pallas"} — Pallas MT kernel on TPU
    max_leaf: int = 4  # BVH leaf width (must match the uploaded build)
    # Traversal stack capacity for the binary-BVH paths.  Size it from the
    # actual build with `scene.required_stack(ds)` (the CLI/bench do) — the
    # integrator checks DeviceScene.tree_depth (static pytree metadata)
    # against this at trace time and raises on a stack the build could
    # overflow, so library callers get a loud error instead of wrong hits.
    max_stack: int = 32
    ray_chunk: int = 8192  # traversal chunk size (coherence-sorted lax.map)
    # Russian roulette: bounces >= rr_start survive with probability
    # max(T) (clamped to [0.05, 1]), throughput compensated by 1/p.
    # -1 disables (the default — matches the oracle and the reference's
    # fixed 3-bounce loop); deep-bounce configs (BASELINE #4: 6 bounces)
    # set rr_start=2 so near-black lanes stop paying traversals.
    rr_start: int = -1
    tonemap_limit: float = 2.0  # luminance clamp in resolve (output.fs:16-18)
    exact_reference_nee: bool = False  # reproduce reference NEE estimator
    # Material families present in the scene (static, so jit traces only the
    # shading code the scene needs — a pure-Lambert scene skips the Disney /
    # glass / mirror lobes entirely).  Compute with `scene.scene_families`;
    # the default traces everything (always correct, just slower).
    families: tuple = ("lambert", "disney", "mirror", "glass")
    # (the reference omits the cos/pi factor in its NEE term,
    #  `path_trace.fs:988-998`; default is the physically correct estimator)
    # Debug render mode (AOV): "beauty" = full path trace; "albedo" =
    # first-hit surface albedo (the reference's debug integrator,
    # `path_trace.fs:822-840`); "normal" = first-hit shading normal
    # mapped to [0,1]; "depth" = first-hit t (normalized by the 99th
    # percentile at resolve).  AOVs bypass accumulation noise — one
    # sample is exact — and make traversal/shading bugs visible per-pass.
    aov: str = "beauty"


def make_camera(
    position,
    look_at,
    fov_degrees: float = 40.0,
    up_hint=(0.0, 1.0, 0.0),
    focal_dist: float = 0.1,
    aperture: float = 0.0,
) -> Camera:
    """Build a camera basis from position/look-at, like the reference ctor
    (`Camera.h:10-25`)."""
    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    forward = look_at - position
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up_hint, np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    return Camera(
        position=position,
        forward=forward.astype(np.float32),
        right=right.astype(np.float32),
        up=up.astype(np.float32),
        fov=np.float32(np.deg2rad(fov_degrees)),
        focal_dist=np.float32(focal_dist),
        aperture=np.float32(aperture),
    )


# Material types that are handled as perfect-specular (delta) lobes by the
# integrator: no NEE at these vertices, path stays "specular" for MIS.
# ROUGH_DIELECTRIC is approximated as smooth glass in v1 (documented
# estimator simplification — a microfacet transmission lobe is future work);
# GLASS_NO_REFRACT gets ior≈1 at parse time (straight-through transmission).
SPECULAR_TYPES = (
    MaterialType.MIRROR,
    MaterialType.GLASS,
    MaterialType.GLASS_COLOR,
    MaterialType.GLASS_NO_REFRACT,
    MaterialType.ROUGH_DIELECTRIC,
    MaterialType.CONDUCTOR,
    MaterialType.THIN_DIELECTRIC,
    MaterialType.THIN_SHEET,
)

# Types shaded as pure Lambert (the reference's concrete integrator math).
LAMBERT_TYPES = (MaterialType.DIFFUSE, MaterialType.LIGHT_DIFFUSE)
