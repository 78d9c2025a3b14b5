"""The Cornell box with a Disney floor, frozen: `builtin.cornell_box`'s 36
triangles and materials, and a fifth material, the floor's, as
scenes/cornell_disney.toml asks for it (`floor = "disney"`): the Disney
type, base color 0.9, roughness 0.5, ior 1.5, every other parameter at
the builder's default (metallic, spec_tint, sheen, clearcoat, subsurface
0; clearcoat_gloss 1).  Its floor's two triangles, the first two of the
box, take that material."""

from __future__ import annotations

import numpy as np

from cellbench.scenes import builtin

DISNEY = 17  # the material type id of the Disney BRDF


def make() -> dict:
    sc = builtin.cornell_box()
    b = builtin.SceneBuilder()
    b.add_material(albedo=(0.9, 0.9, 0.9), mat_type=DISNEY)
    floor = b.build()["materials"]
    mats = sc["materials"]
    sc["materials"] = {k: np.concatenate([mats[k], floor[k]]) for k in builtin.MATERIAL_FIELDS}
    sc["tri_v"][:2, 3] = len(mats["albedo"])
    return sc
