"""Config system: TOML scene presets + CLI override → RenderOptions/Camera.

A copy of caitlynrenderer_tpu/utils/config.py for the port, which imports
nothing of the JAX package; its outputs are held byte-equal to the
original's in tests/test_torch_host.py.

Replaces the reference's hardcoded absolute paths and dead imgui widgets
(`Caitlyn/main.cpp:24-26,280-288`; commented camera presets
`Scene.h:459-484`) with declarative per-scene files:

    # scene.toml
    [scene]
    obj = "models/cornell-box.obj"     # or builtin = "cornell"
    [camera]
    position = [-2.75561, 2.745992, 7.58545]
    look_at  = [-2.75561, 2.745992, 6.58545]
    fov = 40.0
    [render]
    width = 700
    height = 700
    max_depth = 3
    max_samples = 1024
    accel = "wide"
"""

from __future__ import annotations

import os
import tomllib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from caitlynrenderer_tpu_torch.core.types import Camera, RenderOptions, make_camera


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return tomllib.load(f)


def options_from_config(cfg: Dict[str, Any], **overrides) -> RenderOptions:
    r = dict(cfg.get("render", {}))
    r.update({k: v for k, v in overrides.items() if v is not None})
    if isinstance(r.get("families"), list):
        r["families"] = tuple(r["families"])  # TOML lists are unhashable
    allowed = RenderOptions._fields
    return RenderOptions(**{k: v for k, v in r.items() if k in allowed})


def camera_from_config(cfg: Dict[str, Any], translation=None) -> Camera:
    c = cfg.get("camera", {})
    pos = np.asarray(c.get("position", [0.0, 1.0, 4.0]), np.float32)
    look = np.asarray(c.get("look_at", [0.0, 1.0, 0.0]), np.float32)
    if translation is not None:
        pos = pos + translation
        look = look + translation
    return make_camera(
        pos,
        look,
        fov_degrees=float(c.get("fov", 40.0)),
        focal_dist=float(c.get("focal_dist", 0.1)),
        aperture=float(c.get("aperture", 0.0)),
    )


def scene_from_config(cfg: Dict[str, Any], base_dir: str = "."):
    """Load the scene named by the config: OBJ file or a builtin.

    `[scene] env = "sky"` attaches the procedural sky env map;
    `env_png = "path.png"` loads an equirect map from a PNG (decoded as
    linear via gamma 2.2).  Enable sampling with `[render] use_env_map`."""
    s = cfg.get("scene", {})
    if "obj" in s:
        from caitlynrenderer_tpu_torch.io.obj import load_obj

        path = s["obj"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        scene, translation = load_obj(path)
    else:
        from caitlynrenderer_tpu_torch.io import builtin_scenes

        builtin = s.get("builtin", "cornell")
        if builtin == "cornell":
            from caitlynrenderer_tpu_torch.core.types import MaterialType

            # `floor = "disney"` puts a Disney BSDF on the floor (the
            # BASELINE config-5 recovery scene).
            floor = s.get("floor", "diffuse").upper()
            scene, translation = builtin_scenes.cornell_box(
                floor_type=int(MaterialType[floor])
            )
        elif builtin.startswith("grid"):
            res = int(s.get("resolution", 224))
            scene, translation = builtin_scenes.displaced_grid(resolution=res)
        elif builtin == "soup":
            scene, translation = builtin_scenes.random_triangle_soup(
                int(s.get("triangles", 20000))
            )
        else:
            raise ValueError(f"unknown builtin scene {builtin!r}")
    if s.get("env") == "sky":
        from caitlynrenderer_tpu_torch.io.builtin_scenes import procedural_sky

        scene = scene._replace(env_map=procedural_sky())
    elif "env_png" in s:
        from caitlynrenderer_tpu_torch.io.image import load_png

        path = s["env_png"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        scene = scene._replace(env_map=(load_png(path) ** 2.2).astype(np.float32))
    return scene, translation
