"""Carrying a render across packages (counterpart of
caitlynrenderer_tpu/utils/checkpoint.py:22-42).

A renderer's "weights" are its scene arrays and its progressive state.
These functions take and give numpy arrays only, so neither package
imports the other: given the same scene and state, both compute the same
thing from there on.
"""

from __future__ import annotations

import numpy as np
import torch

from caitlynrenderer_tpu.core.types import SceneArrays
from caitlynrenderer_tpu_torch.render.progressive import RenderState
from caitlynrenderer_tpu_torch.scene import (
    WIDE_FIELDS,
    DeviceScene,
    empty_wide_arrays,
    scene_to_device,
    validate_scene,
)


def device_scene_from_numpy(scene: SceneArrays, device, wide=None) -> DeviceScene:
    """The port's DeviceScene from the reference DeviceScene's `scene`
    field with every array as numpy (e.g.
    `jax.tree_util.tree_map(np.asarray, ds.scene)`), and, for the wide
    accelerator, its wide arrays: `wide` maps each name of
    `scene.WIDE_FIELDS` ("wb_group_bounds", "wb_mega", "wb_oct_bounds",
    "wb_oct_gid", "wb_oct_start", "wb_oct_blk") to a numpy array, e.g.
    `{k: np.asarray(getattr(ds, k)) for k in WIDE_FIELDS}`.  Nothing is
    rebuilt: the port then sees the reference's triangle ids and groups.
    Without `wide` the scene serves the brute-force sweep, in whatever
    triangle order it has."""
    validate_scene(scene)
    if wide is None:
        wide = empty_wide_arrays()
    missing = set(WIDE_FIELDS) - set(wide)
    if missing:
        raise ValueError(f"wide arrays missing: {sorted(missing)}")
    return scene_to_device(scene, wide, device)


def state_from_numpy(accum, frame_count, base_key, device) -> RenderState:
    """RenderState from the fields `utils/checkpoint.save_render_state`
    writes: accum (H*W, 3) f32, frame_count int, base_key uint32[2]."""
    key = np.asarray(base_key, dtype=np.uint32).reshape(2)
    return RenderState(
        accum=torch.tensor(np.asarray(accum, dtype=np.float32), device=device),
        frame_count=int(frame_count),
        base_key=(int(key[0]), int(key[1])),
    )


def state_to_numpy(state: RenderState) -> dict:
    """The inverse of `state_from_numpy`: {"accum", "frame_count",
    "base_key"}, the checkpoint's fields and dtypes, so `np.savez(path,
    **state_to_numpy(state))` writes a file the reference's
    `load_render_state` reads."""
    return {
        "accum": state.accum.detach().cpu().numpy(),
        "frame_count": np.int32(state.frame_count),
        "base_key": np.asarray(state.base_key, dtype=np.uint32),
    }
