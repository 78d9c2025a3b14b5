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
from caitlynrenderer_tpu_torch.scene import DeviceScene, upload_scene


def device_scene_from_numpy(scene: SceneArrays, device) -> DeviceScene:
    """The port's DeviceScene from the reference DeviceScene's `scene`
    field with every array as numpy (e.g.
    `jax.tree_util.tree_map(np.asarray, ds.scene)`).  The reference keeps a
    brute-force scene in its own triangle order and a BVH scene in leaf
    order; either is a valid scene for the brute-force sweep."""
    return upload_scene(scene, "brute", device)


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
