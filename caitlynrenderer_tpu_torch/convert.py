"""Carrying a render across packages (counterpart of
caitlynrenderer_tpu/utils/checkpoint.py:22-42).

A renderer's "weights" are its scene arrays, its progressive state and
its optimizable parameters.
These functions take and give numpy arrays only, so neither package
imports the other: given the same scene and state, both compute the same
thing from there on.
"""

from __future__ import annotations

import numpy as np
import torch

from caitlynrenderer_tpu_torch.accel.bvh import FlatBVH
from caitlynrenderer_tpu_torch.core.types import SceneArrays
from caitlynrenderer_tpu_torch.render.progressive import RenderState
from caitlynrenderer_tpu_torch.scene import (
    BVH_FIELDS,
    CW_FIELDS,
    WIDE_FIELDS,
    DeviceScene,
    empty_cw_arrays,
    empty_wide_arrays,
    one_leaf_bvh,
    scene_to_device,
    validate_scene,
)


def _fields(name, arrays, fields):
    missing = set(fields) - set(arrays)
    if missing:
        raise ValueError(f"{name} arrays missing: {sorted(missing)}")
    return {k: arrays[k] for k in fields}


def device_scene_from_numpy(scene: SceneArrays, device, wide=None, cw=None,
                            bvh=None) -> DeviceScene:
    """The port's DeviceScene from the reference DeviceScene's `scene`
    field with every array as numpy (e.g.
    `jax.tree_util.tree_map(np.asarray, ds.scene)`; the texture atlas and
    the env map, where present, become f32 tensors too), and the arrays of at
    most one accelerator, each a dict of numpy arrays under the reference
    DeviceScene's names, e.g. `{k: np.asarray(getattr(ds, k)) for k in
    WIDE_FIELDS}`:
      wide: scene.WIDE_FIELDS ("wb_group_bounds", "wb_mega",
            "wb_oct_bounds", "wb_oct_gid", "wb_oct_start", "wb_oct_blk");
      cw:   scene.CW_FIELDS ("cw_nodes" (N8, 20) uint32, "cw_planes",
            "cw_bounds"), the bits of the node words unchanged;
      bvh:  scene.BVH_FIELDS ("node_bounds", "node_meta"), for "bvh2" and
            "sbvh".
    Nothing is rebuilt: the port then sees the reference's triangle ids.
    Without any the scene serves the brute-force sweep, in whatever
    triangle order it has."""
    validate_scene(scene)
    given = [k for k, v in (("wide", wide), ("cwbvh", cw), ("bvh2", bvh)) if v is not None]
    if len(given) > 1:
        raise ValueError(f"give the arrays of one accelerator, got {given}")
    accel = given[0] if given else "brute"
    tree = one_leaf_bvh(scene.num_triangles)
    if bvh is not None:
        b = _fields("bvh", bvh, BVH_FIELDS)
        tree = FlatBVH(b["node_bounds"], b["node_meta"], tree.tri_order)
    wide = empty_wide_arrays() if wide is None else _fields("wide", wide, WIDE_FIELDS)
    cw = empty_cw_arrays() if cw is None else _fields("cw", cw, CW_FIELDS)
    return scene_to_device(scene, accel, device, bvh=tree, wide=wide, cw=cw)


def params_from_numpy(params_np: dict, device) -> dict:
    """grad/inverse.py's parameter dict from the reference's, given as
    numpy arrays (e.g. `{k: np.asarray(v) for k, v in params.items()}`):
    each an f32 tensor on `device`."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
            for k, v in params_np.items()}


def params_to_numpy(params: dict) -> dict:
    """The inverse of `params_from_numpy`: each parameter as an f32 numpy
    array on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


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
