"""Sharded rendering and the sharded inverse-rendering step over a mesh of
ranks (counterpart of caitlynrenderer_tpu/parallel/render.py).

  * the pixel axis is cut into dp blocks (padded to a multiple of dp),
    one block per mesh row, and each rank holds its row's block of the
    accumulation;
  * the sp ranks of a row trace independent sample streams of its pixels,
    summed by an all-reduce over the row;
  * every rank holds the whole scene;
  * the training step all-reduces the loss and every gradient over the
    whole mesh.

Every collective is an all-reduce (SUM), which gloo carries on CPU and
CUDA tensors alike and NCCL on CUDA tensors.  An image is assembled by
summing zero-filled buffers into which each row writes its block: x + 0
is exact, so the sum equals an all-gather bit for bit.

Determinism: a pixel's uniforms depend only on (base key, sample index,
global pixel id), so with sp = 1 the sharded accumulation equals the
single-process progressive one bit for bit; with sp > 1 the row's sum
reassociates the samples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from caitlynrenderer_tpu_torch.core.types import Camera, RenderOptions
from caitlynrenderer_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from caitlynrenderer_tpu_torch.render import sampling
from caitlynrenderer_tpu_torch.render.progressive import RenderState, display, render_pixels
from caitlynrenderer_tpu_torch.scene import DeviceScene


def padded_pixels(width: int, height: int, dp: int) -> int:
    n = width * height
    return ((n + dp - 1) // dp) * dp


def init_sharded_state(mesh: Mesh, width: int, height: int, seed: int, device) -> RenderState:
    """A RenderState whose accum is this rank's (n_pad / dp, 3) block of the
    padded accumulation."""
    block = padded_pixels(width, height, mesh.dp) // mesh.dp
    return RenderState(accum=torch.zeros((block, 3), dtype=torch.float32, device=device),
                       frame_count=0, base_key=sampling.prng_key(seed))


def _block_ids(mesh: Mesh, block: int, device):
    return mesh.dp_idx * block + torch.arange(block, dtype=torch.int32, device=device)


def sharded_render_step(ds: DeviceScene, camera: Camera, state: RenderState, mesh: Mesh,
                        width: int, height: int, options: RenderOptions) -> RenderState:
    """One progressive step on the mesh: every rank traces its row's pixel
    block with its own sample stream, and the row sums its sp streams.
    Adds sp samples per pixel per call."""
    block = state.accum.shape[0]
    sample_idx = state.frame_count * mesh.sp + mesh.sp_idx
    key = sampling.sample_key(state.base_key, sample_idx)
    radiance = render_pixels(ds, camera, key, _block_ids(mesh, block, state.accum.device),
                             width, height, options)
    radiance = all_reduce_sum(radiance, mesh.sp_group)
    return RenderState(state.accum + radiance, state.frame_count + 1, state.base_key)


def resolve_accum(accum, frame_count: int, sp: int, width: int, height: int,
                  options: RenderOptions):
    """(>= H*W, 3) accumulation in pixel order → display image (H, W, 3):
    the first H*W rows over frames·sp, as the reference resolves a sharded
    accumulation (accum / frames, not progressive.resolve's accum *
    (1 / frames))."""
    frames = max(float(frame_count * sp), 1.0)
    hdr = accum[: width * height] / frames * options.hdr_multiplier
    return display(hdr, width, height, options)


def _assemble(local, slots, n: int, mesh: Mesh):
    """(n, 3) buffer on every rank: each row's first rank writes `local`
    (rows of its block) at `slots`, the others add zeros, and the mesh
    sums the buffers."""
    buf = torch.zeros((n, 3), dtype=local.dtype, device=local.device)
    if mesh.sp_idx == 0:
        buf[slots] = local
    return all_reduce_sum(buf, mesh.group)


def gather_accum(state: RenderState, mesh: Mesh):
    """The whole (n_pad, 3) accumulation on every rank."""
    block = state.accum.shape[0]
    n_pad = block * mesh.dp
    slots = _block_ids(mesh, block, state.accum.device).long()
    return _assemble(state.accum, slots, n_pad, mesh)


def gather_image(state: RenderState, mesh: Mesh, width: int, height: int,
                 options: RenderOptions):
    """The resolved display image (H, W, 3) on every rank, as a tensor on
    the accumulation's device."""
    return resolve_accum(gather_accum(state, mesh), state.frame_count, mesh.sp, width, height,
                         options)


# ---------------------------------------------------------------------------
# Inverse rendering: one step over the mesh.
# ---------------------------------------------------------------------------


def sharded_train_step(params, ds: DeviceScene, camera: Camera, target, key, sample_idx: int,
                       mesh: Mesh, width: int, height: int, options: RenderOptions,
                       lr: float = 1e-2):
    """One step of inverse rendering over the mesh.

    params: {name: tensor}, any of grad.inverse.apply_params' keys;
    target: this rank's (n_pad / dp, 3) block of the target radiance;
    key: an int pair; each rank draws its 1-spp uniforms from
    sample_key(fold_in(key, sp_idx), sample_idx).

    The loss is the mean squared error over the mesh's n_pad·sp pixel
    samples: each rank differentiates the sum of its squared errors, then
    the loss and every gradient are summed over the whole mesh, and each
    parameter steps by lr along its gradient over the gradient's RMS (the
    reference's normalized step, not Adam): parameter groups of different
    scales, a roughness next to a camera position, move comparably.
    Returns (new params, loss as a float)."""
    from caitlynrenderer_tpu_torch.grad.inverse import apply_params

    block = target.shape[0]
    k = sampling.sample_key(sampling.fold_in(key, mesh.sp_idx), sample_idx)
    leaves = {name: p.detach().clone().requires_grad_(True) for name, p in params.items()}
    ds2, cam2 = apply_params(ds, camera, leaves)
    radiance = render_pixels(ds2, cam2, k, _block_ids(mesh, block, target.device), width,
                             height, options)
    loss = torch.sum((radiance - target) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    loss = all_reduce_sum(loss.detach().reshape(1), mesh.group)
    new_params = {}
    for (name, p), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        g = all_reduce_sum(g.contiguous(), mesh.group)
        new_params[name] = (p - lr * g / (torch.sqrt(torch.mean(g * g)) + 1e-12)).detach()
    return new_params, float(loss[0]) / (block * mesh.dp * mesh.sp)


# ---------------------------------------------------------------------------
# Tile-parallel rendering: the tile grid sharded over the mesh rows.  Each
# row owns a contiguous run of tiles (compact pixel sets, coherent rays);
# pixels keep their global ids, so the image equals the untiled one.
# ---------------------------------------------------------------------------


def tile_pixel_order(width: int, height: int, tiles_x: int, tiles_y: int, dp: int):
    """Pixel ids in tile-major order, padded to a multiple of dp.  Returns
    (order, n_pad): order[slot] is the global pixel id accumulated at that
    slot, -1 for the padding at the tail (which traces pixel 0 and is
    never gathered)."""
    tw = -(-width // tiles_x)
    th = -(-height // tiles_y)
    ids = []
    for tyi in range(tiles_y):
        for txi in range(tiles_x):
            ys = np.arange(tyi * th, min((tyi + 1) * th, height))
            xs = np.arange(txi * tw, min((txi + 1) * tw, width))
            ids.append((ys[:, None] * width + xs[None, :]).ravel())
    order = np.concatenate(ids).astype(np.int32)
    n_pad = ((order.size + dp - 1) // dp) * dp
    order = np.concatenate([order, np.full(n_pad - order.size, -1, np.int32)])
    return order, n_pad


class TiledState(NamedTuple):
    """accum: this rank's (n_pad / dp, 3) block of the tile-major
    accumulation; order: (n_pad / dp,) int32, the global pixel id of each
    of its slots (-1: padding)."""

    accum: torch.Tensor
    order: torch.Tensor


def init_tiled_state(mesh: Mesh, order, device) -> TiledState:
    """This rank's block of tile_pixel_order's `order`, and a zero
    accumulation for it."""
    block = order.shape[0] // mesh.dp
    local = np.ascontiguousarray(order[mesh.dp_idx * block : (mesh.dp_idx + 1) * block])
    return TiledState(accum=torch.zeros((block, 3), dtype=torch.float32, device=device),
                      order=torch.tensor(local, dtype=torch.int32, device=device))


def sharded_render_step_tiled(ds: DeviceScene, camera: Camera, accum, order, frame_count: int,
                              base_key, mesh: Mesh, width: int, height: int,
                              options: RenderOptions):
    """One sample of every tile: tiles sharded over the rows, sample
    streams over sp (summed over the row).  Returns the new accum."""
    sample_idx = frame_count * mesh.sp + mesh.sp_idx
    key = sampling.sample_key(base_key, sample_idx)
    pixel_ids = torch.clamp(order, min=0)  # padding traces pixel 0
    radiance = render_pixels(ds, camera, key, pixel_ids, width, height, options)
    return accum + all_reduce_sum(radiance, mesh.sp_group)


def gather_image_tiled(accum, order, frame_count: int, mesh: Mesh, width: int, height: int,
                       options: RenderOptions):
    """Scatter every rank's tile-major block back to pixel order (the kept
    slots only) and resolve; the image (H, W, 3) on every rank."""
    keep = order >= 0
    pix = _assemble(accum[keep], order[keep].long(), width * height, mesh)
    return resolve_accum(pix, frame_count, mesh.sp, width, height, options)
