"""Progressive rendering: accumulation state, sample loop and resolve
(counterpart of caitlynrenderer_tpu/render/progressive.py).

The state is explicit — accumulation buffer, sample counter, base key — so
a render resumes exactly (convert.state_from_numpy reads the reference's
checkpoint fields).  Samples are a plain Python loop: the reference's
`lax.scan` batching hid per-launch dispatch cost on a TPU and has no
counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from caitlynrenderer_tpu_torch.core.types import Camera, RenderOptions
from caitlynrenderer_tpu_torch.render import sampling
from caitlynrenderer_tpu_torch.render.integrator import render_sample
from caitlynrenderer_tpu_torch.scene import DeviceScene


class RenderState(NamedTuple):
    """accum:       (H*W, 3) f32 tensor — sum of per-sample radiance
    frame_count: int — samples accumulated so far
    base_key:    (k1, k2) uint32 values — per-sample keys are folded from
                 it, so a resumed render continues the same sample sequence
    """

    accum: torch.Tensor
    frame_count: int
    base_key: Tuple[int, int]


def init_state(width: int, height: int, seed: int, device) -> RenderState:
    return RenderState(
        accum=torch.zeros((width * height, 3), dtype=torch.float32, device=device),
        frame_count=0,
        base_key=sampling.prng_key(seed),
    )


def reset(state: RenderState) -> RenderState:
    """Camera moved: clear the accumulation."""
    return state._replace(accum=torch.zeros_like(state.accum), frame_count=0)


def render_pixels(ds: DeviceScene, camera: Camera, key, pixel_ids, width: int, height: int,
                  options: RenderOptions):
    """One sample (`key`, an int pair) of the global pixel ids `pixel_ids`
    ((N,) int32; ids past the image trace throwaway rays): (N, 3) radiance.
    A pixel's uniforms depend only on the key and its id, so any split of
    the pixels (tiles, shards) renders each the same."""
    uniforms = sampling.pixel_uniforms(key, pixel_ids, options.max_depth)
    return render_sample(ds, camera, uniforms, width, height, options, pixel_ids)


def render_step(ds: DeviceScene, camera: Camera, state: RenderState, width: int,
                height: int, options: RenderOptions) -> RenderState:
    """Add one sample per pixel to the accumulation."""
    key = sampling.sample_key(state.base_key, state.frame_count)
    pixel_ids = torch.arange(width * height, dtype=torch.int32, device=state.accum.device)
    radiance = render_pixels(ds, camera, key, pixel_ids, width, height, options)
    return RenderState(state.accum + radiance, state.frame_count + 1, state.base_key)


def render_steps(ds: DeviceScene, camera: Camera, state: RenderState, width: int,
                 height: int, options: RenderOptions, spp: int) -> RenderState:
    """Accumulate `spp` samples; identical to `spp` render_step calls."""
    for _ in range(spp):
        state = render_step(ds, camera, state, width, height, options)
    return state


def tonemap(rgb, limit: float = 2.0):
    """Luminance-limited Reinhard (lum = .3r + .6g + .1b), then gamma 1/2.2."""
    lum = 0.3 * rgb[..., 0] + 0.6 * rgb[..., 1] + 0.1 * rgb[..., 2]
    c = rgb / (1.0 + lum / limit)[..., None]
    return torch.clamp(c, 0.0, 1.0) ** (1.0 / 2.2)


def resolve(state: RenderState, width: int, height: int, options: RenderOptions):
    """Accumulation → display image (H, W, 3) in [0, 1], row 0 at the top.
    The beauty pass is tonemapped; an AOV is a data view and resolves
    linearly, clipped to [0, 1], "depth" first normalized by the frame's
    largest value."""
    inv = 1.0 / max(float(state.frame_count), 1.0)
    return display(state.accum * inv * options.hdr_multiplier, width, height, options)


def display(hdr, width: int, height: int, options: RenderOptions):
    """Mean radiance (H*W, 3), row-major from the bottom row → display
    image (H, W, 3), as `resolve` describes."""
    if options.aov == "depth":
        img = torch.clamp(hdr / torch.clamp(hdr.max(), min=1e-8), 0.0, 1.0)
    elif options.aov != "beauty":
        img = torch.clamp(hdr, 0.0, 1.0)
    else:
        img = tonemap(hdr, options.tonemap_limit)
    return img.reshape(height, width, 3).flip(0)


def render_image(ds: DeviceScene, camera: Camera, options: RenderOptions, spp: int = 16,
                 seed: int = 0):
    """Accumulate `spp` samples on the scene's device and resolve.
    Returns (image, state)."""
    w, h = options.width, options.height
    state = render_steps(ds, camera, init_state(w, h, seed, ds.device), w, h, options, spp)
    return resolve(state, w, h, options), state
