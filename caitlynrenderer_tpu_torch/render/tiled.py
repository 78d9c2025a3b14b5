"""Tiled rendering (counterpart of caitlynrenderer_tpu/render/tiled.py).

The image is cut into a grid of tiles, each rendered as its own, smaller
ray batch: the memory of a sample's ray state is a tile's, not the frame's.
A pixel's uniforms are keyed by its global id, so a tiled render
accumulates exactly what the untiled progressive render does, bit for
bit.  The accumulation stays on the scene's device.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from caitlynrenderer_tpu_torch.core.types import Camera, RenderOptions
from caitlynrenderer_tpu_torch.render import sampling
from caitlynrenderer_tpu_torch.render.progressive import display, render_pixels
from caitlynrenderer_tpu_torch.scene import DeviceScene


class Tile(NamedTuple):
    x0: int
    y0: int
    w: int
    h: int


def tile_grid(width: int, height: int, tiles_x: int, tiles_y: int) -> Iterator[Tile]:
    """Uniform tile grid, row by row (the last row and column absorb the
    remainder)."""
    bw = width // tiles_x
    bh = height // tiles_y
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            w = bw if tx < tiles_x - 1 else width - bw * (tiles_x - 1)
            h = bh if ty < tiles_y - 1 else height - bh * (tiles_y - 1)
            yield Tile(tx * bw, ty * bh, w, h)


def render_tile(ds: DeviceScene, camera: Camera, key, tile: Tile, width: int, height: int,
                options: RenderOptions):
    """One sample (`key`, an int pair) of one tile: (tile.h * tile.w, 3)
    radiance, row-major within the tile."""
    dev = ds.device
    yy, xx = torch.meshgrid(torch.arange(tile.h, dtype=torch.int32, device=dev),
                            torch.arange(tile.w, dtype=torch.int32, device=dev), indexing="ij")
    pixel_ids = (tile.y0 + yy.reshape(-1)) * width + (tile.x0 + xx.reshape(-1))
    return render_pixels(ds, camera, key, pixel_ids, width, height, options)


def accumulate_tiled(ds: DeviceScene, camera: Camera, options: RenderOptions, spp: int = 4,
                     seed: int = 0):
    """Sum of `spp` samples of every pixel, tile by tile over the grid of
    options.num_tiles_x by num_tiles_y: (H*W, 3) on the scene's device,
    equal to progressive.render_steps' accumulation."""
    width, height = options.width, options.height
    accum = torch.zeros((height, width, 3), dtype=torch.float32, device=ds.device)
    base_key = sampling.prng_key(seed)
    tiles = list(tile_grid(width, height, options.num_tiles_x, options.num_tiles_y))
    for s in range(spp):
        key = sampling.sample_key(base_key, s)
        for t in tiles:
            radiance = render_tile(ds, camera, key, t, width, height, options)
            accum[t.y0 : t.y0 + t.h, t.x0 : t.x0 + t.w] += radiance.reshape(t.h, t.w, 3)
    return accum.reshape(-1, 3)


def render_image_tiled(ds: DeviceScene, camera: Camera, options: RenderOptions, spp: int = 4,
                       seed: int = 0):
    """The display image (H, W, 3) of a tiled render of `spp` samples, on
    the scene's device.  Resolved as the reference resolves it (accum / spp
    * hdr_multiplier), which for a spp that is not a power of two differs
    by an ulp from progressive.resolve's accum * (1 / spp)."""
    accum = accumulate_tiled(ds, camera, options, spp, seed)
    return display(accum / spp * options.hdr_multiplier, options.width, options.height, options)
