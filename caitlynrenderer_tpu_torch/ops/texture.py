"""Texture atlas and environment-map sampling on tensors (counterpart of
caitlynrenderer_tpu/ops/texture.py).

The atlas is a dense (K, H, W, 3) f32 tensor of albedo textures, the
environment map an (H, W, 3) f32 equirectangular radiance map; both are
sampled bilinearly with four gathers and a lerp, batched over the rays.
Integer wrap uses Python's `%` on tensors (floor modulo, as `jnp.mod`, so
a negative texel index wraps to the far edge; `torch.fmod` would not).
"""

from __future__ import annotations

import math

import torch


def _lerp4(c00, c10, c01, c11, fx, fy):
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear(atlas, layer, uv):
    """Bilinear sample with GL_REPEAT wrap: atlas (K, H, W, 3); layer (N,)
    integer, clamped to [0, K); uv (N, 2), any real values.  Returns
    (N, 3)."""
    k, h, w, _ = atlas.shape
    u = uv[:, 0] * w - 0.5
    v = uv[:, 1] * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]
    x0i = x0.to(torch.int64) % w
    y0i = y0.to(torch.int64) % h
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h
    layer = torch.clamp(layer.to(torch.int64), 0, k - 1)
    return _lerp4(atlas[layer, y0i, x0i], atlas[layer, y0i, x1i], atlas[layer, y1i, x0i],
                  atlas[layer, y1i, x1i], fx, fy)


def sample_env(env, d):
    """Equirectangular lookup by unit direction d (N, 3): env (H, W, 3),
    row 0 at the zenith (+y up); bilinear, wrapping in longitude and
    clamped in latitude.  Returns (N, 3) radiance."""
    u = torch.atan2(d[:, 2], d[:, 0]) * (0.5 / math.pi) + 0.5
    v = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    h, w, _ = env.shape
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int64) % w
    x1i = (x0i + 1) % w
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    return _lerp4(env[y0i, x0i], env[y0i, x1i], env[y1i, x0i], env[y1i, x1i], fx, fy)
