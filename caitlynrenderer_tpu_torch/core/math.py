"""Shared geometric math on tensors (counterpart of
caitlynrenderer_tpu/core/math.py).

Vectorized over leading batch axes.  Dot products are written out
component by component, ((x + y) + z), so the order of the sum is fixed on
every device and matches the reference's 3-element reduction.  The
reference's one-hot `gather_rows` is a TPU matrix-unit workaround and has
no counterpart: callers index with `table[idx]`.
"""

from __future__ import annotations

import math

import torch

INF = 1e9
EPS = 1e-4
RAY_OFFSET = 2e-4  # hit-point offset along the normal


def dot(a, b, keepdims: bool = False):
    out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return out.unsqueeze(-1) if keepdims else out


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v, eps: float = 1e-20):
    return v * torch.reciprocal(torch.sqrt(torch.clamp(dot(v, v, True), min=eps)))


def norm(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def onb(n):
    """Orthonormal basis (u, v) around unit normal n: the branchless
    Frisvad basis with the n.z ≈ -1 pole handled by a select."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    a = 1.0 / torch.clamp(1.0 + nz, min=1e-7)
    b = -nx * ny * a
    u_reg = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    v_reg = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    pole = (nz < -0.9999999).unsqueeze(-1)
    # The pole's basis is made on the device: a constant from the host (a
    # list, or a scalar stored into an element) is a copy that waits for
    # the card, which a CUDA graph cannot capture.
    axis = torch.arange(3, device=n.device)
    u_pole = torch.where(axis == 1, -1.0, 0.0).to(n.dtype)
    v_pole = torch.where(axis == 0, -1.0, 0.0).to(n.dtype)
    return torch.where(pole, u_pole, u_reg), torch.where(pole, v_pole, v_reg)


def cosine_hemisphere_dir(u1, u2):
    """Cosine-weighted hemisphere sample in local (u, v, n) coordinates."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1.0 - u1, min=0.0))],
        dim=-1,
    )


def local_to_world(local_dir, n):
    """Rotate a local-frame direction into the world frame around n."""
    u, v = onb(n)
    return u * local_dir[..., 0:1] + v * local_dir[..., 1:2] + n * local_dir[..., 2:3]


def _tent(r):
    return torch.where(
        r < 1.0, torch.sqrt(r) - 1.0, 1.0 - torch.sqrt(torch.clamp(2.0 - r, min=0.0))
    )


def tent_jitter(r1, r2):
    """Tent-filter antialiasing jitter in [-1, 1] pixels for r in [0, 2)."""
    return _tent(r1), _tent(r2)


def reflect(d, n):
    """Mirror reflection of incident direction d about normal n."""
    return d - 2.0 * dot(d, n, True) * n


def luminance(rgb):
    """Rec. 709 luminance of (..., 3) linear RGB."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def interpolate(a, b, c, u, v):
    """Barycentric interpolation a*(1-u-v) + b*u + c*v."""
    w = 1.0 - u - v
    return a * w.unsqueeze(-1) + b * u.unsqueeze(-1) + c * v.unsqueeze(-1)
