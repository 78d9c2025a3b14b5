"""Camera ray generation (counterpart of caitlynrenderer_tpu/core/camera.py):
tent-filter AA jitter, vertical fov, aspect-corrected NDC and thin-lens
depth of field.  Takes the numpy `Camera` from `core.types.make_camera`,
or one whose fields are float32 tensors on the rays' device
(`camera_tensors`), which generates the same rays bit for bit without a
copy from the host: a CUDA graph holds such a camera in its static
buffers and `copy_camera` moves the next camera into them.  With a tensor
camera the caller says whether the lens is on (`has_lens` of the host's
camera), since reading the aperture back would wait for the card."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from caitlynrenderer_tpu_torch.core.types import Camera
from caitlynrenderer_tpu_torch.core import math as cm


def _vec(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def has_lens(camera: Camera) -> bool:
    """Whether the thin lens is on (aperture > 0), read on the host."""
    return bool(float(camera.aperture) > 0.0)


def camera_tensors(camera: Camera, device) -> Camera:
    """The camera with every field a float32 tensor of its own on
    `device` ((3,) vectors, 0-d scalars)."""
    return Camera(*(torch.tensor(np.asarray(f, np.float32), device=device) for f in camera))


def copy_camera(dst: Camera, camera: Camera) -> None:
    """Write a host camera's fields into the tensors of `dst` (from
    `camera_tensors`), without waiting for the card: the host's values
    are staged at once and copied in stream order."""
    for t, f in zip(dst, camera):
        t.copy_(torch.from_numpy(np.asarray(f, np.float32)), non_blocking=True)


def generate_rays(camera: Camera, width: int, height: int, uniforms,
                  lens: Optional[bool] = None):
    """One primary ray per pixel, all H*W pixels in row-major order, on
    `uniforms.device`.  Returns (origins, directions), each (H*W, 3)."""
    pixel_ids = torch.arange(width * height, dtype=torch.int32, device=uniforms.device)
    return generate_rays_for_ids(camera, width, height, pixel_ids, uniforms, lens)


def generate_rays_for_ids(camera: Camera, width: int, height: int, pixel_ids, uniforms,
                          lens: Optional[bool] = None):
    """One primary ray per global pixel id (y*width + x; ids past the image
    make throwaway rays).  uniforms: (N, >=4) in [0, 1): tent-jitter pair +
    lens pair.  lens: whether the thin lens is on, `has_lens(camera)` when
    None (give it for a camera of CUDA tensors).  Pixel (0, 0) is the
    bottom-left (GL convention); resolve flips rows.  Returns (origins,
    directions), each (N, 3) f32."""
    dev = uniforms.device
    xx = (pixel_ids % width).to(torch.float32)
    yy = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    u = (xx + 0.5) / width
    v = (yy + 0.5) / height

    jx, jy = cm.tent_jitter(2.0 * uniforms[:, 0], 2.0 * uniforms[:, 1])
    jx = jx / (width * 0.5)
    jy = jy / (height * 0.5)
    dx = (2.0 * u - 1.0) + jx
    dy = (2.0 * v - 1.0) + jy

    tan_fov = torch.tan(_vec(camera.fov, dev) * 0.5)
    dx = dx * (width / height) * tan_fov
    dy = dy * tan_fov

    right, up, forward = (_vec(c, dev) for c in (camera.right, camera.up, camera.forward))
    directions = cm.normalize(
        dx[:, None] * right[None, :] + dy[:, None] * up[None, :] + forward[None, :]
    )
    origins = _vec(camera.position, dev).expand_as(directions).clone()
    if not (has_lens(camera) if lens is None else lens):
        return origins, directions

    # Thin lens: jitter the origin on the aperture disk and refocus through
    # the focal plane.
    lens_r = torch.sqrt(uniforms[:, 2]) * (_vec(camera.aperture, dev) * 0.5)
    lens_phi = 2.0 * math.pi * uniforms[:, 3]
    lens_x = lens_r * torch.cos(lens_phi)
    lens_y = lens_r * torch.sin(lens_phi)
    focus_t = _vec(camera.focal_dist, dev) / torch.clamp(
        cm.dot(directions, forward[None, :]), min=1e-6
    )
    focus_point = origins + directions * focus_t[:, None]
    origins = origins + (lens_x[:, None] * right[None, :] + lens_y[:, None] * up[None, :])
    return origins, cm.normalize(focus_point - origins)
