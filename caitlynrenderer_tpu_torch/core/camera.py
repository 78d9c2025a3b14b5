"""Camera ray generation (counterpart of caitlynrenderer_tpu/core/camera.py):
tent-filter AA jitter, vertical fov, aspect-corrected NDC and thin-lens
depth of field.  Takes the numpy `Camera` from `core.types.make_camera`."""

from __future__ import annotations

import math

import torch

from caitlynrenderer_tpu_torch.core.types import Camera
from caitlynrenderer_tpu_torch.core import math as cm


def _vec(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def generate_rays(camera: Camera, width: int, height: int, uniforms):
    """One primary ray per pixel, all H*W pixels in row-major order, on
    `uniforms.device`.  Returns (origins, directions), each (H*W, 3)."""
    pixel_ids = torch.arange(width * height, dtype=torch.int32, device=uniforms.device)
    return generate_rays_for_ids(camera, width, height, pixel_ids, uniforms)


def generate_rays_for_ids(camera: Camera, width: int, height: int, pixel_ids, uniforms):
    """One primary ray per global pixel id (y*width + x; ids past the image
    make throwaway rays).  uniforms: (N, >=4) in [0, 1): tent-jitter pair +
    lens pair.  Pixel (0, 0) is the bottom-left (GL convention); resolve
    flips rows.  Returns (origins, directions), each (N, 3) f32."""
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
    if not float(camera.aperture) > 0.0:
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
