"""Numerical guard of a render (counterpart of
caitlynrenderer_tpu/utils/debug.py).

A NaN or inf born in one bounce poisons the whole progressive
accumulation.  The shading clamps keep the Disney and glass branches
finite (the sqrt floors of the GGX, GTR1 and Fresnel terms, the log of
GTR1's clamped alpha); `checked_render_sample` is the check that they did,
run on one sample before a long accumulation (`cli render --debug-checks`).
"""

from __future__ import annotations

import torch


def checked_render_sample(ds, camera, uniforms, width: int, height: int, options):
    """Render one sample and return its (H*W, 3) radiance; raise ValueError
    naming the first non-finite value's pixel and channel if there is
    one."""
    from caitlynrenderer_tpu_torch.render.integrator import render_sample

    out = render_sample(ds, camera, uniforms, width, height, options)
    bad = ~torch.isfinite(out)
    if bool(bad.any()):
        first = int(bad.reshape(-1).nonzero()[0])
        pixel, channel = divmod(first, 3)
        x, y = pixel % width, pixel // width
        raise ValueError(
            f"non-finite radiance {float(out.reshape(-1)[first])} at pixel {pixel} (x {x}, "
            f"y {y} counted from the bottom row), channel {channel}, in "
            f"{int(bad.any(dim=1).sum())} of {out.shape[0]} pixels: NaN or inf born in "
            "shading or traversal")
    return out
