"""Image output helpers (host side).

A copy of caitlynrenderer_tpu/io/image.py for the port, which imports
nothing of the JAX package; its outputs are held byte-equal to the
original's in tests/test_torch_host.py.
"""

from __future__ import annotations

import numpy as np


def save_png(path: str, img) -> None:
    """Save an (H, W, 3) float [0,1] image as PNG via PIL."""
    from PIL import Image

    arr = np.asarray(img)
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
