"""Everything a run draws from `--seed`: the base key of each image and the
pixels the output check compares.  Any whole number is a seed, however
large; every seed asks for the same amount of work."""

from __future__ import annotations

import numpy as np


def _words(seed: int):
    seed = int(seed)
    sign = 1 if seed < 0 else 0
    seed = abs(seed)
    out = [sign]
    while True:
        out.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return out


def image_seed(seed: int, image: int) -> int:
    """The 32-bit seed of the base key of image number `image` (0, 1, ...)
    of a run: each image restarts the accumulation under its own key."""
    return int(np.random.SeedSequence(_words(seed) + [1, image]).generate_state(1)[0])


def check_pixels(seed: int, num_pixels: int, count: int) -> np.ndarray:
    """`count` distinct pixel ids below `num_pixels`, sorted, that the
    output check compares."""
    rng = np.random.default_rng(np.random.SeedSequence(_words(seed) + [2]))
    return np.sort(rng.choice(num_pixels, size=min(count, num_pixels), replace=False))
