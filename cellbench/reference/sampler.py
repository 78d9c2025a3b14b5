"""The pixel-keyed sampler, frozen: Threefry-2x32 `fold_in` and `uniform`
in int64 torch arithmetic, equal bit for bit to `jax.random` under its
default partitionable threefry.

A pixel-sample's uniforms are a function of the image's base key, the
sample index and the pixel id alone, so the reference draws the numbers
of any pixel of any sample without the rest of the frame.

Uniform layout per pixel-sample: [0:2] tent-filter jitter, [2:4] lens,
then per bounce b, [4+7b : 11+7b] = light_pick, light_u1, light_u2,
bsdf_u1, bsdf_u2, bsdf_lobe, rr.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE = 0x3F800000  # the bits of 1.0f
_MANTISSA_SHIFT = 9


def uniforms_per_sample(max_depth: int) -> int:
    return 4 + 7 * max_depth


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter pair (x0, x1) under the key
    (k1, k2); every word a uint32 value held in int64 (ints or tensors
    that broadcast)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def base_key(seed: int):
    """`jax.random.PRNGKey(seed)` for a seed below 2**32: (0, seed)."""
    return 0, int(seed) & MASK


def uniforms(key, sample_idx, pixel_ids, max_depth: int) -> torch.Tensor:
    """(S, P, 4 + 7 max_depth) float32 in [0, 1): the uniforms of samples
    `sample_idx` ((S,) int64) of pixels `pixel_ids` ((P,) int64) of the
    image whose base key is `key`."""
    k1, k2 = key
    sk1, sk2 = threefry2x32(k1, k2, torch.zeros_like(sample_idx), sample_idx & MASK)
    pid = (pixel_ids & MASK)[None, :]
    pk1, pk2 = threefry2x32(sk1[:, None], sk2[:, None], torch.zeros_like(pid), pid)
    count = torch.arange(uniforms_per_sample(max_depth), dtype=torch.int64,
                         device=pixel_ids.device)[None, None, :]
    b0, b1 = threefry2x32(pk1[..., None], pk2[..., None], torch.zeros_like(count), count)
    bits = ((b0 ^ b1) >> _MANTISSA_SHIFT) | _ONE
    return bits.to(torch.int32).view(torch.float32) - 1.0
