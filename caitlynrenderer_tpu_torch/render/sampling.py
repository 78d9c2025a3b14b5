"""Deterministic, pixel-keyed random numbers (counterpart of
caitlynrenderer_tpu/render/sampling.py).

Threefry-2x32 `fold_in` and `uniform` written in torch, bitwise equal to
`jax.random` under jax's default `jax_threefry_partitionable=True`: a
pixel's numbers depend only on (key, sample index, pixel id), so a port
render can be compared bitwise with a reference render.

A key is a pair (k1, k2) of uint32 values, as in the reference's raw
`uint32[2]` key: Python ints, or 0-d int64 tensors on the scene's device.
A CUDA graph of several samples (render/progressive.py) folds a frame
counter that lives on the card into a base key there, so that each replay
draws the samples of its own frames; the numbers are the same either way.
torch has little uint32 support (especially on CUDA), so the arithmetic
runs in int64 with every sum and shift masked back to 32 bits.

`pixel_uniforms` and `draw_uniforms` draw on the card through kernel B5
(ops/threefry.py, csrc/threefry.cu) and on the CPU through their plain
twins `pixel_uniforms_plain` and `draw_uniforms_plain`, which the kernel
equals bit for bit; there is no fallback from one to the other.  The key
folds (`fold_in`, `sample_key`) stay torch on either device.

Uniform layout per pixel-sample (shared with the reference integrator):

    [0:2]  tent-filter AA jitter pair
    [2:4]  thin-lens aperture pair
    then per bounce b: [4+7b : 11+7b] =
        light_pick, light_u1, light_u2, bsdf_u1, bsdf_u2, bsdf_lobe, rr
"""

from __future__ import annotations

import torch

from caitlynrenderer_tpu_torch.ops import _build, threefry

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant
_ONE = 0x3F800000  # the bits of 1.0f
_MANTISSA_SHIFT = 9  # 32 random bits -> 23 of mantissa


def uniforms_per_sample(max_depth: int) -> int:
    return 4 + 7 * max_depth


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under key
    (k1, k2).  x0, x1: int64 tensors (or Python ints) holding uint32 values;
    k1, k2: ints or int64 tensors broadcasting against them.  Returns the
    two output words, same kind as the inputs."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(key):
    """A key's two words: as they are where they are tensors, else ints."""
    k1, k2 = key
    if isinstance(k1, torch.Tensor):
        return k1, k2
    return int(k1), int(k2)


def fold_in(key, data):
    """`jax.random.fold_in(key, data)`: data an integer, or an int64 tensor
    of integers (then each is folded in, and the key's words are tensors
    of data's shape)."""
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor):
        return threefry2x32(k1, k2, torch.zeros_like(data), data & _MASK)
    return threefry2x32(k1, k2, 0, int(data) & _MASK)


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)` as an int pair, under jax's default 32-bit
    integers (the seed's high word is 0)."""
    return (0, int(seed) & _MASK)


def sample_key(base_key, sample_idx):
    """Per-sample key: the progressive sample counter folded into the base
    key.  sample_idx: an int, or an int64 tensor of sample counters on the
    card (the base key's words then ints or 0-d tensors there)."""
    return fold_in(base_key, sample_idx)


def _bits_to_uniform(b0, b1):
    """jax.random.uniform's float32 in [0, 1) from one threefry output pair:
    the 23 high bits of b0 ^ b1 as mantissa of a float in [1, 2), minus 1."""
    bits = ((b0 ^ b1) >> _MANTISSA_SHIFT) | _ONE
    return bits.to(torch.int32).view(torch.float32) - 1.0


def draw_uniforms_plain(key, num_pixels: int, max_depth: int, device) -> torch.Tensor:
    """`jax.random.uniform(key, (num_pixels, 4 + 7*max_depth))`: the uniform
    block for one sample of every pixel, keyed by lane position."""
    n_u = uniforms_per_sample(max_depth)
    count = torch.arange(num_pixels * n_u, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(*_words(key), torch.zeros_like(count), count)
    return _bits_to_uniform(b0, b1).reshape(num_pixels, n_u)


def pixel_uniforms_plain(key, pixel_ids, max_depth: int) -> torch.Tensor:
    """Per-pixel-keyed uniforms, `vmap(uniform(fold_in(key, pid), (n_u,)))`:
    stream i depends only on (key, pixel_ids[i]).  key: an int pair, or a
    pair of 0-d int64 tensors on pixel_ids' device; pixel_ids: (N,) integer
    tensor.  Returns (N, 4 + 7*max_depth) f32 in [0, 1) on its device."""
    n_u = uniforms_per_sample(max_depth)
    pid = pixel_ids.to(torch.int64) & _MASK
    pk1, pk2 = threefry2x32(*_words(key), torch.zeros_like(pid), pid)
    pk1, pk2 = pk1[:, None], pk2[:, None]
    count = torch.arange(n_u, dtype=torch.int64, device=pixel_ids.device)[None, :]
    b0, b1 = threefry2x32(pk1, pk2, torch.zeros_like(count), count)
    return _bits_to_uniform(b0, b1)


def draw_uniforms(key, num_pixels: int, max_depth: int, device) -> torch.Tensor:
    """`draw_uniforms_plain`'s numbers: on a CUDA device from kernel B5
    (ops/threefry.py, which takes the key's words as ints), on the CPU
    from the twin."""
    if torch.device(device).type == "cpu":
        threefry.launches["lane_twin"] += 1
        return draw_uniforms_plain(key, num_pixels, max_depth, device)
    return threefry.threefry_lane(key, num_pixels, uniforms_per_sample(max_depth), device)


def pixel_uniforms(key, pixel_ids, max_depth: int) -> torch.Tensor:
    """`pixel_uniforms_plain`'s numbers: for ids on a CUDA device from
    kernel B5 (ops/threefry.py, which takes (N,) contiguous int32 ids and
    the key's words as ints or 0-d int64 tensors on that card), on the CPU
    from the twin."""
    if _build.is_cpu(pixel_ids, *key):
        threefry.launches["pixel_twin"] += 1
        return pixel_uniforms_plain(key, pixel_ids, max_depth)
    return threefry.threefry_pixel(key, pixel_ids, uniforms_per_sample(max_depth))
