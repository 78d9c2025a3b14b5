"""The port's texture and environment sampling (ops/texture.py) ≡ the
reference's on seeded inputs, atol 1e-6 (four gathers and a lerp in the
same order; XLA may contract the lerp's multiply-adds): wrap of uv outside
[0, 1) and of negative uv, out-of-range layers, longitude wrap, and the
poles and the seam of the equirect map.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from caitlynrenderer_tpu.io.builtin_scenes import procedural_sky
from caitlynrenderer_tpu.ops import texture as j_tex
from caitlynrenderer_tpu_torch.ops import texture as t_tex

ATOL = 1e-6


@pytest.mark.parametrize("span", [(0.0, 1.0), (-3.0, 3.0), (-1e-7, 1e-7)])
def test_sample_bilinear_matches_reference(span):
    """uv in [0, 1), across several wraps on both sides of 0, and at texel
    boundaries just around 0 (floor of a tiny negative value is -1)."""
    rng = np.random.default_rng(int(span[1] * 10))
    atlas = rng.random((3, 8, 16, 3), dtype=np.float32)
    n = 4096
    uv = rng.uniform(*span, (n, 2)).astype(np.float32)
    uv[:64] = np.array([[0.0, 0.0], [1.0, 1.0], [-1.0, 0.5], [0.5, -2.0]], np.float32)[
        np.arange(64) % 4]
    layer = rng.integers(-2, 5, n).astype(np.int32)  # clamped to [0, 3)
    want = np.asarray(j_tex.sample_bilinear(jnp.asarray(atlas), jnp.asarray(layer),
                                            jnp.asarray(uv)))
    got = t_tex.sample_bilinear(torch.from_numpy(atlas), torch.from_numpy(layer),
                                torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_sample_env_matches_reference():
    """Random unit directions, the poles (y = ±1, and |y| a hair above 1,
    which the clamp absorbs), the seam (z = 0, x < 0: atan2's ±pi) and
    axis directions, on the procedural sky.  Its sun reaches ~20, where
    atol 1e-6 is below one ulp: rtol 1e-6 beside it."""
    rng = np.random.default_rng(4)
    env = procedural_sky(16, 32)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    special = np.array([[0, 1, 0], [0, -1, 0], [0, 1.0000001, 0], [-1, 0, 0], [-1, 0, -0.0],
                        [-1, 0, 1e-7], [-1, 0, -1e-7], [1, 0, 0], [0, 0, 1], [0, 0, -1]],
                       np.float32)
    d[:len(special)] = special
    want = np.asarray(j_tex.sample_env(jnp.asarray(env), jnp.asarray(d)))
    got = t_tex.sample_env(torch.from_numpy(env), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)
    assert np.isfinite(got).all()
