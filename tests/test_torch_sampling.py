"""Port's threefry sampler ≡ jax.random, bitwise, under jax's defaults.

Compared as raw uint32 bit patterns: a port render can only be compared
bitwise with a reference render if every uniform is the same float."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu.render import sampling as j_sampling
from caitlynrenderer_tpu_torch.render import sampling as t_sampling

DEMO_PIXELS = 700 * 700


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _keys(seed, sample):
    jk = j_sampling.sample_key(jax.random.PRNGKey(seed), sample)
    tk = t_sampling.sample_key(t_sampling.prng_key(seed), sample)
    return jk, tk


@pytest.mark.parametrize("seed", [0, 1, 12345, -7, 2**31 - 1])
def test_prng_key_and_sample_key_match(seed):
    assert t_sampling.prng_key(seed) == tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
    for sample in (0, 1, 47, 1023):
        jk, tk = _keys(seed, sample)
        assert tk == tuple(int(v) for v in np.asarray(jk))


@pytest.mark.parametrize(
    "seed,sample,ids",
    [
        (0, 0, (0, 4096, 1)),
        (0, 5, (0, 4096, 1)),
        (3, 17, (DEMO_PIXELS - 4096, DEMO_PIXELS, 1)),  # the demo frame's last rows
        (42, 1, (0, DEMO_PIXELS, 131)),  # spread over the whole demo frame
    ],
)
@pytest.mark.parametrize("max_depth", [1, 3])
def test_pixel_uniforms_bitwise(seed, sample, ids, max_depth):
    jk, tk = _keys(seed, sample)
    pids = np.arange(*ids, dtype=np.int32)
    ref = j_sampling.pixel_uniforms(jk, jnp.asarray(pids), max_depth)
    got = t_sampling.pixel_uniforms(tk, torch.from_numpy(pids), max_depth)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("seed,sample,pixels", [(0, 0, 1), (0, 3, 777), (9, 2, 4096)])
def test_draw_uniforms_bitwise(seed, sample, pixels):
    jk, tk = _keys(seed, sample)
    ref = j_sampling.draw_uniforms(jk, pixels, 3)
    got = t_sampling.draw_uniforms(tk, pixels, 3, "cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    assert (got >= 0).all() and (got < 1).all()
