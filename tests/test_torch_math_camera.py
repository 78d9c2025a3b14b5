"""Port's core/math and core/camera ≡ the reference's, on the same numpy
inputs.  Tolerance rtol 1e-6 with atol 1e-7: the same float32 expressions,
up to the ulp-level differences of XLA's and torch's sqrt/sin/cos/tan."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu.core import camera as j_camera
from caitlynrenderer_tpu.core import math as j_math
from caitlynrenderer_tpu.core.types import make_camera
from caitlynrenderer_tpu_torch.core import camera as t_camera
from caitlynrenderer_tpu_torch.core import math as t_math

RTOL, ATOL = 1e-6, 1e-7
N = 2048


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    vec = lambda: rng.standard_normal((N, 3)).astype(np.float32)  # noqa: E731
    unit = lambda: (lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(vec())  # noqa: E731
    n = unit()
    n[:8] = [0.0, 0.0, -1.0]  # the onb pole branch
    return {
        "a": vec(), "b": vec(), "c": vec(), "n": n, "d": unit(),
        "u1": rng.random(N, dtype=np.float32), "u2": rng.random(N, dtype=np.float32),
        "r1": 2.0 * rng.random(N, dtype=np.float32), "r2": 2.0 * rng.random(N, dtype=np.float32),
        "bu": rng.random(N, dtype=np.float32) * 0.5, "bv": rng.random(N, dtype=np.float32) * 0.5,
    }


CASES = {
    "dot": lambda m, x: m.dot(x["a"], x["b"]),
    "dot_keepdims": lambda m, x: m.dot(x["a"], x["b"], True),
    "normalize": lambda m, x: m.normalize(x["a"]),
    "norm": lambda m, x: m.norm(x["a"]),
    "onb": lambda m, x: m.onb(x["n"]),
    "cosine_hemisphere_dir": lambda m, x: m.cosine_hemisphere_dir(x["u1"], x["u2"]),
    "local_to_world": lambda m, x: m.local_to_world(
        m.cosine_hemisphere_dir(x["u1"], x["u2"]), x["n"]),
    "tent_jitter": lambda m, x: m.tent_jitter(x["r1"], x["r2"]),
    "reflect": lambda m, x: m.reflect(x["d"], x["n"]),
    "interpolate": lambda m, x: m.interpolate(x["a"], x["b"], x["c"], x["bu"], x["bv"]),
}


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_reference(name):
    x = _inputs()
    ref = _flat(CASES[name](j_math, {k: jnp.asarray(v) for k, v in x.items()}))
    got = _flat(CASES[name](t_math, {k: torch.from_numpy(v) for k, v in x.items()}))
    assert len(ref) == len(got)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aperture", [0.0, 0.25])
def test_generate_rays_matches_reference(aperture):
    cam = make_camera(
        np.array([2.8, 2.75, 13.18], np.float32), np.array([2.8, 2.75, 12.18], np.float32),
        40.0, focal_dist=9.5, aperture=aperture,
    )
    w, h = 48, 32
    uni = np.random.default_rng(1).random((w * h, 25), dtype=np.float32)
    oj, dj = j_camera.generate_rays(cam, w, h, jnp.asarray(uni))
    ot, dt = t_camera.generate_rays(cam, w, h, torch.from_numpy(uni))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL, atol=ATOL)
    if aperture > 0:
        assert np.ptp(ot.numpy(), axis=0).max() > 0.01  # origins spread on the lens
