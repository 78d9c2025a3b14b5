"""The port's Disney BSDF (ops/bsdf.py) ≡ the reference's on seeded inputs.

4,096 random (n, v, l, parameters) rows, parameters across their ranges
with the corners roughness 0.02 (the clamp's floor), metallic 0 / 1,
clearcoat 0 / 1 and a black base color on their own rows.  Tolerance rtol
1e-5, atol 1e-6: the same float32 expressions in the same order, but XLA
on the CPU contracts multiply-adds and the port does not, and the two
libraries' sqrt / pow / log / sin / cos may differ in the last ulp.
`valid` (f and pdf nonzero: l above the surface) must be equal on every
row.

`sample`'s f and pdf are evaluated at its own sampled direction, which
lands near the lobes' peaks, where the GGX and GTR1 terms are ill-
conditioned: t = 1 + (a² - 1)(n·h)² cancels to ~a², so a 1-ulp difference
in n·h (from a contracted multiply-add in the half vector, or in the
sampled l itself) moves D by up to tens of percent (seen: 0.4 relative at
roughness 0.02).  So there l is held to rtol 1e-5 on every row, and f and
pdf on all rows but at most 0.5 %, each of those with n·h > 0.9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from caitlynrenderer_tpu.core.types import Materials, MaterialType
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box
from caitlynrenderer_tpu.ops import bsdf as j_bsdf
from caitlynrenderer_tpu_torch.core import math as cm
from caitlynrenderer_tpu_torch.ops import bsdf as t_bsdf
from caitlynrenderer_tpu_torch.scene import upload_scene as t_upload

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng, n):
    x = rng.standard_normal((n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _rows(seed):
    """(n, v, l, params as numpy, lobe and direction uniforms)."""
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    # v in n's hemisphere (the integrator flips n toward the viewer); l
    # anywhere, so that half of the rows lie under the surface.
    v = _unit(rng, N)
    v = np.where((v * n).sum(1, keepdims=True) < 0, -v, v)
    l = _unit(rng, N)
    p = {
        "base_color": rng.random((N, 3), dtype=np.float32),
        "roughness": np.clip(rng.random(N, dtype=np.float32), 0.02, 1.0),
        "metallic": rng.random(N, dtype=np.float32),
        "spec_tint": rng.random(N, dtype=np.float32),
        "sheen": rng.random(N, dtype=np.float32),
        "clearcoat": rng.random(N, dtype=np.float32),
        "clearcoat_gloss": rng.random(N, dtype=np.float32),
        "subsurface": rng.random(N, dtype=np.float32),
        "ior": rng.uniform(1.01, 2.5, N).astype(np.float32),
    }
    corner = np.arange(N) % 8
    p["roughness"][corner == 1] = 0.02
    p["metallic"][corner == 2] = 0.0
    p["metallic"][corner == 3] = 1.0
    p["clearcoat"][corner == 4] = 0.0
    p["clearcoat"][corner == 5] = 1.0
    p["base_color"][corner == 6] = 0.0  # luminance 0: _tint's other branch
    u = rng.random((3, N), dtype=np.float32)
    return n, v, l, p, u


def _params(mod, p, conv):
    return mod.DisneyParams(**{k: conv(x) for k, x in p.items()})


def _both(seed):
    n, v, l, p, u = _rows(seed)
    j = (jnp.asarray(n), jnp.asarray(v), jnp.asarray(l), _params(j_bsdf, p, jnp.asarray),
         [jnp.asarray(x) for x in u])
    t = (torch.from_numpy(n), torch.from_numpy(v), torch.from_numpy(l),
         _params(t_bsdf, p, torch.from_numpy), [torch.from_numpy(x) for x in u])
    return j, t


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_pdf_matches_reference(seed):
    (jn, jv, jl, jp, _), (tn, tv, tl, tp, _) = _both(seed)
    fj, pj = (np.asarray(x) for x in j_bsdf.eval_pdf(jp, jn, jv, jl))
    ft, pt = (x.numpy() for x in t_bsdf.eval_pdf(tp, tn, tv, tl))
    np.testing.assert_array_equal(pt > 0, pj > 0)
    assert 0.4 < (pt > 0).mean() < 0.6
    np.testing.assert_allclose(ft, fj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt, pj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_matches_reference(seed):
    (jn, jv, _, jp, ju), (tn, tv, _, tp, tu) = _both(seed)
    lj, fj, pj = (np.asarray(x) for x in j_bsdf.sample(jp, jn, jv, *ju))
    lt, ft, pt = (x.numpy() for x in t_bsdf.sample(tp, tn, tv, *tu))
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pt > 0, pj > 0)
    off = ((np.abs(ft - fj) > ATOL + RTOL * np.abs(fj)).any(axis=1)
           | (np.abs(pt - pj) > ATOL + RTOL * np.abs(pj)))
    ndh = cm.dot(tn, cm.normalize(tv + torch.from_numpy(lt))).numpy()
    assert off.mean() <= 0.005, off.sum()
    assert (ndh[off] > 0.9).all(), ndh[off]
    # Every lobe was sampled: the clearcoat corner rows pick clearcoat.
    w_diff, w_spec, _ = (x.numpy() for x in t_bsdf._lobe_weights(tp))
    u_lobe = tu[0].numpy()
    picks = np.select([u_lobe < w_diff, u_lobe < w_diff + w_spec], [0, 1], 2)
    assert np.bincount(picks, minlength=3).min() > 100


def test_params_from_rows_and_materials_match_reference():
    """The fused table's columns 37-44 and the Materials rows give the
    reference's parameters (roughness clamped to [0.02, 1], ior floored at
    1.01), exactly."""
    rng = np.random.default_rng(3)
    scene, _ = cornell_box(floor_type=int(MaterialType.DISNEY))
    m = scene.materials
    k = m.albedo.shape[0]
    mats = m._replace(specular=rng.uniform(0.5, 2.0, (k, 4)).astype(np.float32),
                      disney=rng.uniform(-0.2, 1.2, (k, 4)).astype(np.float32),
                      disney2=rng.random((k, 4)).astype(np.float32))
    ds = t_upload(scene._replace(materials=mats), "brute", "cpu")
    mtl = scene.tri_v[:, 3]
    base = rng.random((mtl.shape[0], 3)).astype(np.float32)
    want = j_bsdf.params_from_materials(Materials(*map(jnp.asarray, mats)), jnp.asarray(mtl),
                                        jnp.asarray(base))
    got_m = t_bsdf.params_from_materials(ds.scene.materials, torch.from_numpy(mtl).long(),
                                         torch.from_numpy(base))
    got_r = t_bsdf.params_from_rows(ds.shade_tab, torch.from_numpy(base))
    for name in t_bsdf.DisneyParams._fields:
        for got in (got_m, got_r):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), name)
