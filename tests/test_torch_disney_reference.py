"""The benchmark's plain Disney reference (cellbench/reference/disney.py)
against the port, and on its own.

- The BRDF: on seeded random Disney parameters (every lobe nonzero on
  some rows, the corners on others) and random n, v, l, the reference's
  eval, pdf and sample equal ops/bsdf.py's within float32 rounding.
- The reference alone: its BRDF without the cosine is reciprocal in
  (v, l), and its mixture pdf, integrated over the hemisphere by seeded
  quasi-Monte Carlo, equals the share of its own samples that leave above
  the surface (1 where no lobe reflects under the horizon).
- The benchmark's frozen Disney-floor box (cellbench/scenes/cornell_disney.py)
  is the port's built-in box with a Disney floor, bit for bit.
- End to end: on the Cornell box with seeded random Disney parameters on
  every material but the light, at 32x32 and 4 bounces, the reference's
  accumulation of a few samples at seeded pixels is what the port renders
  on the CPU, within the limits of the benchmark's Disney configuration.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from caitlynrenderer_tpu_torch.core.types import MaterialType
from caitlynrenderer_tpu_torch.io.builtin_scenes import cornell_box
from caitlynrenderer_tpu_torch.ops import bsdf as t_bsdf

from cellbench import check, manifest, seeds
from cellbench.program import Renderer, scene_arrays
from cellbench.reference import disney, sampler
from cellbench.scenes import builtin

N = 4096
RTOL, ATOL = 1e-5, 1e-6
CASES = ("random", "every_lobe", "corners")


def _unit(g, n):
    return torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)


def _params(case, seed, n=N):
    """(reference Params, port DisneyParams) of n rows: uniform over the
    parameters' ranges; with every lobe's weight and term nonzero (metallic
    below 1, sheen, clearcoat and subsurface above 0.2); or the corners
    (roughness at its floor, metallic 0 or 1, clearcoat 0 or 1, black base)
    on alternate rows."""
    g = torch.Generator().manual_seed(seed)

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    base = torch.rand((n, 3), generator=g)
    q = dict(roughness=u(0.02, 1.0), metallic=u(), spec_tint=u(), sheen=u(), clearcoat=u(),
             clearcoat_gloss=u(), subsurface=u(), ior=u(1.01, 2.5))
    if case == "every_lobe":
        q.update(metallic=u(0.0, 0.8), sheen=u(0.2, 1.0), clearcoat=u(0.2, 1.0),
                 subsurface=u(0.2, 1.0))
    elif case == "corners":
        odd = torch.arange(n) % 2 == 1
        q["roughness"] = torch.where(odd, 0.02, q["roughness"])
        q["metallic"] = torch.where(odd, (torch.arange(n) % 4 == 1).float(), q["metallic"])
        q["clearcoat"] = torch.where(odd, (torch.arange(n) % 8 < 4).float(), q["clearcoat"])
        base = torch.where((torch.arange(n) % 6 == 5)[:, None], 0.0, base)
    ref = disney.Params(base, *(q[k] for k in ("roughness", "metallic", "spec_tint", "sheen",
                                                "clearcoat", "clearcoat_gloss", "subsurface",
                                                "ior")))
    port = t_bsdf.DisneyParams(base, **q)
    return ref, port


def _frame(seed, n=N):
    """n, v on n's side, l anywhere (half the rows under the surface)."""
    g = torch.Generator().manual_seed(seed + 100)
    nrm, v, l = _unit(g, n), _unit(g, n), _unit(g, n)
    v = torch.where(((v * nrm).sum(1) < 0)[:, None], -v, v)
    return nrm, v, l, torch.rand((n, 3), generator=g)


@pytest.mark.parametrize("what", ["eval_pdf", "sample"])
@pytest.mark.parametrize("case", CASES)
def test_reference_bsdf_equals_the_ports(case, what):
    ref_p, port_p = _params(case, CASES.index(case))
    nrm, v, l, u = _frame(CASES.index(case))
    if what == "eval_pdf":
        got, want = disney.eval_pdf(ref_p, nrm, v, l), t_bsdf.eval_pdf(port_p, nrm, v, l)
        assert torch.equal(got[1] > 0, want[1] > 0)
        assert 0.3 < float((got[1] > 0).float().mean()) < 0.7
    else:
        got = disney.sample(ref_p, nrm, v, u[:, 0], u[:, 1], u[:, 2])
        want = t_bsdf.sample(port_p, nrm, v, u[:, 0], u[:, 1], u[:, 2])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    if case == "every_lobe":
        w_d, w_s, w_c = disney.lobe_weights(ref_p)
        assert bool((w_d > 0).all() and (w_s > 0).all() and (w_c > 0).all())


@pytest.mark.parametrize("case", CASES)
def test_reference_brdf_is_reciprocal(case):
    """f(v, l) / cos(theta_l) = f(l, v) / cos(theta_v) wherever both lie
    above the surface."""
    ref_p, _ = _params(case, 10 + CASES.index(case))
    nrm, v, l, _ = _frame(10 + CASES.index(case))
    l = torch.where(((l * nrm).sum(1) < 0)[:, None], -l, l)
    keep = ((v * nrm).sum(1) > 1e-3) & ((l * nrm).sum(1) > 1e-3)
    f_vl, _ = disney.eval_pdf(ref_p, nrm, v, l)
    f_lv, _ = disney.eval_pdf(ref_p, nrm, l, v)
    brdf_vl = f_vl / (l * nrm).sum(1, keepdim=True)
    brdf_lv = f_lv / (v * nrm).sum(1, keepdim=True)
    assert int(keep.sum()) > N // 2
    np.testing.assert_allclose(brdf_vl[keep].numpy(), brdf_lv[keep].numpy(), rtol=2e-4, atol=1e-6)


# (roughness, metallic, clearcoat, clearcoat_gloss, view angle from n in degrees)
LOBES = {"normal_incidence": (0.3, 0.0, 0.0, 0.0, 0.0),
         "glossy_oblique": (0.4, 0.5, 0.0, 0.0, 50.0),
         "metal_clearcoat": (0.5, 1.0, 1.0, 0.2, 30.0),
         "rough_everything": (1.0, 0.3, 0.6, 0.0, 20.0)}


@pytest.mark.parametrize("lobe", list(LOBES))
def test_reference_pdf_integrates_to_its_samples_above_the_surface(lobe):
    """The mixture pdf over the hemisphere (scrambled Sobol directions,
    uniform in solid angle) equals the share of `sample`'s directions that
    leave above the surface, within 2 %; at normal incidence on a surface
    whose specular lobe keeps above the horizon both are 1 within 2 %."""
    rough, metal, coat, gloss, angle = LOBES[lobe]
    m = 1 << 18
    one = torch.ones(m)
    p = disney.Params(torch.full((m, 3), 0.6), rough * one, metal * one, 0.3 * one, 0.5 * one,
                      coat * one, gloss * one, 0.4 * one, 1.5 * one)
    nrm = torch.tensor([0.0, 0.0, 1.0]).expand(m, 3)
    a = math.radians(angle)
    v = torch.tensor([math.sin(a), 0.0, math.cos(a)]).expand(m, 3)
    q = torch.quasirandom.SobolEngine(2, scramble=True, seed=7).draw(m)
    z = q[:, 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * q[:, 1]
    l = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=1)
    _, pdf = disney.eval_pdf(p, nrm, v, l)
    integral = float(pdf.double().mean()) * 2.0 * math.pi
    u = torch.quasirandom.SobolEngine(3, scramble=True, seed=8).draw(m)
    drawn, _, _ = disney.sample(p, nrm, v, u[:, 0], u[:, 1], u[:, 2])
    above = float((drawn[:, 2] > 1e-6).double().mean())
    assert abs(integral - above) < 0.02, (integral, above)
    if lobe == "normal_incidence":
        assert abs(integral - 1.0) < 0.02 and above > 0.98


def test_frozen_disney_box_equals_the_ports():
    """Every array of the frozen scene, dtype, shape and bytes."""
    got = scene_arrays(builtin.make_scene({"generator": "cornell_disney"}))
    want = cornell_box(floor_type=int(MaterialType.DISNEY))[0]
    for name in ("vertices", "normals", "texcoords", "tri_v", "tri_vn", "tri_vt"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    for group in ("materials", "lights"):
        for a, b in zip(getattr(got, group), getattr(want, group)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert want.textures is None and want.env_map is None


def _random_disney_box(seed):
    """The benchmark's Cornell box with every material but the light's made
    a Disney material of seeded random parameters."""
    sc = builtin.cornell_box()
    rng = np.random.default_rng(seed)
    mats = sc["materials"]
    lit = mats["emission"][:, 3] != -1
    k = int((~lit).sum())
    mats["albedo"][~lit, 3] = 17
    mats["albedo"][~lit, :3] = rng.uniform(0.05, 0.95, (k, 3))
    mats["disney"][~lit] = np.stack([rng.uniform(0.02, 1.0, k), rng.uniform(0, 1, k),
                                     rng.uniform(0, 1, k), rng.uniform(0, 1, k)], 1)
    mats["disney2"][~lit, :3] = rng.uniform(0, 1, (k, 3))
    mats["specular"][~lit, 3] = rng.uniform(1.05, 2.5, k)
    return sc


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 77_777])
def test_reference_accumulates_what_the_port_renders(seed):
    bench = manifest.load()
    cfg = dict(manifest.config(bench, "cornell_disney700"), width=32, height=32, max_depth=4)
    sc = _random_disney_box(seed)
    cam = builtin.make_camera(**cfg["camera"])
    spp = 3
    r = Renderer(cfg, sc, cam, "cpu")
    assert r.accel == "brute" and r.options.families == ("lambert", "disney")
    r.upload()
    image_seed = seeds.image_seed(seed, 0)
    r.new_image(image_seed)
    r.launch(spp)
    pixels = seeds.check_pixels(seed, 32 * 32, 256)
    got = r.accum_rows(pixels)
    ref = disney.load_scene(sc, "cpu")
    ids = torch.as_tensor(pixels, dtype=torch.int64)
    want = disney.accumulate(ref, cam, 32, 32, 4, sampler.base_key(image_seed), spp, ids).numpy()
    assert want.sum() > 0
    limits = cfg["check"]["limits"]
    assert check.rel_l1(got, want) <= limits["accum_rel_l1"]
    assert check.worst_pixel(got, want) <= limits["accum_worst_pixel"]
    shown = disney.display(torch.as_tensor(got), spp).numpy()
    assert check.rel_l1(shown, disney.display(torch.as_tensor(want), spp).numpy()) <= limits[
        "image_rel_l1"]
