"""The benchmark's plain specular reference (cellbench/reference/specular.py)
against the port, and on its own.

- The reference's Fresnel term and refraction against closed forms: the
  reflectance ((eta - 1) / (eta + 1))^2 at normal incidence (0.04 at
  1.5) from either side, total internal reflection beyond the critical
  angle from inside, Snell's law and the refracted direction's plane,
  and the reflectance seen from both sides of one interface alike,
  R(theta_i, eta) = R(theta_t, 1 / eta).
- The same lobes against the port's `integrator.continuation` on seeded
  random directions, normals, iors in [1.2, 2.0] and lobe uniforms:
  direction, origin, pdf and the delta flag within float32 rounding.
- The benchmark's frozen scene (cellbench/scenes/cornell_specular.py):
  7,948 triangles, the port's built-in box without its inner boxes bit for
  bit, unit radial vertex normals on both spheres, both spheres inside the
  box, the families (lambert, mirror, glass) and `auto_accel` -> bvh2.
- End to end: the reference's accumulation of a few samples at seeded
  pixels is what the port renders on the CPU through the benchmark's
  program adapter, at 32x32 and 8 bounces, within the limits of the
  benchmark's specular configuration, on seeded random albedos and iors
  of the two spheres and on a mirror-only and a glass-only variant.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from caitlynrenderer_tpu_torch.io.builtin_scenes import cornell_box
from caitlynrenderer_tpu_torch.render import integrator
from caitlynrenderer_tpu_torch.scene import auto_accel, scene_families

from cellbench import check, manifest, seeds
from cellbench.program import Renderer, scene_arrays
from cellbench.reference import specular, sampler
from cellbench.scenes import builtin, cornell_specular

N = 4096
SPEC = {"generator": "cornell_specular"}


def _cos_eta(cos_i, eta):
    return (torch.tensor(cos_i, dtype=torch.float32).reshape(-1),
            torch.tensor(eta, dtype=torch.float32).reshape(-1))


def _closed_form_normal_incidence():
    for ior in (1.2, 1.5, 2.0):
        want = ((ior - 1.0) / (ior + 1.0)) ** 2
        for eta in (1.0 / ior, ior):  # entering and leaving
            f, cos_t, tir = specular.fresnel_dielectric(*_cos_eta(1.0, eta))
            assert not bool(tir) and abs(float(cos_t) - 1.0) < 1e-6
            assert abs(float(f) - want) < 1e-6, (ior, eta)
    f, _, _ = specular.fresnel_dielectric(*_cos_eta(1.0, 1.0 / 1.5))
    assert abs(float(f) - 0.04) < 1e-6


def _closed_form_total_internal_reflection():
    ior = torch.linspace(1.2, 2.0, 9)
    critical = torch.sqrt(1.0 - 1.0 / (ior * ior))  # cos of the critical angle, from inside
    beyond = critical * 0.999
    f, _, tir = specular.fresnel_dielectric(beyond, ior)
    assert bool(tir.all()) and bool((f == 1.0).all())
    within = critical * 1.001
    f, _, tir = specular.fresnel_dielectric(within, ior)
    assert not bool(tir.any()) and bool((f < 1.0).all())
    # From outside no angle reflects totally.
    _, _, tir = specular.fresnel_dielectric(torch.full((9,), 1e-3), 1.0 / ior)
    assert not bool(tir.any())


def _unit(g, n):
    return torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)


def _closed_form_snell():
    g = torch.Generator().manual_seed(5)
    nrm, d = _unit(g, N), _unit(g, N)
    d = torch.where(((d * nrm).sum(1) > 0)[:, None], -d, d)  # n on the incident side
    ior = 1.2 + 0.8 * torch.rand(N, generator=g)
    eta = torch.where(torch.arange(N) % 2 == 0, 1.0 / ior, ior)
    cos_i = torch.abs((d * nrm).sum(1))
    f, cos_t, tir = specular.fresnel_dielectric(cos_i, eta)
    t = specular.refract(d, nrm, eta, cos_i, cos_t)
    ok = ~tir
    assert int(ok.sum()) > N // 2 and int(tir.sum()) > 0
    sin_i = torch.sqrt(1.0 - cos_i * cos_i)
    sin_t = torch.linalg.norm(torch.cross(t, -nrm, dim=1), dim=1)
    np.testing.assert_allclose(sin_t[ok].numpy(), (eta * sin_i)[ok].numpy(), atol=2e-5)
    np.testing.assert_allclose(torch.linalg.norm(t, dim=1).numpy(), 1.0, atol=1e-6)
    # Through the surface, in the plane of d and n.
    assert bool(((t * nrm).sum(1)[ok] < 0).all())
    plane = torch.cross(d, nrm, dim=1)
    assert float((t * plane).sum(1)[ok].abs().max()) < 1e-5
    np.testing.assert_allclose((-(t * nrm).sum(1))[ok].numpy(), cos_t[ok].numpy(), atol=2e-5)


def _closed_form_reciprocity():
    # In float64: near the critical angle the term is too steep for a
    # float32 cos_t to carry it back.
    g = torch.Generator().manual_seed(6)
    ior = 1.2 + 0.8 * torch.rand(N, generator=g, dtype=torch.float64)
    cos_i = torch.rand(N, generator=g, dtype=torch.float64) * 0.999 + 1e-3
    f_out, cos_t, tir = specular.fresnel_dielectric(cos_i, 1.0 / ior)
    assert not bool(tir.any())
    f_in, back, tir_in = specular.fresnel_dielectric(cos_t, ior)
    assert not bool(tir_in.any())
    np.testing.assert_allclose(back.numpy(), cos_i.numpy(), atol=1e-9)
    np.testing.assert_allclose(f_in.numpy(), f_out.numpy(), atol=1e-9)


CLOSED_FORMS = {"normal_incidence": _closed_form_normal_incidence,
                "total_internal_reflection": _closed_form_total_internal_reflection,
                "snell": _closed_form_snell,
                "reciprocity": _closed_form_reciprocity}


@pytest.mark.parametrize("case", list(CLOSED_FORMS))
def test_reference_fresnel_and_refraction_closed_forms(case):
    CLOSED_FORMS[case]()


@pytest.mark.parametrize("material", ["mirror", "glass"])
def test_reference_lobes_equal_the_ports_continuation(material):
    """The port's `continuation` on a HitFrame and Surface of seeded random
    shading normals (half the rays arriving from inside), iors in
    [1.2, 2.0] and lobe uniforms, every lane of one material, against the
    reference's `reflect` and `glass_lobe`."""
    g = torch.Generator().manual_seed(11 if material == "mirror" else 12)
    n_shade, d = _unit(g, N), _unit(g, N)
    cos_incident = (d * n_shade).sum(1)
    n_flip = torch.where((cos_incident > 0)[:, None], -n_shade, n_shade)
    point = torch.randn((N, 3), generator=g)
    ior = 1.2 + 0.8 * torch.rand(N, generator=g)
    u = torch.rand((N, 3), generator=g)
    albedo = torch.rand((N, 3), generator=g)
    T = torch.rand((N, 3), generator=g)
    zeros = torch.zeros(N)
    hf = integrator.HitFrame(torch.zeros((N, 50)), torch.ones(N, dtype=torch.bool), zeros,
                             zeros, zeros, cos_incident, n_flip, point)
    yes, no = torch.ones(N, dtype=torch.bool), torch.zeros(N, dtype=torch.bool)
    surf = integrator.Surface(albedo, ior, yes, None, yes if material == "mirror" else no,
                              yes if material == "glass" else None, None)
    got_d, got_T, got_pdf, got_spec, ok, got_o = integrator.continuation(
        hf, surf, d, T, u[:, 0], u[:, 1], u[:, 2])
    if material == "mirror":
        want_d, refracted = specular.reflect(d, n_flip), no
    else:
        want_d, refracted = specular.glass_lobe(d, n_flip, cos_incident, ior, u[:, 2])
        assert 0.05 < float(refracted.float().mean()) < 0.95
    want_o = point + torch.where(refracted[:, None], -2.0 * specular.RAY_OFFSET * n_flip, 0.0)
    np.testing.assert_allclose(got_d.numpy(), specular.normalize(want_d).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got_T, T * albedo) and bool(ok.all())
    assert bool((got_pdf == 1.0).all()) and bool(got_spec.all())
    # The delta direction leaves on the side the lobe says.
    side = (got_d * n_flip).sum(1)
    assert bool((side[~refracted] >= 0).all()) and bool((side[refracted] <= 0).all())


def test_frozen_scene():
    sc = builtin.make_scene(SPEC)
    arrays = scene_arrays(sc)
    assert arrays.num_triangles == 7948 and len(sc["vertices"]) == 36 + 2 * 1986
    # The box: the port's built-in box without its inner boxes, bit for bit.
    box = cornell_box(with_boxes=False)[0]
    k = cornell_specular.BOX_TRIANGLES
    assert box.num_triangles == k
    for name in ("vertices", "tri_v", "tri_vn", "tri_vt"):
        a, b = getattr(arrays, name)[: len(getattr(box, name))], getattr(box, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for a, b in zip(arrays.materials, box.materials):
        assert a[:4].tobytes() == b.tobytes()
    for a, b in zip(arrays.lights, box.lights):
        assert a.tobytes() == b.tobytes()
    mats = sc["materials"]
    assert mats["albedo"][4:].tolist() == [[0.9990000128746033] * 3 + [1.0],
                                           [0.9990000128746033] * 3 + [2.0]]
    assert mats["specular"][5, 3] == np.float32(1.5)
    # The spheres: radial unit normals, interpolated, inside the box, on its floor.
    for s, centre in enumerate((cornell_specular.MIRROR_CENTRE, cornell_specular.GLASS_CENTRE)):
        rows = slice(k + 3968 * s, k + 3968 * (s + 1))
        tv, tn = sc["tri_v"][rows], sc["tri_vn"][rows]
        assert (tv[:, 3] == 4 + s).all() and (tn[:, 3] == 1).all()
        v = sc["vertices"][tv[:, :3]].astype(np.float64)
        n = sc["normals"][tn[:, :3]].astype(np.float64)
        radial = v - np.asarray(centre)
        r = np.linalg.norm(radial, axis=-1)
        np.testing.assert_allclose(r, cornell_specular.RADIUS, rtol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(n, radial / r[..., None], atol=1e-6)
        assert v.min() >= -1e-6 and v.max() <= 5.56 and abs(v[..., 1].min()) < 1e-6
        # Wound outward.
        geo = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        assert (np.einsum("ij,ij->i", geo, v.mean(axis=1) - np.asarray(centre)) > 0).all()
    assert scene_families(arrays) == ("lambert", "mirror", "glass")
    assert auto_accel(arrays) == "bvh2"


def _variant(variant, seed):
    """The frozen scene, its spheres' albedos and iors drawn from `seed`;
    "mirror_only" and "glass_only" make both spheres one material."""
    sc = builtin.make_scene(SPEC)
    rng = np.random.default_rng(seed)
    mats = sc["materials"]
    mats["albedo"][4:, :3] = rng.uniform(0.5, 1.0, (2, 3))
    mats["specular"][4:, 3] = rng.uniform(1.2, 2.0, 2)
    if variant == "mirror_only":
        mats["albedo"][5, 3] = cornell_specular.MIRROR
    elif variant == "glass_only":
        mats["albedo"][4, 3] = cornell_specular.GLASS
    return sc


@pytest.mark.parametrize("variant,seed", [("both", 3), ("both", 2**31 + 5),
                                          ("mirror_only", 77_777), ("glass_only", 91)])
def test_reference_accumulates_what_the_port_renders(variant, seed):
    bench = manifest.load()
    cfg = dict(manifest.config(bench, "cornell_specular700"), width=32, height=32)
    assert cfg["max_depth"] == 8
    sc = _variant(variant, seed)
    cam = builtin.make_camera(**cfg["camera"])
    spp = 2
    r = Renderer(cfg, sc, cam, "cpu")
    families = {"both": ("lambert", "mirror", "glass"), "mirror_only": ("lambert", "mirror"),
                "glass_only": ("lambert", "glass")}[variant]
    assert r.accel == "bvh2" and r.options.families == families
    r.upload()
    image_seed = seeds.image_seed(seed, 0)
    r.new_image(image_seed)
    r.launch(spp)
    pixels = seeds.check_pixels(seed, 32 * 32, 256)
    got = r.accum_rows(pixels)
    ref = specular.load_scene(sc, "cpu")
    ids = torch.as_tensor(pixels, dtype=torch.int64)
    want = specular.accumulate(ref, cam, 32, 32, 8, sampler.base_key(image_seed), spp,
                               ids).numpy()
    assert want.sum() > 0
    limits = cfg["check"]["limits"]
    assert check.rel_l1(got, want) <= limits["accum_rel_l1"]
    assert check.worst_pixel(got, want) <= limits["accum_worst_pixel"]
    shown = specular.display(torch.as_tensor(got), spp).numpy()
    assert check.rel_l1(shown, specular.display(torch.as_tensor(want), spp).numpy()) <= limits[
        "image_rel_l1"]
    assert math.isfinite(float(got.sum()))
