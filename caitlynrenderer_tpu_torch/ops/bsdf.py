"""Disney-family BSDF on tensors: eval / sample / pdf (counterpart of
caitlynrenderer_tpu/ops/bsdf.py).

The Burley 2012 Disney BRDF (principled diffuse with retro-reflection and
a subsurface blend, sheen, GGX specular in the metallic workflow, GTR1
clearcoat) with a sample / eval / pdf triple, so that MIS stays
consistent.  Term for term the reference's expressions in the reference's
order; integer powers are written as the products XLA evaluates them as.

Conventions: n is the shading normal flipped toward the viewer, v points
away from the surface toward the viewer (v = -ray.d), l away from it
toward the light.  Every function is batched over rays.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from caitlynrenderer_tpu_torch.core import math as cm


class DisneyParams(NamedTuple):
    base_color: torch.Tensor  # (N, 3)
    roughness: torch.Tensor  # (N,)
    metallic: torch.Tensor
    spec_tint: torch.Tensor
    sheen: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    subsurface: torch.Tensor
    ior: torch.Tensor


def params_from_materials(mats, mtl, base_color):
    """Per-ray parameters gathered from the Materials rows `mtl`; the base
    color is passed separately (it may be texture-modulated)."""
    d1 = mats.disney[mtl]
    d2 = mats.disney2[mtl]
    return DisneyParams(
        base_color=base_color,
        roughness=torch.clamp(d1[:, 0], 0.02, 1.0),
        metallic=d1[:, 1],
        spec_tint=d1[:, 2],
        sheen=d1[:, 3],
        clearcoat=d2[:, 0],
        clearcoat_gloss=d2[:, 1],
        subsurface=d2[:, 2],
        ior=torch.clamp(mats.specular[mtl, 3], min=1.01),
    )


def params_from_rows(rows, base_color):
    """Per-ray parameters from fused shading-table rows (scene.py's column
    map: 37 ior, 38:42 disney, 42:46 disney2), as the reference
    integrator's fused path reads them."""
    return DisneyParams(
        base_color=base_color,
        roughness=torch.clamp(rows[:, 38], 0.02, 1.0),
        metallic=rows[:, 39],
        spec_tint=rows[:, 40],
        sheen=rows[:, 41],
        clearcoat=rows[:, 42],
        clearcoat_gloss=rows[:, 43],
        subsurface=rows[:, 44],
        ior=torch.clamp(rows[:, 37], min=1.01),
    )


def _schlick(m):
    m = torch.clamp(1.0 - m, 0.0, 1.0)
    m2 = m * m
    return m * (m2 * m2)  # m**5 as XLA's integer power evaluates it


def _gtr2(ndh, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return a2 / torch.clamp(math.pi * t * t, min=1e-12)


def _gtr1(ndh, a):
    a2 = torch.clamp(a * a, 1e-4, 0.9999)
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    # log(a2) < 0 and t > 0: the denominator is strictly negative, so the
    # guard keeps it on the negative side.
    return (a2 - 1.0) / torch.clamp(math.pi * torch.log(a2) * t, max=-1e-12)


def _smith_g_ggx(ndv, a):
    a2 = a * a
    b = ndv * ndv
    return 1.0 / torch.clamp(ndv + torch.sqrt(a2 + b - a2 * b), min=1e-8)


def _tint(base_color):
    lum = cm.luminance(base_color)
    return torch.where((lum > 0)[:, None], base_color / torch.clamp(lum[:, None], min=1e-8),
                       torch.ones_like(base_color))


def _spec_f0(p: DisneyParams):
    q = (p.ior - 1.0) / (p.ior + 1.0)
    f0_scalar = q * q
    tint = _tint(p.base_color)
    dielectric = f0_scalar[:, None] * ((1.0 - p.spec_tint[:, None]) + p.spec_tint[:, None] * tint)
    return dielectric * (1.0 - p.metallic[:, None]) + p.base_color * p.metallic[:, None]


def _lobe_weights(p: DisneyParams):
    """Sampling weights of the (diffuse, specular, clearcoat) lobes."""
    w_diff = (1.0 - p.metallic) * cm.luminance(p.base_color)
    w_spec = cm.luminance(_spec_f0(p)) + 0.08
    w_cc = 0.25 * p.clearcoat
    total = torch.clamp(w_diff + w_spec + w_cc, min=1e-8)
    return w_diff / total, w_spec / total, w_cc / total


def eval_pdf(p: DisneyParams, n, v, l):
    """The full Disney BRDF and its sampling pdf: (f (N, 3), pdf (N,)), both
    0 where l is under the surface.  f is pre-multiplied by cos(theta_l):
    the integrator uses it directly in L += T Le f w / pdf_light and
    T *= f / pdf."""
    ndv = torch.clamp(cm.dot(n, v), min=1e-6)
    ndl = cm.dot(n, l)
    valid = ndl > 1e-6
    ndl_c = torch.clamp(ndl, min=1e-6)
    h = cm.normalize(v + l)
    ndh = torch.clamp(cm.dot(n, h), 0.0, 1.0)
    ldh = torch.clamp(cm.dot(l, h), 0.0, 1.0)

    a = torch.clamp(p.roughness * p.roughness, min=1e-4)

    # Diffuse (Burley retro-reflection) and the subsurface approximation.
    fl = _schlick(ndl_c)
    fv = _schlick(ndv)
    fd90 = 0.5 + 2.0 * ldh * ldh * p.roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldh * ldh * p.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(ndl_c + ndv, min=1e-6) - 0.5) + 0.5)
    diff_mix = fd * (1.0 - p.subsurface) + ss * p.subsurface
    f_diffuse = p.base_color / math.pi * diff_mix[:, None]

    # Sheen.
    f_sheen = (p.sheen[:, None]
               * ((1.0 - p.spec_tint[:, None]) + p.spec_tint[:, None] * _tint(p.base_color))
               * _schlick(ldh)[:, None])

    # GGX specular, metallic workflow; the 0.25 folds 1 / (4 ndl ndv) into
    # the separable Smith terms.
    d_spec = _gtr2(ndh, a)
    f0 = _spec_f0(p)
    f_spec_fresnel = f0 + (1.0 - f0) * _schlick(ldh)[:, None]
    g_spec = _smith_g_ggx(ndl_c, a) * _smith_g_ggx(ndv, a)
    f_specular = d_spec[:, None] * f_spec_fresnel * g_spec[:, None] * 0.25

    # Clearcoat: GTR1, F0 = 0.04, G with alpha 0.25.
    a_cc = 0.1 + (0.001 - 0.1) * p.clearcoat_gloss  # lerp(0.1, 0.001, gloss)
    d_cc = _gtr1(ndh, a_cc)
    f_cc = 0.04 + 0.96 * _schlick(ldh)
    g_cc = _smith_g_ggx(ndl_c, 0.25) * _smith_g_ggx(ndv, 0.25)
    f_clearcoat = (0.25 * p.clearcoat * d_cc * f_cc * g_cc)[:, None] * 0.25

    f = ((f_diffuse + f_sheen) * (1.0 - p.metallic[:, None]) + f_specular
         + f_clearcoat) * ndl_c[:, None]

    # The pdf: the lobe mixture.
    w_diff, w_spec, w_cc = _lobe_weights(p)
    pdf_diff = ndl_c / math.pi
    pdf_spec = d_spec * ndh / torch.clamp(4.0 * ldh, min=1e-8)
    pdf_cc = d_cc * ndh / torch.clamp(4.0 * ldh, min=1e-8)
    pdf = w_diff * pdf_diff + w_spec * pdf_spec + w_cc * pdf_cc

    return torch.where(valid[:, None], f, 0.0), torch.where(valid, pdf, 0.0)


def _sample_ggx_h(n, a, u1, u2):
    """A GTR2 (GGX) half-vector about n, sampled from the NDF."""
    phi = 2.0 * math.pi * u1
    ct2 = (1.0 - u2) / torch.clamp(1.0 + (a * a - 1.0) * u2, min=1e-12)
    # Strictly inside (0, 1): sqrt's derivative is infinite at 0, and a
    # gradient through an unselected lobe would turn 0 * inf into NaN.  The
    # 1e-12 shift is far below the sampling resolution.
    ct = torch.sqrt(torch.clamp(ct2, 1e-12, 1.0 - 1e-12))
    st = torch.sqrt(torch.clamp(1.0 - ct2, 1e-12, 1.0 - 1e-12))
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    return cm.local_to_world(local, n)


def _sample_gtr1_h(n, a, u1, u2):
    """A GTR1 (clearcoat) half-vector about n."""
    a2 = torch.clamp(a * a, 1e-4, 0.9999)
    phi = 2.0 * math.pi * u1
    ct2 = (1.0 - torch.pow(a2, 1.0 - u2)) / torch.clamp(1.0 - a2, min=1e-8)
    ct = torch.sqrt(torch.clamp(ct2, 1e-12, 1.0 - 1e-12))
    st = torch.sqrt(torch.clamp(1.0 - ct2, 1e-12, 1.0 - 1e-12))
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    return cm.local_to_world(local, n)


def sample(p: DisneyParams, n, v, u_lobe, u1, u2):
    """An outgoing direction sampled from the lobe mixture, u_lobe picking
    the lobe and (u1, u2) the direction within it.  Returns (l, f, pdf):
    f (cos-premultiplied) and the mixture pdf come from `eval_pdf`, so the
    MIS weights are consistent by construction."""
    w_diff, w_spec, w_cc = _lobe_weights(p)
    a = torch.clamp(p.roughness * p.roughness, min=1e-4)
    a_cc = 0.1 + (0.001 - 0.1) * p.clearcoat_gloss

    l_diff = cm.local_to_world(cm.cosine_hemisphere_dir(u1, u2), n)
    l_spec = cm.reflect(-v, _sample_ggx_h(n, a, u1, u2))
    l_cc = cm.reflect(-v, _sample_gtr1_h(n, a_cc, u1, u2))

    pick_spec = (u_lobe >= w_diff) & (u_lobe < w_diff + w_spec)
    pick_cc = u_lobe >= (w_diff + w_spec)
    l = torch.where(pick_cc[:, None], l_cc, torch.where(pick_spec[:, None], l_spec, l_diff))
    l = cm.normalize(l)
    f, pdf = eval_pdf(p, n, v, l)
    return l, f, pdf
