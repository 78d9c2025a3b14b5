"""The benchmark's plain reference of sky-lit scenes
(cellbench/reference/weekend.py) against the port, on a small cut of the
final scene of "Ray Tracing in One Weekend" (cellbench/scenes/weekend_final.py).

The cut: 48x32 pixels, depth 6, the configuration's camera and generator
seed, 12 of the generator's spheres (the three large ones, and the small
Lambert, metal and glass spheres nearest the origin) tessellated at 16 x
8, the ground at 4 x 4 quads under a 16 x 16 checker layer, and a 32 x 64
sky.  The port renders through its progressive loop on the CPU
(`render_sample` -> `trace_paths`, traversal "xla"); the reference
accumulates the same samples of every pixel.

- End to end, a case for each mechanism, so that a failure points at it:
  the whole cut (thin lens, texture, sky, the four families), the lens
  off, the texture off, and the sky alone (the ground alone, one bounce:
  a camera ray's radiance is the sky where it misses and 0 where it hits).
- Where the reference shares the program's order (the camera rays, thin
  lens included) the two are equal bit for bit; the atlas and sky lookups,
  written apart from the port's, agree within float32 rounding.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from caitlynrenderer_tpu_torch.core.camera import generate_rays_for_ids
from caitlynrenderer_tpu_torch.ops.texture import sample_bilinear, sample_env
from caitlynrenderer_tpu_torch.render import progressive, sampling

from cellbench import check, manifest, seeds
from cellbench.program import Renderer
from cellbench.reference import sampler, weekend
from cellbench.scenes import builtin, weekend_final

W, H, DEPTH, SPP = 48, 32, 6, 3
CONFIG = "weekend_final1200"
CASES = ("full", "lens_off", "texture_off", "sky_alone")


def _config():
    return manifest.config(manifest.load(), CONFIG)


def _picked(seed: int) -> list:
    """The three large spheres, then the 4 Lambert, 3 metal and 2 glass
    small spheres nearest the origin, as indices of the generator's list."""
    drawn = weekend_final.draw_spheres(np.random.default_rng(seed))
    out = list(range(len(drawn) - 3, len(drawn)))
    for kind, k in (("lambert", 4), ("metal", 3), ("glass", 2)):
        small = [i for i, s in enumerate(drawn) if s[2] == kind and s[1] < 1.0]
        out += sorted(small, key=lambda i: math.hypot(drawn[i][0][0], drawn[i][0][2]))[:k]
    return out


def _scene(case: str) -> dict:
    seed = _config()["scene"]["args"]["seed"]
    spheres = [] if case == "sky_alone" else _picked(seed)
    sc = weekend_final.make(seed, segments=16, bands=8, spheres=spheres, ground_quads=4,
                            checker=16, sky=32)
    if case in ("texture_off", "sky_alone"):
        sc["materials"]["tex_ind"][:, 0] = -1
        del sc["textures"]
    return sc


def _camera(case: str) -> dict:
    cam = dict(_config()["camera"])
    if case in ("lens_off", "sky_alone"):
        cam["aperture"] = 0.0
    return builtin.make_camera(**cam)


@pytest.mark.parametrize("case", CASES)
def test_reference_accumulates_what_the_port_renders(case):
    cfg = dict(_config(), width=W, height=H, max_depth=1 if case == "sky_alone" else DEPTH)
    sc, cam = _scene(case), _camera(case)
    r = Renderer(cfg, sc, cam, "cpu")
    assert r.options.use_env_map and r.options.families == (
        ("lambert",) if case == "sky_alone" else ("lambert", "disney", "mirror", "glass"))
    assert (r.scene.textures is None) == (case in ("texture_off", "sky_alone"))
    r.upload()
    options = r.options._replace(traversal="xla")
    seed = 2**31 + 17
    image_seed = seeds.image_seed(seed, 0)
    state = progressive.render_steps(r.ds, r.camera,
                                     progressive.init_state(W, H, image_seed, "cpu"), W, H,
                                     options, SPP)
    got = state.accum.numpy()
    ref = weekend.load_scene(sc, "cpu")
    ids = torch.arange(W * H, dtype=torch.int64)
    want = weekend.accumulate(ref, cam, W, H, cfg["max_depth"], sampler.base_key(image_seed),
                              SPP, ids).numpy()
    assert np.isfinite(got).all() and want.sum() > 0
    if case == "sky_alone":
        # The sky and nothing else: the two lookups differ by float32
        # rounding of their interpolation weights (a few ulps of ~1).
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
        assert (want.sum(1) == 0).any() and (want.sum(1) > 0).any()
        return
    # The cell's limits: the atlas and the sky are looked up by other
    # arithmetic (rounding of the radiance, never of a path's direction), and
    # a ray within rounding of an edge shared by two triangles may take the
    # other one in the reference's BVH; either stays far inside them.
    limits = cfg["check"]["limits"]
    assert check.rel_l1(got, want) <= limits["accum_rel_l1"]
    assert check.worst_pixel(got, want) <= limits["accum_worst_pixel"]
    shown = weekend.display(torch.as_tensor(got), SPP).numpy()
    assert check.rel_l1(shown, weekend.display(torch.as_tensor(want), SPP).numpy()) <= limits[
        "image_rel_l1"]
    # Most pixels meet the sky or the checker through rounding alone.
    assert check.rel_l1(got, want) < 1e-5


@pytest.mark.parametrize("lens", [True, False])
def test_camera_rays_are_the_ports_bit_for_bit(lens):
    """The reference's thin lens, written out in its own code in the
    program's order, gives the port's camera rays bit for bit."""
    cam = _camera("full" if lens else "lens_off")
    ids = torch.from_numpy(seeds.check_pixels(2**31 + 3, 1200 * 800, 4096)).to(torch.int64)
    uni = sampler.uniforms(sampler.base_key(7), torch.tensor([0, 11]), ids, 1)
    from cellbench.program import camera as program_camera

    for s in range(2):
        o, d = weekend.camera_rays(cam, 1200, 800, ids, uni[s, :, 0:4], torch.float32)
        po, pd = generate_rays_for_ids(program_camera(cam), 1200, 800, ids.to(torch.int32),
                                       uni[s])
        assert torch.equal(o, po) and torch.equal(d, pd)
        # On the lens, within the 0.1 aperture's radius of the camera's position.
        off = float(torch.linalg.norm(o - torch.from_numpy(cam["position"]), dim=1).max())
        assert (off > 0.04) is lens and off <= 0.05 + 1e-6


def test_lookups_agree_with_the_ports():
    """The reference's atlas and sky lookups, written apart from
    ops/texture.py, on seeded texture coordinates (far outside [0, 1) too)
    and directions: within float32 rounding of the port's."""
    g = torch.Generator().manual_seed(21)
    atlas = torch.rand((2, 16, 16, 3), generator=g)
    sky = torch.rand((32, 64, 3), generator=g)
    n = 4096
    uv = (torch.rand((n, 2), generator=g) - 0.5) * 40.0
    layer = torch.randint(0, 2, (n,), generator=g)
    scene = weekend.Scene(*([None] * 7), None, None, layer, torch.cat(
        [uv, torch.zeros((n, 4))], 1), atlas, sky, torch.float32)
    rows = torch.zeros((n, 12))
    zero = torch.zeros(n)
    got = weekend.albedo_of(scene, torch.arange(n), rows, zero, zero)
    # A texel coordinate u W of up to 320 carries ~3e-5 texel of rounding,
    # which may fall either way in the two codes and moves a blend of texels
    # in [0, 1] by as much.
    np.testing.assert_allclose(got.numpy(), sample_bilinear(atlas, layer, uv).numpy(),
                               rtol=0, atol=4e-5)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    d[:8] = torch.tensor([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1],
                          [0.6, 0.8, 0], [0, -0.8, -0.6]], dtype=torch.float32)
    # The longitude is divided by 2 pi where the port multiplies by 1 / (2
    # pi): its texel coordinate (below 64) may differ by an ulp or two, ~1e-5
    # of a texel.
    np.testing.assert_allclose(weekend.sky(scene, d).numpy(), sample_env(sky, d).numpy(),
                               rtol=0, atol=1e-5)
