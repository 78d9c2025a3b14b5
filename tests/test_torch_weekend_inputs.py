"""What the configuration `weekend_final1200` hands the port, and the spans
and counters that trace its path.

- The generator at the configuration's seed (cellbench/scenes/weekend_final.py):
  485 spheres of 3,968 triangles and the ground's 2,048; the materials'
  shares within the book's draw; the layout check empty; the benchmark's
  program adapter handing the atlas, the sky map and the lens to the
  port's SceneArrays and Camera, and picking the four families, the
  environment map and `auto` -> bvh2.  The checker is the book's where it
  falls on the ground, the sky map the book's gradient.
- The tracing: the sky and texture spans' groups; an eager CPU pass
  records both spans of every bounce, and a fake capture (one node an op)
  with the phase map has as many nodes as one without; `trace_paths`'
  stats carry sky_per_bounce and textured_per_bounce, one entry a bounce.
"""

import collections
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)

from caitlynrenderer_tpu_torch.core.camera import camera_tensors, generate_rays
from caitlynrenderer_tpu_torch.ops import _build
from caitlynrenderer_tpu_torch.ops.texture import sample_bilinear
from caitlynrenderer_tpu_torch.render import progressive, sampling
from caitlynrenderer_tpu_torch.render.integrator import trace_paths
from caitlynrenderer_tpu_torch.scene import auto_accel, scene_families
from caitlynrenderer_tpu_torch.utils import metrics

from cellbench import manifest, program
from cellbench.scenes import builtin, weekend_final

CONFIG = "weekend_final1200"
SPHERE_TRIANGLES = 3968


def _config():
    return manifest.config(manifest.load(), CONFIG)


@pytest.fixture(scope="module")
def scene():
    """The configuration's scene, as the benchmark makes it."""
    return builtin.make_scene(_config()["scene"])


def test_sphere_and_triangle_counts(scene):
    drawn = weekend_final.draw_spheres(np.random.default_rng(_config()["scene"]["args"]["seed"]))
    assert len(drawn) == 485
    ground = weekend_final.GROUND_QUADS ** 2 * 2
    assert len(scene["tri_v"]) == 485 * SPHERE_TRIANGLES + ground == 1_926_528
    # One material a sphere, then the ground's; the ground's triangles last.
    assert len(scene["materials"]["albedo"]) == 486
    assert (scene["tri_v"][-ground:, 3] == 485).all()
    assert (np.diff(scene["tri_v"][:-ground, 3]) >= 0).all()
    smooth = scene["tri_vn"][:, 3] == 1
    assert smooth[:-ground].all() and not smooth[-ground:].any()


def test_material_shares_within_the_books_draw(scene):
    types = scene["materials"]["albedo"][:, 3].astype(int)
    small, large = types[:482], types[482:485]
    n = len(small)
    # The book's draw: 80 % Lambert, 15 % metal, 5 % glass; each share
    # within four binomial standard deviations of it.
    for kind, p in ((0, 0.80), (weekend_final.DISNEY, 0.15), (weekend_final.GLASS, 0.05)):
        share = float((small == kind).mean())
        assert abs(share - p) <= 4 * math.sqrt(p * (1 - p) / n), (kind, share)
    assert sorted(set(small.tolist())) == [0, weekend_final.GLASS, weekend_final.DISNEY]
    assert large.tolist() == [weekend_final.GLASS, 0, weekend_final.MIRROR]
    mats = scene["materials"]
    metal = types == weekend_final.DISNEY
    assert (mats["disney"][metal, 1] == 1.0).all()  # metallic
    assert (mats["disney"][metal, 0] >= 0).all() and (mats["disney"][metal, 0] < 0.5).all()
    assert (mats["albedo"][metal, :3] >= 0.5).all()
    assert mats["albedo"][484, :3].tolist() == pytest.approx([0.7, 0.6, 0.5])
    assert mats["albedo"][483, :3].tolist() == pytest.approx([0.4, 0.2, 0.1])
    glass = types == weekend_final.GLASS
    assert (mats["specular"][glass, 3] == np.float32(1.5)).all()
    assert (mats["albedo"][glass, :3] == 1.0).all()
    assert (mats["tex_ind"][:485, 0] == -1).all() and mats["tex_ind"][485, 0] == 0
    assert len(scene["lights"]["p"]) == 0 and (mats["emission"][:, 3] == -1).all()


def test_layout_is_well_formed(scene):
    assert builtin.layout_problems(scene) == []


def test_program_gets_the_atlas_the_sky_and_the_lens(scene):
    cfg = _config()
    arrays = program.scene_arrays(scene)
    for name in ("textures", "env_map"):
        got = getattr(arrays, name)
        assert got is not scene[name] and np.array_equal(got, scene[name])
    assert arrays.textures.shape == (1, 512, 512, 3) and arrays.env_map.shape == (512, 1024, 3)
    cam = program.camera(builtin.make_camera(**cfg["camera"]))
    assert float(cam.aperture) == np.float32(0.1) and float(cam.focal_dist) == 10.0
    assert scene_families(arrays) == ("lambert", "disney", "mirror", "glass")
    assert auto_accel(arrays) == "bvh2"


def test_checker_and_sky_are_the_books():
    """Away from the cell edges the atlas gives The Next Week's checker as
    it falls on the ground just below y = 0 (the sign of sin(10 x) sin(10
    z) sin(10 y) with sin(10 y) < 0), and the sky map's rows hold the
    book's gradient at their centres' cosines."""
    atlas = torch.from_numpy(weekend_final.checker_layer())[None]
    g = torch.Generator().manual_seed(4)
    xz = (torch.rand((2000, 2), generator=g, dtype=torch.float64) - 0.5) * 22.0
    s = torch.sin(10.0 * xz)
    inside = (s.abs() > 0.1).all(1)  # a few texels away from every edge
    got = sample_bilinear(atlas, torch.zeros(2000),
                          (xz / weekend_final.CHECKER_PERIOD).float())[inside]
    odd = (s[:, 0] * s[:, 1] > 0)[inside]
    want = torch.where(odd[:, None], torch.tensor(weekend_final.ODD),
                       torch.tensor(weekend_final.EVEN)).float()
    assert int(inside.sum()) > 1000 and torch.allclose(got, want, atol=1e-6)
    sky = weekend_final.sky_map(8)
    y = np.cos(np.pi * (np.arange(8) + 0.5) / 8)
    t = 0.5 * (y + 1.0)[:, None]
    np.testing.assert_allclose(sky[:, 3], (1 - t) + t * np.array([0.5, 0.7, 1.0]), rtol=1e-6)
    assert (sky == sky[:, :1]).all()


# -- the tracing ------------------------------------------------------------


def _small(depth=3, w=16, h=8):
    """A cut of the scene (four spheres of each kind at 16 x 8, the ground,
    the atlas and the sky) uploaded to the CPU, its camera and options."""
    cfg = dict(_config(), width=w, height=h, max_depth=depth)
    drawn = weekend_final.draw_spheres(np.random.default_rng(cfg["scene"]["args"]["seed"]))
    kinds = [next(i for i, s in enumerate(drawn) if s[2] == k)
             for k in ("lambert", "metal", "glass", "mirror")]
    sc = weekend_final.make(cfg["scene"]["args"]["seed"], segments=16, bands=8, spheres=kinds,
                            ground_quads=4, checker=16, sky=16)
    r = program.Renderer(cfg, sc, builtin.make_camera(**cfg["camera"]), "cpu")
    r.upload()
    return r


def test_sky_and_texture_phase_groups():
    assert metrics.phase_group("b7.sky") == "sky"
    assert metrics.phase_group("b7.texture") == "texture"
    assert {"sky", "texture"} <= set(metrics.GROUPS)


def test_eager_pass_records_sky_and_texture_spans():
    r = _small()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        progressive.render_step(r.ds, r.camera, progressive.init_state(16, 8, 3, "cpu"), 16, 8,
                                r.options)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    for b in range(3):
        assert {f"caitlyn.b{b}.sky", f"caitlyn.b{b}.texture"} <= names


class _FakeCapture(TorchDispatchMode):
    """One chain node per dispatched op, as test_torch_phases.py's."""

    def __init__(self):
        super().__init__()
        self.nodes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.nodes.append((len(self.nodes) + 1, True, str(func)))
        return func(*args, **(kwargs or {}))

    def tail(self, stream):
        return self.nodes[-1][0] if self.nodes else 0


def test_sky_and_texture_spans_add_no_node(monkeypatch):
    r = _small()
    body = (r.ds, camera_tensors(r.camera, "cpu"), torch.zeros((16 * 8, 3)),
            torch.zeros((), dtype=torch.int64), (torch.zeros((), dtype=torch.int64),
                                                  torch.ones((), dtype=torch.int64)),
            16, 8, r.options, 1, True)
    plain = _FakeCapture()
    with torch.no_grad(), plain:
        progressive.accumulate(*body)
    fake = _FakeCapture()
    monkeypatch.setattr(_build, "capture_tail", fake.tail)
    monkeypatch.setattr(_build, "graph_nodes", lambda raw: (fake.nodes, True))
    with torch.no_grad(), fake, metrics.capture_phases(0) as marks:
        progressive.accumulate(*body)
    nodes, phases = marks.node_phases(0)
    assert len(nodes) == len(plain.nodes) and None not in phases
    groups = collections.Counter(metrics.phase_group(p) for p in phases)
    assert groups["sky"] > 0 and groups["texture"] > 0
    assert {p for p in phases if metrics.phase_group(p) in ("sky", "texture")} == {
        f"b{b}.{g}" for b in range(3) for g in ("sky", "texture")}


def test_rays_stats_count_sky_and_textured_lanes():
    r = _small(depth=4, w=24, h=16)
    opts = r.options
    uni = sampling.draw_uniforms(sampling.prng_key(9), 24 * 16, opts.max_depth, "cpu")
    o, d = generate_rays(r.camera, 24, 16, uni)
    _, stats = trace_paths(r.ds, o, d, uni, opts, with_stats=True)
    sky, tex, alive = (stats[k] for k in ("sky_per_bounce", "textured_per_bounce",
                                          "alive_per_bounce"))
    assert sky.shape == tex.shape == alive.shape == (opts.max_depth,)
    # Lightless: a live lane either misses (and takes the sky), or hits and
    # goes on unless its Disney sample has no pdf.
    assert bool((alive[1:] <= alive[:-1] - sky[:-1]).all())
    assert bool((sky + tex <= alive).all())
    assert int(sky[0]) > 0 and int(tex[0]) > 0 and int(sky.sum()) > int(sky[0])
    assert stats["anyhit_per_bounce"].numel() == 0 and int(stats["rays_anyhit"]) == 0
