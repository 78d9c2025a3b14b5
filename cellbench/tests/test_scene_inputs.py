"""What a configuration may hand the program besides geometry, materials
and area lights: a texture atlas, an environment map (which the program
samples wherever the scene carries one), no light at all and a thin-lens
camera.  The layout check
refuses malformed ones; well-formed ones reach the program as they are
(the benchmark's `Renderer` renders what the program's own progressive
loop renders on the same inputs); the plain references refuse what they
do not trace; and the four configurations of BENCHMARK.json hand the
program what they did before these inputs existed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from caitlynrenderer_tpu_torch import scene as pscene
from caitlynrenderer_tpu_torch.core.types import (Lights, Materials, RenderOptions, SceneArrays,
                                                  make_camera)
from caitlynrenderer_tpu_torch.render import progressive

from cellbench import manifest, program, seeds
from cellbench.reference import disney, sampler, specular, tracer
from cellbench.scenes import builtin
from cellbench.tests.conftest import SEED

BENCH = manifest.load()
REFERENCES = {"tracer": tracer, "disney": disney, "specular": specular}


def _sky_scene(env=True) -> dict:
    """A floor textured from a two-layer atlas (layer 1) and a grey wall,
    no area light, under an environment map: 4 triangles."""
    b = builtin.SceneBuilder()
    floor = b.add_material(albedo=(0.8, 0.8, 0.8))
    wall = b.add_material(albedo=(0.5, 0.6, 0.7))
    b.add_quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2), floor)
    b.add_quad((-2, 0, -2), (2, 0, -2), (2, 2, -2), (-2, 2, -2), wall)
    sc = b.build()
    rng = np.random.default_rng(7)
    sc["textures"] = rng.uniform(0.1, 0.9, (2, 4, 4, 3)).astype(np.float32)
    sc["materials"]["tex_ind"][floor, 0] = 1
    sc["texcoords"] = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    sc["tri_vt"][:2, :3] = [[0, 1, 2], [0, 2, 3]]
    if env:
        sc["env_map"] = rng.uniform(0.5, 3.0, (8, 16, 3)).astype(np.float32)
    return sc


def _broken(case: str) -> dict:
    sc = _sky_scene()
    if case == "atlas_float64":
        sc["textures"] = sc["textures"].astype(np.float64)
    elif case == "atlas_rank3":
        sc["textures"] = sc["textures"][0]
    elif case == "atlas_rgba":
        sc["textures"] = np.ones((2, 4, 4, 4), np.float32)
    elif case == "atlas_empty":
        sc["textures"] = np.ones((0, 4, 4, 3), np.float32)
    elif case == "atlas_nan":
        sc["textures"][1, 2, 3, 0] = np.nan
    elif case == "atlas_negative":
        sc["textures"][0, 0, 0, 1] = -0.01
    elif case == "env_float16":
        sc["env_map"] = sc["env_map"].astype(np.float16)
    elif case == "env_rank4":
        sc["env_map"] = sc["env_map"][None]
    elif case == "env_list":
        sc["env_map"] = sc["env_map"].tolist()
    elif case == "env_inf":
        sc["env_map"][0, 0, 0] = np.inf
    elif case == "env_negative":
        sc["env_map"][3, 5, 2] = -1.0
    elif case == "layer_at_k":
        sc["materials"]["tex_ind"][0, 0] = 2
    elif case == "layer_fraction":
        sc["materials"]["tex_ind"][0, 0] = 0.5
    elif case == "layer_minus_two":
        sc["materials"]["tex_ind"][1, 0] = -2
    elif case == "layer_without_atlas":
        del sc["textures"]
    elif case == "texcoord_past_end":
        sc["tri_vt"][1, 2] = 4
    elif case == "texcoord_negative":
        sc["tri_vt"][0, 0] = -1
    elif case == "unknown_key":
        sc["normal_map"] = sc["textures"]
    return sc


@pytest.mark.parametrize("case,message", [
    ("atlas_float64", "textures is not"), ("atlas_rank3", "textures is not"),
    ("atlas_rgba", "textures is not"), ("atlas_empty", "textures is not"),
    ("atlas_nan", "textures holds"), ("atlas_negative", "textures holds"),
    ("env_float16", "env_map is not"), ("env_rank4", "env_map is not"),
    ("env_list", "env_map is not"), ("env_inf", "env_map holds"),
    ("env_negative", "env_map holds"), ("layer_at_k", "texture layers"),
    ("layer_fraction", "texture layers"), ("layer_minus_two", "texture layers"),
    ("layer_without_atlas", "texture layers"), ("texcoord_past_end", "index texcoords"),
    ("texcoord_negative", "index texcoords"), ("unknown_key", "keys"),
])
def test_layout_refuses_malformed_images(case, message):
    problems = builtin.layout_problems(_broken(case))
    assert len(problems) == 1 and message in problems[0], problems


@pytest.mark.parametrize("case", ["atlas_and_env", "atlas", "env", "no_light", "untextured_atlas"])
def test_layout_accepts_well_formed_images(case):
    sc = _sky_scene(env=case != "atlas")
    if case == "env":
        del sc["textures"]
        sc["materials"]["tex_ind"][:, 0] = -1
    elif case == "untextured_atlas":  # an atlas that no material samples
        sc["materials"]["tex_ind"][:, 0] = -1
        sc["texcoords"] = np.zeros((0, 2), np.float32)
    elif case == "no_light":
        sc = builtin.cornell_box()
        sc["materials"]["emission"][:] = 0.0
        sc["materials"]["emission"][:, 3] = -1
        sc["tri_vt"][:, 3] = -1
        sc["lights"] = {k: v[:0] for k, v in sc["lights"].items()}
    assert builtin.layout_problems(sc) == []
    if case != "no_light":
        assert len(sc["lights"]["p"]) == 0


CFG = {"name": "sky_lens", "width": 8, "height": 6, "max_depth": 3, "accel": "auto"}


LENS = dict(position=(0.3, 1.2, 4.0), look_at=(0.0, 0.4, 0.0), fov_degrees=45.0,
            focal_dist=3.5, aperture=0.4)


def _renderer_accum(sc, spp=3):
    r = program.Renderer(CFG, sc, builtin.make_camera(**LENS), "cpu")
    r.upload()
    r.new_image(SEED)
    r.launch(spp)
    return r, r.state.accum.clone()


def test_renderer_hands_images_and_lens_to_the_program():
    """The benchmark's Renderer on a textured, environment-lit, lightless
    scene under a thin lens gives bit for bit what the program's
    progressive loop gives on the same SceneArrays, camera and options."""
    sc = _sky_scene()
    r, got = _renderer_accum(sc)
    assert r.options.use_env_map and r.scene.textures is not None
    arrays = SceneArrays(
        sc["vertices"], sc["normals"], sc["texcoords"], sc["tri_v"], sc["tri_vn"], sc["tri_vt"],
        Materials(*(sc["materials"][k] for k in builtin.MATERIAL_FIELDS)),
        Lights(*(sc["lights"][k] for k in builtin.LIGHT_FIELDS)),
        textures=sc["textures"], env_map=sc["env_map"])
    camera = make_camera(**LENS)
    assert all(np.array_equal(a, b) for a, b in zip(camera, r.camera))
    ds = pscene.upload_scene(arrays, "brute", torch.device("cpu"))
    options = RenderOptions(width=8, height=6, max_depth=3, use_env_map=True, accel="brute",
                            families=("lambert",))
    options = options._replace(max_stack=pscene.required_stack(ds))
    assert r.options == options
    state = progressive.render_steps(ds, camera, progressive.init_state(8, 6, SEED, "cpu"), 8, 6,
                                     options, 3)
    assert torch.equal(got, state.accum)
    assert float(got.sum()) > 0.0
    # Without the map the lightless scene is black; the map and the
    # textured floor are what light it.
    dark_r, dark = _renderer_accum(dict(sc, env_map=None))
    assert not dark_r.options.use_env_map
    assert not torch.equal(got, dark) and float(dark.abs().sum()) == 0.0
    _, plain = _renderer_accum(dict(sc, textures=None))
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("what,match", [("env_map", "environment map"), ("atlas", "untextured"),
                                        ("texture", "untextured"), ("lens", "pinhole")])
@pytest.mark.parametrize("name", sorted(REFERENCES))
def test_references_refuse_what_they_do_not_trace(name, what, match):
    ref = REFERENCES[name]
    sc = builtin.cornell_box()  # Lambert: each reference traces it
    cam = builtin.make_camera(position=(2.8, 2.75, 13.18), look_at=(2.8, 2.75, 12.18),
                              aperture=0.25 if what == "lens" else 0.0)
    if what == "env_map":
        sc["env_map"] = np.ones((4, 8, 3), np.float32)
    elif what == "atlas":
        sc["textures"] = np.ones((1, 2, 2, 3), np.float32)
    elif what == "texture":
        sc["materials"]["tex_ind"][1, 0] = 0
    with pytest.raises(ValueError, match=match):
        scene = ref.load_scene(sc, "cpu")
        ref.radiance(scene, cam, 8, 6, 2, sampler.base_key(5), torch.zeros(1, dtype=torch.int64),
                     torch.arange(4))


def _camera_rays_two_uniforms(cam, width, height, pixel_ids, u0, u1, dtype):
    """`tracer.camera_rays` as it was when it took the jitter pair alone."""
    dev = pixel_ids.device

    def vec(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev).to(dtype)

    xx = (pixel_ids % width).to(dtype)
    yy = torch.div(pixel_ids, width, rounding_mode="floor").to(dtype)
    u = (xx + 0.5) / width
    v = (yy + 0.5) / height
    jx, jy = tracer._tent(2.0 * u0), tracer._tent(2.0 * u1)
    dx = (2.0 * u - 1.0) + jx / (width * 0.5)
    dy = (2.0 * v - 1.0) + jy / (height * 0.5)
    tan_fov = torch.tan(vec(cam["fov"]) * 0.5)
    dx = dx * (width / height) * tan_fov
    dy = dy * tan_fov
    right, up, forward = vec(cam["right"]), vec(cam["up"]), vec(cam["forward"])
    d = tracer.normalize(dx[:, None] * right[None, :] + dy[:, None] * up[None, :]
                         + forward[None, :])
    return vec(cam["position"]).expand_as(d).clone(), d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_four_uniform_pinhole_rays_are_the_two_uniform_rays(name, dtype):
    cfg = manifest.config(BENCH, name)
    cam = builtin.make_camera(**cfg["camera"])
    w, h = cfg["width"], cfg["height"]
    ids = torch.from_numpy(seeds.check_pixels(SEED, w * h, 2048)).to(torch.int64)
    uni = sampler.uniforms(sampler.base_key(seeds.image_seed(SEED, 0)),
                           torch.tensor([0, 7], dtype=torch.int64), ids, 1)
    for s in range(2):
        u = uni[s].to(dtype)
        o, d = tracer.camera_rays(cam, w, h, ids, u[:, 0:4], dtype)
        o2, d2 = _camera_rays_two_uniforms(cam, w, h, ids, u[:, 0], u[:, 1], dtype)
        assert torch.equal(o, o2) and torch.equal(d, d2)
        # The lens pair is left unread by a pinhole.
        o3, d3 = tracer.camera_rays(cam, w, h, ids, torch.cat([u[:, 0:2], 1 - u[:, 2:4]], 1),
                                    dtype)
        assert torch.equal(o, o3) and torch.equal(d, d3)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configurations_hand_the_program_what_they_did(name):
    """Each configuration of BENCHMARK.json gives the program the arrays,
    camera and options it gave before a scene could carry images: no
    atlas, no environment map, `use_env_map` off, a pinhole camera."""
    cfg = manifest.config(BENCH, name)
    sc = builtin.make_scene(cfg["scene"])
    cam = builtin.make_camera(**cfg["camera"])
    assert builtin.layout_problems(sc) == []
    r = program.Renderer(cfg, sc, cam, "cpu")
    before = SceneArrays(
        vertices=sc["vertices"].copy(), normals=sc["normals"].copy(),
        texcoords=sc["texcoords"].copy(), tri_v=sc["tri_v"].copy(),
        tri_vn=sc["tri_vn"].copy(), tri_vt=sc["tri_vt"].copy(),
        materials=Materials(*(sc["materials"][k].copy() for k in builtin.MATERIAL_FIELDS)),
        lights=Lights(*(sc["lights"][k].copy() for k in builtin.LIGHT_FIELDS)))
    assert r.scene.textures is None and r.scene.env_map is None
    for got, want in zip(r.scene[:8], before[:8]):
        for g, w in zip(got, want) if isinstance(want, tuple) else [(got, want)]:
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    accel = pscene.auto_accel(before) if cfg["accel"] == "auto" else cfg["accel"]
    assert r.options == RenderOptions(width=cfg["width"], height=cfg["height"],
                                      max_depth=cfg["max_depth"], accel=accel,
                                      families=pscene.scene_families(before))
    assert float(r.camera.aperture) == 0.0
    assert all(np.array_equal(a, np.array(cam[k], np.float32))
               for a, k in zip(r.camera, builtin.CAMERA_FIELDS))
