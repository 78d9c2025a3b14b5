"""The slice as a whole: the port's renders ≡ the reference's.

Camera from scenes/cornell.toml (the golden's camera), not the `cornell`
fixture, whose camera frames empty space.  Tolerances, each with its
reason:
  * trace_paths with shared uniforms, Lambert (the cornell, and the scenes
    kernel B6 shades on the card, tests/test_torch_shade.FUSED_CASES): per
    pixel atol 1e-5 (same estimator, same float32 expressions; ulp-level
    differences of sqrt/sin/cos and XLA's fused multiply-adds), stats
    equal;
  * trace_paths with shared uniforms, the Disney, mirror, glass and
    CONDUCTOR floors, the textured OBJ, the sky-lit cornell (also under the
    wide BVH) and the default families: at most 0.5 % of pixels beyond atol 1e-4 and the means
    within rtol 1e-3; the stats within 0.5 % of the lanes.  A Disney lobe
    pick or a Fresnel choice compares a uniform with a float32 threshold
    the two packages may round apart, and then the whole path differs;
  * first-hit AOVs: atol 1e-5 (one deterministic closest hit);
  * render_image vs the reference's brute render: mean |d| < 1e-3,
    max < 0.06 (a ray grazing an edge may flip its hit across frameworks);
  * the committed golden: tests/test_golden.py's bounds.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu.core.camera import generate_rays as j_generate_rays
from caitlynrenderer_tpu.core.types import MaterialType, RenderOptions, make_camera
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, procedural_sky
from caitlynrenderer_tpu.io.obj import load_obj
from caitlynrenderer_tpu.render import integrator as j_integrator
from caitlynrenderer_tpu.render import progressive as j_progressive
from caitlynrenderer_tpu.scene import scene_families, upload_scene as j_upload
from caitlynrenderer_tpu.utils import checkpoint, config
from caitlynrenderer_tpu_torch import cli, convert
from caitlynrenderer_tpu_torch.core.camera import generate_rays as t_generate_rays
from caitlynrenderer_tpu_torch.ops import mt_brute
from caitlynrenderer_tpu_torch.render import integrator as t_integrator
from caitlynrenderer_tpu_torch.render import progressive as t_progressive
from caitlynrenderer_tpu_torch.scene import upload_scene as t_upload

import test_torch_shade

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
DISNEY_TOML = os.path.join(ROOT, "scenes", "cornell_disney.toml")
GOLDEN = os.path.join(ROOT, "scenes", "golden", "cornell_64_cpu.npz")


def _setup(width, height, **kw):
    cfg = config.load_config(TOML)
    scene, translation = config.scene_from_config(cfg, os.path.dirname(TOML))
    camera = config.camera_from_config(cfg, translation)
    options = RenderOptions(width=width, height=height, max_depth=3, accel="brute",
                            families=scene_families(scene), **kw)
    return scene, camera, options


def _trace_both(ds_scene, camera, options, seed):
    """trace_paths of both packages on the same rays and uniforms, each
    scene uploaded for options.accel: (port radiance, port stats,
    reference radiance, reference stats), radiance as numpy."""
    w, h = options.width, options.height
    uni = np.random.default_rng(seed).random((w * h, 4 + 7 * options.max_depth),
                                             dtype=np.float32)
    oj, dj = j_generate_rays(camera, w, h, jnp.asarray(uni))
    j_trace = jax.jit(j_integrator.trace_paths, static_argnames=("options", "with_stats"))
    lj, sj = j_trace(j_upload(ds_scene, accel=options.accel), oj, dj, jnp.asarray(uni), options,
                     with_stats=True)
    ot, dt = t_generate_rays(camera, w, h, torch.from_numpy(uni))
    lt, st = t_integrator.trace_paths(t_upload(ds_scene, options.accel, "cpu"), ot, dt,
                                      torch.from_numpy(uni), options, with_stats=True)
    return lt.numpy(), st, np.asarray(lj), sj


def assert_lambert_close(lt, st, lj, sj):
    """The Lambert contract (module docstring): per pixel atol 1e-5, stats
    equal."""
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    assert float(lt.sum()) > 0.0
    for key in ("rays_closest", "rays_anyhit", "alive_per_bounce"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))


def assert_shaded_close(lt, st, lj, sj):
    """The contract of the other families, textures and the environment
    (module docstring): at most 0.5 % of pixels beyond atol 1e-4, the
    means within rtol 1e-3, the stats within 0.5 % of the lanes."""
    off = (np.abs(lt - lj) > 1e-4).any(axis=1)
    assert off.mean() <= 0.005, off.sum()
    np.testing.assert_allclose(lt.mean(), lj.mean(), rtol=1e-3)
    assert lt.mean() > 0.02
    lanes = lt.shape[0]
    for key in ("rays_closest", "rays_anyhit", "alive_per_bounce"):
        assert (np.abs(st[key].numpy() - np.asarray(sj[key])) <= 0.005 * lanes).all(), key


@pytest.mark.parametrize("rr_start,exact_nee", [(-1, False), (1, False), (-1, True)])
def test_trace_paths_matches_reference_per_pixel(rr_start, exact_nee):
    scene, camera, options = _setup(48, 48, rr_start=rr_start, exact_reference_nee=exact_nee)
    assert_lambert_close(*_trace_both(scene, camera, options, rr_start + 5))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def textured(tmp_path_factory, smoke):
    """The textured OBJ scene of tests/test_textures.py as chip_smoke.py
    writes it (16x16 atlas), and its camera."""
    scene, translation = load_obj(smoke.write_textured_scene(str(tmp_path_factory.mktemp("tex"))),
                                  tex_size=16)
    pos = np.array([0.0, 1.0, 4.0], np.float32) + translation
    return scene, make_camera(pos, pos + np.array([0, 0, -1], np.float32), 40.0)


def test_chip_smoke_textured_scene_is_test_textures(smoke):
    from test_textures import MTL_TEXT, OBJ_TEXT

    assert smoke.TEX_OBJ == OBJ_TEXT and smoke.TEX_MTL == MTL_TEXT


FLOORS = ("disney", "mirror", "glass", "conductor")


def _shaded_case(case, textured, width=48):
    """(scene, camera, options) of a shading case: a cornell floor of
    another family, the textured OBJ, the sky-lit cornell, or the Lambert
    cornell with the default (all four) families."""
    scene, camera, options = _setup(width, width)
    if case in FLOORS:
        scene = cornell_box(floor_type=int(MaterialType[case.upper()]))[0]
    elif case == "textured":
        scene, camera = textured
    elif case == "sky":
        scene = scene._replace(env_map=procedural_sky(16, 32))
        options = options._replace(use_env_map=True)
    if case == "default_families":
        return scene, camera, options._replace(families=RenderOptions().families)
    return scene, camera, options._replace(families=scene_families(scene))


@pytest.mark.parametrize("case", [*FLOORS, "textured", "sky", "default_families"])
def test_trace_paths_shading_matches_reference_per_pixel(case, textured):
    """Every family, texture and the env map, per pixel with shared uniforms
    (the module docstring's contract); the CONDUCTOR floor pins the
    reference's handling of it (specular: no NEE; not MIRROR: no
    reflection; so a Lambert bounce)."""
    scene, camera, options = _shaded_case(case, textured)
    lt, st, lj, sj = _trace_both(scene, camera, options, 11)
    assert_shaded_close(lt, st, lj, sj)
    if case == "default_families":  # tracing unused families changes nothing
        lam, _, _, _ = _trace_both(scene, camera, options._replace(families=("lambert",)), 11)
        np.testing.assert_array_equal(lt, lam)


def test_trace_paths_under_wide_matches_reference_per_pixel():
    """The glass floor under the sky, every family traced, through the wide
    BVH: the plain bounce's refraction, environment and specular MIS with
    the wide queries, against the reference's wide path, which threads its
    own origin-group hint (the module docstring's contract)."""
    scene = cornell_box(floor_type=int(MaterialType.GLASS))[0]
    scene = scene._replace(env_map=procedural_sky(16, 32))
    _, camera, options = _setup(48, 48, use_env_map=True)
    options = options._replace(accel="wide", families=RenderOptions().families)
    assert_shaded_close(*_trace_both(scene, camera, options, 13))


@pytest.mark.parametrize("name", list(test_torch_shade.FUSED_CASES))
def test_plain_loop_matches_reference_per_pixel(name, monkeypatch):
    """The scenes kernel B6 shades on the card, under brute, wide, cwbvh
    and bvh2, through the loop with B6's plain twin on the CPU, against the
    reference on the same rays and uniforms: the Lambert cases within the
    Lambert contract, the Disney, mirror and glass ones within the
    contract of the other families.  One twin call a bounce, one finishing
    add a bounce."""
    calls = test_torch_shade.count_plain_steps(monkeypatch)
    # The other families at 48x40: enough lanes on the floor for every lobe
    # and on the spheres for each delta lobe.
    lambert = test_torch_shade.lambert_case(name)
    size = (test_torch_shade.W, test_torch_shade.H) if lambert else (48, 40)
    scene, _, camera, options = test_torch_shade._fused_setup(name, width=size[0],
                                                              height=size[1])
    got = _trace_both(scene, camera, options, 11)
    (assert_lambert_close if lambert else assert_shaded_close)(*got)
    assert calls == {"bounce": options.max_depth, "finish": options.max_depth}


def test_conductor_is_specular_but_scatters_as_lambert():
    """The reference's CONDUCTOR (type 6): in its specular types, so no
    shadow ray leaves it, but not MIRROR, so it is not reflected, and not
    Disney: it continues as a Lambert bounce, not specular."""
    scene = cornell_box(floor_type=int(MaterialType.CONDUCTOR))[0]
    _, camera, options = _setup(32, 32)
    fams = scene_families(scene)
    assert fams == ("lambert", "mirror")
    ds = t_upload(scene, "brute", "cpu")
    uni = torch.from_numpy(np.random.default_rng(2).random((32 * 32, 25), dtype=np.float32))
    o, d = t_generate_rays(camera, 32, 32, uni)
    _, tri, _, _ = mt_brute.brute_closest_plain(o, d, torch.ones(o.shape[0], dtype=torch.bool),
                                                ds.tris9)
    zero = torch.zeros_like(o[:, 0])
    hf = t_integrator.hit_frame(ds, o, d, zero, tri, zero, zero)
    surf = t_integrator.surface(ds, hf, fams)
    floor = hf.keep & (torch.round(hf.rows[:, 29]) == int(MaterialType.CONDUCTOR))
    assert int(floor.sum()) > 50
    assert bool(surf.specular[floor].all()) and not bool(surf.mirror[floor].any())
    u = t_integrator.bounce_uniforms(uni, 0)
    _, _, _, _, _, cand, _ = t_integrator.light_sample(ds.light_tab, hf.point, hf.n_flip, *u[:3],
                                                        hf.keep, surf.specular)
    assert not bool(cand[floor].any())
    new_d, new_T, pdf, spec, ok, origin = t_integrator.continuation(
        hf, surf, d, torch.ones_like(o), u[3], u[4], u[5])
    local = t_integrator.cm.cosine_hemisphere_dir(u[3], u[4])
    lam = t_integrator.cm.normalize(t_integrator.cm.local_to_world(local, hf.n_flip))
    assert torch.equal(new_d[floor], lam[floor]) and not bool(spec[floor].any())
    assert torch.equal(new_T[floor], surf.albedo[floor]) and bool(ok.all())
    assert torch.equal(origin, hf.point)


@pytest.mark.parametrize("floor", ["diffuse", "glass", "disney"])
def test_chip_smoke_rays_are_the_integrators(monkeypatch, smoke, floor):
    """chip_smoke.py times and checks the kernels on "the main path's"
    bounce and shadow rays: they are the rays trace_paths hands its second
    closest-hit query and its first any-hit query, on every lane it issues
    them for, on the Lambert cornell and on its glass and Disney floors
    (refracted rays, Disney samples, no shadow ray from the glass)."""
    scene, camera, options = _setup(32, 32)
    if floor != "diffuse":
        scene = cornell_box(floor_type=int(MaterialType[floor.upper()]))[0]
        options = options._replace(families=scene_families(scene))
    uni = torch.from_numpy(np.random.default_rng(7).random((32 * 32, 25), dtype=np.float32))
    ds = t_upload(scene, "brute", "cpu")
    o, d = t_generate_rays(camera, 32, 32, uni)
    calls = {"closest": [], "anyhit": []}

    def closest(qo, qd, active, tris9):
        calls["closest"].append((qo, qd, active))
        return mt_brute.brute_closest(qo, qd, active, tris9)

    def anyhit(qo, qd, t_max, active, tris9):
        calls["anyhit"].append((qo, qd, active, t_max))
        return mt_brute.brute_anyhit(qo, qd, t_max, active, tris9)

    monkeypatch.setattr(t_integrator, "brute_closest", closest)
    monkeypatch.setattr(t_integrator, "brute_anyhit", anyhit)
    t_integrator.trace_paths(ds, o, d, uni, options)
    _, tri, _, _ = mt_brute.brute_closest_plain(o, d, torch.ones(o.shape[0], dtype=torch.bool),
                                                ds.tris9)
    fams = options.families
    for got, want in ((smoke.bounce_rays(ds, o, d, tri, uni, fams), calls["closest"][1]),
                      (smoke.shadow_rays(ds, o, d, tri, uni, fams), calls["anyhit"][0])):
        live = want[2]
        assert torch.equal(got[2], live) and int(live.sum()) > 100
        for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert torch.equal(a[live], b[live])
    if floor == "glass":  # some continuation rays went through the floor
        hf, surf, _ = smoke.vertex(ds, o, d, tri, fams)
        bo, bd, live = smoke.bounce_rays(ds, o, d, tri, uni, fams)
        refracted = live & surf.glass & (t_integrator.cm.dot(bd, hf.n_flip) < 0)
        assert int(refracted.sum()) > 20
        assert torch.allclose(bo[refracted], (hf.point - 2 * t_integrator.RAY_OFFSET
                                              * hf.n_flip)[refracted], atol=1e-6)


def test_convert_carries_textures_and_env_map(textured):
    """The reference's scene arrays carried across keep the texture atlas
    and the env map, as f32 tensors on the device, and render as the
    port's own upload does."""
    scene, camera = textured
    scene = scene._replace(env_map=procedural_sky(16, 32))
    options = RenderOptions(width=24, height=24, max_depth=2, accel="brute", use_env_map=True,
                            families=scene_families(scene))
    ref = jax.tree_util.tree_map(np.asarray, j_upload(scene, accel="brute").scene)
    tds = convert.device_scene_from_numpy(ref, "cpu")
    for name in ("textures", "env_map"):
        got = getattr(tds.scene, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), getattr(scene, name))
    uni = torch.from_numpy(np.random.default_rng(5).random((24 * 24, 18), dtype=np.float32))
    imgs = [t_integrator.render_sample(ds, camera, uni, 24, 24, options)
            for ds in (tds, t_upload(scene, "brute", "cpu"))]
    assert torch.equal(imgs[0], imgs[1]) and float(imgs[0].mean()) > 0


@pytest.mark.parametrize("aov", ["albedo", "normal", "depth"])
@pytest.mark.parametrize("case", ["disney", "textured"])
def test_aov_matches_reference(aov, case, textured):
    """render_sample's first-hit AOVs (the port reads the normal and albedo
    from the shading-table rows, the reference's non-fused `_shading_normal`
    and `_albedo` from the scene arrays), atol 1e-5."""
    scene, camera, options = _shaded_case(case, textured)
    options = options._replace(aov=aov)
    w = options.width
    uni = np.random.default_rng(2).random((w * w, 25), dtype=np.float32)
    want = np.asarray(j_integrator.render_sample(j_upload(scene, accel="brute"), camera,
                                                 jnp.asarray(uni), w, w, options))
    mt_brute.reset_launches()
    got = t_integrator.render_sample(t_upload(scene, "brute", "cpu"), camera,
                                     torch.from_numpy(uni), w, w, options).numpy()
    assert mt_brute.launches["closest_twin"] == 1 and mt_brute.launches["anyhit_twin"] == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    hit = (want != 0).any(axis=1)
    assert 0.2 < hit.mean() <= 1.0


@pytest.mark.parametrize("aov", ["beauty", "albedo", "normal", "depth"])
def test_resolve_matches_reference(aov):
    """resolve of the same accumulation: tonemapped beauty, linear clipped
    AOVs, depth normalized by the frame's maximum (atol 1e-6)."""
    w, h = 8, 6
    accum = np.random.default_rng(4).uniform(0, 12, (w * h, 3)).astype(np.float32)
    options = RenderOptions(width=w, height=h, aov=aov)
    want = np.asarray(j_progressive.resolve(
        j_progressive.init_state(w, h, 0)._replace(accum=jnp.asarray(accum),
                                                   frame_count=jnp.int32(4)), w, h, options))
    got = t_progressive.resolve(t_progressive.RenderState(torch.from_numpy(accum), 4, (0, 0)),
                                w, h, options).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (h, w, 3) and 0.0 <= got.min() and got.max() <= 1.0


def test_render_image_matches_reference_render():
    scene, camera, options = _setup(64, 64)
    ij, _ = j_progressive.render_image(j_upload(scene, accel="brute"), camera, options,
                                       spp=16, seed=0)
    it, _ = t_progressive.render_image(t_upload(scene, "brute", "cpu"), camera, options,
                                       spp=16, seed=0)
    err = np.abs(it.numpy() - np.asarray(ij))
    assert err.mean() < 1e-3, err.mean()
    assert err.max() < 0.06, err.max()


def test_golden_render_within_golden_bounds():
    scene, camera, options = _setup(64, 64)
    mt_brute.reset_launches()
    img, state = t_progressive.render_image(t_upload(scene, "brute", "cpu"), camera, options,
                                            spp=48, seed=0)
    assert mt_brute.launches["closest_twin"] == 48 * 3  # CPU tensors: the twin
    assert mt_brute.launches["closest"] == 0
    golden = np.load(GOLDEN)["img"]
    img = img.numpy()
    assert img.shape == golden.shape and state.frame_count == 48
    err = np.abs(img - golden)
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.06, err.max()
    assert img[32, 4, 0] > img[32, 4, 1]  # left wall red-dominant
    assert img[32, 60, 1] > img[32, 60, 0]  # right wall green-dominant


def test_state_carries_over_from_reference(tmp_path):
    scene, camera, options = _setup(32, 32)
    w, h = 32, 32
    jds = j_upload(scene, accel="brute")
    half = j_progressive.render_steps(jds, camera, j_progressive.init_state(w, h, 3),
                                      w, h, options, 8)
    ckpt = str(tmp_path / "half.npz")
    checkpoint.save_render_state(ckpt, half)  # before render_steps donates `half`
    full = j_progressive.render_steps(jds, camera, half, w, h, options, 8)
    z = np.load(ckpt)
    state = convert.state_from_numpy(z["accum"], z["frame_count"], z["base_key"], "cpu")
    tds = convert.device_scene_from_numpy(jax.tree_util.tree_map(np.asarray, jds.scene), "cpu")
    state = t_progressive.render_steps(tds, camera, state, w, h, options, 8)
    assert state.frame_count == 16
    ref = np.asarray(full.accum) / 16.0
    assert np.abs(state.accum.numpy() / 16.0 - ref).mean() < 1e-4
    # ... and back: the reference loads the port's state as a checkpoint.
    out = str(tmp_path / "port.npz")
    np.savez(out, **convert.state_to_numpy(state))
    back = checkpoint.load_render_state(out)
    assert int(back.frame_count) == 16
    np.testing.assert_array_equal(np.asarray(back.base_key), np.asarray(full.base_key))
    np.testing.assert_array_equal(np.asarray(back.accum), state.accum.numpy())


def test_cli_render_writes_png(tmp_path):
    out = tmp_path / "cornell.png"
    rc = cli.main(["render", TOML, "--accel", "auto", "--width", "32", "--height", "32",
                   "--spp", "2", "--device", "cpu", "-o", str(out)])
    assert rc == 0 and out.exists()
    from PIL import Image

    assert Image.open(out).size == (32, 32)


def _cli(config, tmp_path, *flags):
    out = tmp_path / "x.png"
    rc = cli.main(["render", config, "--device", "cpu", "--spp", "1", "--width", "16",
                   "--height", "16", "-o", str(out), *flags])
    return rc, out


@pytest.mark.parametrize("flag", [["--mesh", "auto"], ["--turntable", "4"], ["--mesh", "1x1"]])
def test_cli_unported_options_raise(flag, tmp_path):
    """The flags that once raised NotImplementedError render now (a
    process without a process group is the 1x1 mesh; tests/test_torch_tiled.py
    and tests/test_torch_parallel.py hold what they render), and each
    raises ValueError with an option its path does not carry."""
    rc, out = _cli(TOML, tmp_path, *flag)
    assert rc == 0
    assert (tmp_path / "x_003.png").exists() if "--turntable" in flag else out.exists()
    with pytest.raises(ValueError, match="with --resume"):
        _cli(TOML, tmp_path, *flag, "--resume", str(tmp_path / "ck.npz"))


@pytest.mark.parametrize("config,flags", [(DISNEY_TOML, []), (TOML, ["--aov", "depth"])],
                         ids=["disney", "aov_depth"])
def test_cli_renders_disney_and_aov(config, flags, tmp_path):
    """The Disney-floor scene and a depth AOV render to PNG."""
    rc, out = _cli(config, tmp_path, *flags)
    assert rc == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (16, 16, 3) and img.max() > img.min()


@pytest.mark.parametrize("flags,accel", [([], "wide"), (["--accel", "brute"], "brute")])
def test_cli_accel_from_config_unless_given(flags, accel, tmp_path, capsys):
    """scenes/cornell.toml says accel = "wide": without --accel the config
    decides, and an explicit --accel wins."""
    rc, _ = _cli(TOML, tmp_path, *flags)
    assert rc == 0 and f"accel {accel}," in capsys.readouterr().out


@pytest.mark.parametrize("poison", [False, True])
def test_cli_debug_checks(poison, tmp_path, monkeypatch, capsys, caplog):
    """--debug-checks passes on cornell and logs the reference's
    `debug_checks` record ({"finite": true}), and on a scene whose light
    emits NaN raises a ValueError that names the first bad pixel and
    channel, logging no such record."""
    import json
    import logging

    caplog.set_level(logging.INFO, logger="caitlynrenderer_tpu_torch")

    def records():
        return [json.loads(r.getMessage().split(" ", 1)[1]) for r in caplog.records
                if r.getMessage().startswith("debug_checks ")]

    if poison:
        setup = cli.render_setup

        def nan_light(*args, **kw):
            scene, camera, options = setup(*args, **kw)
            emission = scene.materials.emission.copy()
            emission[emission[:, 3] != -1, :3] = np.nan
            return scene._replace(materials=scene.materials._replace(emission=emission)), \
                camera, options

        monkeypatch.setattr(cli, "render_setup", nan_light)
        with pytest.raises(ValueError, match=r"non-finite radiance .* at pixel \d+ .* channel \d"):
            _cli(TOML, tmp_path, "--debug-checks")
        assert records() == []
    else:
        rc, out = _cli(TOML, tmp_path, "--debug-checks")
        assert rc == 0 and out.exists() and "radiance is finite" in capsys.readouterr().out
        assert records() == [{"finite": True}]


@pytest.mark.parametrize("change", ["accel"])
def test_unported_render_options_raise(change):
    """An accelerator the scene was not uploaded for raises ValueError."""
    scene, camera, options = _setup(8, 8)
    options = options._replace(accel="cwbvh")
    ds = t_upload(scene, "brute", "cpu")
    with pytest.raises(ValueError, match="uploaded without"):
        t_progressive.render_image(ds, camera, options, spp=1)
