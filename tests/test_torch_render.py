"""The slice as a whole: the port's cornell render ≡ the reference's.

Camera from scenes/cornell.toml (the golden's camera), not the `cornell`
fixture, whose camera frames empty space.  Tolerances, each with its
reason:
  * trace_paths with shared uniforms: per pixel atol 1e-5 (same estimator,
    same float32 expressions; ulp-level differences of sqrt/sin/cos and
    XLA's fused multiply-adds), stats equal;
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
from caitlynrenderer_tpu.core.types import RenderOptions
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


@pytest.mark.parametrize("rr_start,exact_nee", [(-1, False), (1, False), (-1, True)])
def test_trace_paths_matches_reference_per_pixel(rr_start, exact_nee):
    scene, camera, options = _setup(48, 48, rr_start=rr_start, exact_reference_nee=exact_nee)
    uni = np.random.default_rng(rr_start + 5).random((48 * 48, 25), dtype=np.float32)
    oj, dj = j_generate_rays(camera, 48, 48, jnp.asarray(uni))
    j_trace = jax.jit(j_integrator.trace_paths, static_argnames=("options", "with_stats"))
    lj, sj = j_trace(j_upload(scene, accel="brute"), oj, dj, jnp.asarray(uni), options,
                     with_stats=True)
    ot, dt = t_generate_rays(camera, 48, 48, torch.from_numpy(uni))
    lt, st = t_integrator.trace_paths(t_upload(scene, "brute", "cpu"), ot, dt,
                                      torch.from_numpy(uni), options, with_stats=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    assert float(lt.sum()) > 0.0
    for key in ("rays_closest", "rays_anyhit", "alive_per_bounce"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))


def test_chip_smoke_rays_are_the_integrators(monkeypatch):
    """chip_smoke.py times and checks B1 on "the main path's" bounce and
    shadow rays: they are the rays trace_paths hands its second closest-hit
    query and its first any-hit query, on every lane it issues them for."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene, camera, options = _setup(32, 32)
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
    for got, want in ((smoke.bounce_rays(ds, o, d, tri, uni), calls["closest"][1]),
                      (smoke.shadow_rays(ds, o, d, tri, uni), calls["anyhit"][0])):
        live = want[2]
        assert torch.equal(got[2], live) and int(live.sum()) > 100
        for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert torch.equal(a[live], b[live])


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


@pytest.mark.parametrize("flag", [["--mesh", "auto"], ["--turntable", "4"], ["--resume", "c.npz"],
                                  [DISNEY_TOML]])
def test_cli_unported_options_raise(flag, tmp_path):
    """Unported flags, and a scene whose Disney floor is not ported yet."""
    config, flag = (flag[0], []) if flag == [DISNEY_TOML] else (TOML, flag)
    with pytest.raises(NotImplementedError):
        cli.main(["render", config, "--device", "cpu", "--spp", "1", "--width", "8",
                  "--height", "8", "-o", str(tmp_path / "x.png"), *flag])


@pytest.mark.parametrize("change", ["families", "env_map", "textures", "aov", "accel"])
def test_unported_render_options_raise(change):
    """Unported options raise NotImplementedError naming their ROADMAP item;
    an accelerator the scene was not uploaded for raises ValueError."""
    scene, camera, options = _setup(8, 8)
    if change == "families":
        options = options._replace(families=("lambert", "disney"))
    elif change == "env_map":
        options = options._replace(use_env_map=True)
        scene = scene._replace(env_map=np.ones((4, 8, 3), np.float32))
    elif change == "textures":
        scene = scene._replace(textures=np.ones((1, 4, 4, 3), np.float32),
                               texcoords=np.zeros((3, 2), np.float32))
    elif change == "aov":
        options = options._replace(aov="normal")
    else:
        options = options._replace(accel="cwbvh")
    ds = t_upload(scene, "brute", "cpu")
    error, match = (ValueError, "uploaded without") if change == "accel" else (
        NotImplementedError, "ROADMAP")
    with pytest.raises(error, match=match):
        t_progressive.render_image(ds, camera, options, spp=1)
