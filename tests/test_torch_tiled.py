"""Port's tiled rendering and the rest of its CLI ≡ the reference's.

The cornell scene of scenes/cornell.toml through "brute" on CPU tensors.
Tolerances, each with its reason:
  * tile_grid: equal tiles;
  * the port's render_image_tiled vs the reference's, 24x24, 3x2 tiles,
    3 spp: per pixel atol 1e-5, the render tests' tolerance (same
    estimator and float32 expressions; ulp-level differences of
    sqrt/sin/cos and XLA's fused multiply-adds);
  * tiled vs untiled in the port: bit for bit (the same per-pixel work,
    keyed by the global pixel id, accumulated in the same order), the
    accumulation at any spp and the image where the two resolves agree;
  * CLI images: equal PNGs (the same tensors through the same save); the
    turntable's frames, and a --spp-per-launch render, against the
    reference CLI's within one 8-bit level; the chunked loop's checkpoint
    saves and progress records at the same sample counts as the
    reference CLI's.
"""

import os

import numpy as np
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu.render import tiled as j_tiled
from caitlynrenderer_tpu.scene import upload_scene as j_upload
from caitlynrenderer_tpu.utils import config as j_config
from caitlynrenderer_tpu_torch import cli
from caitlynrenderer_tpu_torch.io.image import load_png, save_png
from caitlynrenderer_tpu_torch.render import progressive
from caitlynrenderer_tpu_torch.render import tiled
from caitlynrenderer_tpu_torch.scene import scene_families, upload_scene
from caitlynrenderer_tpu_torch.utils import checkpoint, config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")


def _setup(width, height, tiles=(1, 1), depth=3):
    """(scene, camera, port RenderOptions) of scenes/cornell.toml, brute."""
    cfg = config.load_config(TOML)
    scene, translation = config.scene_from_config(cfg, os.path.dirname(TOML))
    camera = config.camera_from_config(cfg, translation)
    options = config.options_from_config(cfg, width=width, height=height, max_depth=depth,
                                         accel="brute")
    options = options._replace(families=scene_families(scene), num_tiles_x=tiles[0],
                               num_tiles_y=tiles[1])
    return scene, camera, options


@pytest.mark.parametrize("shape", [(100, 60, 3, 2), (24, 24, 3, 2), (7, 5, 2, 2),
                                   (16, 16, 4, 4), (10, 3, 3, 1), (5, 9, 1, 4)])
def test_tile_grid_equals_reference(shape):
    got = list(tiled.tile_grid(*shape))
    want = list(j_tiled.tile_grid(*shape))
    assert [tuple(t) for t in got] == [tuple(t) for t in want]
    w, h = shape[:2]
    assert sum(t.w * t.h for t in got) == w * h


def test_render_image_tiled_matches_reference():
    """24x24 in 3x2 tiles, 3 spp (not a power of two: the resolve is the
    reference's accum / spp), seed 4: per pixel atol 1e-5."""
    scene, camera, options = _setup(24, 24, (3, 2))
    j_cfg = j_config.load_config(TOML)
    j_options = j_config.options_from_config(j_cfg, width=24, height=24, max_depth=3,
                                             accel="brute")._replace(
        families=options.families, num_tiles_x=3, num_tiles_y=2)
    want = np.asarray(j_tiled.render_image_tiled(j_upload(scene, accel="brute"), camera,
                                                 j_options, spp=3, seed=4))
    got = tiled.render_image_tiled(upload_scene(scene, "brute", "cpu"), camera, options, spp=3,
                                   seed=4)
    assert got.shape == (24, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tiles", [(3, 2), (5, 7)])
def test_tiled_equals_untiled_bit_for_bit(tiles):
    """The tiled accumulation equals progressive.render_steps' bit for bit
    (3 spp), the tiled image equals the 1x1-tile image, and at 4 spp (a
    power of two, where accum / spp == accum * (1 / spp)) it equals
    progressive.resolve's image too."""
    scene, camera, options = _setup(24, 20, tiles, depth=2)
    ds = upload_scene(scene, "bvh2", "cpu")
    options = options._replace(accel="bvh2")
    acc = tiled.accumulate_tiled(ds, camera, options, spp=3, seed=1)
    state = progressive.render_steps(ds, camera, progressive.init_state(24, 20, 1, "cpu"),
                                     24, 20, options, 3)
    assert torch.equal(acc, state.accum)
    one = options._replace(num_tiles_x=1, num_tiles_y=1)
    assert torch.equal(tiled.render_image_tiled(ds, camera, options, spp=3, seed=1),
                       tiled.render_image_tiled(ds, camera, one, spp=3, seed=1))
    img, _ = progressive.render_image(ds, camera, options, spp=4, seed=1)
    assert torch.equal(tiled.render_image_tiled(ds, camera, options, spp=4, seed=1), img)


def _write_toml(tmp_path, extra):
    text = open(TOML).read().replace('accel = "wide"', 'accel = "brute"') + extra
    path = tmp_path / "scene.toml"
    path.write_text(text)
    return str(path)


def test_cli_render_takes_the_tiled_path(tmp_path, monkeypatch):
    """A config with num_tiles_x = 2 renders through render_image_tiled
    (the CLI before the tiled path rendered it untiled, never calling it)
    and writes its image."""
    calls = []
    real = tiled.render_image_tiled

    def spy(*a, **kw):
        o = a[2]
        calls.append((o.width, o.height, o.num_tiles_x, o.num_tiles_y))
        return real(*a, **kw)

    monkeypatch.setattr(tiled, "render_image_tiled", spy)
    path = _write_toml(tmp_path, "num_tiles_x = 2\nnum_tiles_y = 3\n")
    out = str(tmp_path / "t.png")
    assert cli.main(["render", path, "--device", "cpu", "--width", "16", "--height", "12",
                     "--depth", "2", "--spp", "3", "-o", out]) == 0
    assert calls == [(16, 12, 2, 3)]
    scene, camera, options = _setup(16, 12, (2, 3), depth=2)
    want = real(upload_scene(scene, "brute", "cpu"), camera, options, spp=3, seed=0)
    save_png(str(tmp_path / "want.png"), want.numpy())
    np.testing.assert_array_equal(load_png(out), load_png(str(tmp_path / "want.png")))
    with pytest.raises(ValueError, match="num_tiles_x/num_tiles_y with --resume"):
        cli.main(["render", path, "--device", "cpu", "--resume", str(tmp_path / "ck.npz")])


def test_cli_turntable_writes_each_orbit_frame(tmp_path, capsys):
    """--turntable 3 on a config whose camera has a lens: OUT_000.png ..
    OUT_002.png, each within one 8-bit level of the reference CLI's own
    `render --turntable 3` frame on the same config (the PNG form of the
    render tests' per-pixel atol 1e-5: such a difference can carry a value
    across one rounding boundary, never two), and bit for bit the port's
    progressive render from cli.turntable_camera's orbit camera.  The
    reference's orbit camera drops the lens; the config's own camera, lens
    included, renders frame 0 differently, so the test sees a lens that
    leaks into the orbit."""
    from caitlynrenderer_tpu import cli as j_cli

    path = tmp_path / "lens.toml"
    path.write_text(open(TOML).read().replace(
        "fov = 40.0", "fov = 40.0\nfocal_dist = 1.0\naperture = 0.3"))
    args = ["render", str(path), "--accel", "brute", "--width", "12", "--height", "12",
            "--depth", "2", "--spp", "2", "--turntable", "3"]
    assert cli.main([*args, "--device", "cpu", "-o", str(tmp_path / "orbit.png")]) == 0
    assert "frame 3/3" in capsys.readouterr().out
    assert j_cli.main([*args, "-o", str(tmp_path / "ref.png")]) == 0
    cfg = config.load_config(str(path))
    scene, translation = config.scene_from_config(cfg, str(tmp_path))
    _, _, options = _setup(12, 12, depth=2)
    ds = upload_scene(scene, "brute", "cpu")
    frames = []
    for k in range(3):
        got = load_png(str(tmp_path / f"orbit_{k:03d}.png"))
        want = load_png(str(tmp_path / f"ref_{k:03d}.png"))
        assert got.shape == want.shape == (12, 12, 3)
        assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6, k
        img, _ = progressive.render_image(ds, cli.turntable_camera(cfg, translation, k, 3),
                                          options, spp=2, seed=0)
        save_png(str(tmp_path / f"want{k}.png"), img.numpy())
        np.testing.assert_array_equal(got, load_png(str(tmp_path / f"want{k}.png")))
        frames.append(got)
    assert not np.array_equal(frames[0], frames[1])
    assert not os.path.exists(tmp_path / "orbit_003.png")
    lens, _ = progressive.render_image(ds, config.camera_from_config(cfg, translation), options,
                                       spp=2, seed=0)
    save_png(str(tmp_path / "lens.png"), lens.numpy())
    assert np.abs(load_png(str(tmp_path / "lens.png")) - frames[0]).max() > 2.0 / 255
    with pytest.raises(ValueError, match="--turntable with --resume"):
        cli.main(["render", TOML, "--device", "cpu", "--turntable", "2", "--resume",
                  str(tmp_path / "ck.npz")])
    with pytest.raises(ValueError, match="at least 1"):
        cli.main(["render", TOML, "--device", "cpu", "--turntable", "0"])


def test_cli_turntable_1_renders_a_still_image(tmp_path, capsys):
    """--turntable 1 is the still image at -o, as in the reference's CLI
    (its turntable runs only for N > 1): one PNG, OUT.png and no OUT_000.png,
    within one 8-bit level of the reference CLI's `render --turntable 1`
    on the same config (the turntable test's tolerance, for the same
    reason) and bit for bit the port's render without --turntable; the
    still path takes --resume, which the turntable refuses."""
    from caitlynrenderer_tpu import cli as j_cli

    args = ["render", TOML, "--accel", "brute", "--width", "12", "--height", "12", "--depth", "2",
            "--spp", "2"]
    port, ref, plain = (tmp_path / d for d in ("port", "ref", "plain"))
    for d in (port, ref, plain):
        d.mkdir()
    assert cli.main([*args, "--device", "cpu", "--turntable", "1", "-o", str(port / "x.png"),
                     "--resume", str(tmp_path / "ck.npz")]) == 0
    assert "frame" not in capsys.readouterr().out
    assert j_cli.main([*args, "--turntable", "1", "-o", str(ref / "x.png")]) == 0
    assert cli.main([*args, "--device", "cpu", "-o", str(plain / "x.png")]) == 0
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == ["x.png"]
    got = load_png(str(port / "x.png"))
    assert got.shape == (12, 12, 3) and got.max() > 0
    assert np.abs(got - load_png(str(ref / "x.png"))).max() <= 1.0 / 255 + 1e-6
    np.testing.assert_array_equal(got, load_png(str(plain / "x.png")))
    assert checkpoint.load_render_state(str(tmp_path / "ck.npz"), "cpu").frame_count == 2


def test_cli_benchmark_help(capfd):
    """`benchmark` runs the port's bench module with the remaining
    arguments, --help included."""
    assert cli.main(["benchmark", "--help"]) == 0
    out = capfd.readouterr().out
    assert "--scene" in out and "grid100k" in out


@pytest.mark.parametrize("spl", [1, 2, 8, 0, 64])
def test_cli_spp_per_launch_spaces_checkpoint_checks(tmp_path, monkeypatch, spl):
    """--spp-per-launch with --resume: the port's checkpoint saves fall
    after the same samples as the reference CLI's on the same argv.  With
    --checkpoint-every -1 the clock is read, and saves, after every
    launch, and the budget halves every launch after the first to one
    sample; then the final save.  spl 0 reads as 1."""
    from caitlynrenderer_tpu import cli as j_cli
    from caitlynrenderer_tpu.utils import checkpoint as j_checkpoint

    seen = {"port": [], "ref": []}

    def spy(side, real):
        def save(path, state):
            seen[side].append(int(state.frame_count))
            real(path, state)
        return save

    monkeypatch.setattr(checkpoint, "save_render_state", spy("port", checkpoint.save_render_state))
    monkeypatch.setattr(j_checkpoint, "save_render_state",
                        spy("ref", j_checkpoint.save_render_state))
    argv = ["render", TOML, "--accel", "brute", "--width", "8", "--height", "8", "--depth", "1",
            "--spp", "9", "--checkpoint-every", "-1", "--spp-per-launch", str(spl)]
    assert cli.main([*argv, "--device", "cpu", "--resume", str(tmp_path / "ck.npz"), "-o",
                     str(tmp_path / "s.png")]) == 0
    assert j_cli.main([*argv, "--resume", str(tmp_path / "j_ck.npz"), "-o",
                       str(tmp_path / "j.png")]) == 0
    first = spl if 1 < spl <= 9 else 1
    assert seen["port"] == seen["ref"] == [*range(first, 10), 9]


def test_cli_spp_per_launch_image_and_progress_match_reference(tmp_path, caplog):
    """cli render --spp 20 --spp-per-launch 8 (launches of 8, 8, then 1 x
    4): the PNG within one 8-bit level of the reference CLI's, and the
    progress records at the same sample counts (each tenth of --spp the
    count crosses), each with its samples and rays counted."""
    import json
    import logging

    from caitlynrenderer_tpu import cli as j_cli

    argv = ["render", TOML, "--accel", "brute", "--width", "12", "--height", "10", "--depth",
            "2", "--spp", "20", "--spp-per-launch", "8", "--seed", "3"]
    with caplog.at_level(logging.INFO):
        assert cli.main([*argv, "--device", "cpu", "-o", str(tmp_path / "port.png")]) == 0
        assert j_cli.main([*argv, "-o", str(tmp_path / "ref.png")]) == 0

    def progress(logger):
        return [json.loads(r.getMessage().split(" ", 1)[1]) for r in caplog.records
                if r.name == logger and r.getMessage().startswith("progress ")]

    got, want = progress("caitlynrenderer_tpu_torch"), progress("caitlynrenderer_tpu")
    assert [r["spp"] for r in got] == [r["spp"] for r in want] == [8, 16, 18, 20]
    assert [r["samples"] for r in got] == [r["spp"] for r in got]
    assert got[-1]["rays"] == want[-1]["rays"] > 0 and got[-1]["rays_per_sec"] > 0
    img, ref = load_png(str(tmp_path / "port.png")), load_png(str(tmp_path / "ref.png"))
    assert img.shape == ref.shape == (10, 12, 3)
    assert np.abs(img - ref).max() <= 1.0 / 255 + 1e-6
