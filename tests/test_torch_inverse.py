"""The port's optimizer, tooling and entry points against the reference.

Adam and the projection against the reference's on the same gradients
(within 1e-7); the port's `optimize` recovering a perturbed albedo (the
assertions of tests/test_grad.py's reference recovery) and a Disney
roughness with a camera offset; `cli optimize` and `cli render --resume`
on the CPU, their files read by both packages; the parameter converters;
the metrics module.
"""

import logging
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu.accel import bvh as j_bvh
from caitlynrenderer_tpu.grad import inverse as j_inverse
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box as j_cornell
from caitlynrenderer_tpu.render import progressive as j_progressive
from caitlynrenderer_tpu.scene import upload_scene as j_upload
from caitlynrenderer_tpu.utils import checkpoint as j_checkpoint
from caitlynrenderer_tpu.utils import config as j_config
from caitlynrenderer_tpu.utils import metrics as j_metrics
from caitlynrenderer_tpu_torch import cli, convert
from caitlynrenderer_tpu_torch.accel import bvh as t_bvh
from caitlynrenderer_tpu_torch.core.types import MaterialType, RenderOptions, make_camera
from caitlynrenderer_tpu_torch.grad import inverse as t_inverse
from caitlynrenderer_tpu_torch.io.builtin_scenes import cornell_box
from caitlynrenderer_tpu_torch.io.image import load_png
from caitlynrenderer_tpu_torch.render import sampling
from caitlynrenderer_tpu_torch.render.integrator import render_sample
from caitlynrenderer_tpu_torch.scene import scene_families, upload_scene
from caitlynrenderer_tpu_torch.utils import checkpoint, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
DISNEY_TOML = os.path.join(ROOT, "scenes", "cornell_disney.toml")
POS = np.array([2.78, 2.73, 7.5], np.float32)  # tests/test_grad.py's camera


def _cornell_params():
    scene = j_cornell()[0]
    m = scene.materials
    return {"albedo": m.albedo, "disney": m.disney, "emission": m.emission,
            "vertices": scene.vertices, "cam_position": POS, "cam_fov": np.float32(0.7)}


def test_adam_steps_and_projection_match_reference():
    """Three Adam steps and projections of every parameter group on the
    same gradients, large enough to leave the domains (albedo outside
    [0, 1], Disney below 0, emission below 0): within 1e-7 of the
    reference, relative (XLA may round one operation apart: an f32 ulp of
    a coordinate near 2 is 1.2e-7), and 1e-7 absolute near 0; the
    projection leaves column 3 (the type/flag word) as the step left it."""
    params = {k: np.asarray(v, np.float32) for k, v in _cornell_params().items()}
    rng = np.random.default_rng(0)
    grads = [{k: rng.normal(0.0, 1.0, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    tp = convert.params_from_numpy(params, "cpu")
    js, ts = j_inverse.adam_init(jp), t_inverse.adam_init(tp)
    for g in grads:
        jp, js = j_inverse.adam_update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr=0.4)
        jp = j_inverse.project_params(jp)
        stepped, ts = t_inverse.adam_update(convert.params_from_numpy(g, "cpu"), ts, tp, lr=0.4)
        tp = t_inverse.project_params(stepped)
        for k in ("albedo", "emission"):
            assert torch.equal(tp[k][:, 3], stepped[k][:, 3])
        for k in params:
            for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-7,
                                           atol=1e-7, err_msg=k)
    assert ts.step == int(js.step) == 3
    assert float(tp["albedo"][:, :3].max()) == 1.0 and float(tp["albedo"][:, :3].min()) == 0.0
    assert float(tp["disney"].min()) == 0.0 and float(tp["emission"][:, :3].min()) == 0.0


def _self_target(ds, camera, options, key, spp):
    w, h = options.width, options.height
    with torch.no_grad():
        return sum(render_sample(ds, camera, sampling.draw_uniforms(
            sampling.fold_in(key, i), w * h, options.max_depth, "cpu"), w, h, options)
            for i in range(spp)) / spp


def test_optimize_recovers_albedo():
    """tests/test_grad.py's reference recovery through the port (16², 2
    bounces, 40 steps of Adam at lr 5e-2 from 0.4x the wall albedo): the
    excess loss over the Monte-Carlo floor shrinks by over 60 % and the
    white material's error to under 35 % of its start."""
    scene, _ = cornell_box(with_boxes=False)
    camera = make_camera(POS, POS + np.array([0, 0, -1.0], np.float32), 40.0)
    w = h = 16
    options = RenderOptions(width=w, height=h, max_depth=2, accel="brute",
                            families=scene_families(scene))
    ds = upload_scene(scene, "brute", "cpu")
    true_albedo = ds.scene.materials.albedo
    target = _self_target(ds, camera, options, sampling.prng_key(7), 4)
    start = torch.cat([true_albedo[:, :3] * 0.4, true_albedo[:, 3:]], 1)
    loss_fn = t_inverse.make_loss(ds, camera, target, w, h, options)
    key100 = sampling.prng_key(100)
    with torch.no_grad():
        l_truth = float(loss_fn({"albedo": true_albedo}, key100))
        l0 = float(loss_fn({"albedo": start}, key100))
    params, losses = t_inverse.optimize(ds, camera, target, {"albedo": start}, w, h, options,
                                        steps=40, lr=5e-2, seed=1)
    assert len(losses) == 40 and all(isinstance(x, float) for x in losses)
    with torch.no_grad():
        l_end = float(loss_fn(params, key100))
    assert (l_end - l_truth) < 0.4 * (l0 - l_truth), (l0, l_end, l_truth)
    err_start = float((start[0, :3] - true_albedo[0, :3]).abs().mean())
    err_end = float((params["albedo"][0, :3] - true_albedo[0, :3]).abs().mean())
    assert err_end < 0.35 * err_start, (err_start, err_end)


def test_optimize_recovers_disney_roughness_and_camera():
    """BASELINE config #5 at 16², 2 bounces, 60 steps at lr 2e-2: the
    Disney floor's roughness +0.35 and the camera +0.35 in x come back to
    at most half their start error, the late losses below the early ones;
    the returned parameters carry no graph, so a render with them records
    none.  (The camera looks down at the floor so that it covers enough
    of the 256 pixels; the target has 16 samples.)"""
    scene, _ = cornell_box(floor_type=int(MaterialType.DISNEY), with_boxes=False)
    camera = make_camera(POS, POS + np.array([0, -0.5, -1.0], np.float32), 40.0)
    w = h = 16
    options = RenderOptions(width=w, height=h, max_depth=2, accel="brute",
                            families=scene_families(scene))
    ds = upload_scene(scene, "brute", "cpu")
    target = _self_target(ds, camera, options, sampling.prng_key(0), 16)
    true_d = ds.scene.materials.disney
    floor = ds.scene.materials.albedo[:, 3] == int(MaterialType.DISNEY)
    start = true_d.clone()
    start[floor, 0] += 0.35
    pos = torch.from_numpy(POS)
    params, losses = t_inverse.optimize(
        ds, camera, target, {"disney": start, "cam_position": pos + torch.tensor([0.35, 0, 0])},
        w, h, options, steps=60, lr=2e-2, seed=2)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), (losses[0], losses[-1])
    rough_err = float((params["disney"][floor, 0] - true_d[floor, 0]).abs().max())
    cam_err = float((params["cam_position"] - pos).norm())
    assert rough_err <= 0.175 and cam_err <= 0.175, (rough_err, cam_err)
    assert not any(p.requires_grad for p in params.values())
    ds2, cam2 = t_inverse.apply_params(ds, camera, params)
    img = render_sample(ds2, cam2, sampling.draw_uniforms((0, 1), w * h, 2, "cpu"), w, h, options)
    assert not img.requires_grad


def test_params_round_trip():
    params = _cornell_params()
    got = convert.params_from_numpy(params, "cpu")
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in got.values())
    assert got["cam_fov"].shape == ()
    back = convert.params_to_numpy(got)
    assert set(back) == set(params)
    for k, v in params.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))


def test_cli_optimize_params_load_in_both_packages(tmp_path, capsys, caplog):
    """`cli optimize --device cpu` on a copy of scenes/cornell_disney.toml
    at 16², 5 steps: its parameters (albedo, Disney, camera) load in the
    reference's checkpoint.load_params and the port's; the reference's
    save_params file loads in the port's.  The run logs its "scene",
    "opt" and "opt_final" records."""
    toml = str(tmp_path / "cornell_disney.toml")
    shutil.copy(DISNEY_TOML, toml)
    out = str(tmp_path / "params.npz")
    with caplog.at_level(logging.INFO, logger="caitlynrenderer_tpu_torch"):
        rc = cli.main(["optimize", toml, "--device", "cpu", "--width", "16", "--height", "16",
                       "--steps", "5", "--perturb-roughness", "0.35", "--optimize-camera",
                       "-o", out])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "wrote " + out in printed and "disney: max |err| vs truth" in printed
    kinds = [r.getMessage().split(" ", 1)[0] for r in caplog.records]
    assert kinds.count("scene") == 1 and kinds.count("opt") == 1
    assert kinds.count("opt_final") == 3
    ref, ref_extra = j_checkpoint.load_params(out)
    port, extra = checkpoint.load_params(out, "cpu")
    assert set(ref) == set(port) == {"albedo", "disney", "cam_position"} and not ref_extra
    assert not extra
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    scene = j_config.scene_from_config(j_config.load_config(toml))[0]
    assert port["albedo"].shape == scene.materials.albedo.shape

    back = str(tmp_path / "ref_params.npz")
    j_checkpoint.save_params(back, {k: jnp.asarray(v) for k, v in _cornell_params().items()},
                             extra={"step": jnp.int32(7)})
    port, extra = checkpoint.load_params(back, "cpu")
    for k, v in _cornell_params().items():
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(v, np.float32))
    assert int(extra["step"]) == 7


def test_cli_optimize_against_a_png_target(tmp_path, capsys):
    """A PNG target (here a 16x16 render) is fitted without a truth to
    report; one of another size is refused; with nothing perturbed the
    loss is still evaluated and no parameter is written."""
    png = str(tmp_path / "target.png")
    _render(tmp_path, "target.png", 2)
    base = ["optimize", TOML, "--device", "cpu", "--width", "16", "--height", "16", "--steps",
            "2", "--target", png]
    out = str(tmp_path / "p.npz")
    assert cli.main(base + ["-o", out]) == 0
    printed = capsys.readouterr().out
    assert "vs truth" not in printed and "loss " in printed
    assert set(checkpoint.load_params(out, "cpu")[0]) == {"albedo"}
    assert cli.main(base + ["--perturb", "1.0", "-o", out]) == 0
    assert checkpoint.load_params(out, "cpu")[0] == {}
    with pytest.raises(ValueError, match="16x16, the render 8x8"):
        cli.main(["optimize", TOML, "--device", "cpu", "--width", "8", "--height", "8",
                  "--target", png, "-o", out])


def _render(tmp_path, name, spp, *flags):
    out = str(tmp_path / name)
    rc = cli.main(["render", TOML, "--device", "cpu", "--accel", "brute", "--width", "16",
                   "--height", "16", "--spp", str(spp), "-o", out, *flags])
    assert rc == 0
    return load_png(out)


def test_cli_render_resume_continues_exactly(tmp_path, capsys):
    """render --resume twice: the first run saves its 3 samples, the second
    resumes at that frame_count and its 6-sample image equals one
    uninterrupted 6-sample run's, bit for bit."""
    ckpt = str(tmp_path / "ck.npz")
    _render(tmp_path, "a.png", 3, "--resume", ckpt)
    assert int(np.load(ckpt)["frame_count"]) == 3
    capsys.readouterr()
    resumed = _render(tmp_path, "b.png", 6, "--resume", ckpt, "--checkpoint-every", "0")
    assert "resumed at 3 spp" in capsys.readouterr().out
    state = checkpoint.load_render_state(ckpt, "cpu")
    assert state.frame_count == 6 and state.base_key == sampling.prng_key(0)
    np.testing.assert_array_equal(resumed, _render(tmp_path, "c.png", 6))


def test_cli_render_resumes_a_reference_checkpoint(tmp_path, capsys):
    """A state the reference's save_render_state wrote (2 samples of the
    same render) resumes in the port: 4 samples in all, an image within one
    8-bit step of the port's uninterrupted run."""
    cfg = j_config.load_config(TOML)
    scene = j_config.scene_from_config(cfg, os.path.dirname(TOML))[0]
    camera = j_config.camera_from_config(cfg, None)
    options = j_config.options_from_config(cfg, width=16, height=16, accel="brute")
    state = j_progressive.render_steps(j_upload(scene, accel="brute"), camera,
                                       j_progressive.init_state(16, 16, 0), 16, 16, options, 2)
    ckpt = str(tmp_path / "ref.npz")
    j_checkpoint.save_render_state(ckpt, state)
    resumed = _render(tmp_path, "r.png", 4, "--resume", ckpt)
    assert "resumed at 2 spp" in capsys.readouterr().out
    assert int(j_checkpoint.load_render_state(ckpt).frame_count) == 4
    assert np.abs(resumed - _render(tmp_path, "u.png", 4)).max() <= 1.0 / 255 + 1e-6


def test_cli_resume_rejects_another_resolution(tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    _render(tmp_path, "a.png", 1, "--resume", ckpt)
    with pytest.raises(ValueError, match="accumulates 256 pixels"):
        cli.main(["render", TOML, "--device", "cpu", "--accel", "brute", "--width", "8",
                  "--height", "8", "--spp", "2", "--resume", ckpt,
                  "-o", str(tmp_path / "b.png")])


def test_metrics_match_reference(tmp_path, caplog):
    """bvh_build_stats equals the reference's on the cornell BVH; the timer's
    summary, the JSON log record, and profile_trace (a no-op without a
    directory, a Chrome trace with one)."""
    sc = j_cornell()[0]
    want = j_metrics.bvh_build_stats(j_bvh.build_bvh(sc.vertices, sc.tri_v, max_leaf=4))
    assert metrics.bvh_build_stats(t_bvh.build_bvh(sc.vertices, sc.tri_v, max_leaf=4)) == want
    timer = metrics.StepTimer()
    with timer.span("step"):
        pass
    timer.count("rays", 1000)
    summary = timer.summary()
    assert summary["rays"] == 1000 and "step" in summary and summary["rays_per_sec"] > 0
    with caplog.at_level(logging.INFO, logger="caitlynrenderer_tpu_torch"):
        metrics.log_record("opt", {"step": 0, "loss": 0.5})
    assert caplog.records[-1].getMessage() == 'opt {"loss": 0.5, "step": 0}'
    with metrics.profile_trace(None):
        torch.ones(4).sum()
    with metrics.profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
