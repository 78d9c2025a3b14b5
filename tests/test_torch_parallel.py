"""Port's sharded, multi-process rendering (parallel/) ≡ its single-process
render and the reference's shard_map render.

The port's ranks are processes: each test spawns them with
torch.multiprocessing, wired over gloo through a file under the test's
temporary directory (so parallel test workers never share a port), with a
60 s timeout on the process group and on the join, each rank on one CPU
thread.  The reference runs in this process on conftest's 8 virtual CPU
devices.  Scene: the cornell box with scenes/cornell.toml's camera, 16x16,
2 bounces.  Tolerances, each with its reason:
  * sp = 1 against the port's single-process progressive render: bit for
    bit (a pixel's uniforms depend only on its global id and the sample);
  * sp > 1: rtol 1e-5, atol 1e-6 (the row's sum reassociates the samples,
    as tests/test_parallel.py allows);
  * against the reference's sharded_render_step on the same (dp, sp)
    mesh: per pixel atol 1e-5, the render tests' tolerance;
  * the tiled sharded image: bit for bit against the untiled one;
  * sharded_train_step against the reference's: the loss rtol 1e-4 (the
    render's 1e-5 summed over 1024 squared errors), the step each
    parameter takes at tests/test_torch_grad.py's gradient tolerance (rtol
    1e-4, atol 1e-6 of the largest), the step being lr times the gradient
    over its RMS.
"""

import os
import signal
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu_torch import cli
from caitlynrenderer_tpu_torch.core.types import RenderOptions, make_camera
from caitlynrenderer_tpu_torch.io.builtin_scenes import cornell_box
from caitlynrenderer_tpu_torch.io.image import load_png
from caitlynrenderer_tpu_torch.parallel import distributed as pd
from caitlynrenderer_tpu_torch.parallel import render as pr
from caitlynrenderer_tpu_torch.parallel.mesh import SINGLE, Mesh, factor_mesh, make_mesh
from caitlynrenderer_tpu_torch.render import progressive
from caitlynrenderer_tpu_torch.scene import scene_families, upload_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
SIDE, DEPTH, SEED, STEPS = 16, 2, 5, 2
ACCELS = ("bvh2", "brute")
MESHES = ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))
TIMEOUT_S = 60
LR, TRAIN_KEY = 2.0, 11


def _scene():
    sc = cornell_box()[0]
    camera = make_camera(np.float32([2.8, 2.75, 13.18]), np.float32([2.8, 2.75, 12.18]), 40.0)
    return sc, camera


def _options(sc, accel, side=SIDE):
    return RenderOptions(width=side, height=side, max_depth=DEPTH, accel=accel,
                         families=scene_families(sc))


def _train_params(ds, camera):
    """The start of the training step: the albedo RGB halved, the camera
    where it is (numpy, for both packages)."""
    albedo = ds.scene.materials.albedo.numpy().copy()
    albedo[:, :3] *= 0.5
    return {"albedo": albedo, "cam_position": np.asarray(camera.position, np.float32)}


# --------------------------------------------------------------------------
# The ranks
# --------------------------------------------------------------------------


def _render_each_accel(mesh):
    """{accel: STEPS sharded steps on `mesh`: this rank's block, the frame
    count, the whole accumulation, the image by gather_image and by
    assemble_image}."""
    sc, camera = _scene()
    res = {}
    for accel in ACCELS:
        ds = upload_scene(sc, accel, "cpu")
        opts = _options(sc, accel)
        st = pr.init_sharded_state(mesh, SIDE, SIDE, SEED, "cpu")
        for _ in range(STEPS):
            st = pr.sharded_render_step(ds, camera, st, mesh, SIDE, SIDE, opts)
        res[accel] = {"block": st.accum, "frames": st.frame_count,
                      "accum": pr.gather_accum(st, mesh),
                      "image": pr.gather_image(st, mesh, SIDE, SIDE, opts),
                      "assembled": pd.assemble_image(st, mesh, SIDE, SIDE, opts)}
    return res


def _rank_main(rank, world, init, out_dir, shape, extra):
    """One rank: wire gloo, render on the (dp, sp) mesh with each accel and
    save what the tests read to out_dir/rank{rank}.pt."""
    torch.set_num_threads(1)
    pd.init_distributed(init_method=init, world_size=world, rank=rank, backend="gloo",
                        device="cpu", timeout=timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(shape)
        sc, camera = _scene()
        res = _render_each_accel(mesh)
        if "tiled" in extra:  # through "brute"
            ds = upload_scene(sc, "brute", "cpu")
            opts = _options(sc, "brute")
            order, _ = pr.tile_pixel_order(SIDE, SIDE, 4, 4, mesh.dp)
            ts = pr.init_tiled_state(mesh, order, "cpu")
            accum = ts.accum
            for f in range(STEPS):
                accum = pr.sharded_render_step_tiled(ds, camera, accum, ts.order, f, (0, SEED),
                                                     mesh, SIDE, SIDE, opts)
            res["tiled"] = pr.gather_image_tiled(accum, ts.order, STEPS, mesh, SIDE, SIDE, opts)
        if "train" in extra:
            ds = upload_scene(sc, "bvh2", "cpu")
            opts = _options(sc, "bvh2")
            target = torch.from_numpy(extra["train"])
            block = target.shape[0] // mesh.dp
            target = target[mesh.dp_idx * block : (mesh.dp_idx + 1) * block]
            params = {k: torch.from_numpy(v) for k, v in _train_params(ds, camera).items()}
            losses, steps = [], []
            for i in range(5):
                params, loss = pr.sharded_train_step(params, ds, camera, target,
                                                     (0, TRAIN_KEY), i, mesh, SIDE, SIDE, opts,
                                                     lr=LR)
                losses.append(loss)
                steps.append(params)
            res["train"] = {"losses": losses, "first": steps[0]}
        if "scaling" in extra:
            ds = upload_scene(sc, "bvh2", "cpu")
            res["scaling"] = pd.scaling_report(ds, camera, _options(sc, "bvh2"), SIDE, SIDE,
                                               spp=1)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(out_dir, shape, extra):
    """Run _rank_main on dp * sp gloo ranks; each rank's saved results.  A
    rank that raises fails the test with its traceback; ranks still
    running after TIMEOUT_S are killed and fail it."""
    world = shape[0] * shape[1]
    init = "file://" + os.path.join(out_dir, "rendezvous")
    ctx = mp.start_processes(_rank_main, args=(world, init, out_dir, shape, extra),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"mesh {shape}: ranks still running after {TIMEOUT_S} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


_RUNS = {}


def _run(shape, tmp_path_factory):
    """The ranks' results on mesh `shape`, spawned once per test module:
    every mesh renders both accels; 4x1 also the tiled grid, 2x2 also the
    training step, 2x1 also the scaling report.  1x1 runs in this process
    (no process group: parallel.mesh.SINGLE)."""
    if shape not in _RUNS:
        extra = {}
        if shape == (4, 1):
            extra["tiled"] = True
        if shape == (2, 2):
            extra["train"] = _train_target()
        if shape == (2, 1):
            extra["scaling"] = True
        out = str(tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"))
        if shape == (1, 1):
            _RUNS[shape] = [_render_each_accel(make_mesh())]
        else:
            _RUNS[shape] = _spawn(out, shape, extra)
    return _RUNS[shape]


def _progressive(accel, samples):
    """The port's single-process progressive state after `samples` steps."""
    sc, camera = _scene()
    st = progressive.init_state(SIDE, SIDE, SEED, "cpu")
    return progressive.render_steps(upload_scene(sc, accel, "cpu"), camera, st, SIDE, SIDE,
                                    _options(sc, accel), samples)


def _train_target():
    """(256, 3) target radiance, the mean of 2 progressive samples of the
    true scene (numpy: the same array goes to both packages)."""
    return (_progressive("bvh2", 2).accum / 2.0).numpy()


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_render_matches_single_process(shape, accel, tmp_path_factory):
    """Every rank's block is its slice of the whole accumulation; the
    whole equals STEPS * sp progressive samples (bit for bit at sp = 1);
    every rank resolves the same image, through gather_image and
    assemble_image alike, from the frames * sp samples."""
    results = _run(shape, tmp_path_factory)
    dp, sp = shape
    want = _progressive(accel, STEPS * sp)
    block = -(-SIDE * SIDE // dp)
    for rank, res in enumerate(results):
        r = res[accel]
        assert r["frames"] == STEPS and r["block"].shape == (block, 3)
        assert torch.equal(r["accum"], results[0][accel]["accum"])
        assert torch.equal(r["block"], r["accum"][rank // sp * block : (rank // sp + 1) * block])
        assert torch.equal(r["image"], results[0][accel]["image"])
        np.testing.assert_array_equal(r["assembled"], r["image"].numpy())
    got = results[0][accel]["accum"][: SIDE * SIDE]
    if sp == 1:
        assert torch.equal(got, want.accum)
        img = progressive.resolve(want, SIDE, SIDE, _options(_scene()[0], accel))
        assert torch.equal(results[0][accel]["image"], img)  # frames a power of two
    else:
        np.testing.assert_allclose(got.numpy(), want.accum.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_render_matches_reference(shape, accel, tmp_path_factory):
    """The reference's sharded_render_step on the same (dp, sp) mesh of
    virtual CPU devices, STEPS steps from the same seed."""
    import jax

    from caitlynrenderer_tpu.parallel.mesh import make_mesh as j_make_mesh
    from caitlynrenderer_tpu.parallel.render import init_sharded_state, sharded_render_step
    from caitlynrenderer_tpu.scene import upload_scene as j_upload

    results = _run(shape, tmp_path_factory)
    sc, camera = _scene()
    mesh = j_make_mesh(jax.devices()[: shape[0] * shape[1]], shape=shape)
    ds = j_upload(sc, accel=accel)
    st = init_sharded_state(mesh, SIDE, SIDE, seed=SEED)
    for _ in range(STEPS):
        st = sharded_render_step(ds, camera, st, mesh, SIDE, SIDE, _options(sc, accel))
    want = np.asarray(st.accum)
    got = results[0][accel]["accum"].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_padding_10x10_on_8():
    """tests/test_parallel.py's case: 100 pixels on dp = 8 pad to 104, 13
    a rank.  The 8 ranks' steps need no collective at sp = 1, so they run
    here one after another: their blocks laid end to end equal the
    progressive accumulation on the 100 pixels, and the reference's
    (8, 1) mesh on all 104 slots (the padding traces throwaway rays)."""
    import jax

    from caitlynrenderer_tpu.parallel.mesh import make_mesh as j_make_mesh
    from caitlynrenderer_tpu.parallel.render import init_sharded_state, sharded_render_step
    from caitlynrenderer_tpu.scene import upload_scene as j_upload

    assert pr.padded_pixels(10, 10, 8) == 104
    sc, camera = _scene()
    opts = _options(sc, "bvh2", side=10)
    ds = upload_scene(sc, "bvh2", "cpu")
    blocks = []
    for rank in range(8):
        mesh = Mesh(dp=8, sp=1, rank=rank, group=None, sp_group=None)
        st = pr.init_sharded_state(mesh, 10, 10, SEED, "cpu")
        assert st.accum.shape == (13, 3)
        blocks.append(pr.sharded_render_step(ds, camera, st, mesh, 10, 10, opts).accum)
    got = torch.cat(blocks)
    single = progressive.render_step(ds, camera, progressive.init_state(10, 10, SEED, "cpu"),
                                     10, 10, opts)
    assert torch.equal(got[:100], single.accum)
    jm = j_make_mesh(jax.devices()[:8], shape=(8, 1))
    jst = sharded_render_step(j_upload(sc, accel="bvh2"), camera,
                              init_sharded_state(jm, 10, 10, seed=SEED), jm, 10, 10, opts)
    assert np.asarray(jst.accum).shape == (104, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jst.accum), rtol=0, atol=1e-5)


def test_tiled_sharded_render_equals_untiled(tmp_path_factory):
    """4x4 tiles over dp = 4: every rank's image equals the untiled
    single-process render of the same samples bit for bit (as
    tests/test_distributed.py asserts for the reference)."""
    results = _run((4, 1), tmp_path_factory)
    want = progressive.resolve(_progressive("brute", STEPS), SIDE, SIDE,
                               _options(_scene()[0], "brute"))
    for res in results:
        assert torch.equal(res["tiled"], want)
    order, n_pad = pr.tile_pixel_order(SIDE, SIDE, 4, 4, 4)
    assert n_pad == 256 and sorted(order.tolist()) == list(range(256))
    order, n_pad = pr.tile_pixel_order(10, 7, 3, 2, 4)  # ragged tiles, 2 padding slots
    assert n_pad == 72 and (order[-2:] == -1).all() and sorted(order[:70]) == list(range(70))


def test_sharded_train_step_matches_reference(tmp_path_factory):
    """One step on the 2x2 mesh from the same numpy parameters (albedo and
    camera position), target and key as the reference's; over 5 steps the
    loss falls."""
    import jax
    import jax.numpy as jnp

    from caitlynrenderer_tpu.parallel.mesh import make_mesh as j_make_mesh
    from caitlynrenderer_tpu.parallel.render import sharded_train_step
    from caitlynrenderer_tpu.scene import upload_scene as j_upload

    results = _run((2, 2), tmp_path_factory)
    sc, camera = _scene()
    ds = upload_scene(sc, "bvh2", "cpu")
    p0 = _train_params(ds, camera)
    jm = j_make_mesh(jax.devices()[:4], shape=(2, 2))
    want, want_loss = sharded_train_step(
        {k: jnp.asarray(v) for k, v in p0.items()}, j_upload(sc, accel="bvh2"), camera,
        jnp.asarray(_train_target()), jax.random.PRNGKey(TRAIN_KEY), jnp.int32(0), jm, SIDE,
        SIDE, _options(sc, "bvh2"), lr=LR)
    for res in results:
        tr = res["train"]
        np.testing.assert_allclose(tr["losses"][0], float(want_loss), rtol=1e-4)
        for k, v in p0.items():
            step_want = np.asarray(want[k]) - v
            step_got = tr["first"][k].numpy() - v
            np.testing.assert_allclose(step_got, step_want, rtol=1e-4,
                                       atol=1e-6 * np.abs(step_want).max(), err_msg=k)
        assert np.isfinite(tr["losses"]).all() and tr["losses"][-1] < tr["losses"][0]
        assert tr["losses"] == results[0]["train"]["losses"]


def test_assemble_image_and_single_process_wiring():
    """assemble_image equals gather_image; init_distributed in a plain
    process is (0, 1) and a second call too; the mesh of a process without
    a process group is 1x1, and any other shape raises."""
    assert pd.init_distributed() == (0, 1)
    assert pd.init_distributed() == (0, 1)
    assert not dist.is_initialized() and not pd.launched()
    assert make_mesh() == SINGLE and pd.make_multihost_mesh() == SINGLE
    assert (SINGLE.dp_idx, SINGLE.sp_idx, SINGLE.shape) == (0, 0, {"dp": 1, "sp": 1})
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2))
    with pytest.raises(ValueError, match="does not divide"):
        pd.make_multihost_mesh(sp=3)
    assert factor_mesh(8) == (4, 2) and factor_mesh(3) == (3, 1) and factor_mesh(1) == (1, 1)
    assert pd.rank_device("cpu") == torch.device("cpu")
    res = _render_each_accel(make_mesh())["bvh2"]
    np.testing.assert_array_equal(res["assembled"], res["image"].numpy())


def test_scaling_report_counts_the_integrators_rays(tmp_path_factory):
    """scaling_report on 2 ranks: rank 0 alone, then both; the same report
    on each rank, the ray count the integrator's stats give."""
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths

    results = _run((2, 1), tmp_path_factory)
    sc, camera = _scene()
    opts = _options(sc, "bvh2")
    uni = sampling.draw_uniforms(sampling.prng_key(0), SIDE * SIDE, DEPTH, "cpu")
    o, d = generate_rays(camera, SIDE, SIDE, uni)
    _, stats = trace_paths(upload_scene(sc, "bvh2", "cpu"), o, d, uni, opts, with_stats=True)
    rays = int(stats["rays_closest"]) + int(stats["rays_anyhit"])
    assert SIDE * SIDE <= rays < SIDE * SIDE * DEPTH * 2
    for res in results:
        rep = res["scaling"]
        assert rep["devices"] == 2 and rep["rays_per_sample"] == rays
        assert rep["rays_per_sec_per_chip_1"] == results[0]["scaling"]["rays_per_sec_per_chip_1"]
        assert rep["rays_per_sec_per_chip_1"] > 0 and rep["rays_per_sec_per_chip_n"] > 0
        assert rep["scaling_efficiency"] > 0
    one = pd.scaling_report(upload_scene(sc, "bvh2", "cpu"), camera, opts, SIDE, SIDE, spp=1)
    assert one["devices"] == 1 and one["scaling_efficiency"] == 1.0  # by construction


def test_cli_mesh_under_torchrun_writes_the_single_process_png(tmp_path):
    """`torchrun --nproc_per_node 2 -m ...cli render --mesh 2x1 --device cpu`
    writes the PNG the single-process render writes (4 spp, bvh2)."""
    args = ["render", TOML, "--device", "cpu", "--width", str(SIDE), "--height", str(SIDE),
            "--depth", str(DEPTH), "--spp", "4", "--accel", "bvh2"]
    out = str(tmp_path / "mesh.png")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "caitlynrenderer_tpu_torch.cli", *args, "--mesh", "2x1", "-o", out]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"torchrun still running after {TIMEOUT_S} s")
    assert proc.returncode == 0, log
    assert "mesh 2x1" in log
    single = str(tmp_path / "single.png")
    assert cli.main([*args, "-o", single]) == 0
    np.testing.assert_array_equal(load_png(out), load_png(single))


@pytest.mark.parametrize("flags", [["--aov", "depth"], ["--resume", "ck.npz"],
                                   ["--turntable", "2"], ["--debug-checks"]])
def test_cli_mesh_refuses_what_it_does_not_carry(flags, tmp_path):
    """--mesh with an option the sharded render does not carry raises
    (the reference's CLI ignores them), before any process group."""
    with pytest.raises(ValueError, match="--mesh with"):
        cli.main(["render", TOML, "--device", "cpu", "--mesh", "1x1", *flags,
                  "-o", str(tmp_path / "x.png")])
    assert not dist.is_initialized()
