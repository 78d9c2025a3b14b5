"""Command-line interface of the port (counterpart of
caitlynrenderer_tpu/cli.py): progressive render to PNG, with checkpoint
and resume, tiled ([render] num_tiles_x/num_tiles_y), as a turntable or
sharded over a mesh of ranks; the benchmark; inverse rendering.

    python -m caitlynrenderer_tpu_torch.cli render scenes/cornell.toml -o out.png --spp 64
    python -m caitlynrenderer_tpu_torch.cli render scene.toml --resume ckpt.npz
    python -m caitlynrenderer_tpu_torch.cli render scene.toml --turntable 8 -o frame.png
    torchrun --nproc_per_node 2 -m caitlynrenderer_tpu_torch.cli render scene.toml --mesh 2x1
    python -m caitlynrenderer_tpu_torch.cli benchmark --scene grid100k
    python -m caitlynrenderer_tpu_torch.cli optimize scenes/cornell_disney.toml \\
        --perturb-roughness 0.35 --optimize-camera -o params.npz

Everything runs on the card unless given `--device cpu`.  A combination
of options that a path does not carry raises ValueError instead of being
ignored.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def render_setup(cfg: dict, base_dir: str, **overrides):
    """(scene, camera, options) for a parsed TOML config: the scene and
    camera it names, RenderOptions from its [render] table with `overrides`
    (None values ignored), then accel "auto" resolved by triangle count and
    the shading families the scene's materials use (unless the config
    names them)."""
    from caitlynrenderer_tpu_torch.utils import config
    from caitlynrenderer_tpu_torch.scene import auto_accel, scene_families

    scene, translation = config.scene_from_config(cfg, base_dir)
    camera = config.camera_from_config(cfg, translation)
    options = config.options_from_config(cfg, **overrides)
    if options.accel == "auto":
        options = options._replace(accel=auto_accel(scene))
    if "families" not in cfg.get("render", {}):
        options = options._replace(families=scene_families(scene))
    return scene, camera, options


def _upload(args, device=None, **overrides):
    """(device, ds, camera, options) of the config named on the command
    line: render_setup with `overrides`, then the upload to `device`
    (default args.device), logged as a "scene" record with the seconds of
    each step of the upload (its "upload" record), the binary-BVH stack
    sized from the build (a deep tree would overflow a fixed one)."""
    from caitlynrenderer_tpu_torch.device import get_device
    from caitlynrenderer_tpu_torch.scene import UPLOAD_STEPS, required_stack, upload_scene
    from caitlynrenderer_tpu_torch.utils import config, metrics

    device = get_device(args.device) if device is None else device
    scene, camera, options = render_setup(config.load_config(args.config),
                                          os.path.dirname(args.config), **overrides)
    ds = upload_scene(scene, options.accel, device, max_leaf=options.max_leaf)
    options = options._replace(max_stack=required_stack(ds))
    upload = metrics.last_records["upload"]
    metrics.log_record("scene", {
        "triangles": scene.num_triangles,
        "lights": scene.lights.count,
        "materials": scene.materials.count,
        "accel": options.accel,
        **{k: upload[k] for k in UPLOAD_STEPS},
    })
    return device, ds, camera, options


def turntable_camera(cfg: dict, translation, k: int, frames: int):
    """Camera k of `frames` orbiting the config camera's look-at point about
    the vertical axis, k / frames of a turn from the config's position: the
    reference's turntable camera, which keeps the config's fov and leaves
    focal_dist and aperture at make_camera's defaults.  The [camera] table
    is read here as the reference reads it, since a Camera keeps no look-at
    point."""
    from caitlynrenderer_tpu_torch.core.types import make_camera

    c = cfg.get("camera", {})
    pos = np.asarray(c.get("position", [0.0, 1.0, 4.0]), np.float32)
    look = np.asarray(c.get("look_at", [0.0, 1.0, 0.0]), np.float32)
    if translation is not None:
        pos = pos + translation
        look = look + translation
    rel = pos - look
    ang = 2.0 * np.pi * k / frames
    ca, sa = np.cos(ang), np.sin(ang)
    rot = np.array([rel[0] * ca + rel[2] * sa, rel[1], -rel[0] * sa + rel[2] * ca], np.float32)
    return make_camera(look + rot, look, fov_degrees=float(c.get("fov", 40.0)))


def _refuse(flags) -> None:
    """ValueError naming each combination in `flags` ({description: set?})
    that is set: the render path taken does not carry it."""
    given = [k for k, on in flags.items() if on]
    if given:
        raise ValueError(f"not carried by this render path: {'; '.join(given)}")


def _turntable_frames(args):
    """--turntable's frame count where the render is a turntable (N > 1, as
    the reference's `if args.turntable > 1`), else None: --turntable 1 is a
    still image at -o.  Raises for N < 1."""
    if args.turntable is not None and args.turntable < 1:
        raise ValueError(f"--turntable must be at least 1, not {args.turntable}")
    return args.turntable if args.turntable is not None and args.turntable > 1 else None


def cmd_render(args) -> int:
    if args.mesh is not None:
        return _render_mesh(args)

    from caitlynrenderer_tpu_torch.device import synchronize
    from caitlynrenderer_tpu_torch.io.image import save_png
    from caitlynrenderer_tpu_torch.render import progressive
    from caitlynrenderer_tpu_torch.utils import checkpoint, metrics

    device, ds, camera, options = _upload(
        args, width=args.width, height=args.height, max_depth=args.depth, accel=args.accel,
        aov=args.aov)
    w, h = options.width, options.height
    spp = args.spp or options.max_samples
    spl = max(1, args.spp_per_launch)
    tiled = options.num_tiles_x * options.num_tiles_y > 1
    frames = _turntable_frames(args)
    if frames is not None:
        _refuse({"--turntable with --resume": args.resume,
                 "--turntable with --profile": args.profile,
                 "--turntable with [render] num_tiles_x/num_tiles_y": tiled})
    elif tiled:
        _refuse({"[render] num_tiles_x/num_tiles_y with --resume": args.resume,
                 "[render] num_tiles_x/num_tiles_y with --profile": args.profile})
    if args.debug_checks:
        # One sample checked for NaN/inf radiance before the accumulation.
        from caitlynrenderer_tpu_torch.render import sampling
        from caitlynrenderer_tpu_torch.utils.debug import checked_render_sample

        checked_render_sample(
            ds, camera, sampling.draw_uniforms(sampling.prng_key(args.seed), w * h,
                                               options.max_depth, device),
            w, h, options)
        metrics.log_record("debug_checks", {"finite": True})
        print("debug checks: the first sample's radiance is finite")

    t0 = time.perf_counter()
    if frames is not None:
        # The camera moves every frame, so every frame restarts the
        # accumulation (the reference's interactive loop, offline).
        from caitlynrenderer_tpu_torch.utils import config

        cfg = config.load_config(args.config)
        translation = config.scene_from_config(cfg, os.path.dirname(args.config))[1]
        base, ext = os.path.splitext(args.output)
        state = progressive.init_state(w, h, args.seed, device)
        for k in range(frames):
            cam_k = turntable_camera(cfg, translation, k, frames)
            state = progressive.reset(state)
            while state.frame_count < spp:
                chunk = min(spl, spp - state.frame_count)
                state = progressive.render_steps(ds, cam_k, state, w, h, options, chunk)
            path = f"{base}_{k:03d}{ext}"
            save_png(path, progressive.resolve(state, w, h, options).cpu().numpy())
            print(f"wrote {path} ({spp} spp, frame {k + 1}/{frames})")
        return 0

    if tiled:
        from caitlynrenderer_tpu_torch.render.tiled import render_image_tiled

        img = render_image_tiled(ds, camera, options, spp=spp, seed=args.seed).cpu().numpy()
        save_png(args.output, img)
        print(f"wrote {args.output} ({spp} spp, {w}x{h} in {options.num_tiles_x}x"
              f"{options.num_tiles_y} tiles, accel {options.accel}, {device}, "
              f"{time.perf_counter() - t0:.3f} s)")
        return 0

    if args.resume and os.path.exists(args.resume):
        # The saved state carries its base key: the samples continue its
        # sequence, whatever --seed says.
        state = checkpoint.load_render_state(args.resume, device)
        if tuple(state.accum.shape) != (w * h, 3):
            raise ValueError(f"{args.resume} accumulates {state.accum.shape[0]} pixels, "
                             f"not the {w}x{h} of this render")
        print(f"resumed at {state.frame_count} spp")
    else:
        state = progressive.init_state(w, h, args.seed, device)
    rays_per_sample = _rays_per_sample(ds, camera, options, args.seed, device)
    with metrics.profile_trace(args.profile, progressive.phase_maps):
        timer = metrics.StepTimer()
        last_ckpt = time.monotonic()
        last_logged = 0
        log_every = max(spp // 10, 1)
        while state.frame_count < spp:
            # spl samples a launch, the tail one at a time.  With --resume the
            # chunk is halved until one launch takes about --checkpoint-every
            # at the pace so far (a power of two, so few graphs are captured):
            # checkpoints fall between launches.
            chunk = spl if spp - state.frame_count >= spl else 1
            if args.resume and chunk > 1 and timer.counts.get("samples", 0) > 0:
                s_per_sample = timer.spans.get("step", 0.0) / timer.counts["samples"]
                budget = max(1, int(args.checkpoint_every / max(s_per_sample, 1e-9)))
                while chunk > budget and chunk > 1:
                    chunk //= 2
            with timer.span("step"):
                state = progressive.render_steps(ds, camera, state, w, h, options, chunk)
                synchronize(device)
            timer.count("samples", chunk)
            timer.count("rays", rays_per_sample * chunk)
            if args.resume and time.monotonic() - last_ckpt > args.checkpoint_every:
                checkpoint.save_render_state(args.resume, state)
                last_ckpt = time.monotonic()
            # Logged where the count crosses the next tenth of spp (it moves in
            # chunks, so a multiple of spp / 10 may never be hit).
            if state.frame_count // log_every > last_logged // log_every:
                last_logged = state.frame_count
                metrics.log_record("progress", {"spp": state.frame_count, **timer.summary()})
    if args.resume:
        checkpoint.save_render_state(args.resume, state)
    img = progressive.resolve(state, w, h, options).cpu().numpy()
    seconds = time.perf_counter() - t0
    save_png(args.output, img)
    print(f"wrote {args.output} ({state.frame_count} spp, {w}x{h}, accel {options.accel}, "
          f"{device}, {seconds:.3f} s)")
    return 0


def _rays_per_sample(ds, camera, options, seed: int, device) -> int:
    """The closest-hit and any-hit queries one sample issues (an
    instrumented pass of the seed's first uniforms), for the rays counted
    in the progress records; logged as a "rays" record with the live lanes
    entering each bounce's closest-hit query, those shading their hit with
    the Disney BRDF, those shading it with a mirror or glass, those that
    miss and take the environment map, those whose albedo the texture
    atlas gives and each bounce's any-hit candidates."""
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths
    from caitlynrenderer_tpu_torch.utils import metrics

    w, h = options.width, options.height
    uni = sampling.draw_uniforms(sampling.prng_key(seed), w * h, options.max_depth, device)
    o, d = generate_rays(camera, w, h, uni)
    _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
    rays = {k: int(stats[k]) for k in ("rays_closest", "rays_anyhit")}
    metrics.log_record("rays", {"rays": w * h, **rays, **{
        k: stats[k].tolist() for k in ("alive_per_bounce", "disney_per_bounce",
                                       "specular_per_bounce", "sky_per_bounce",
                                       "textured_per_bounce", "anyhit_per_bounce")}})
    return rays["rays_closest"] + rays["rays_anyhit"]


def _render_mesh(args) -> int:
    """`render --mesh DPxSP|auto`: one rank of the sharded render, each
    rank a process (torchrun), pixels over dp, sample streams over sp; the
    image written by rank 0 with a "mesh_render" record.  A config with
    tiles shards its tile grid instead of pixel rows."""
    import torch.distributed as dist

    from caitlynrenderer_tpu_torch.device import synchronize
    from caitlynrenderer_tpu_torch.io.image import save_png
    from caitlynrenderer_tpu_torch.parallel import render as pr
    from caitlynrenderer_tpu_torch.parallel.distributed import (
        assemble_image,
        init_distributed,
        make_multihost_mesh,
        rank_device,
    )
    from caitlynrenderer_tpu_torch.parallel.mesh import make_mesh
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.utils import metrics

    _refuse({"--mesh with --aov": args.aov not in (None, "beauty"),
             "--mesh with --resume": args.resume,
             "--mesh with --turntable": _turntable_frames(args) is not None,
             "--mesh with --debug-checks": args.debug_checks,
             "--mesh with --profile": args.profile})
    device = rank_device(args.device)
    rank, world = init_distributed(device=device)
    try:
        if args.mesh == "auto":
            mesh = make_multihost_mesh()
        else:
            dp_s, _, sp_s = args.mesh.lower().partition("x")
            mesh = make_mesh((int(dp_s), int(sp_s or 1)))
        _, ds, camera, options = _upload(args, device=device, width=args.width,
                                         height=args.height, max_depth=args.depth,
                                         accel=args.accel)
        w, h = options.width, options.height
        spp = args.spp or options.max_samples
        if spp % mesh.sp:
            raise ValueError(f"--spp {spp} is not a multiple of the mesh's sp = {mesh.sp} "
                             "(each step adds sp samples)")
        steps = spp // mesh.sp
        timer = metrics.StepTimer()
        tiles = (options.num_tiles_x, options.num_tiles_y)
        if tiles[0] * tiles[1] > 1:
            order, _ = pr.tile_pixel_order(w, h, *tiles, mesh.dp)
            ts = pr.init_tiled_state(mesh, order, device)
            accum, base_key = ts.accum, sampling.prng_key(args.seed)
            for f in range(steps):
                with timer.span("step"):
                    accum = pr.sharded_render_step_tiled(ds, camera, accum, ts.order, f, base_key,
                                                         mesh, w, h, options)
                    synchronize(device)
                timer.count("samples", mesh.sp)
            img = pr.gather_image_tiled(accum, ts.order, steps, mesh, w, h, options)
            img = img.cpu().numpy()
        else:
            state = pr.init_sharded_state(mesh, w, h, args.seed, device)
            for _ in range(steps):
                with timer.span("step"):
                    state = pr.sharded_render_step(ds, camera, state, mesh, w, h, options)
                    synchronize(device)
                timer.count("samples", mesh.sp)
            img = assemble_image(state, mesh, w, h, options)
        if rank == 0:
            save_png(args.output, img)
            metrics.log_record("mesh_render", {"mesh": mesh.shape, "spp": spp,
                                               "tiles": list(tiles), **timer.summary()})
            print(f"wrote {args.output} ({spp} spp, mesh {mesh.dp}x{mesh.sp}, {w}x{h}, "
                  f"accel {options.accel}, {device})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def cmd_benchmark(args) -> int:
    """Runs `python -m caitlynrenderer_tpu_torch.bench` with the remaining
    arguments (one JSON line; needs a CUDA card)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return subprocess.call([sys.executable, "-m", "caitlynrenderer_tpu_torch.bench",
                            *args.bench_args], env=env)


def cmd_optimize(args) -> int:
    """Inverse rendering: against a PNG target, or, without one, against a
    self-target rendered from the true parameters, which are then
    perturbed and recovered (BASELINE config #5 with
    --perturb-roughness and --optimize-camera)."""
    import numpy as np
    import torch

    from caitlynrenderer_tpu_torch.core.types import LAMBERT_TYPES
    from caitlynrenderer_tpu_torch.grad.inverse import optimize
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import render_sample
    from caitlynrenderer_tpu_torch.utils import checkpoint, metrics

    device, ds, camera, options = _upload(args, width=args.width, height=args.height,
                                          max_depth=args.depth)
    w, h = options.width, options.height
    if args.target:
        from caitlynrenderer_tpu_torch.io.image import load_png

        # The PNG is a display image: undo its gamma for a rough radiance
        # target, rows flipped to the renderer's bottom-up order.
        img = load_png(args.target) ** 2.2
        if img.shape != (h, w, 3):
            raise ValueError(f"target {args.target} is {img.shape[1]}x{img.shape[0]}, "
                             f"the render {w}x{h}")
        target = torch.tensor(np.ascontiguousarray(img[::-1]).reshape(-1, 3), device=device)
    else:
        key = sampling.prng_key(0)
        target = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
        with torch.no_grad():
            for i in range(args.target_spp):
                uni = sampling.draw_uniforms(sampling.fold_in(key, i), w * h, options.max_depth,
                                             device)
                target = target + render_sample(ds, camera, uni, w, h, options)
        target = target / args.target_spp

    # Only the perturbed groups are optimized: a group at its truth adds
    # nothing but Monte-Carlo noise to walk on.
    mats = ds.scene.materials
    params, truth, disney_rows = {}, {}, None
    if args.perturb != 1.0:
        params["albedo"] = torch.cat([mats.albedo[:, :3] * args.perturb, mats.albedo[:, 3:]], 1)
        truth["albedo"] = mats.albedo
    if args.perturb_roughness:
        # Only the rows of the Disney-shaded materials carry a roughness
        # gradient.
        lambert = torch.tensor([int(t) for t in LAMBERT_TYPES], device=device)
        disney_rows = ~torch.isin(mats.albedo[:, 3].to(torch.int64), lambert)
        rough = torch.clamp(mats.disney[:, 0] + args.perturb_roughness, 0.02, 0.98)
        params["disney"] = torch.cat([torch.where(disney_rows, rough, mats.disney[:, 0])[:, None],
                                      mats.disney[:, 1:]], 1)
        truth["disney"] = mats.disney
    if args.optimize_camera:
        params["cam_position"] = torch.tensor(camera.position, device=device)
        truth["cam_position"] = params["cam_position"]

    def log_step(i, loss, _params):
        if i % 10 == 0:
            metrics.log_record("opt", {"step": i, "loss": round(loss, 6)})

    params, losses = optimize(ds, camera, target, params, w, h, options, steps=args.steps,
                              lr=args.lr, seed=args.seed, callback=log_step)
    checkpoint.save_params(args.output, params)
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; wrote {args.output}")
    if not args.target:
        # The self-target knows the truth: the recovery error per group.
        for k, true_value in truth.items():
            err = (params[k] - true_value).abs()
            if k == "disney":
                err = torch.where(disney_rows, err[:, 0], 0.0)
            err = float(err.max())
            metrics.log_record("opt_final", {"param": k, "max_err": round(err, 5)})
            print(f"  {k}: max |err| vs truth = {err:.5f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="caitlynrenderer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="progressive render to PNG")
    r.add_argument("config")
    r.add_argument("-o", "--output", default="render.png")
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--accel", default=None,
                   help="brute, bvh2, sbvh, wide, cwbvh, or auto (brute up to 2048 "
                   "triangles, bvh2 above); default: the config's [render] accel; on the "
                   "card bvh2 and sbvh take a tree up to 127 levels deep")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--aov", default=None, choices=["beauty", "albedo", "normal", "depth"],
                   help="first-hit AOV instead of the beauty pass")
    r.add_argument("--debug-checks", action="store_true",
                   help="check one sample for NaN/inf radiance before rendering")
    r.add_argument("--device", default="cuda", help="torch device (default cuda)")
    r.add_argument("--resume", default=None,
                   help="checkpoint path: resumed from where it exists, saved between "
                   "launches every --checkpoint-every seconds and at the end")
    r.add_argument("--checkpoint-every", type=float, default=60.0)
    r.add_argument("--spp-per-launch", type=int, default=64,
                   help="samples per launch from the host: on the card one replay of a CUDA "
                   "graph of that many samples, on the CPU a loop (values < 1 read as 1); "
                   "with --resume the chunk is halved until a launch takes about "
                   "--checkpoint-every, and checkpoints fall between launches; the turntable "
                   "chunks each frame by it; tiles and --mesh ignore it")
    r.add_argument("--mesh", default=None, metavar="DPxSP|auto",
                   help="sharded render, one rank per process under torchrun (pixels over "
                   "dp, sample streams over sp; --spp a multiple of sp), e.g. "
                   "torchrun --nproc_per_node 4 -m caitlynrenderer_tpu_torch.cli render "
                   "scene.toml --mesh 2x2; not with --aov, --resume, --turntable N > 1 or "
                   "--debug-checks")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the progressive loop with torch.profiler into DIR/trace.json "
                   "(Chrome trace format): the program's caitlyn.* phase spans and the card's "
                   "kernels on one clock, a graph replay's kernels given their phases; logs a "
                   "profile record of device ms by phase")
    r.add_argument("--turntable", type=int, default=None, metavar="N",
                   help="N > 1 frames orbiting the look-at point, each restarting the "
                   "accumulation; writes OUTPUT_000.png ... (N = 1: the still image at -o)")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("benchmark", add_help=False,
                       help="python -m caitlynrenderer_tpu_torch.bench with the remaining "
                       "arguments (--help for its own)")
    b.set_defaults(fn=cmd_benchmark)

    o = sub.add_parser("optimize", help="inverse rendering")
    o.add_argument("config")
    o.add_argument("-o", "--output", default="params.npz")
    o.add_argument("--target", default=None, help="target PNG (else the self-target demo)")
    o.add_argument("--target-spp", type=int, default=8)
    o.add_argument("--steps", type=int, default=100)
    o.add_argument("--lr", type=float, default=2e-2)
    o.add_argument("--perturb", type=float, default=0.5,
                   help="scale the albedo RGB by this and recover it (1: albedo not optimized)")
    o.add_argument("--perturb-roughness", type=float, default=0.0,
                   help="offset the Disney roughness by this and recover it")
    o.add_argument("--optimize-camera", action="store_true")
    o.add_argument("--width", type=int, default=64)
    o.add_argument("--height", type=int, default=64)
    o.add_argument("--depth", type=int, default=None)
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--device", default="cuda", help="torch device (default cuda)")
    o.set_defaults(fn=cmd_optimize)

    # Everything after "benchmark" is the bench's, its --help included.
    args, rest = ap.parse_known_args(argv)
    if args.cmd != "benchmark" and rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.bench_args = rest
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
