"""Command-line interface of the port (counterpart of
caitlynrenderer_tpu/cli.py): progressive render to PNG on one device, with
checkpoint and resume, and inverse rendering.

    python -m caitlynrenderer_tpu_torch.cli render scenes/cornell.toml -o out.png --spp 64
    python -m caitlynrenderer_tpu_torch.cli render scene.toml --resume ckpt.npz
    python -m caitlynrenderer_tpu_torch.cli optimize scenes/cornell_disney.toml \\
        --perturb-roughness 0.35 --optimize-camera -o params.npz

Both run on the card unless given `--device cpu`.  Options the port does
not cover yet raise NotImplementedError instead of being ignored.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


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


def _upload(args, **overrides):
    """(device, ds, camera, options) of the config named on the command
    line: render_setup with `overrides`, then the upload to args.device,
    logged as a "scene" record, the binary-BVH stack sized from the build
    (a deep tree would overflow a fixed one)."""
    from caitlynrenderer_tpu_torch.device import get_device
    from caitlynrenderer_tpu_torch.scene import required_stack, upload_scene
    from caitlynrenderer_tpu_torch.utils import config, metrics

    device = get_device(args.device)
    scene, camera, options = render_setup(config.load_config(args.config),
                                          os.path.dirname(args.config), **overrides)
    t0 = time.perf_counter()
    ds = upload_scene(scene, options.accel, device, max_leaf=options.max_leaf)
    options = options._replace(max_stack=required_stack(ds))
    metrics.log_record("scene", {
        "triangles": scene.num_triangles,
        "lights": scene.lights.count,
        "materials": scene.materials.count,
        "accel": options.accel,
        "build_s": round(time.perf_counter() - t0, 3),
    })
    return device, ds, camera, options


def cmd_render(args) -> int:
    if args.mesh is not None:
        raise NotImplementedError("--mesh: multi-device rendering is not ported yet (ROADMAP A9)")
    if args.turntable is not None:
        raise NotImplementedError("--turntable is not ported yet (ROADMAP A6)")

    from caitlynrenderer_tpu_torch.io.image import save_png
    from caitlynrenderer_tpu_torch.render import progressive
    from caitlynrenderer_tpu_torch.utils import checkpoint

    device, ds, camera, options = _upload(
        args, width=args.width, height=args.height, max_depth=args.depth, accel=args.accel,
        aov=args.aov)
    w, h = options.width, options.height
    spp = args.spp or options.max_samples
    if args.debug_checks:
        # One sample checked for NaN/inf radiance before the accumulation.
        from caitlynrenderer_tpu_torch.render import sampling
        from caitlynrenderer_tpu_torch.utils.debug import checked_render_sample

        checked_render_sample(
            ds, camera, sampling.draw_uniforms(sampling.prng_key(args.seed), w * h,
                                               options.max_depth, device),
            w, h, options)
        print("debug checks: the first sample's radiance is finite")
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
    t0 = time.perf_counter()
    last_ckpt = time.monotonic()
    while state.frame_count < spp:
        state = progressive.render_step(ds, camera, state, w, h, options)
        if args.resume and time.monotonic() - last_ckpt > args.checkpoint_every:
            checkpoint.save_render_state(args.resume, state)
            last_ckpt = time.monotonic()
    if args.resume:
        checkpoint.save_render_state(args.resume, state)
    img = progressive.resolve(state, w, h, options).cpu().numpy()
    seconds = time.perf_counter() - t0
    save_png(args.output, img)
    print(f"wrote {args.output} ({state.frame_count} spp, {w}x{h}, accel {options.accel}, "
          f"{device}, {seconds:.3f} s)")
    return 0


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
                   "triangles, wide above); default: the config's [render] accel")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--aov", default=None, choices=["beauty", "albedo", "normal", "depth"],
                   help="first-hit AOV instead of the beauty pass")
    r.add_argument("--debug-checks", action="store_true",
                   help="check one sample for NaN/inf radiance before rendering")
    r.add_argument("--device", default="cuda", help="torch device (default cuda)")
    r.add_argument("--resume", default=None,
                   help="checkpoint path: resumed from where it exists, saved between "
                   "samples every --checkpoint-every seconds and at the end")
    r.add_argument("--checkpoint-every", type=float, default=60.0)
    r.add_argument("--mesh", default=None, help="not ported yet")
    r.add_argument("--turntable", type=int, default=None, help="not ported yet")
    r.set_defaults(fn=cmd_render)

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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
