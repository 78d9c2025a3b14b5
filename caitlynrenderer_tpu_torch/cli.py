"""Command-line interface of the port: progressive render to PNG on one
device (counterpart of the `render` subcommand of caitlynrenderer_tpu/cli.py).

    python -m caitlynrenderer_tpu_torch.cli render scenes/cornell.toml -o out.png --spp 64

Options the port does not cover yet raise NotImplementedError instead of
being ignored.
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


def cmd_render(args) -> int:
    if args.mesh is not None:
        raise NotImplementedError("--mesh: multi-device rendering is not ported yet (ROADMAP A9)")
    if args.turntable is not None:
        raise NotImplementedError("--turntable is not ported yet (ROADMAP A6)")
    if args.resume is not None:
        raise NotImplementedError("--resume (checkpointing) is not ported yet (ROADMAP A6)")

    from caitlynrenderer_tpu_torch.io.image import save_png
    from caitlynrenderer_tpu_torch.utils import config
    from caitlynrenderer_tpu_torch.device import get_device
    from caitlynrenderer_tpu_torch.render import progressive
    from caitlynrenderer_tpu_torch.scene import required_stack, upload_scene

    device = get_device(args.device)
    scene, camera, options = render_setup(
        config.load_config(args.config), os.path.dirname(args.config),
        width=args.width, height=args.height, max_depth=args.depth, accel=args.accel,
        aov=args.aov,
    )
    ds = upload_scene(scene, options.accel, device, max_leaf=options.max_leaf)
    # Size the binary-BVH stack from the build: a deep tree would overflow
    # a fixed one.
    options = options._replace(max_stack=required_stack(ds))
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
    t0 = time.perf_counter()
    state = progressive.render_steps(
        ds, camera, progressive.init_state(w, h, args.seed, device), w, h, options, spp
    )
    img = progressive.resolve(state, w, h, options).cpu().numpy()
    seconds = time.perf_counter() - t0
    save_png(args.output, img)
    print(f"wrote {args.output} ({spp} spp, {w}x{h}, accel {options.accel}, "
          f"{device}, {seconds:.3f} s)")
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
    r.add_argument("--resume", default=None, help="not ported yet")
    r.add_argument("--mesh", default=None, help="not ported yet")
    r.add_argument("--turntable", type=int, default=None, help="not ported yet")
    r.set_defaults(fn=cmd_render)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
