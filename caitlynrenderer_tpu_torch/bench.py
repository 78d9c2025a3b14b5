"""Benchmark harness of the port: prints ONE JSON line with the headline
metric, rays/s on a CUDA card (the keys of the repo-root bench.py, plus
"device" = the card's name).

Headline: closest-hit + any-hit ray queries actually issued per second on
a progressive render: the cornell box (default) or the root bench's large
scenes, each with its camera.  It needs a CUDA device and fails without
one.  The root bench's protocol: `--warmup` launches of `--steps` samples
(the first captures the CUDA graph of render_steps), then 2 launches of
`--steps` samples timed; ms_per_frame is over those 2 x steps samples.
`--spp-per-launch N` splits each of those launches into render_steps
calls of N samples (the rest one at a time).

    python -m caitlynrenderer_tpu_torch.bench [--width N] [--height N]
        [--depth N] [--steps N] [--warmup N] [--spp-per-launch N]
        [--scene cornell|soup|grid100k|grid1m]
        [--accel auto|brute|bvh2|sbvh|wide|cwbvh]
        [--group-tris N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# The root bench.py's documented estimate of reference-class GPU throughput
# on this scene (the reference publishes no numbers).
REFERENCE_RAYS_PER_SEC = 1.0e8


def bench_scene(name: str):
    """(scene, camera) of the root bench.py's scene `name`."""
    from caitlynrenderer_tpu_torch.core.types import make_camera
    from caitlynrenderer_tpu_torch.io import builtin_scenes

    if name == "cornell":
        pos = np.array([2.78, 2.73, 7.5], np.float32)
        return builtin_scenes.cornell_box()[0], make_camera(
            pos, pos + np.array([0, 0, -1.0], np.float32), 40.0)
    if name == "soup":
        return builtin_scenes.random_triangle_soup(20000)[0], make_camera(
            np.array([5.0, 6.0, 25.0], np.float32), np.array([5.0, 5.0, 5.0], np.float32), 45.0)
    # grid100k / grid1m: the terrain framed from above
    scene = builtin_scenes.displaced_grid(resolution=GRID_RESOLUTION[name])[0]
    return scene, make_camera(np.array([5.0, 9.0, 11.0], np.float32),
                              np.array([5.0, 2.0, 5.0], np.float32), 50.0)


GRID_RESOLUTION = {"grid100k": 224, "grid1m": 708}  # ~100k and ~1M triangles
SCENES = ("cornell", "soup", *GRID_RESOLUTION)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--accel", default="auto",
                    choices=["auto", "brute", "bvh2", "sbvh", "wide", "cwbvh"])
    ap.add_argument("--scene", default="cornell", choices=SCENES)
    ap.add_argument("--steps", type=int, default=128,
                    help="samples per launch (2 launches are timed)")
    ap.add_argument("--warmup", type=int, default=1,
                    help="launches of --steps samples before timing")
    ap.add_argument("--spp-per-launch", type=int, default=None,
                    help="samples per render_steps call within a launch of --steps "
                    "(default --steps)")
    ap.add_argument("--group-tris", type=int, default=None,
                    help="wide-BVH group size (default: by triangle count; explicit values "
                    "are used as given)")
    args = ap.parse_args(argv)

    import torch

    from caitlynrenderer_tpu_torch.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.device import get_device
    from caitlynrenderer_tpu_torch.render import progressive, sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths
    from caitlynrenderer_tpu_torch.scene import (
        auto_accel,
        required_stack,
        scene_families,
        upload_scene,
    )

    device = get_device("cuda")
    scene, camera = bench_scene(args.scene)
    accel = auto_accel(scene) if args.accel == "auto" else args.accel

    t_build0 = time.perf_counter()
    options = RenderOptions(width=args.width, height=args.height, max_depth=args.depth,
                            accel=accel, families=scene_families(scene))
    ds = upload_scene(scene, accel, device, max_leaf=options.max_leaf,
                      wide_group_tris=args.group_tris)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build0
    options = options._replace(max_stack=required_stack(ds))

    w, h, depth = args.width, args.height, args.depth
    n = w * h

    # Count the actual ray queries once (instrumented pass).
    uniforms = sampling.draw_uniforms(sampling.prng_key(0), n, depth, device)
    o, d = generate_rays(camera, w, h, uniforms)
    _, stats = trace_paths(ds, o, d, uniforms, options, with_stats=True)
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])

    # Timed section: the production progressive loop, `args.steps` samples
    # a launch (one replay of a CUDA graph unless --spp-per-launch splits
    # it), after warm-up launches of the same length (the first one
    # captures the graph).
    spl = args.steps if args.spp_per_launch is None else max(1, min(args.spp_per_launch,
                                                                    args.steps))

    def launch(state):
        for _ in range(args.steps // spl):
            state = progressive.render_steps(ds, camera, state, w, h, options, spl)
        for _ in range(args.steps % spl):
            state = progressive.render_steps(ds, camera, state, w, h, options, 1)
        return state

    state = progressive.init_state(w, h, 0, device)
    for _ in range(max(args.warmup, 1)):
        state = launch(state)
    torch.cuda.synchronize()
    launches = 2
    t0 = time.perf_counter()
    for _ in range(launches):
        state = launch(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0

    frames = launches * args.steps
    rays_per_sec = rays_per_sample * frames / elapsed
    name = torch.cuda.get_device_name(device)
    result = {
        "metric": "rays/sec/chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REFERENCE_RAYS_PER_SEC, 4),
        "device": name,
        "detail": {
            "scene": args.scene,
            "triangles": int(scene.num_triangles),
            "resolution": [w, h],
            "max_depth": depth,
            "accel": accel,
            "ms_per_frame": round(elapsed / frames * 1e3, 3),
            "rays_per_sample": rays_per_sample,
            "bvh_build_s": round(build_s, 3),
            "device": name,
            "steps_timed": frames,
            "spp_per_launch": spl,
            "alive_per_bounce": [int(x) for x in stats["alive_per_bounce"]],
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
