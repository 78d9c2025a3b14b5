#!/usr/bin/env python3
"""Kernel B6 (ops/shade.py) on the card, alone: chip_smoke.py's phase 23
without the rest of the smoke run.

    python3 tools/b6_times.py OUT.json [--reps N]

On the 700x700 cornell under brute force (B1) and grid1m at 1024x1024
under wide (B2), through the Lambert instantiation, the cornell_specular700
cell's box with a mirror and a glass sphere at 700x700 and 8 bounces
(bvh2, B4) through the delta one, and the 700x700 Disney-floor cornell at
4 bounces (B1) through the Disney one: the benchmark cells' scenes and
sizes; on the specular box also B4 against its twins, as phase 23 does.  Bounce 0 on the camera rays, bounce 1
with bounce 0's NEE folded in, and the finishing add of bounce 1's NEE,
each checked against its plain twin bit for bit where the path loop
reads the outputs (the twin returns new tensors, B6 writes the path state
in place) and timed by CUDA events
(N calls, default 30) beside its bound (`chip_smoke.shade_bound`,
`finish_bound`: the bytes each lane's outcome needs over 3.35 TB/s).  Prints the card's name and power limit and one
line per bounce; writes phase 23's record to OUT.json.  Needs an NVIDIA
card; run from the repository's root with PYTHONPATH=.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py of this checkout (phase23 and B6's bounds), loaded by
    path so that another checkout on sys.path cannot shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scenes(dev):
    from caitlynrenderer_tpu_torch.bench import bench_scene
    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.scene import scene_families, upload_scene
    from caitlynrenderer_tpu_torch.utils import config

    cfg = config.load_config(os.path.join(ROOT, "scenes", "cornell.toml"))
    scene, camera, options = render_setup(cfg, os.path.join(ROOT, "scenes"), width=700,
                                          height=700, accel="brute")
    yield "cornell 700x700 brute (B1)", upload_scene(scene, "brute", dev), camera, options
    yield _chip_smoke().specular_run(dev)
    scene, camera = bench_scene("grid1m")
    options = RenderOptions(width=1024, height=1024, max_depth=6, accel="wide",
                            families=scene_families(scene))
    yield "grid1m 1024x1024 wide (B2)", upload_scene(scene, "wide", dev), camera, options
    cfg = config.load_config(os.path.join(ROOT, "scenes", "cornell_disney.toml"))
    scene, camera, options = render_setup(cfg, os.path.join(ROOT, "scenes"), width=700,
                                          height=700, max_depth=4, accel="brute")
    yield "cornell_disney 700x700 brute (B1)", upload_scene(scene, "brute", dev), camera, options


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        rec = _chip_smoke().phase23(dev, card, list(scenes(dev)), args.reps)[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
