#!/usr/bin/env python3
"""Value-and-grad against forward times of one checkout on the card, so that
two versions of the gradient path can be compared in one run on one card.

    python3 tools/grad_times.py [--root DIR] [--label NAME]

Runs chip_smoke.py's phase-18c measurement (`grad_overhead`: one
render_sample under no_grad against make_loss and backward for the
albedo, Disney and camera-position groups, 5 repetitions after 2 warm-ups,
peak memory, one profiled call of each: kernels launched, device busy) with
the package and the chip_smoke.py of the checkout at DIR (default: this
one), on the Disney floor at 700x700, 3 bounces (B1), and grid100k at
256x256, 4 bounces through wide (B2), also with the vertices.  Prints the
card's name and power limit, then one JSON line per case.

Needs an NVIDIA card and a checkout whose chip_smoke.py has
`grad_overhead` (this PR's or later).  DIR may hold another version of
the port: `mkdir -p DIR && git archive <commit> | tar -x -C DIR` under a
git-ignored directory; run parent, change, change, parent.
"""

import argparse
import json
import os
import subprocess
import sys
import tomllib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("grad_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.scene import upload_scene

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"{args.label} {root}", flush=True)
    dev = torch.device("cuda")
    scenes = os.path.join(root, "scenes")
    with open(os.path.join(scenes, "cornell.toml"), "rb") as f:
        cfg = tomllib.load(f)
    cfg = {**cfg, "scene": {**cfg["scene"], "floor": "disney"}}
    grid = {"scene": {"builtin": "grid", "resolution": 224},
            "camera": {"position": [5.0, 9.0, 11.0], "look_at": [5.0, 2.0, 5.0], "fov": 50.0}}
    cases = [("Disney floor 700x700, B1", cfg, 700, 3, "auto", [cs.GRAD_KEYS]),
             ("grid100k 256x256, wide (B2)", grid, 256, 4, "wide",
              [cs.GRAD_KEYS, cs.GRAD_KEYS + ("vertices",)])]
    for label, c, side, depth, accel, key_sets in cases:
        sc, cam, opts = render_setup(c, scenes, width=side, height=side, max_depth=depth,
                                     accel=accel)
        ds = upload_scene(sc, opts.accel, dev)
        for i, keys in enumerate(key_sets):
            rec = cs.grad_overhead(f"{args.label} {label}", ds, cam, opts, keys, 5, 2,
                                   split=i == 0)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
