"""The control of the output check: the configuration's plain reference
put in the program's place, its arithmetic in bfloat16 (the precision
below the configuration's float32; each sample's radiance is added in
float32), held against the float32 reference by the numbers and limits
of the check.  A sound check reads it as not correct.

    python3 -m cellbench.control --workload <cell> --seeds 1,2,3 \
        --samples <accumulated> [--display-samples <of a display image>]

`--samples` is the accumulation a run compares (its samples in the
current image) and `--display-samples` that of the display image it
compares (1024 for a completed image); both at the cell's pixels.  Needs
no program; runs on the first CUDA card, or the CPU without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cellbench import check, manifest
from cellbench.scenes import builtin


def control_numbers(cfg: dict, seed: int, samples: int, display_samples: int, device,
                    dtype=torch.bfloat16) -> dict:
    """The check's numbers of the reference in `dtype` against the float32
    reference, for image 0 of `seed`."""
    sc = builtin.make_scene(cfg["scene"])
    cam = builtin.make_camera(**cfg["camera"])
    ref = check.Reference(cfg, sc, cam, seed, device)
    low = check.Reference(cfg, sc, cam, seed, device, dtype)
    answers = {}
    if samples:
        answers["accum"] = (0, samples, low.accum(0, samples))
    if display_samples:
        w, h = cfg["width"], cfg["height"]
        img = torch.zeros((h, w, 3)).numpy()
        img[h - 1 - ref.pixels // w, ref.pixels % w] = low.display(0, display_samples)
        answers["display"] = (0, display_samples, img)
    return check.compare(ref, answers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--samples", type=int, required=True)
    ap.add_argument("--display-samples", type=int, default=0)
    args = ap.parse_args(argv)
    bench = manifest.load()
    cfg = manifest.config(bench, manifest.workload(bench, args.workload)["config"])
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        values = control_numbers(cfg, seed, args.samples, args.display_samples, device)
        correct, rows = check.judge(values, cfg["check"]["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "samples": args.samples,
                          "display_samples": args.display_samples, "correct": correct,
                          "numbers": {k: [v, lim] for k, v, lim in rows},
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
