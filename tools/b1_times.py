#!/usr/bin/env python3
"""Kernel B1 (csrc/mt_brute.cu) timed on the main path's ray sets, so that
two versions of the kernel can be compared in one run on one card.

    python3 tools/b1_times.py rays SETS.pt
        Make the sets with this checkout and save them: the 700x700 cornell
        frame's primary rays (sample 0, chip_smoke.py's), the integrator's
        bounce and NEE shadow rays from their hits (chip_smoke.bounce_rays
        and shadow_rays, through render/integrator.py's own helpers), and
        65,536 rays into the 2048-triangle soup; with the plain twins'
        answers and each query's bound (chip_smoke.mt_bound).
    python3 tools/b1_times.py time SETS.pt [--root DIR] [--label NAME]
        Time the B1 of the checkout at DIR (default: this one) on them, and
        check its answers against the twins'.  Prints the card's name and
        power limit, then one JSON line per set and query: the device time
        (CUDA events, the host enqueuing ahead of the card), the time per
        call as a caller issues them back to back (host included), the
        bound and the share of it.

Both need an NVIDIA card.  The timing step uses only the wrapper module
`caitlynrenderer_tpu_torch.ops.mt_brute` (brute_closest, brute_anyhit),
which every version of the port has, so DIR may hold an earlier commit:
`mkdir -p DIR && git archive <commit> | tar -x -C DIR`.  Any-hit takes
t_max 20 on every set but the shadow rays, whose t_max is the light's
distance less EPS, as the integrator issues them.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def _chip_smoke():
    """chip_smoke.py of this checkout (its ray helpers, event_ms, mt_bound),
    loaded by path so that another checkout on sys.path cannot shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_sets(path):
    import tomllib

    sys.path.insert(0, ROOT)
    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.core import math as cm
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.ops import mt_brute as mt
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.scene import upload_scene

    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    with open(smoke.CORNELL_TOML, "rb") as f:
        cfg = tomllib.load(f)
    scene, camera, _ = render_setup(cfg, os.path.dirname(smoke.CORNELL_TOML), width=smoke.DEMO,
                                    height=smoke.DEMO, max_depth=3, accel="auto")
    ds = upload_scene(scene, "brute", dev)
    n = smoke.DEMO * smoke.DEMO
    uni = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0),
                                  torch.arange(n, dtype=torch.int32, device=dev), 3)
    o, d = generate_rays(camera, smoke.DEMO, smoke.DEMO, uni)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    _, tri, _, _ = mt.brute_closest_plain(o, d, act, ds.tris9)
    soup, _, _ = render_setup({"scene": {"builtin": "soup", "triangles": 2048}}, ROOT)
    soup_tris = upload_scene(soup, "brute", dev).tris9[-2048:].contiguous()
    rng = np.random.default_rng(6)
    ns = 65536
    so = torch.tensor(rng.uniform(0, 10, (ns, 3)), dtype=torch.float32, device=dev)
    sd = cm.normalize(torch.tensor(rng.standard_normal((ns, 3)), dtype=torch.float32,
                                   device=dev))
    shadow = smoke.shadow_rays(ds, o, d, tri, uni)
    sets = {
        "cornell primary": (o, d, act, ds.tris9, None),
        "cornell bounce": (*smoke.bounce_rays(ds, o, d, tri, uni), ds.tris9, None),
        "cornell shadow": (*shadow[:3], ds.tris9, shadow[3]),
        "soup 2048": (so, sd, torch.ones(ns, dtype=torch.bool, device=dev), soup_tris, None),
    }
    out = {}
    for name, (qo, qd, qa, qt, tm) in sets.items():
        if tm is None:
            tm = torch.full((qo.shape[0],), 20.0, device=dev)
        t_tri = mt.brute_closest_plain(qo, qd, qa, qt)[1]
        t_occ = mt.brute_anyhit_plain(qo, qd, tm, qa, qt)
        out[name] = {
            "o": qo, "d": qd, "active": qa, "tris9": qt, "t_max": tm, "tri": t_tri, "occ": t_occ,
            "bound": {"closest": smoke.mt_bound(qo, qd, qa, qt),
                      "anyhit": smoke.mt_bound(qo, qd, qa, qt, tm)},
        }
        print(f"{name}: {qo.shape[0]} rays ({int(qa.sum())} live) x {qt.shape[0]} tris, "
              f"hits {int((t_tri >= 0).sum())}, occluded {int(t_occ.sum())}, bound "
              f"{out[name]['bound']}", flush=True)
    torch.save({k: {f: (v.cpu() if torch.is_tensor(v) else v) for f, v in s.items()}
                for k, s in out.items()}, path)


def time_sets(path, root, label):
    smoke = _chip_smoke()
    sys.path.insert(0, os.path.abspath(root))
    from caitlynrenderer_tpu_torch.ops import mt_brute as mt

    print(f"{label}: {mt.__file__}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    for name, s in torch.load(path).items():
        qo, qd, qa, qt, tm = (s[k].to(dev) for k in ("o", "d", "active", "tris9", "t_max"))
        tri = mt.brute_closest(qo, qd, qa, qt)[1]
        occ = mt.brute_anyhit(qo, qd, tm, qa, qt)
        torch.cuda.synchronize()
        if not (torch.equal(tri.cpu(), s["tri"]) and torch.equal(occ.cpu(), s["occ"])):
            raise RuntimeError(f"{label}, {name}: the kernel differs from the twin")
        calls = {"closest": lambda: mt.brute_closest(qo, qd, qa, qt),
                 "anyhit": lambda: mt.brute_anyhit(qo, qd, tm, qa, qt)}
        for q, fn in calls.items():
            ms = smoke.event_ms(fn, REPS)
            per_call = smoke.event_ms(fn, REPS, host_ahead=False)
            b_ms, b_by = s["bound"][q]
            print(json.dumps({"label": label, "set": name, "query": q, "rays": qo.shape[0],
                              "live": int(qa.sum()), "tris": qt.shape[0], "ms": ms,
                              "per_call_ms": per_call, "bound_ms": b_ms, "bound_by": b_by,
                              "share": b_ms / ms}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("rays", "time"))
    parser.add_argument("sets", help="file of ray sets (.pt)")
    parser.add_argument("--root", default=ROOT, help="checkout whose B1 is timed")
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("b1_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.mode == "rays":
        make_sets(args.sets)
    else:
        time_sets(args.sets, args.root, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
