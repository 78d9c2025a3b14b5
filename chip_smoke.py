#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):
  1. require CUDA; print the card's name and power limit (nvidia-smi)
  2. build csrc/mt_brute.cu from this checkout with nvcc
  3. kernel vs plain PyTorch twin on the card: cornell primary + bounce
     rays at 700x700, 65536 rays x the 2048-triangle soup, and an edge-case
     set (ragged N, inactive lanes, det = 0 padding rows, rays along edges).
     tri and occlusion must be equal on every ray, t/u/v within 1e-6
     relative (atol 0).
  4. golden: cornell 64x64, 3 bounces, 48 spp, seed 0 through the port's
     render_image against scenes/golden/cornell_64_cpu.npz (mean < 2e-3,
     max < 0.06, red/green walls); kernel launches > 0, twin calls = 0
  5. the main path at the demo size: upload_scene -> render_steps ->
     resolve, 700x700, 3 bounces, 32 spp after one warm-up sample
  6. closest-hit (and any-hit) kernel vs twin times at the path's shapes:
     490k rays x 36 triangles and 65k rays x 2048 triangles
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time
import tomllib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "scenes", "golden", "cornell_64_cpu.npz")
CORNELL_TOML = os.path.join(ROOT, "scenes", "cornell.toml")
DEMO = 700
TOL_REL = 1e-6


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


def event_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(label, mt, o, d, active, tris9, t_max):
    """Kernel vs twin on one input; returns the largest |difference| of
    (t, u, v) and of occlusion (0 or 1)."""
    tk, trk, uk, vk = mt.brute_closest(o, d, active, tris9)
    tt, trt, ut, vt = mt.brute_closest_plain(o, d, active, tris9)
    occ_k = mt.brute_anyhit(o, d, t_max, active, tris9)
    occ_t = mt.brute_anyhit_plain(o, d, t_max, active, tris9)
    torch.cuda.synchronize()
    tri_diff = int((trk != trt).sum())
    occ_diff = int((occ_k != occ_t).sum())
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in ((tk, tt), (uk, ut), (vk, vt)):
        diff = (a - b).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / b.abs().clamp(min=1e-30)).max()))
    hits = int((trt >= 0).sum())
    print(f"  {label}: rays {o.shape[0]} tris {tris9.shape[0]} hits {hits} "
          f"occluded {int(occ_t.sum())} | tri mismatches {tri_diff}, occluded "
          f"mismatches {occ_diff}, max |dt,du,dv| {worst_abs:.3e}, max rel {worst_rel:.3e}")
    check(tri_diff == 0, f"{label}: kernel and twin disagree on tri for {tri_diff} rays")
    check(occ_diff == 0, f"{label}: kernel and twin disagree on occlusion for {occ_diff} rays")
    for a, b, name in ((tk, tt, "t"), (uk, ut, "u"), (vk, vt, "v")):
        check(bool(((a - b).abs() <= TOL_REL * b.abs()).all()),
              f"{label}: {name} differs beyond {TOL_REL} relative")
    return worst_abs, float(occ_diff > 0)


def main():
    # -------------------------------------------------------------- phase 1
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.core import math as cm
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.device import get_device
    from caitlynrenderer_tpu_torch.ops import _build
    from caitlynrenderer_tpu_torch.ops import mt_brute as mt
    from caitlynrenderer_tpu_torch.render import progressive, sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths
    from caitlynrenderer_tpu_torch.scene import upload_scene

    dev = get_device("cuda")

    # -------------------------------------------------------------- phase 2
    phase("2 build")
    info = _build.build("mt_brute", force=True)
    print(f"  built {os.path.relpath(info['path'], ROOT)} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "ptxas" in line:
            print("  " + line.strip())

    # -------------------------------------------------------------- phase 3
    phase("3 kernel vs twin")
    with open(CORNELL_TOML, "rb") as f:
        cfg = tomllib.load(f)

    def setup(width, height):
        return render_setup(cfg, os.path.dirname(CORNELL_TOML), width=width, height=height,
                            max_depth=3, accel="auto")

    scene, camera, options = setup(DEMO, DEMO)
    check(options.accel == "brute", "cornell must take the brute-force path")
    ds = upload_scene(scene, options.accel, dev)
    rng = np.random.default_rng(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    n = DEMO * DEMO
    uni = sampling.pixel_uniforms(
        sampling.sample_key(sampling.prng_key(0), 0),
        torch.arange(n, dtype=torch.int32, device=dev), 3,
    )
    o, d = generate_rays(camera, DEMO, DEMO, uni)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    results = [compare("cornell primary", mt, o, d, act, ds.tris9, cuda(rng.uniform(0, 20, n)))]
    # Bounce rays: from each primary hit, offset off the surface, in a
    # random direction; t_max up to the box size (shadow-ray-like).
    t, tri, _, _ = mt.brute_closest_plain(o, d, act, ds.tris9)
    rows = ds.shade_tab[tri.clamp(min=0).long()]
    nrm = cm.normalize(cm.cross(rows[:, 3:6], rows[:, 6:9]))
    nrm = torch.where((cm.dot(d, nrm) > 0)[:, None], -nrm, nrm)
    hit_o = (o + d * t[:, None] + nrm * cm.RAY_OFFSET).contiguous()
    bd = cm.normalize(cuda(rng.standard_normal((n, 3))))
    results.append(compare("cornell bounce", mt, hit_o, bd, tri >= 0, ds.tris9,
                           cuda(rng.uniform(0, 8, n))))

    soup, _, _ = render_setup({"scene": {"builtin": "soup", "triangles": 2048}}, ROOT)
    soup_tris = upload_scene(soup, "brute", dev).tris9[-2048:].contiguous()
    ns = 65536
    so = cuda(rng.uniform(0, 10, (ns, 3)))
    sd = cm.normalize(cuda(rng.standard_normal((ns, 3))))
    results.append(compare("soup 2048", mt, so, sd, cuda(rng.random(ns) < 0.9, torch.bool),
                           soup_tris, cuda(rng.uniform(0, 12, ns))))

    # Edge cases: N not a multiple of the block, ~10 % inactive lanes,
    # all-zero padding rows (det = 0), rays through vertices and edge
    # midpoints, and rays lying in a triangle's plane along an edge.
    tris_np = ds.tris9.cpu().numpy()
    v0, e1, e2 = tris_np[:, 0:3], tris_np[:, 3:6], tris_np[:, 6:9]
    ne = 3001
    k = rng.integers(0, tris_np.shape[0], ne)
    bary = np.array([[0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5], [0.5, 0.5]], np.float32)
    b = bary[rng.integers(0, len(bary), ne)]
    target = v0[k] + b[:, :1] * e1[k] + b[:, 1:] * e2[k]
    origin = camera.position[None, :] + rng.uniform(-1, 1, (ne, 3)).astype(np.float32)
    along = rng.random(ne) < 0.2
    origin[along] = v0[k][along]
    direction = np.where(along[:, None], e1[k], target - origin)
    edge_tris = torch.cat([ds.tris9, torch.zeros((29, 9), device=dev)]).contiguous()
    results.append(compare("edge cases", mt, cuda(origin), cm.normalize(cuda(direction)),
                           cuda(rng.random(ne) < 0.9, torch.bool), edge_tris,
                           cuda(rng.uniform(0, 30, ne))))
    err = {"closest": max(r[0] for r in results), "anyhit": max(r[1] for r in results)}

    # -------------------------------------------------------------- phase 4
    phase("4 golden")
    _, _, options = setup(64, 64)
    mt.reset_launches()
    img, _ = progressive.render_image(ds, camera, options, spp=48, seed=0)
    img = img.cpu().numpy()
    golden = np.load(GOLDEN)["img"]
    gerr = np.abs(img - golden)
    print(f"  vs golden: mean {gerr.mean():.3e} max {gerr.max():.3e}; launches {mt.launches}")
    check(img.shape == golden.shape, f"golden shape {img.shape} != {golden.shape}")
    check(gerr.mean() < 2e-3 and gerr.max() < 0.06, "golden render out of bounds")
    check(img[32, 4, 0] > img[32, 4, 1], "left wall is not red-dominant")
    check(img[32, 60, 1] > img[32, 60, 0], "right wall is not green-dominant")
    check(mt.launches["closest"] > 0 and mt.launches["anyhit"] > 0, "kernels not launched")
    check(mt.launches["closest_twin"] == 0 and mt.launches["anyhit_twin"] == 0,
          "the twin ran on the card's path")

    # -------------------------------------------------------------- phase 5
    phase("5 main path at 700x700")
    spp = 32
    _, _, options = setup(DEMO, DEMO)
    u0 = sampling.draw_uniforms(sampling.prng_key(0), n, 3, dev)
    o0, d0 = generate_rays(camera, DEMO, DEMO, u0)
    _, stats = trace_paths(ds, o0, d0, u0, options, with_stats=True)
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])
    alive_per_bounce = [int(x) for x in stats["alive_per_bounce"]]

    mt.reset_launches()
    ds_main = upload_scene(scene, options.accel, dev)
    state = progressive.init_state(DEMO, DEMO, 0, dev)
    state = progressive.render_steps(ds_main, camera, state, DEMO, DEMO, options, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = progressive.render_steps(ds_main, camera, state, DEMO, DEMO, options, spp)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    img = progressive.resolve(state, DEMO, DEMO, options)
    torch.cuda.synchronize()
    launches = dict(mt.launches)
    check(launches["closest"] == 3 * (spp + 1) and launches["anyhit"] == 3 * (spp + 1),
          f"unexpected launch counts {launches}")
    check(launches["closest_twin"] == 0 and launches["anyhit_twin"] == 0,
          "the twin ran on the card's path")
    check(bool(torch.isfinite(state.accum).all()), "non-finite radiance")
    check(tuple(img.shape) == (DEMO, DEMO, 3), f"image shape {tuple(img.shape)}")
    check(float(img.mean()) > 0.05, "image is black")
    rays_per_sec = rays_per_sample * spp / elapsed
    ms_per_frame = elapsed / spp * 1e3
    print(f"  rays_per_sample {rays_per_sample} rays_per_sec {rays_per_sec:.1f} "
          f"ms_per_frame {ms_per_frame:.3f} alive_per_bounce {alive_per_bounce} "
          f"mean pixel {float(img.mean()):.4f} launches {launches}")

    # -------------------------------------------------------------- phase 6
    phase("6 kernel and twin times")
    times = {}
    shapes = {"36": (o, d, act, ds.tris9),
              "2048": (so, sd, torch.ones(ns, dtype=torch.bool, device=dev), soup_tris)}
    for tag, (qo, qd, qa, qt) in shapes.items():
        tm = torch.full((qo.shape[0],), 20.0, device=dev)
        row = {
            "closest_plain": event_ms(lambda: mt.brute_closest_plain(qo, qd, qa, qt), 3),
            "closest": event_ms(lambda: mt.brute_closest(qo, qd, qa, qt), 20),
            "anyhit": event_ms(lambda: mt.brute_anyhit(qo, qd, tm, qa, qt), 20),
            "anyhit_plain": event_ms(lambda: mt.brute_anyhit_plain(qo, qd, tm, qa, qt), 3),
        }
        times[tag] = row
        print(f"  {qo.shape[0]} rays x {qt.shape[0]} tris: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items()))

    record = {"kernels": [
        {"name": f"mt_brute_{q}", "route": "cuda", "source": mt.SOURCE,
         "replaces": mt.REPLACES, "launches": launches[q],
         "max_abs_err": err[q],
         "ms": times["36"][q], "plain_ms": times["36"][f"{q}_plain"]}
        for q in ("closest", "anyhit")
    ]}
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
