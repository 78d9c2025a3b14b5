#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):
  1. require CUDA; print the card's name and power limit (nvidia-smi)
  2. build csrc/mt_brute.cu (B1), csrc/traverse_mega.cu (B2) and
     csrc/traverse_cw8.cu (B3) from this checkout, one nvcc each, started
     together; print ptxas's lines
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
  7. B2 vs its plain twin, closest and any-hit: grid100k primary rays at
     256x256 (the root bench's camera), bounce rays from their hits,
     65536 rays into the 20,000-triangle soup, cornell forced to "wide"
     with 64-triangle groups and with 2-triangle groups (flat boxes), and
     an edge set on the latter (ragged N, ~10 % inactive lanes, rays at
     vertices and along edges, axis-aligned directions, an all-dead
     batch, random og).  tri,
     group and occlusion equal on every ray, t within 1e-6 relative.
  8. B2 vs B1 at grid1m (999,700 triangles): 16384 rays, half aimed at
     triangle centroids; hit or miss equal, t within rtol 5e-4
     (Baldwin-Weber against Moller-Trumbore, tests/test_mega.py's contract)
  9. golden through B2: cornell 64x64, 48 spp, accel "wide", 64-triangle
     groups, within the golden's bounds; B2 launched, B1 and the twins not
 10. the main path on grid100k and grid1m: upload_scene -> render_steps ->
     resolve at 256x256, 4 bounces, 16 spp after one warm-up sample;
     upload seconds, ms/frame, rays/s, live lanes per bounce, launch
     counts, and the split of a sample between sampling, camera and the
     integrator, with B2's share from a torch.profiler trace
 11. B2 vs twin times at grid100k (65536 rays) and B2 vs B1 at grid1m
     (16384 rays)
 12. B3 vs its plain twin, closest and any-hit: cornell "cwbvh" primary and
     bounce rays at 700x700, 65536 rays into the 20,000-triangle soup,
     grid100k primary and bounce rays at 256x256 (the bench camera), and
     the edge set (ragged N, ~10 % inactive lanes, rays at vertices and
     along edges, axis-aligned directions, random og, an all-dead batch,
     an empty scene).  tri, window and occlusion equal on every ray, t
     within 1e-6 relative.
 13. B3 vs B1 at grid1m: 16384 rays, half aimed at triangle centroids; hit
     or miss equal, the same triangle or t within rtol 5e-4, occlusion equal
 14. golden through B3 ("cwbvh"), and through "bvh2" and "sbvh" (plain
     torch walk, no kernel): cornell 64x64, 48 spp, within the golden's
     bounds; for "cwbvh" B3 launched, B1, B2 and the twins not
 15. the cwbvh main path on grid100k and grid1m, as phase 10, B3's share
     from the profiler
 16. B3 vs twin times at grid100k (65536 primary and bounce rays) and B3 vs
     B2 vs B1 at grid1m (16384 rays)
About 3 minutes on one H100, builds included.  The line before the last is
the kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time
import tomllib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "scenes", "golden", "cornell_64_cpu.npz")
CORNELL_TOML = os.path.join(ROOT, "scenes", "cornell.toml")
DEMO = 700
TOL_REL = 1e-6
BENCH = 256  # the root bench's resolution and depth for the large scenes
BENCH_DEPTH = 4
MAIN_SPP = 16


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


def compare_mega(label, mega, o, d, active, wide, t_max, og=None):
    """B2 vs its twin on one input: tri, group and occlusion equal on every
    ray, t within TOL_REL relative.  Returns the largest |dt| and the
    occlusion mismatch (0 or 1)."""
    tk, trk, gk = mega.mega_closest(o, d, active, *wide, og=og)
    tt, trt, gt = mega.mega_closest_plain(o, d, active, *wide)
    occ_k = mega.mega_anyhit(o, d, t_max, active, *wide, og=og)
    occ_t = mega.mega_anyhit_plain(o, d, t_max, active, *wide)
    torch.cuda.synchronize()
    tri_diff = int((trk != trt).sum())
    grp_diff = int((gk != gt).sum())
    occ_diff = int((occ_k != occ_t).sum())
    dt = (tk - tt).abs()
    worst_abs = float(dt.max()) if o.shape[0] else 0.0
    worst_rel = float((dt / tt.abs().clamp(min=1e-30)).max()) if o.shape[0] else 0.0
    print(f"  {label}: rays {o.shape[0]} groups {wide[1].shape[0]} hits {int((trt >= 0).sum())} "
          f"occluded {int(occ_t.sum())} | tri mismatches {tri_diff}, group mismatches "
          f"{grp_diff}, occluded mismatches {occ_diff}, max |dt| {worst_abs:.3e}, "
          f"max rel {worst_rel:.3e}", flush=True)
    check(tri_diff == 0, f"{label}: B2 and twin disagree on tri for {tri_diff} rays")
    check(grp_diff == 0, f"{label}: B2 and twin disagree on group for {grp_diff} rays")
    check(occ_diff == 0, f"{label}: B2 and twin disagree on occlusion for {occ_diff} rays")
    check(bool((dt <= TOL_REL * tt.abs()).all()), f"{label}: t differs beyond {TOL_REL} relative")
    return worst_abs, float(occ_diff > 0)


def compare_cw8(label, cw8, o, d, active, cw, t_max, og=None):
    """B3 vs its twin on one input: tri, window and occlusion equal on every
    ray, t within TOL_REL relative.  Returns the largest |dt| and the
    occlusion mismatch (0 or 1)."""
    tk, trk, wk = cw8.cw8_closest(o, d, active, *cw, og=og)
    tt, trt, wt = cw8.cw8_closest_plain(o, d, active, *cw)
    occ_k = cw8.cw8_anyhit(o, d, t_max, active, *cw, og=og)
    occ_t = cw8.cw8_anyhit_plain(o, d, t_max, active, *cw)
    torch.cuda.synchronize()
    tri_diff = int((trk != trt).sum())
    win_diff = int((wk != wt).sum())
    occ_diff = int((occ_k != occ_t).sum())
    dt = (tk - tt).abs()
    worst_abs = float(dt.max()) if o.shape[0] else 0.0
    worst_rel = float((dt / tt.abs().clamp(min=1e-30)).max()) if o.shape[0] else 0.0
    print(f"  {label}: rays {o.shape[0]} node8s {cw[0].shape[0]} (depth {cw[3]}) hits "
          f"{int((trt >= 0).sum())} occluded {int(occ_t.sum())} | tri mismatches {tri_diff}, "
          f"window mismatches {win_diff}, occluded mismatches {occ_diff}, max |dt| "
          f"{worst_abs:.3e}, max rel {worst_rel:.3e}", flush=True)
    check(tri_diff == 0, f"{label}: B3 and twin disagree on tri for {tri_diff} rays")
    check(win_diff == 0, f"{label}: B3 and twin disagree on window for {win_diff} rays")
    check(occ_diff == 0, f"{label}: B3 and twin disagree on occlusion for {occ_diff} rays")
    check(bool((dt <= TOL_REL * tt.abs()).all()), f"{label}: t differs beyond {TOL_REL} relative")
    return worst_abs, float(occ_diff > 0)


def wide_args(ds):
    from caitlynrenderer_tpu_torch.scene import WIDE_FIELDS

    return [getattr(ds, k) for k in WIDE_FIELDS]


def cw_args(ds):
    return [ds.cw_nodes, ds.cw_planes, ds.cw_bounds, ds.cw_depth]


def edge_rays(ds, camera, rng, ne):
    """Rays at vertices and edge midpoints of the scene's triangles from
    around the camera, 20 % along an edge from its vertex, 10 %
    axis-aligned."""
    tris = ds.tris9.cpu().numpy()
    bary = np.array([[0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5], [0.5, 0.5]], np.float32)
    k = rng.integers(0, tris.shape[0], ne)
    b = bary[rng.integers(0, len(bary), ne)]
    target = tris[k, 0:3] + b[:, :1] * tris[k, 3:6] + b[:, 1:] * tris[k, 6:9]
    origin = camera.position[None, :] + rng.uniform(-1, 1, (ne, 3)).astype(np.float32)
    along = rng.random(ne) < 0.2
    origin[along] = tris[k, 0:3][along]
    direction = np.where(along[:, None], tris[k, 3:6], target - origin)
    axis = rng.random(ne) < 0.1
    sign = rng.choice([-1, 1], (axis.sum(), 1))
    direction[axis] = np.eye(3)[rng.integers(0, 3, axis.sum())] * sign
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    return origin, direction


def bounce_rays(ds, o, d, t, tri, rng, cuda):
    """Rays leaving each hit, offset off the surface, in random directions
    (origins of missing rays stay where they were; those lanes are
    inactive)."""
    from caitlynrenderer_tpu_torch.core import math as cm

    rows = ds.shade_tab[tri.clamp(min=0).long()]
    nrm = cm.normalize(cm.cross(rows[:, 3:6], rows[:, 6:9]))
    nrm = torch.where((cm.dot(d, nrm) > 0)[:, None], -nrm, nrm)
    hit = tri >= 0
    tt = torch.where(hit, t, 0.0)
    hit_o = (o + d * tt[:, None] + nrm * cm.RAY_OFFSET).contiguous()
    bd = cm.normalize(cuda(rng.standard_normal((o.shape[0], 3))))
    return hit_o, bd, hit


# The kernel module and kernel name each large-scene path runs.
PATH_KERNEL = {"wide": ("traverse_mega", "mega_kernel", "B2"),
               "cwbvh": ("traverse_cw8", "cw8_kernel", "B3")}


def main_path(label, scene, camera, options, dev, spp):
    """upload_scene -> render_steps -> resolve, timed after a warm-up
    sample, through the "wide" or "cwbvh" kernel.  Returns the launch
    counts of the timed run's kernels, by module."""
    from caitlynrenderer_tpu.accel.native import native_available
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.ops import mt_brute, traverse_cw8, traverse_mega
    from caitlynrenderer_tpu_torch.render import progressive, sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths
    from caitlynrenderer_tpu_torch.scene import upload_scene

    modules = {"mt_brute": mt_brute, "traverse_mega": traverse_mega,
               "traverse_cw8": traverse_cw8}
    name, kernel, tag = PATH_KERNEL[options.accel]
    w, h, depth = options.width, options.height, options.max_depth
    n = w * h
    t0 = time.perf_counter()
    ds = upload_scene(scene, options.accel, dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    layout = (f"{ds.wb_mega.shape[0]} groups of {ds.wb_mega.shape[2] // 3} columns"
              if options.accel == "wide" else
              f"{ds.cw_nodes.shape[0]} node8s of depth {ds.cw_depth}, "
              f"{ds.cw_planes.shape[0]} windows")
    print(f"  {label}: {scene.num_triangles} triangles, {layout}; upload + build "
          f"{upload_s:.3f} s (native BVH build: {native_available()})", flush=True)

    uni = sampling.draw_uniforms(sampling.prng_key(0), n, depth, dev)
    o, d = generate_rays(camera, w, h, uni)
    _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])
    alive_per_bounce = [int(x) for x in stats["alive_per_bounce"]]

    for m in modules.values():
        m.reset_launches()
    state = progressive.init_state(w, h, 0, dev)
    state = progressive.render_steps(ds, camera, state, w, h, options, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = progressive.render_steps(ds, camera, state, w, h, options, spp)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    img = progressive.resolve(state, w, h, options)
    torch.cuda.synchronize()
    launches = {k: dict(m.launches) for k, m in modules.items()}
    run = launches[name]
    expect = depth * (spp + 1)
    check(run["closest"] == expect and run["anyhit"] == expect,
          f"{label}: unexpected launch counts {launches}")
    check(run["closest_twin"] == 0 and run["anyhit_twin"] == 0,
          f"{label}: the twin ran on the card's path")
    check(all(v == 0 for k, m in launches.items() if k != name for v in m.values()),
          f"{label}: another kernel or twin ran: {launches}")
    check(bool(torch.isfinite(state.accum).all()), f"{label}: non-finite radiance")
    check(tuple(img.shape) == (h, w, 3), f"{label}: image shape {tuple(img.shape)}")
    check(float(img.mean()) > 0.05, f"{label}: image is black")
    print(f"  {label}: rays_per_sample {rays_per_sample} rays_per_sec "
          f"{rays_per_sample * spp / elapsed:.1f} ms_per_frame {elapsed / spp * 1e3:.3f} "
          f"alive_per_bounce {alive_per_bounce} mean pixel {float(img.mean()):.4f} "
          f"launches {launches}", flush=True)

    # Where a sample's time goes: CUDA events around each stage, then the
    # kernel's device time from a profiler trace of two samples.
    key = sampling.sample_key(sampling.prng_key(0), 0)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    stages = {
        "sampling.pixel_uniforms": lambda: sampling.pixel_uniforms(key, ids, depth),
        "camera.generate_rays": lambda: generate_rays(camera, w, h, uni),
        "integrator.trace_paths": lambda: trace_paths(ds, o, d, uni, options),
        "progressive.render_step": lambda: progressive.render_step(
            ds, camera, state, w, h, options),
    }
    split = {k: event_ms(f, 5) for k, f in stages.items()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        progressive.render_steps(ds, camera, state, w, h, options, 2)
        torch.cuda.synchronize()
    k_us = {}
    for evt in prof.key_averages():
        if kernel in evt.key:
            us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
            k_us[evt.key] = (us, evt.count)
    print(f"  {label} ms per sample: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
          flush=True)
    print(f"  {label} {tag} device time over 2 samples (profiler): " + ", ".join(
        f"{k} {us:.1f} us / {c} launches" for k, (us, c) in k_us.items()), flush=True)
    return launches, ds


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
    from caitlynrenderer_tpu_torch.ops import traverse_cw8 as cw8
    from caitlynrenderer_tpu_torch.ops import traverse_mega as mega
    from caitlynrenderer_tpu_torch.bench import bench_scene
    from caitlynrenderer_tpu.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.render import progressive, sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths
    from caitlynrenderer_tpu_torch.scene import required_stack, scene_families, upload_scene

    dev = get_device("cuda")

    # -------------------------------------------------------------- phase 2
    phase("2 build")
    names = ("mt_brute", "traverse_mega", "traverse_cw8")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc each, all at once
        infos = list(pool.map(lambda name: _build.build(name, force=True), names))
    for info in infos:
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

    # -------------------------------------------------------------- phase 7
    phase("7 B2 vs twin")
    grid, grid_cam = bench_scene("grid100k")
    gds = upload_scene(grid, "wide", dev)
    nb = BENCH * BENCH
    uni = sampling.pixel_uniforms(
        sampling.sample_key(sampling.prng_key(0), 0),
        torch.arange(nb, dtype=torch.int32, device=dev), BENCH_DEPTH,
    )
    go, gd = generate_rays(grid_cam, BENCH, BENCH, uni)
    gact = torch.ones(nb, dtype=torch.bool, device=dev)
    gw = wide_args(gds)
    mega_results = [compare_mega("grid100k primary", mega, go, gd, gact, gw,
                                 cuda(rng.uniform(0, 20, nb)))]
    t, tri, _ = mega.mega_closest_plain(go, gd, gact, *gw)
    bo, bd, bact = bounce_rays(gds, go, gd, t, tri, rng, cuda)
    mega_results.append(compare_mega("grid100k bounce", mega, bo, bd, bact, gw,
                                     cuda(rng.uniform(0, 8, nb))))

    soup20k, _ = bench_scene("soup")
    sds = upload_scene(soup20k, "wide", dev)
    mega_results.append(compare_mega(
        "soup 20000", mega, so, sd, cuda(rng.random(ns) < 0.9, torch.bool), wide_args(sds),
        cuda(rng.uniform(0, 12, ns))))

    cds = upload_scene(scene, "wide", dev, wide_group_tris=64)
    cw = wide_args(cds)
    mega_results.append(compare_mega("cornell wide primary", mega, o, d, act, cw,
                                     cuda(rng.uniform(0, 20, n))))
    t, tri, _ = mega.mega_closest_plain(o, d, act, *cw)
    co, cd, cact = bounce_rays(cds, o, d, t, tri, rng, cuda)
    mega_results.append(compare_mega("cornell wide bounce", mega, co, cd, cact, cw,
                                     cuda(rng.uniform(0, 8, n))))

    # Two-triangle groups: each wall quad is its own group with a flat box.
    fds = upload_scene(scene, "wide", dev, wide_group_tris=2)
    fw = wide_args(fds)
    mega_results.append(compare_mega("cornell 2-triangle groups bounce", mega, co, cd, cact, fw,
                                     cuda(rng.uniform(0, 8, n))))

    # Edge set on cornell with flat 2-triangle group boxes: ragged N,
    # ~10 % inactive lanes, rays at vertices and edge midpoints, rays along
    # edges, axis-aligned directions (1/0 = inf in the exit clamp), random
    # og; then an all-dead batch.
    origin, direction = edge_rays(fds, camera, rng, ne)
    og = cuda(rng.integers(0, fds.wb_mega.shape[0], ne), torch.int32)
    mega_results.append(compare_mega(
        "edge cases", mega, cuda(origin), cuda(direction), cuda(rng.random(ne) < 0.9, torch.bool),
        fw, cuda(rng.uniform(0, 30, ne)), og=og))
    dead = torch.zeros(ne, dtype=torch.bool, device=dev)
    mega_results.append(compare_mega("all dead", mega, cuda(origin), cuda(direction), dead, fw,
                                     cuda(rng.uniform(0, 30, ne)), og=og))
    err_b2 = {"closest": max(r[0] for r in mega_results),
              "anyhit": max(r[1] for r in mega_results)}
    del sds, cds, fds

    # -------------------------------------------------------------- phase 8
    phase("8 B2 vs B1 at grid1m")
    grid1m, _ = bench_scene("grid1m")
    mds = upload_scene(grid1m, "wide", dev)
    nm = 16384
    lo = grid1m.vertices.min(axis=0) - 1.0
    hi = grid1m.vertices.max(axis=0) + 1.0
    mo = rng.random((nm, 3)).astype(np.float32) * (hi - lo) + lo
    md = rng.standard_normal((nm, 3)).astype(np.float32)
    half = nm // 2
    mtris = mds.tris9[:, 0:3] + (mds.tris9[:, 3:6] + mds.tris9[:, 6:9]) / 3.0
    cen = mtris[torch.as_tensor(rng.integers(0, grid1m.num_triangles, half), device=dev)]
    md[:half] = cen.cpu().numpy() - mo[:half]
    md /= np.linalg.norm(md, axis=1, keepdims=True)
    mo, md = cuda(mo), cuda(md)
    mact = torch.ones(nm, dtype=torch.bool, device=dev)
    mw = wide_args(mds)
    t2, tri2, _ = mega.mega_closest(mo, md, mact, *mw)
    t1, tri1, _, _ = mt.brute_closest(mo, md, mact, mds.tris9)
    mtmax = cuda(rng.uniform(0, 20, nm))
    occ2 = mega.mega_anyhit(mo, md, mtmax, mact, *mw)
    occ1 = mt.brute_anyhit(mo, md, mtmax, mact, mds.tris9)
    torch.cuda.synchronize()
    hit1, hit2 = tri1 >= 0, tri2 >= 0
    rel = ((t2 - t1).abs() / t1.abs())[hit1]
    print(f"  {nm} rays x {grid1m.num_triangles} tris ({mds.wb_mega.shape[0]} groups): hits "
          f"B1 {int(hit1.sum())} B2 {int(hit2.sum())}, hit/miss mismatches "
          f"{int((hit1 != hit2).sum())}, same tri {int((tri1 == tri2).sum())}, max rel dt "
          f"{float(rel.max()):.3e}; occluded B1 {int(occ1.sum())} B2 {int(occ2.sum())}",
          flush=True)
    check(bool((hit1 == hit2).all()), "B2 and B1 disagree on hit or miss at grid1m")
    check(float(rel.max()) <= 5e-4, "B2 and B1 t differ beyond rtol 5e-4 at grid1m")
    # Occlusion may differ only where t_max lies within that tolerance of the hit.
    near = hit1 & ((t1 - mtmax).abs() <= 5e-4 * t1)
    check(not bool(((occ1 != occ2) & ~near).any()), "B2 and B1 disagree on occlusion at grid1m")

    # -------------------------------------------------------------- phase 9
    phase("9 golden through B2")
    _, _, options = setup(64, 64)
    options = options._replace(accel="wide")
    wds = upload_scene(scene, "wide", dev, wide_group_tris=64)
    mt.reset_launches()
    mega.reset_launches()
    img, _ = progressive.render_image(wds, camera, options, spp=48, seed=0)
    img = img.cpu().numpy()
    gerr = np.abs(img - golden)
    print(f"  vs golden: mean {gerr.mean():.3e} max {gerr.max():.3e}; B2 launches "
          f"{mega.launches}, B1 launches {mt.launches}")
    check(gerr.mean() < 2e-3 and gerr.max() < 0.06, "golden render through B2 out of bounds")
    check(img[32, 4, 0] > img[32, 4, 1] and img[32, 60, 1] > img[32, 60, 0],
          "walls are not red / green dominant")
    check(mega.launches["closest"] > 0 and mega.launches["anyhit"] > 0, "B2 not launched")
    check(mega.launches["closest_twin"] == 0 and mega.launches["anyhit_twin"] == 0,
          "the B2 twin ran on the card's path")
    check(all(v == 0 for v in mt.launches.values()), "B1 or its twin ran on the wide path")

    # ------------------------------------------------------------- phase 10
    phase("10 main path on the large scenes")
    mega_launches = {"closest": 0, "anyhit": 0}
    for label, sc in (("grid100k", grid), ("grid1m", grid1m)):
        opts = RenderOptions(width=BENCH, height=BENCH, max_depth=BENCH_DEPTH, accel="wide",
                             families=scene_families(sc))
        runs, _ = main_path(label, sc, grid_cam, opts, dev, MAIN_SPP)
        for q in mega_launches:
            mega_launches[q] += runs["traverse_mega"][q]

    # ------------------------------------------------------------- phase 11
    phase("11 B2 times")
    tmax = torch.full((nb,), 20.0, device=dev)
    b2_times = {
        "closest": event_ms(lambda: mega.mega_closest(go, gd, gact, *gw), 20),
        "closest_plain": event_ms(lambda: mega.mega_closest_plain(go, gd, gact, *gw), 2),
        "anyhit": event_ms(lambda: mega.mega_anyhit(go, gd, tmax, gact, *gw), 20),
        "anyhit_plain": event_ms(lambda: mega.mega_anyhit_plain(go, gd, tmax, gact, *gw), 2),
        "closest_bounce": event_ms(lambda: mega.mega_closest(bo, bd, bact, *gw), 20),
        "anyhit_bounce": event_ms(lambda: mega.mega_anyhit(bo, bd, tmax, bact, *gw), 20),
    }
    print(f"  grid100k, {nb} rays: " + ", ".join(f"{k} {v:.4f} ms" for k, v in b2_times.items()))
    row = {
        "B2 closest": event_ms(lambda: mega.mega_closest(mo, md, mact, *mw), 20),
        "B1 closest": event_ms(lambda: mt.brute_closest(mo, md, mact, mds.tris9), 3),
        "B2 anyhit": event_ms(lambda: mega.mega_anyhit(mo, md, mtmax, mact, *mw), 20),
        "B1 anyhit": event_ms(lambda: mt.brute_anyhit(mo, md, mtmax, mact, mds.tris9), 3),
    }
    print(f"  grid1m, {nm} rays: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))

    # ------------------------------------------------------------- phase 12
    phase("12 B3 vs twin")
    cwds = upload_scene(scene, "cwbvh", dev)
    cc = cw_args(cwds)
    cw_results = [compare_cw8("cornell cwbvh primary", cw8, o, d, act, cc,
                              cuda(rng.uniform(0, 20, n)))]
    t, tri, _ = cw8.cw8_closest_plain(o, d, act, *cc)
    co, cd, cact = bounce_rays(cwds, o, d, t, tri, rng, cuda)
    cw_results.append(compare_cw8("cornell cwbvh bounce", cw8, co, cd, cact, cc,
                                  cuda(rng.uniform(0, 8, n))))
    s20 = upload_scene(soup20k, "cwbvh", dev)
    cw_results.append(compare_cw8(
        "soup 20000", cw8, so, sd, cuda(rng.random(ns) < 0.9, torch.bool), cw_args(s20),
        cuda(rng.uniform(0, 12, ns))))
    del s20
    g3 = upload_scene(grid, "cwbvh", dev)
    gc = cw_args(g3)
    cw_results.append(compare_cw8("grid100k primary", cw8, go, gd, gact, gc,
                                  cuda(rng.uniform(0, 20, nb))))
    t, tri, _ = cw8.cw8_closest_plain(go, gd, gact, *gc)
    b3o, b3d, b3act = bounce_rays(g3, go, gd, t, tri, rng, cuda)
    cw_results.append(compare_cw8("grid100k bounce", cw8, b3o, b3d, b3act, gc,
                                  cuda(rng.uniform(0, 8, nb))))
    # Edge set on cornell: ragged N, ~10 % inactive lanes, rays at vertices
    # and along edges, axis-aligned directions, random og; an all-dead
    # batch; an empty scene.
    origin, direction = edge_rays(cwds, camera, rng, ne)
    og = cuda(rng.integers(0, cwds.cw_planes.shape[0], ne), torch.int32)
    cw_results.append(compare_cw8(
        "edge cases", cw8, cuda(origin), cuda(direction), cuda(rng.random(ne) < 0.9, torch.bool),
        cc, cuda(rng.uniform(0, 30, ne)), og=og))
    cw_results.append(compare_cw8("all dead", cw8, cuda(origin), cuda(direction), dead, cc,
                                  cuda(rng.uniform(0, 30, ne)), og=og))
    empty = upload_scene(scene._replace(tri_v=scene.tri_v[:0], tri_vn=scene.tri_vn[:0],
                                        tri_vt=scene.tri_vt[:0]), "cwbvh", dev)
    cw_results.append(compare_cw8("empty scene", cw8, cuda(origin), cuda(direction),
                                  cuda(rng.random(ne) < 0.9, torch.bool), cw_args(empty),
                                  cuda(rng.uniform(0, 30, ne))))
    err_b3 = {"closest": max(r[0] for r in cw_results),
              "anyhit": max(r[1] for r in cw_results)}

    # ------------------------------------------------------------- phase 13
    phase("13 B3 vs B1 at grid1m")
    m3 = upload_scene(grid1m, "cwbvh", dev)
    mc = cw_args(m3)
    t3, tri3, _ = cw8.cw8_closest(mo, md, mact, *mc)
    t1, tri1, _, _ = mt.brute_closest(mo, md, mact, m3.tris9)  # the same triangle order
    occ3 = cw8.cw8_anyhit(mo, md, mtmax, mact, *mc)
    occ1 = mt.brute_anyhit(mo, md, mtmax, mact, m3.tris9)
    torch.cuda.synchronize()
    hit1, hit3 = tri1 >= 0, tri3 >= 0
    same = tri1 == tri3
    rel = ((t3 - t1).abs() / t1.abs())[hit1]
    print(f"  {nm} rays x {grid1m.num_triangles} tris ({m3.cw_nodes.shape[0]} node8s, depth "
          f"{m3.cw_depth}): hits B1 {int(hit1.sum())} B3 {int(hit3.sum())}, hit/miss mismatches "
          f"{int((hit1 != hit3).sum())}, same tri {int(same.sum())}, max rel dt "
          f"{float(rel.max()):.3e}; occluded B1 {int(occ1.sum())} B3 {int(occ3.sum())}",
          flush=True)
    check(bool((hit1 == hit3).all()), "B3 and B1 disagree on hit or miss at grid1m")
    check(float(rel.max()) <= 5e-4, "B3 and B1 t differ beyond rtol 5e-4 at grid1m")
    near = hit1 & ((t1 - mtmax).abs() <= 5e-4 * t1)
    check(not bool(((occ1 != occ3) & ~near).any()), "B3 and B1 disagree on occlusion at grid1m")

    # ------------------------------------------------------------- phase 14
    phase("14 golden through B3, bvh2 and sbvh")
    for accel in ("cwbvh", "bvh2", "sbvh"):
        _, _, options = setup(64, 64)
        ads = upload_scene(scene, accel, dev)
        options = options._replace(accel=accel, max_stack=required_stack(ads))
        mt.reset_launches()
        mega.reset_launches()
        cw8.reset_launches()
        img, _ = progressive.render_image(ads, camera, options, spp=48, seed=0)
        img = img.cpu().numpy()
        gerr = np.abs(img - golden)
        print(f"  {accel} vs golden: mean {gerr.mean():.3e} max {gerr.max():.3e}; B3 launches "
              f"{cw8.launches}, B2 {mega.launches}, B1 {mt.launches}", flush=True)
        check(gerr.mean() < 2e-3 and gerr.max() < 0.06, f"golden through {accel} out of bounds")
        check(img[32, 4, 0] > img[32, 4, 1] and img[32, 60, 1] > img[32, 60, 0],
              f"{accel}: walls are not red / green dominant")
        want = 48 * 3 if accel == "cwbvh" else 0
        check(cw8.launches["closest"] == want and cw8.launches["anyhit"] == want,
              f"{accel}: B3 launches {cw8.launches}")
        check(cw8.launches["closest_twin"] == 0 and cw8.launches["anyhit_twin"] == 0,
              f"{accel}: the B3 twin ran on the card's path")
        check(all(v == 0 for m in (mt, mega) for v in m.launches.values()),
              f"{accel}: B1, B2 or their twins ran")

    # ------------------------------------------------------------- phase 15
    phase("15 cwbvh main path on the large scenes")
    cw_launches = {"closest": 0, "anyhit": 0}
    for label, sc in (("grid100k", grid), ("grid1m", grid1m)):
        opts = RenderOptions(width=BENCH, height=BENCH, max_depth=BENCH_DEPTH, accel="cwbvh",
                             families=scene_families(sc))
        runs, _ = main_path(f"{label} cwbvh", sc, grid_cam, opts, dev, MAIN_SPP)
        for q in cw_launches:
            cw_launches[q] += runs["traverse_cw8"][q]

    # ------------------------------------------------------------- phase 16
    phase("16 B3 times")
    b3_times = {
        "closest": event_ms(lambda: cw8.cw8_closest(go, gd, gact, *gc), 20),
        "closest_plain": event_ms(lambda: cw8.cw8_closest_plain(go, gd, gact, *gc), 2),
        "anyhit": event_ms(lambda: cw8.cw8_anyhit(go, gd, tmax, gact, *gc), 20),
        "anyhit_plain": event_ms(lambda: cw8.cw8_anyhit_plain(go, gd, tmax, gact, *gc), 2),
        "closest_bounce": event_ms(lambda: cw8.cw8_closest(b3o, b3d, b3act, *gc), 20),
        "anyhit_bounce": event_ms(lambda: cw8.cw8_anyhit(b3o, b3d, tmax, b3act, *gc), 20),
    }
    print(f"  grid100k, {nb} rays: " + ", ".join(f"{k} {v:.4f} ms" for k, v in b3_times.items()))
    row = {
        "B3 closest": event_ms(lambda: cw8.cw8_closest(mo, md, mact, *mc), 20),
        "B2 closest": event_ms(lambda: mega.mega_closest(mo, md, mact, *mw), 20),
        "B1 closest": event_ms(lambda: mt.brute_closest(mo, md, mact, mds.tris9), 3),
        "B3 anyhit": event_ms(lambda: cw8.cw8_anyhit(mo, md, mtmax, mact, *mc), 20),
        "B2 anyhit": event_ms(lambda: mega.mega_anyhit(mo, md, mtmax, mact, *mw), 20),
        "B1 anyhit": event_ms(lambda: mt.brute_anyhit(mo, md, mtmax, mact, mds.tris9), 3),
    }
    print(f"  grid1m, {nm} rays: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))

    record = {"kernels": [
        {"name": f"mt_brute_{q}", "route": "cuda", "source": mt.SOURCE,
         "replaces": mt.REPLACES, "launches": launches[q],
         "max_abs_err": err[q],
         "ms": times["36"][q], "plain_ms": times["36"][f"{q}_plain"]}
        for q in ("closest", "anyhit")
    ] + [
        {"name": f"mega_{q}", "route": "cuda", "source": mega.SOURCE,
         "replaces": mega.REPLACES, "launches": mega_launches[q],
         "max_abs_err": err_b2[q],
         "ms": b2_times[q], "plain_ms": b2_times[f"{q}_plain"]}
        for q in ("closest", "anyhit")
    ] + [
        {"name": f"cw8_{q}", "route": "cuda", "source": cw8.SOURCE,
         "replaces": cw8.REPLACES, "launches": cw_launches[q],
         "max_abs_err": err_b3[q],
         "ms": b3_times[q], "plain_ms": b3_times[f"{q}_plain"]}
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
