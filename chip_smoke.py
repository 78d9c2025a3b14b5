#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):
  1. require CUDA; print the card's name and power limit (nvidia-smi)
  2. build csrc/mt_brute.cu (B1), csrc/traverse_mega.cu (B2),
     csrc/traverse_cw8.cu (B3), csrc/traverse_bvh.cu (B4),
     csrc/threefry.cu (B5) and csrc/shade.cu (B6) from this checkout, one
     nvcc each, started together; print ptxas's lines (registers, stack, spills)
  3. kernel vs plain PyTorch twin on the card: cornell primary, bounce
     and shadow rays at 700x700, 65536 rays x the 2048-triangle soup (4 lanes per
     ray), an edge-case set (ragged N, inactive lanes, det = 0 padding rows,
     rays along edges) and tie sets (the soup twice, stacked and
     interleaved, at 65536, 16384 and 1001 rays: 4, 16 and 32 lanes per
     ray).  tri and occlusion must be equal on every ray, t/u/v within 1e-6
     relative (atol 0).
  4. golden: cornell 64x64, 3 bounces, 48 spp, seed 0 through the port's
     render_image (6 launches of 8 samples, CUDA graph replays) against
     scenes/golden/cornell_64_cpu.npz (mean < 2e-3, max < 0.06, red/green
     walls); kernel launches > 0, twin calls = 0
  5. the main path at the demo size: upload_scene -> render_steps ->
     resolve, 700x700, 3 bounces, one launch of 32 spp (a graph's replay)
     after a warm-up launch of the same length (the capture, with its
     warm-up sample); B5 draws every sample (its launches are the kernels
     line's), its twin never; B6 shades every bounce (3 launches and one
     finishing launch a sample, the kernels line's) and its twins never
     run
  6. closest-hit (and any-hit) kernel vs twin times at the path's shapes:
     490k primary, bounce and shadow rays x 36 triangles (the shadow rays
     are the main path's any-hit, and the JSON record's) and 65k rays x
     2048 triangles, each beside its bound (`mt_bound`: the operations up to the
     test that rejects each pair); the kernel also per call as a caller
     issues them, host included (`event_ms`: every other kernel time is
     the device's, the host running ahead)
  7. B2 vs its plain twin, closest and any-hit: grid100k primary rays at
     256x256 (the root bench's camera), bounce rays from their hits (the
     integrator's continuation rays, here and in every phase), scattered
     rays (uniform over the sphere from the same hits, half into their
     own surface), 65536 rays into the 20,000-triangle soup, cornell forced to "wide"
     with 64-triangle groups and with 2-triangle groups (flat boxes), and
     an edge set on the latter (ragged N, ~10 % inactive lanes, rays at
     vertices and along edges, axis-aligned directions, an all-dead
     batch).  tri,
     group and occlusion equal on every ray, t within 1e-6 relative.
  8. B2 vs B1 at grid1m (999,700 triangles): 16384 rays, half aimed at
     triangle centroids; hit or miss equal, t within rtol 5e-4
     (Baldwin-Weber against Moller-Trumbore, tests/test_mega.py's contract)
 8b. grid1m at the main path's shapes: the bench camera's 65536 primary
     rays at 256x256 and their bounce rays.  B2 and B3 against B1 on every
     ray under phase 8's contract (`check_vs_b1`: a bounce ray on B1's
     triangle may also differ in t by COND_ULPS ulps of the scene's
     coordinates over |cos|, t's rounding at grazing angles; edge-crack
     rays pass only where the kernel equals its twin), and B2
     against its twin bit for bit on a 4096-ray subset (every 16th ray)
  9. golden through B2: cornell 64x64, 48 spp, accel "wide", 64-triangle
     groups, within the golden's bounds; B2 launched, B1 and the twins not
 10. the main path on grid100k and grid1m: upload_scene -> render_steps ->
     resolve at 256x256, 4 bounces, one launch of 16 spp after a warm-up
     launch of the same length (as phase 5); upload seconds, ms/frame,
     rays/s, live lanes per bounce, launch counts, and the split of an
     eager sample (render_step) between sampling, camera and the
     integrator, with B2's share from a torch.profiler trace.  Here and
     in every main path (phases 15, 17, 21): B6's launches max_depth and
     one finishing launch a sample where `fused_shading` holds (Lambert
     with any of Disney, mirror and glass, no texture, no sky), none
     elsewhere
 11. B2 vs twin times at grid100k (65536 rays) and B2 vs B1 at grid1m
     (16384 rays); then B2 and B3, closest and any-hit, on four ray sets
     (grid100k and grid1m, primary and bounce, 65536 rays each) in one
     call, with each one's bound (B2's from the groups each ray must
     visit, `mega_bound`; B3's from its stats variant's oracle walk,
     `cw8_bound`) and the share of it reached, and both stats variants:
     per-ray counts (mean, p50, p99, max) and the work each walk did, at
     the bound's rates, over the bound
 12. B3 vs its plain twin, closest and any-hit: cornell "cwbvh" primary and
     bounce rays at 700x700, 65536 rays into the 20,000-triangle soup,
     grid100k primary, bounce and scattered rays at 256x256 (the bench camera), and
     the edge set (ragged N, ~10 % inactive lanes, rays at vertices and
     along edges, axis-aligned directions, an all-dead batch,
     an empty scene).  tri, window and occlusion equal on every ray, t
     within 1e-6 relative; on every set B3's stats variant, plain and
     seeded with the closest t, returns the plain launch's answers.
 13. B3 vs B1 at grid1m: phase 8's rays and contract
 14. golden through B3 ("cwbvh") and B4 ("bvh2" and "sbvh"), 8 samples a
     launch (render_image's CUDA graph replays): cornell 64x64, 48 spp,
     within the golden's bounds; the path's kernel launched (48 samples
     and each capture's warm-up sample) x 3 a query, its twin and the
     other kernels not
 15. the cwbvh main path on grid100k and grid1m, as phase 10, B3's share
     from the profiler
 16. B3 vs twin times at grid100k (65536 primary and bounce rays) and B3 vs
     B2 vs B1 at grid1m (16384 rays)
 17. shading on the card: (a) the main path (as phase 10, one launch of 16
     spp after a warm-up launch; ms/frame, rays/s, launch counts; the kernel launched,
     its twin not, radiance finite and not black) on cornell 700x700, 3
     bounces, with a Disney, a mirror and a glass floor through auto -> B1
     (the Disney one, and the Lambert one beside it, with phase 10's split
     of a sample), on
     scenes/cornell.toml as written (its accel "wide": B2), and on
     grid100k lit by the sky ([scene] env = "sky", use_env_map) at
     256x256, 4 bounces, through B2; (b) B1, B2 (cornell, 64-triangle
     groups) and B3 (cornell cwbvh) against their twins on the
     integrator's new rays: the glass floor's continuation rays (over
     1000 of them refracted, leaving 2 RAY_OFFSET below the floor) and
     shadow rays (none from the floor), and the continuation rays of a
     Disney floor with clearcoat 1 (over 1000 in each of the diffuse, GGX
     and clearcoat lobes), phase 3's contract; (c) one sample at 128x128
     of the Disney floor, the glass floor and the textured OBJ of
     tests/test_textures.py (written to a temporary directory), the same
     uniforms on the card (B1) and on the CPU (the twins): at most 0.5 %
     of pixels beyond 1e-4 and the means within rtol 1e-3; (d) the
     albedo, normal and depth AOVs of cornell at 700x700 through B1, two
     runs of 2 samples equal bit for bit, one closest-hit launch a sample
 18. gradients on the card (grad/inverse.py; traversal detached, the
     kernels in every forward pass): (a) BASELINE config #5,
     scenes/cornell_disney.toml at its 256x256 and 3 bounces through
     auto -> B1, an 8-sample self-target, the Disney rows' roughness +0.35
     and the camera +0.35 in x, `optimize` at lr 2e-2 for 150 steps: the
     losses, both errors every 10 steps, ms per step, peak memory; the
     late losses below the early ones, each error at half its start or
     less at some step (after which it drifts, as the reference's does),
     every step's parameters finite, B1 launched 3 + 3 times a step and
     for the target, no twin; (b) `python -m caitlynrenderer_tpu_torch.cli
     optimize` in a subprocess, its params.npz loaded back; (c) the
     grad-pass overhead ratio (value and grad over forward, as
     benchmarks/run_configs.py measures it; 5 repetitions after 2
     warm-ups, peak memory) of the Disney floor at 700x700 (B1), grid100k
     at 256x256, 4 bounces through wide (B2, also with vertices) and one
     call through cwbvh (B3), B1's and B2's also split under the profiler
     (kernels launched, device busy, the most frequent ops); (d) one value and grad of the Disney floor
     at 64x64 on the card and on the CPU: every group's gradient within
     rtol 1e-3, atol 1e-6 max|g|, the losses within rtol 1e-5.  Its
     numbers, beside the card's name and power limit, are also printed
     as one {"grad": ...} JSON line before the kernels' line.
 19. tooling and multi-device on the card, B5 drawing every sample of
     each path in this process and in (d)'s ranks: (a) the 700x700 cornell (3
     bounces, B1) in 4x4 tiles (render/tiled.py) against the untiled
     progressive loop, 4 samples: accumulations equal bit for bit,
     ms/frame of both, and B1 against its twin bit for bit on every query
     of one tiled sample (30,625 rays a tile); (b) grid100k's 65,536
     primary rays and the main path's bounce and shadow rays: the node8
     torch walk (ops/traverse_cwbvh.py, called directly) against B3 under
     phase 8's contract (`check_vs_b1`, the walk in B1's place: both are
     Moller-Trumbore), the times of both, the walk launching neither B3
     nor any twin; one 256x256, 4-bounce sample under "auto" (B3
     launched 4 + 4 times, its twin never), and traversal "xla" refused
     on the card (ValueError, nothing launched but B5's draw); (c) a 1x1 mesh under
     NCCL (world size 1): the sharded render of the cornell demo (B1) and
     of grid100k through wide (B2, 256x256, 4 bounces), 4 samples, equal
     bit for bit to the progressive loop, ms/frame of both, the kernel
     against its twin bit for bit on one sharded sample's queries (B1's
     all, B2's first bounce), and scaling_report (1.0 by construction on
     one rank); (d) two ranks on cuda:0 over gloo (all-reduce on CUDA
     tensors), spawned here: the cornell demo on the 2x1 mesh equal bit
     for bit to (a)'s loop, on the 1x2 mesh within rtol 1e-5, atol 1e-6
     (the row's sum reassociates samples), each rank's ms/frame, and on
     each rank B1 against its twin bit for bit on one sample's queries of
     its block (245,000 rays on 2x1, 490,000 on 1x2); (e) one
     sharded_train_step at 64x64 on the card against the CPU (loss rtol
     1e-4; each parameter's step rtol 1e-3, atol 1e-6 of the largest);
     (f) `cli render --turntable 2`, `cli benchmark --scene cornell
     --steps 2` and `cli render --mesh 1x1` under `python -m
     torch.distributed.run` (one NCCL rank) as three subprocesses at
     once; each frame and the mesh's image equal, PNG for PNG, the same
     render made in this process.  Its numbers are also
     printed as one {"phase19": ...} JSON line before the kernels' line.
 20. samples per launch (render/progressive.py: render_steps as one
     CUDA-graph replay).  First grid1m as accel "auto" takes it, the
     grid1m.offline cell's path: `auto_accel` gives "bvh2" (B4), the
     stack sized by required_stack, phase 10's main path at the cell's
     1024x1024 and 6 bounces, B4's launches counted from there alone;
     phases 20, 22 and 23 run grid1m on this upload.  Then: (a) on the
     700x700 cornell (3 bounces, B1), grid100k at 256x256, 4 bounces,
     through wide (B2) and cwbvh (B3), and grid1m under auto (B4) at
     256x256: two replays of a graph of 16 samples against 32
     eager render_step calls, accumulations equal bit for bit; both
     paths' ms/frame (the graph's over two more replays), the first
     launch's seconds with the capture's and the instantiation's (from
     the "graph_capture" log record), the graph's node count, the bytes
     in the graphs' pool and the peak over the first launch; the graph
     holds depth x 16 + depth x 16 kernel nodes of the path's kernel,
     counted by name (cuGraphKernelNodeGetParams), which a replay adds to
     the counters, and no twin runs (the graph's warm-up sample runs under
     the sync debug mode "error"); (b) three orbit cameras (`turntable_camera`)
     through the cornell's cached graph, no capture, each frame equal to
     its eager render bit for bit; (c) `cli render scenes/cornell.toml
     --spp 64 --spp-per-launch 64` at 700x700 in a subprocess (one launch
     through the config's "wide"), its PNG equal to the same render made
     eagerly in this process, its progress records present; (d) as (a)
     through B4: "bvh2" and "sbvh" on the 700x700 cornell and "bvh2" on
     grid100k; (e) the cornell at 1920x1080
     in launches of 4, 2 and 2 samples (the halving of the CLI's --resume
     loop) through two graphs that share one memory pool, equal bit for
     bit to 8 eager samples, with the pool's bytes after each capture;
     the second graph grows the pool by at most a tenth.
     Its numbers are also printed
     as one {"phase20": ...} JSON line before the kernels' line.
 21. B4, the binary-BVH walk (ops/traverse_bvh.py, "bvh2" and "sbvh"):
     (a) the main path as phase 10 under "bvh2" and "sbvh" on grid100k and
     grid1m (256x256, 4 bounces, one launch of 16 spp after a warm-up
     launch; grid1m's SBVH is built on the host in a process of its own
     while phases 2-20 run): upload seconds, ms/frame, the eager sample's
     split, one eager frame through the twin walk (the card's path before
     B4) and B4's profiler device time beside the graph's frame; (b) B4 against
     its twin, t, tri, u, v bit for bit and occlusion on every ray: the
     cornell 700x700 primary, bounce and shadow rays, (a)'s four scenes'
     65536 primary rays and the integrator's bounce rays from their hits,
     an edge set (ragged N, ~10 % inactive lanes, rays at vertices and
     along edges, axis-parallel rays with ±0 components in the planes of
     the box faces) at max_leaf 4 and 2 (below the build's leaf width), an
     all-dead batch and an empty scene; on every set B4's stats variant,
     plain and seeded with the closest t, returns the plain launch's
     answers; (c) B4, its stats variant and its twin timed on the cornell
     primary rays and (a)'s ray sets, beside B4's bound (`bvh_bound`, from
     the stats variant's oracle walk) and its walk's work over the bound.  Its
     numbers are also printed as one {"phase21": ...} JSON line before the
     kernels' line.
 22. B5, the threefry sampler (ops/threefry.py; every path's uniforms):
     (a) B5 against its twin, bit for bit (torch.equal on the int32
     views): the 700x700 cornell's ids at depth 3, 256x256 at depth 4, a
     175x175 tile's ids, the 4x4-tiled frame's tile-major ids padded as
     parallel/render.py pads and clamps them, depth 0
     and 8, keys as ints and as 0-d tensor views at frames 0, 1, 2^31 - 1
     and 2^32 - 1, and draw_uniforms at 256x256 x 25 (config #5) and at
     1001 rows (a last block not full); (b) B5 and its twin timed at the
     cornell's 700x700 x 25, the grids' 256x256 x 32 and config #5's lane
     draw, beside B5's bound (`threefry_bound`: the larger of its bytes
     over 3.35 TB/s and its least instructions, the ALU pipe's at 64 a
     clock an SM and all at the SM's 128 issue slots a clock, over the SMs
     at the card's highest SM clock); (c) graph frames
     of 16 samples through the twin (`twin_sampler`, the card's path
     before B5) and through B5, in turns twin, B5, B5, twin, on the
     700x700 cornell (B1), grid100k under wide, cwbvh and bvh2, and grid1m
     under auto (B4), the two graphs' accumulations equal bit for bit; (d) both
     graphs' nodes a sample.  Its numbers are also printed as one
     {"phase22": ...} JSON line before the kernels' line.
 23. B6, the shading kernel (ops/shade.py; every bounce of a scene of
     Lambert with any of Disney, mirror and glass on the card), at the
     main paths' shapes: the 700x700 cornell (B1, 3 bounces) and grid1m at
     1024x1024 under auto (B4, 6 bounces) through its Lambert
     instantiation, the cornell_specular700 cell's box with a mirror and a
     glass sphere (700x700 under auto, B4, 8 bounces) through its delta
     one, the 700x700 Disney-floor cornell (B1, 4 bounces) through its
     Disney one, bounce 0 on
     the camera rays, then bounce 1 on bounce 0's next rays with bounce
     0's NEE folded in, and the finishing add of bounce 1's NEE: (a) B6
     against its twins (`integrator.shade_bounce_plain`,
     `shade_finish_plain`) on the same inputs, every output bit for bit
     where the loop reads it (ldir and pending where cand; o, d and
     prev_pdf on the lanes that went on shading; the delta flag where the
     path goes on); (b) B6 and the twins timed (CUDA events around
     each call, queued behind a device sleep, the state restored between
     calls outside the events), beside B6's bound (`shade_bound`,
     `finish_bound`: the bytes each lane's outcome needs over 3.35 TB/s);
     (c) on grid1m and the specular box, B4 against its twins
     (`traverse_closest_plain`, `traverse_anyhit_plain`) on each bounce's
     closest-hit rays (the camera rays, then bounce 0's continuation rays) and its
     shadow rays, t, tri, u, v and occlusion bit for bit, and on bounce 0's
     B4 and the twins timed beside B4's bound (`bvh_bound` from the stats
     variant's oracle walk).  Its numbers are also printed as one
     {"phase23": ...} JSON line before the kernels' line.
 24. the cornell_specular700.offline cell's path (cellbench's scene,
     camera and configuration: a mirror and a glass UV sphere with
     interpolated vertex normals in the box, 7,948 triangles, 700x700, 8
     bounces): `auto_accel` gives "bvh2" (B4) and B6's delta instantiation
     shades; the main path as phase 20's grid1m run (one launch of 16 spp
     after the capture's, counters reset just before: B4 8 + 8 and B6 8 +
     1 launches a sample); then one eager sample through B6 against the
     same sample on the plain shading step, radiance bit for bit, and its
     queries, copied as `trace_paths` issues them, held against B4's
     twins, t, tri, u, v and
     occlusion bit for bit: the camera rays, each bounce's continuation
     rays (bounce 0's checked equal to `bounce_rays`, refracted ones
     leaving 2 RAY_OFFSET inside a sphere) and each bounce's shadow rays.
     Its numbers are also printed as one {"phase24": ...} JSON line before
     the kernels' line.
About 7 minutes on one H100, builds included.  B3's and B4's stats
variants (`stats=True`) are checked and used for counts and bounds only;
their launches are counted apart (`traverse_cw8.stats_launches`,
`traverse_bvh.stats_launches`).  The line before the last is
the kernels' JSON record, each kernel with its time, its plain twin's, and
its bound (the larger of its bytes over 3.35 TB/s and its FP32 operations
over 67 TFLOP/s, the H100 SXM's published peaks, or for B5 its integer
instructions over the SM's pipes, for B6 its bytes, counted from this
run's inputs as `*_bound` below say); the last line is {"ok": true, "device": {...}}.
Nothing of JAX or of the JAX package is imported.
"""

import contextlib
import json
import logging
import os
import subprocess
import sys
import tempfile
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
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12  # H100 SXM FP32 outside the tensor cores, FLOP/s
# FP32 operations of Moller-Trumbore in its cheapest per-pair form, the
# Pluecker form of csrc/mt_brute.cu's pre-test.  Once per triangle
# (MT_TRI_OPS): n = e2 x e1, p1 = v0 x e1, p2 = v0 x e2 (9 each), c2 =
# e2 . p1 (5).  Once per live ray (MT_RAY_OPS): m = o x d.  Per pair, up to
# the first of the tests that rejects it (MT_STAGE_OPS): det = d . n (5);
# u's numerator e2 . m + d . p2 (11 more); v's, e1 . m + d . p1, and u + v
# (12 more); t's numerator o . n + c2 (6 more), the division, u, v and t
# scaled by it (4) and 1 - (u + v) (1): MT_OPS for a pair that reaches t.
MT_TRI_OPS, MT_RAY_OPS = 32, 9
MT_STAGE_OPS = (5, 16, 28, 39)
MT_OPS = MT_STAGE_OPS[-1]
COL_T_OPS, COL_UV_OPS, BOX_OPS = 11, 12, 20  # B2/B3: a plane column to t, to u/v; a box
FORBIDDEN = ("jax", "caitlynrenderer_tpu")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


def event_ms(fn, reps, host_ahead=True):
    """Mean milliseconds per call of fn() on the card (CUDA events), after
    one warm-up call.  With host_ahead a sleep kernel first holds the card
    while the host enqueues the calls, so that a call whose host side (the
    wrapper's checks and allocations) takes longer than its kernel is timed
    by its device work; without it, back-to-back calls are timed as a
    caller issues them, host included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if host_ahead:
        torch.cuda._sleep(2_000_000 * reps)  # about a millisecond a call
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
    print(f"  {label}: rays {o.shape[0]} tris {tris9.shape[0]} lanes per ray "
          f"{mt._lanes(o.shape[0], tris9.shape[0], o.device)} hits {hits} "
          f"occluded {int(occ_t.sum())} | tri mismatches {tri_diff}, occluded "
          f"mismatches {occ_diff}, max |dt,du,dv| {worst_abs:.3e}, max rel {worst_rel:.3e}")
    check(tri_diff == 0, f"{label}: kernel and twin disagree on tri for {tri_diff} rays")
    check(occ_diff == 0, f"{label}: kernel and twin disagree on occlusion for {occ_diff} rays")
    for a, b, name in ((tk, tt, "t"), (uk, ut, "u"), (vk, vt, "v")):
        check(bool(((a - b).abs() <= TOL_REL * b.abs()).all()),
              f"{label}: {name} differs beyond {TOL_REL} relative")
    return worst_abs, float(occ_diff > 0)


def compare_mega(label, mega, o, d, active, wide, t_max):
    """B2 vs its twin on one input: tri, group and occlusion equal on every
    ray, t within TOL_REL relative.  Returns the largest |dt| and the
    occlusion mismatch (0 or 1)."""
    tk, trk, gk = mega.mega_closest(o, d, active, *wide)
    tt, trt, gt = mega.mega_closest_plain(o, d, active, *wide)
    occ_k = mega.mega_anyhit(o, d, t_max, active, *wide)
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


def compare_cw8(label, cw8, o, d, active, cw, t_max):
    """B3 vs its twin on one input: tri, window and occlusion equal on every
    ray, t within TOL_REL relative; B3's stats variant, as the timed walk
    and as the oracle walk, equal to the plain launch.  Returns the largest
    |dt| and the occlusion mismatch (0 or 1)."""
    tk, trk, wk = cw8.cw8_closest(o, d, active, *cw)
    tt, trt, wt = cw8.cw8_closest_plain(o, d, active, *cw)
    occ_k = cw8.cw8_anyhit(o, d, t_max, active, *cw)
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
    cw8_stats(cw8, o, d, active, cw, t_max)  # the stats variant returns the same answers
    return worst_abs, float(occ_diff > 0)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP32 operations over the FP32 rate."""
    b_ms, f_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def mt_bound(o, d, active, tris9, t_max=None):
    """B1's bound from the work the query needs: rays in and results out,
    the slab read once; per ray x triangle pair, MT_STAGE_OPS up to the
    first of Moller-Trumbore's tests (det, u, v, t) that rejects it, for
    every triangle of a live closest ray and up to the first accepted one
    of an occluded any-hit ray; MT_TRI_OPS per triangle and MT_RAY_OPS per
    live ray."""
    from caitlynrenderer_tpu_torch.ops.intersect import mt_uvt

    n, s = o.shape[0], tris9.shape[0]
    stage_ops = torch.tensor(MT_STAGE_OPS, dtype=torch.float64, device=o.device)
    v0, e1, e2 = tris9[None, :, 0:3], tris9[None, :, 3:6], tris9[None, :, 6:9]
    col = torch.arange(s, device=o.device)
    ops = 0.0
    step = max(1, (1 << 24) // max(s, 1))
    for r0 in range(0, n, step):
        sl = slice(r0, r0 + step)
        det, t, u, v = mt_uvt(o[sl, None], d[sl, None], v0, e1, e2)
        stage = torch.where(~(det.abs() > 0), 0, torch.where(~(u >= 0), 1, torch.where(
            ~((v >= 0) & (1.0 - u - v >= 0)), 2, 3)))
        need = active[sl, None].expand(-1, s)
        if t_max is not None:  # up to the first accepted triangle
            ok = (stage == 3) & (t >= 0) & (t < t_max[sl, None])
            first = torch.where(ok.any(dim=1), ok.int().argmax(dim=1), s - 1)
            need = need & (col[None, :] <= first[:, None])
        ops += float((stage_ops[stage] * need).sum())
    ops += MT_TRI_OPS * s + MT_RAY_OPS * int(active.sum())
    nbytes = n * (24 + 1 + (4 + 1 if t_max is not None else 16)) + s * 36
    return bound(nbytes, ops)


def mega_walk(st, n, kp, anyhit):
    """The work B2's walk did on these rays, from its stats variant, at the
    bound's rates (not a bound: it grows with the walk's own waste): rays
    in and results out, the scene box, and the plane rows 0-3 (3 Kp
    columns, padding included) of every distinct group some ray visited,
    the worklist entries (bounds, gid, start) and block boxes some ray
    tested, each once; COL_T_OPS per column evaluated, COL_UV_OPS more per
    column that reached u/v, BOX_OPS per box test."""
    c = st["counts"].double().sum(dim=0)
    blk, ent, _, cols, uv = (float(x) for x in c)
    nbytes = (n * (24 + 1 + (4 + 1 if anyhit else 12)) + 24
              + int(st["grp_seen"].sum()) * 4 * 3 * kp * 4
              + int(st["ent_seen"].sum()) * (64 + 8) + int(st["blk_seen"].sum()) * 64)
    return bound(nbytes, cols * COL_T_OPS + uv * COL_UV_OPS + (blk + ent) * BOX_OPS)


def mega_bound(wide, o, d, active, t_max=None, t_hit=None, occluded=None):
    """B2's bound from the work the query needs, whatever the walk does: a
    ray must test the box of, and evaluate the triangles of, every group
    whose box it enters before its end: a closest ray's hit t (`t_hit`, the
    kernel's, which equals the twin's) or, on a miss, its scene exit; an
    any-hit ray's t_max clamped at the exit.  An occluded any-hit ray
    (`occluded`) needs only one box and one triangle.  Operations: BOX_OPS
    per needed group box, COL_T_OPS per real (non-padding, non-degenerate)
    triangle column of a needed group, COL_UV_OPS for each hit or occluded
    ray's triangle.  Bytes: rays in and results out, and the box (24 B) and
    the real columns' plane rows 0-3 (3 x 16 B) of each distinct needed
    group, once."""
    from caitlynrenderer_tpu_torch.ops.traverse_mega import INF, _scene_exit_bound

    group_bounds, planes = wide[0], wide[1]
    kp = planes.shape[2] // 3
    real = (planes[:, 0:4, :kp] != 0).any(dim=1).double().sum(dim=1)  # (G,)
    anyhit = occluded is not None
    t_end = _scene_exit_bound(o, d, torch.where(active, t_max if anyhit else INF, -INF),
                              group_bounds)
    if anyhit:
        found, open_rays = occluded & active, active & ~occluded
    else:
        found, open_rays = t_hit < INF, active
        t_end = torch.where(found, t_hit, t_end)
    boxes = cols = 0.0
    needed = torch.zeros(group_bounds.shape[0], dtype=torch.bool, device=o.device)
    inv = 1.0 / d
    for r0 in range(0, o.shape[0], 4096):
        sl = slice(r0, r0 + 4096)
        t0 = (group_bounds[None, :, :3] - o[sl, None]) * inv[sl, None]
        t1 = (group_bounds[None, :, 3:] - o[sl, None]) * inv[sl, None]
        tn = torch.minimum(t0, t1).amax(dim=2).clamp(min=0.0)
        tf = torch.maximum(t0, t1).amin(dim=2)
        enter = (tf >= tn) & (tn <= t_end[sl, None]) & open_rays[sl, None]
        boxes += float(enter.sum())
        cols += float((enter.double() @ real).sum())
        needed |= enter.any(dim=0)
    nf = int(found.sum())
    if anyhit:  # an occluded ray's one box and one column
        boxes, cols = boxes + nf, cols + nf
    nbytes = (o.shape[0] * (24 + 1 + (4 + 1 if anyhit else 12))
              + 24 * int(needed.sum()) + 48 * float(real[needed].sum()))
    return bound(nbytes, boxes * BOX_OPS + cols * COL_T_OPS + nf * COL_UV_OPS)


def cw8_bound(st, anyhit, hits):
    """B3's work at the bound's rates from its stats variant's counts `st`.
    Given the oracle walk's counts (boxes culled against the known closest
    t, acceptance unchanged) it is B3's bound, the work the query needs;
    given the timed walk's own, the work that walk did.  Operations:
    BOX_OPS per child box tested, COL_T_OPS per leaf triangle tested,
    COL_UV_OPS per hit (`hits`: closest hits or occluded rays).  Bytes: rays
    in and results out, the scene box, and each distinct node (80 B) and
    plane column (16 B for n, 48 B where u/v were evaluated) touched, once."""
    boxes, tris = (float(x) for x in st["counts"][:, 1:3].double().sum(dim=0))
    cols = st["col_seen"]
    n = st["counts"].shape[0]
    nbytes = (n * (24 + 1 + (4 + 1 if anyhit else 12)) + 24 + 80 * int(st["node_seen"].sum())
              + 16 * int((cols > 0).sum()) + 32 * int((cols == 2).sum()))
    return bound(nbytes, boxes * BOX_OPS + tris * COL_T_OPS + hits * COL_UV_OPS)


def cw8_stats(cw8, qo, qd, qa, qc, t_max):
    """B3's stats variant on one ray set, closest and any-hit, each as the
    timed walk and as the oracle walk seeded with the closest t.  Checks
    that all four return the plain launch's answer; returns {"closest",
    "anyhit", "closest_oracle", "anyhit_oracle": st} and the hits of each
    query."""
    t, tri, win = cw8.cw8_closest(qo, qd, qa, *qc)
    occ = cw8.cw8_anyhit(qo, qd, t_max, qa, *qc)
    out = {}
    for tag, seed in (("", None), ("_oracle", t)):
        ts, tris, wins, out["closest" + tag] = cw8.cw8_closest(qo, qd, qa, *qc, stats=True,
                                                               t_seed=seed)
        occs, out["anyhit" + tag] = cw8.cw8_anyhit(qo, qd, t_max, qa, *qc, stats=True,
                                                   t_seed=seed)
        torch.cuda.synchronize()
        check(torch.equal(ts, t) and torch.equal(tris, tri) and torch.equal(wins, win)
              and torch.equal(occs, occ),
              f"B3's stats variant{' (oracle walk)' if seed is not None else ''} differs from "
              "the plain launch")
    return out, {"closest": int((tri >= 0).sum()), "anyhit": int(occ.sum())}


def stats_line(st, names):
    """mean / p50 / p99 / max of each per-ray count of a stats variant
    (columns `names`)."""
    c = st["counts"].float()
    q = torch.quantile(c, torch.tensor([0.5, 0.99], device=c.device), dim=0)
    return "; ".join(f"{k} {float(c[:, j].mean()):.1f}/{float(q[0, j]):.0f}/"
                     f"{float(q[1, j]):.0f}/{float(c[:, j].max()):.0f}"
                     for j, k in enumerate(names))


def edge_distance(o, d, tris9, tri):
    """Per ray, how far the ray passes from the nearest edge of triangle
    `tri` (Moller-Trumbore barycentrics: |min(u, v, 1 - u - v)|); inf where
    tri < 0."""
    from caitlynrenderer_tpu_torch.ops.intersect import mt_uvt

    row = tris9[tri.clamp(min=0).long()]
    _, _, u, v = mt_uvt(o, d, row[:, 0:3], row[:, 3:6], row[:, 6:9])
    dist = torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs()
    return torch.where(tri >= 0, dist, torch.inf)


CRACK_SHARE = 1e-3  # at most this share of rays may fall into edge cracks
# Barycentric distance from an edge that counts as on it: 1e-3 of a grid1m
# triangle (~0.014 across) is ~1.4e-5 in scene units, a few f32 ulps of
# coordinates near 10.
CRACK_EDGE = 1e-3
# The rounding error of a hit's t is absolute: about an ulp of the scene's
# coordinates over |cos| between ray and triangle.  At the small t and
# grazing angles of rays that leave a surface it exceeds rtol 5e-4 (grid1m
# bounce rays, H100: |dt| up to 0.5 of one such unit at t ~ 1e-2).
COND_ULPS = 4


def check_vs_b1(label, tk, trk, occk, t1, tri1, occ1, t_max, tris1, trisk,
                surface_d=None, cracks=None):
    """A BVH kernel's closest hit and occlusion against B1's on the same
    rays (tests/test_mega.py's contract): hit or miss equal, t within rtol
    5e-4 (Baldwin-Weber against Moller-Trumbore), occlusion equal except
    where t_max lies within that tolerance of the hit, or between the two
    t's.  One exemption, for rays that start on a surface (`surface_d`:
    their directions; bounce rays): on the same triangle as B1's (rows of
    the two slabs equal, whatever each kernel's order) t may also differ by
    COND_ULPS f32 ulps of the scene's largest coordinate over |cos| between
    the ray and the triangle.

    With `cracks`, a ray that breaks this passes if it is an edge crack:
    one passing within f32 rounding of an edge two triangles share, where
    the kernel's precomputed Baldwin-Weber planes can miss both triangles
    and B1's Moller-Trumbore hits one.  `cracks(bad)` -> (twin_equal, edge
    distance per ray): the kernel must equal its plain twin on every such
    ray bit for bit (the disagreement is the algorithm's, not the
    kernel's), each must lie within CRACK_EDGE of an edge, and they must be
    at most CRACK_SHARE of all rays.  Without `cracks` no ray may break the
    contract."""
    from caitlynrenderer_tpu_torch.core import math as cm

    hit1, hitk = tri1 >= 0, trk >= 0
    both = hit1 & hitk
    row1 = tris1[tri1.clamp(min=0).long()]
    same_tri = both & (row1 == trisk[trk.clamp(min=0).long()]).all(dim=1)
    dt = (tk - t1).abs()
    t_ok = ~hit1 | (dt <= 5e-4 * t1.abs())
    cos = torch.ones_like(t1)
    if surface_d is not None:
        cos = cm.dot(surface_d, cm.normalize(cm.cross(row1[:, 3:6], row1[:, 6:9]))).abs()
        unit = torch.finfo(torch.float32).eps * tris1[:, 0:3].abs().max() / cos
        exempt = both & ~t_ok & same_tri & (dt <= COND_ULPS * unit)
    else:
        exempt = torch.zeros_like(t_ok)
    near = hit1 & ((t1 - t_max).abs() <= 5e-4 * t1.abs() + torch.where(both, dt, 0.0))
    bad = (hit1 != hitk) | ~(t_ok | exempt) | ((occ1 != occk) & ~near)
    nbad = int(bad.sum())
    rel = (dt / t1.abs())[both & t_ok]
    print(f"  {label}: hits B1 {int(hit1.sum())} kernel {int(hitk.sum())}, hit/miss mismatches "
          f"{int((hit1 != hitk).sum())}, same triangle {int(same_tri.sum())}, max rel dt "
          f"{float(rel.max()) if rel.numel() else 0.0:.3e}, t beyond rtol 5e-4 within "
          f"{COND_ULPS} ulps / |cos| of a surface start {int(exempt.sum())} (|cos| "
          f"{[float(f'{x:.3e}') for x in cos[exempt].tolist()[:8]]}, |dt| "
          f"{[float(f'{x:.3e}') for x in dt[exempt].tolist()[:8]]}); occluded B1 "
          f"{int(occ1.sum())} kernel {int(occk.sum())}; rays breaking the contract {nbad}",
          flush=True)
    for i in bad.nonzero()[:8, 0].tolist():
        print(f"    ray {i}: t B1 {float(t1[i]):.6e} kernel {float(tk[i]):.6e}, same triangle "
              f"{bool(same_tri[i])}, occluded B1 {bool(occ1[i])} kernel {bool(occk[i])}, t_max "
              f"{float(t_max[i]):.6e}", flush=True)
    if nbad and cracks is not None:
        twin_equal, dist = cracks(bad)
        print(f"    crack rays: {nbad} of {bad.numel()}, kernel == twin on them: {twin_equal}, "
              f"edge distances {[float(f'{x:.2e}') for x in dist.tolist()[:12]]}", flush=True)
        check(twin_equal, f"{label}: the kernel differs from its twin on a crack ray")
        check(bool((dist <= CRACK_EDGE).all()), f"{label}: a ray off every edge disagrees with B1")
        check(nbad <= CRACK_SHARE * bad.numel(), f"{label}: too many crack rays ({nbad})")
    else:
        check(nbad == 0, f"{label}: the kernel and B1 disagree on {nbad} rays")


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


def vertex(ds, o, d, tri, families=("lambert",)):
    """The integrator's first vertex from bounce 0's closest hits `tri`, as
    render/integrator.py makes it: its `hit_frame` (the next rays' origin
    `point`, the flipped shading normal `n_flip`), its `surface` under the
    shading `families`, and where the path goes on (a hit, not on an
    emitter)."""
    from caitlynrenderer_tpu_torch.render.integrator import hit_frame, surface

    zero = torch.zeros_like(o[:, 0])
    hf = hit_frame(ds, o, d, zero, tri, zero, zero)
    return hf, surface(ds, hf, families), hf.keep & (hf.rows[:, 33] == -1)


def bounce_rays(ds, o, d, tri, uni, families=("lambert",)):
    """The integrator's first continuation rays (its `continuation`: by
    family a Lambert, Disney, mirror or glass sample, a refracted ray
    leaving from below the surface) from `vertex`, with bounce 0's
    uniforms.  Lanes that missed, hit an emitter or drew a Disney sample
    without pdf are inactive, as their paths end."""
    from caitlynrenderer_tpu_torch.render.integrator import bounce_uniforms, continuation

    hf, surf, live = vertex(ds, o, d, tri, families)
    _, _, _, u_b1, u_b2, u_lobe, _ = bounce_uniforms(uni, 0)
    direction, _, _, _, ok, origin = continuation(hf, surf, d, torch.ones_like(o), u_b1, u_b2,
                                                  u_lobe)
    return origin.contiguous(), direction.contiguous(), live & ok


def shadow_rays(ds, o, d, tri, uni, families=("lambert",)):
    """The integrator's first NEE shadow rays (its `light_sample`) from
    `vertex`, with bounce 0's uniforms: active where the integrator issues
    the query (not from a specular material).  Returns (o, d, active,
    t_max)."""
    from caitlynrenderer_tpu_torch.render.integrator import bounce_uniforms, light_sample

    hf, surf, live = vertex(ds, o, d, tri, families)
    u_lp, u_l1, u_l2 = bounce_uniforms(uni, 0)[:3]
    _, ldir, _, _, _, cand, t_max = light_sample(ds.light_tab, hf.point, hf.n_flip, u_lp, u_l1,
                                                 u_l2, live, surf.specular)
    return hf.point.contiguous(), ldir.contiguous(), cand, t_max.contiguous()


def scattered_rays(ds, o, d, tri, rng, cuda):
    """Rays leaving each hit as `bounce_rays` do, but in uniformly random
    directions over the whole sphere: about half point back into their own
    surface, a case the main path never traces, kept for kernel-vs-twin
    equality."""
    from caitlynrenderer_tpu_torch.core import math as cm

    hf, _, act = vertex(ds, o, d, tri)
    return hf.point.contiguous(), cm.normalize(cuda(rng.standard_normal((o.shape[0], 3)))), act


# The textured scene of tests/test_textures.py (held equal to it by
# tests/test_torch_render.py): a checker-textured quad, a plain quad
# behind it and a lamp.
TEX_OBJ = """\
mtllib tex.mtl
v -1 0 0
v  1 0 0
v  1 2 0
v -1 2 0
v -1 0 -3
v  1 0 -3
v  1 2 -3
v -1 2 -3
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl textured
f 1/1 2/2 3/3 4/4
usemtl plain
f 5/1 6/2 7/3 8/4
usemtl lamp
v -0.5 1.9 1.5
v  0.5 1.9 1.5
v  0.0 1.9 2.5
f 9 10 11
"""
TEX_MTL = """\
newmtl textured
Kd 1 1 1
map_Kd checker.png
newmtl plain
Kd 0.2 0.5 0.8
newmtl lamp
Kd 0 0 0
Ke 10 10 10
"""


def write_textured_scene(directory):
    """Write the textured scene (tex.obj, tex.mtl and its 8x8 checker.png)
    into `directory`; returns the OBJ's path.  Its camera: (0, 1, 4)
    looking down -z at 40 degrees, translated with the scene."""
    from caitlynrenderer_tpu_torch.io.image import save_png

    checker = np.zeros((8, 8, 3), np.float32)
    checker[:4, :4] = [1.0, 0.0, 0.0]
    checker[:4, 4:] = [0.0, 1.0, 0.0]
    checker[4:, :4] = [0.0, 0.0, 1.0]
    checker[4:, 4:] = [1.0, 1.0, 0.0]
    save_png(os.path.join(directory, "checker.png"), checker)
    for name, text in (("tex.mtl", TEX_MTL), ("tex.obj", TEX_OBJ)):
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)
    return os.path.join(directory, "tex.obj")


# The kernel module and kernel name each accelerator's path runs.
PATH_KERNEL = {"brute": ("mt_brute", "mt_brute_kernel", "B1"),
               "wide": ("traverse_mega", "mega_kernel", "B2"),
               "cwbvh": ("traverse_cw8", "cw8_kernel", "B3"),
               "bvh2": ("traverse_bvh", "bvh2_kernel", "B4"),
               "sbvh": ("traverse_bvh", "bvh2_kernel", "B4")}


# B5's module: every sample of every path draws its uniforms through it.
SAMPLER = "threefry"
# B6's module: the bounces of a scene `fused_shading` takes shade through it on the card.
SHADER = "shade"


def kernel_modules():
    """{module name: module} of the six kernel modules."""
    from caitlynrenderer_tpu_torch.ops import (
        mt_brute,
        shade,
        threefry,
        traverse_bvh,
        traverse_cw8,
        traverse_mega,
    )

    return {"mt_brute": mt_brute, "traverse_mega": traverse_mega, "traverse_cw8": traverse_cw8,
            "traverse_bvh": traverse_bvh, SAMPLER: threefry, SHADER: shade}


def b6_launches(ds, o, d, uni, options, samples):
    """B6's counter after `samples` samples of the main path: max_depth
    launches and one finishing launch a sample where `fused_shading` holds,
    none elsewhere; no twin call."""
    from caitlynrenderer_tpu_torch.ops import shade
    from caitlynrenderer_tpu_torch.render.integrator import fused_shading

    k = samples if fused_shading(ds, o, d, uni, options) else 0
    out = dict.fromkeys(shade.launches, 0)
    out["finish"] = k
    out[shade.bounce_key(options.families)] = options.max_depth * k
    return out


def only_path(launches, name):
    """True when, in {module: {key: n}}, no twin ran and no kernel but
    module `name`'s, the sampler's (B5) and the shading kernel's (B6)."""
    return all(v == 0 for k, r in launches.items() for q, v in r.items()
               if q.endswith("_twin") or k not in (name, SAMPLER, SHADER))


@contextlib.contextmanager
def twin_sampler():
    """The sampler as the card ran it before B5: `pixel_uniforms` runs its
    plain twin (int64 torch ops) on the card.  Graphs captured inside use
    the twin for good; the graph cache is cleared on entry and exit, so
    none crosses over."""
    from caitlynrenderer_tpu_torch.render import progressive, sampling

    saved = sampling.pixel_uniforms
    progressive.clear_graphs()
    sampling.pixel_uniforms = sampling.pixel_uniforms_plain
    try:
        yield
    finally:
        sampling.pixel_uniforms = saved
        progressive.clear_graphs()


@contextlib.contextmanager
def twin_walk():
    """The binary walk as the card ran it before B4: the integrator's
    "bvh2"/"sbvh" queries go to the plain twins, which read the host at
    every step."""
    from caitlynrenderer_tpu_torch.ops import traverse_bvh as tb
    from caitlynrenderer_tpu_torch.render import integrator

    def closest(o, d, active, *tree, **kw):  # the twin takes the FlatBVH and the scene
        return tb.traverse_closest_plain(o, d, active, *tree[:4], **kw)

    def anyhit(o, d, t_max, active, *tree, **kw):
        return tb.traverse_anyhit_plain(o, d, t_max, active, *tree[:4], **kw)

    saved = integrator.traverse_closest, integrator.traverse_anyhit
    integrator.traverse_closest, integrator.traverse_anyhit = closest, anyhit
    try:
        yield
    finally:
        integrator.traverse_closest, integrator.traverse_anyhit = saved


def main_path(label, scene, camera, options, dev, spp, split_stages=True, prebuilt=None):
    """upload_scene -> render_steps -> resolve, one launch of `spp` samples
    (a CUDA graph's replay) timed after a warm-up launch of the same length
    (the capture), through the accelerator's kernel (B1, B2, B3, or B4
    under "bvh2"/"sbvh", whose stack is sized by required_stack); with
    `split_stages`, then the split of an eager sample between its stages.
    Returns the launch counts of the warm-up and timed run's kernels, by
    module, the upload, and the numbers (upload_s, ms_per_frame,
    rays_per_sec; with the split, each stage's eager ms, the kernel's and
    every kernel's profiler device ms per sample, and under B4 one eager
    frame through the twin walk).  prebuilt: (FlatBVH, seconds) of the
    binary tree upload_scene would build, built ahead (SbvhBuild), handed
    to upload_scene; its seconds count in the upload's."""
    from caitlynrenderer_tpu_torch.accel.native import native_available
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.render import progressive, sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths
    from caitlynrenderer_tpu_torch.scene import required_stack, upload_scene

    modules = kernel_modules()
    name, kernel, tag = PATH_KERNEL[options.accel]
    w, h, depth = options.width, options.height, options.max_depth
    n = w * h
    tree, build_s = prebuilt or (None, 0.0)
    t0 = time.perf_counter()
    ds = upload_scene(scene, options.accel, dev, bvh=tree)
    torch.cuda.synchronize()
    upload_s = build_s + time.perf_counter() - t0
    binary = options.accel in ("bvh2", "sbvh")
    if binary:
        options = options._replace(max_stack=required_stack(ds))
    layout = {"brute": "a brute-force slab",
              "wide": f"{ds.wb_mega.shape[0]} groups of {ds.wb_mega.shape[2] // 3} columns",
              "cwbvh": f"{ds.cw_nodes.shape[0]} node8s of depth {ds.cw_depth}, "
                       f"{ds.cw_planes.shape[0]} windows",
              "bvh2": f"{ds.node_meta.shape[0]} nodes of depth {ds.tree_depth}",
              "sbvh": f"{ds.node_meta.shape[0]} nodes of depth {ds.tree_depth}"}[options.accel]
    print(f"  {label}: {scene.num_triangles} triangles, {layout}; upload + build "
          f"{upload_s:.3f} s (native BVH build: {native_available()})", flush=True)

    uni = sampling.draw_uniforms(sampling.prng_key(0), n, depth, dev)
    o, d = generate_rays(camera, w, h, uni)
    _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])
    alive_per_bounce = [int(x) for x in stats["alive_per_bounce"]]

    for m in modules.values():
        m.reset_launches()
    captures = progressive.graph_counts["captures"]
    state = progressive.init_state(w, h, 0, dev)
    state = progressive.render_steps(ds, camera, state, w, h, options, spp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = progressive.render_steps(ds, camera, state, w, h, options, spp)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    img = progressive.resolve(state, w, h, options)
    torch.cuda.synchronize()
    launches = {k: dict(m.launches) for k, m in modules.items()}
    run = launches[name]
    # Two launches of spp samples, and a capture's warm-up sample.
    samples = 2 * spp + progressive.graph_counts["captures"] - captures
    check(run["closest"] == depth * samples and run["anyhit"] == depth * samples,
          f"{label}: unexpected launch counts {launches}")
    check(launches[SAMPLER]["pixel"] == samples,
          f"{label}: B5 did not draw every sample: {launches[SAMPLER]}")
    check(launches[SHADER] == b6_launches(ds, o, d, uni, options, samples),
          f"{label}: B6 did not shade every bounce of a scene it takes, or ran on another: "
          f"{launches[SHADER]}")
    check(only_path(launches, name), f"{label}: another kernel or a twin ran: {launches}")
    check(bool(torch.isfinite(state.accum).all()), f"{label}: non-finite radiance")
    check(tuple(img.shape) == (h, w, 3), f"{label}: image shape {tuple(img.shape)}")
    check(float(img.mean()) > 0.05, f"{label}: image is black")
    print(f"  {label}: rays_per_sample {rays_per_sample} rays_per_sec "
          f"{rays_per_sample * spp / elapsed:.1f} ms_per_frame {elapsed / spp * 1e3:.3f} "
          f"alive_per_bounce {alive_per_bounce} mean pixel {float(img.mean()):.4f} "
          f"launches {launches}", flush=True)
    rec = {"upload_s": upload_s, "ms_per_frame": elapsed / spp * 1e3,
           "rays_per_sec": rays_per_sample * spp / elapsed}
    if not split_stages:
        return launches, ds, rec

    # Where an eager sample's time goes: CUDA events around each stage, then
    # the kernel's device time from a profiler trace of two eager samples.
    key = sampling.sample_key(sampling.prng_key(0), 0)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    stages = {
        "sampling.pixel_uniforms": lambda: sampling.pixel_uniforms(key, ids, depth),
        "camera.generate_rays": lambda: generate_rays(camera, w, h, uni),
        "integrator.trace_paths": lambda: trace_paths(ds, o, d, uni, options),
        "progressive.render_step": lambda: progressive.render_step(
            ds, camera, state, w, h, options),
    }
    # host included; an eager binary walk syncs the host every step, so once
    reps = 1 if binary else 5
    split = {k: event_ms(f, reps, host_ahead=False) for k, f in stages.items()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            progressive.render_step(ds, camera, state, w, h, options)
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
    kernel_ms = sum(us for us, _ in k_us.values()) / 2e3
    busy_ms = sum(getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
                  for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA) / 2e3
    print(f"  {label} integrator less {tag}: {split['integrator.trace_paths'] - kernel_ms:.3f} "
          f"ms per sample ({tag} {kernel_ms:.3f}); every kernel of a sample on the card "
          f"(profiler) {busy_ms:.3f} ms, {busy_ms / split['progressive.render_step']:.1%} of "
          f"render_step; {tag}'s share of the device's time {kernel_ms / max(busy_ms, 1e-9):.1%}",
          flush=True)
    rec.update({"eager_ms": split, "kernel_device_ms": kernel_ms, "device_busy_ms": busy_ms})
    if binary:
        with twin_walk():
            rec["eager_twin_walk_ms"] = event_ms(lambda: progressive.render_step(
                ds, camera, state, w, h, options), 1, host_ahead=False)
        print(f"  {label} one eager frame through the twin walk (the card's path before B4): "
              f"{rec['eager_twin_walk_ms']:.3f} ms", flush=True)
    return launches, ds, rec


GRAD_STEPS = 150
GRAD_KEYS = ("albedo", "disney", "cam_position")  # the reference's overhead measurement's


def grad_leaves(ds, camera, keys):
    """Fresh leaves of the parameter groups `keys` at the scene's values."""
    m = ds.scene.materials
    values = {"albedo": m.albedo, "disney": m.disney, "emission": m.emission,
              "vertices": ds.scene.vertices,
              "cam_position": torch.tensor(camera.position, device=ds.device),
              "cam_fov": torch.tensor(camera.fov, device=ds.device)}
    return {k: values[k].detach().clone().requires_grad_(True) for k in keys}


def grad_recovery(dev, disney_cfg, base_dir, mt):
    """Phase 18a, BASELINE config #5: scenes/cornell_disney.toml at its own
    256x256 and 3 bounces through auto -> B1, an 8-sample self-target, the
    Disney rows' roughness +0.35 and the camera +0.35 in x, `optimize` at
    lr 2e-2 for GRAD_STEPS steps.  Returns the record and B1's launches."""
    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.core.types import LAMBERT_TYPES
    from caitlynrenderer_tpu_torch.grad.inverse import optimize
    from caitlynrenderer_tpu_torch.ops import threefry
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import render_sample
    from caitlynrenderer_tpu_torch.scene import upload_scene

    sc, cam, opts = render_setup(disney_cfg, base_dir)
    w, h, depth = opts.width, opts.height, opts.max_depth
    check(opts.accel == "brute", f"config #5 resolves to {opts.accel}")
    ds = upload_scene(sc, opts.accel, dev)
    mt.reset_launches()
    threefry.reset_launches()
    target_spp = 8
    with torch.no_grad():
        target = sum(render_sample(ds, cam, sampling.draw_uniforms(
            sampling.fold_in(sampling.prng_key(0), i), w * h, depth, dev), w, h, opts)
            for i in range(target_spp)) / target_spp
    m = ds.scene.materials
    lambert = torch.tensor([int(t) for t in LAMBERT_TYPES], device=dev)
    rows = ~torch.isin(m.albedo[:, 3].to(torch.int64), lambert)
    start_d = m.disney.clone()
    start_d[rows, 0] = torch.clamp(start_d[rows, 0] + 0.35, 0.02, 0.98)
    true_pos = torch.tensor(cam.position, device=dev)
    start = {"disney": start_d, "cam_position": true_pos + torch.tensor([0.35, 0.0, 0.0],
                                                                          device=dev)}

    def errors(p):
        return (float((p["disney"][rows, 0] - m.disney[rows, 0]).abs().max()),
                float((p["cam_position"] - true_pos).norm()))

    trail, finite = [errors(start)], []

    def step(i, loss, p):
        # A non-finite gradient makes Adam's step, and so the parameters,
        # non-finite: finite parameters after every step mean finite
        # gradients.
        finite.append(all(bool(torch.isfinite(v).all()) for v in p.values()))
        trail.append(errors(p))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params, losses = optimize(ds, cam, target, start, w, h, opts, steps=GRAD_STEPS, lr=2e-2,
                              seed=0, callback=step)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / GRAD_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - before
    runs = dict(mt.launches)
    b5 = dict(threefry.launches)
    trail = np.array(trail)
    best = trail[1:].argmin(axis=0) + 1
    rec = {"scene": "scenes/cornell_disney.toml", "size": f"{w}x{h}", "bounces": depth,
           "accel": opts.accel, "steps": GRAD_STEPS, "lr": 2e-2, "ms_per_step": ms_step,
           "peak_bytes": peak, "loss_first": losses[0], "loss_last": losses[-1],
           "loss_mean_first10": float(np.mean(losses[:10])),
           "loss_mean_last10": float(np.mean(losses[-10:])),
           "roughness_err": {"start": trail[0, 0], "min": trail[best[0], 0],
                             "min_step": int(best[0]), "end": trail[-1, 0]},
           "camera_err": {"start": trail[0, 1], "min": trail[best[1], 1],
                          "min_step": int(best[1]), "end": trail[-1, 1]},
           "launches": runs, "b5_launches": b5}
    print(f"  config #5, {w}x{h}, {depth} bounces, {opts.accel}: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} (means of the first and last 10: {rec['loss_mean_first10']:.5f}, "
          f"{rec['loss_mean_last10']:.5f}); {ms_step:.3f} ms per step, peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    for name, col in (("roughness", 0), ("camera", 1)):
        print(f"  {name} error every 10 steps: "
              + " ".join(f"{x:.4f}" for x in trail[::10, col]) + f" | end {trail[-1, col]:.4f}, "
              f"least {trail[best[col], col]:.4f} at step {best[col]}", flush=True)
    print(f"  B1 launches {runs}; B5 {b5}", flush=True)
    check(all(finite), "a gradient of config #5 was not finite")
    check(rec["loss_mean_last10"] < rec["loss_mean_first10"], "config #5: the loss did not fall")
    # The errors reach half their start, then drift (PERF.md: the
    # reference drifts alike); the least error of the run is held.
    for name, col in (("roughness", 0), ("camera", 1)):
        check(trail[best[col], col] <= 0.5 * trail[0, col],
              f"config #5: the {name} error never fell to half its start")
    want = (GRAD_STEPS + target_spp) * depth
    check(runs["closest"] == want and runs["anyhit"] == want,
          f"config #5: B1 launches {runs}, expected {want} each")
    check(runs["closest_twin"] == 0 and runs["anyhit_twin"] == 0, "config #5: a twin ran")
    check(b5 == {"pixel": 0, "lane": GRAD_STEPS + target_spp, "pixel_twin": 0, "lane_twin": 0},
          f"config #5: B5 launches {b5}, expected a lane launch a step and a target sample")
    return rec, runs


def grad_cli(dev):
    """Phase 18b: the `optimize` entry point in a subprocess, on the card;
    its parameters load with checkpoint.load_params."""
    from caitlynrenderer_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_opt_") as tmp:
        out = os.path.join(tmp, "params.npz")
        cmd = [sys.executable, "-m", "caitlynrenderer_tpu_torch.cli", "optimize",
               os.path.join("scenes", "cornell_disney.toml"), "--steps", "20",
               "--perturb-roughness", "0.35", "--optimize-camera", "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        print("  " + " ".join(cmd[1:]) + f": exit {proc.returncode}, {seconds:.3f} s", flush=True)
        for line in proc.stdout.splitlines():
            print("    " + line)
        check(proc.returncode == 0, f"cli optimize failed: {proc.stderr[-2000:]}")
        params, _ = checkpoint.load_params(out, dev)
    check(set(params) == {"albedo", "disney", "cam_position"}
          and all(bool(torch.isfinite(v).all()) for v in params.values()),
          f"cli optimize wrote {sorted(params)}")
    return {"exit": proc.returncode, "seconds": seconds, "params": sorted(params)}


def profile_split(fn):
    """One call of fn() under torch.profiler: (CUDA kernels launched,
    their summed device ms, the CPU-side ops by count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, busy_us, ops = 0, 0.0, {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += evt.count
            busy_us += getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        else:
            ops[evt.key] = evt.count
    return kernels, busy_us / 1e3, ops


def grad_overhead(label, ds, camera, options, keys, reps, warmup, split=False):
    """Phase 18c, the grad-pass overhead ratio as
    benchmarks/run_configs.py:167-242 measures it: one render_sample under
    no_grad against make_loss (the same uniforms, the forward's image as
    target) and backward, for the parameter groups `keys`.  Host clock
    between synchronizations, mean of `reps` after `warmup` calls each;
    peak memory of the value-and-grad calls over what was allocated before
    them.  With `split`, one more call of each under the profiler: kernels
    launched, device-busy ms and the most frequent ops.  rec["calls"]
    counts every forward pass made."""
    from caitlynrenderer_tpu_torch.grad.inverse import make_loss
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import render_sample

    w, h, dev = options.width, options.height, ds.device
    key = sampling.prng_key(0)
    uni = sampling.draw_uniforms(key, w * h, options.max_depth, dev)

    def forward():
        with torch.no_grad():
            return render_sample(ds, camera, uni, w, h, options)

    target = forward()
    loss_fn = make_loss(ds, camera, target, w, h, options)
    grads = {}

    def value_and_grad():
        leaves = grad_leaves(ds, camera, keys)
        loss = loss_fn(leaves, key)
        loss.backward()
        grads.update({k: v.grad for k, v in leaves.items()}, loss=loss.detach())

    def timed(fn, n):
        total = 0.0
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
        return total / n * 1e3 if n else 0.0

    timed(forward, warmup)
    fwd_ms = timed(forward, reps)
    timed(value_and_grad, warmup)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    vg_ms = timed(value_and_grad, reps)
    peak = torch.cuda.max_memory_allocated(dev) - before
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    rec = {"case": label, "keys": list(keys), "reps": reps, "warmup": warmup,
           "forward_ms": fwd_ms, "value_and_grad_ms": vg_ms, "ratio": vg_ms / fwd_ms,
           "peak_bytes": peak, "finite": finite, "calls": 1 + 2 * (reps + warmup)}
    print(f"  {label} ({', '.join(keys)}): forward {fwd_ms:.3f} ms, value and grad "
          f"{vg_ms:.3f} ms, ratio {rec['ratio']:.3f} ({reps} repetitions after {warmup} "
          f"warm-ups), peak {peak / 2**30:.3f} GiB, gradients finite {finite}", flush=True)
    check(finite, f"{label}: a gradient is not finite")
    if split:
        for name, fn in (("forward", forward), ("value_and_grad", value_and_grad)):
            kernels, busy_ms, ops = profile_split(fn)
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
            rec[f"{name}_kernels"], rec[f"{name}_busy_ms"] = kernels, busy_ms
            print(f"    {name} (profiler): {kernels} CUDA kernels, device busy {busy_ms:.3f} ms;"
                  " most frequent ops " + ", ".join(f"{k} {c}" for k, c in top), flush=True)
        rec["calls"] += 2
    return rec


def grad_card_vs_cpu(dev, disney_cfg, base_dir, side):
    """Phase 18d: the Disney floor at side x side, 3 bounces, the same
    uniforms and parameters (every group apply_params takes) on the card
    (B1) and on the CPU (the twins): each gradient entry within rtol 1e-3,
    atol 1e-6 max|g| of the CPU's, the losses within rtol 1e-5."""
    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.grad.inverse import make_loss
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.scene import upload_scene

    sc, cam, opts = render_setup(disney_cfg, base_dir, width=side, height=side, max_depth=3)
    keys = ("albedo", "disney", "emission", "vertices", "cam_position", "cam_fov")
    target = np.random.default_rng(18).uniform(0.0, 0.5, (side * side, 3)).astype(np.float32)
    out = {}
    for where in (dev, torch.device("cpu")):
        ds = upload_scene(sc, opts.accel, where)
        leaves = grad_leaves(ds, cam, keys)
        loss = make_loss(ds, cam, torch.from_numpy(target).to(where), side, side, opts)(
            leaves, sampling.prng_key(5))
        loss.backward()
        out[where.type] = (float(loss.detach()), {k: v.grad.cpu() for k, v in leaves.items()})
    (loss_c, g_c), (loss_h, g_h) = out["cuda"], out["cpu"]
    worst = {}
    for k in keys:
        scale = float(g_h[k].abs().max())
        excess = (g_c[k] - g_h[k]).abs() - (1e-3 * g_h[k].abs() + 1e-6 * scale)
        worst[k] = float(excess.max())
        check(bool(torch.isfinite(g_c[k]).all()) and worst[k] <= 0.0,
              f"card vs CPU, {side}x{side}: the {k} gradient is off by {worst[k]:.3e} beyond "
              "rtol 1e-3, atol 1e-6 max|g|")
    check(abs(loss_c - loss_h) <= 1e-5 * abs(loss_h),
          f"card vs CPU, {side}x{side}: losses {loss_c} and {loss_h}")
    print(f"  Disney floor {side}x{side}, card vs CPU: losses {loss_c:.7f} / {loss_h:.7f}; "
          "largest excess over the bound per group " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items()), flush=True)
    return {"size": f"{side}x{side}", "loss_card": loss_c, "loss_cpu": loss_h}


# Phase 19: tooling and multi-device on the card (tiled render, the node8
# walk, sharded render on a 1x1 NCCL mesh and on two gloo ranks sharing the
# card, the sharded training step, the turntable and benchmark commands).
SHARD_STEPS = 4  # progressive steps of each phase 19 render
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6  # sp > 1: the row's sum reassociates samples


def _timed_steps(step, state, steps, dev):
    """Run `state = step(state)` `steps` times after one warm-up step;
    returns (warm-up state, final state, ms per step)."""
    state = warm = step(state)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize(dev)
    return warm, state, (time.perf_counter() - t0) / steps * 1e3


def _progressive_accum(ds, camera, options, samples, dev):
    """(accum after `samples` progressive samples in one launch, ms per
    frame after a warm-up launch of the same length, the capture)."""
    from caitlynrenderer_tpu_torch.render import progressive

    w, h = options.width, options.height
    st = progressive.init_state(w, h, 0, dev)
    st = progressive.render_steps(ds, camera, st, w, h, options, samples)  # warm-up
    torch.cuda.synchronize(dev)
    st = progressive.init_state(w, h, 0, dev)
    t0 = time.perf_counter()
    st = progressive.render_steps(ds, camera, st, w, h, options, samples)
    torch.cuda.synchronize(dev)
    return st.accum, (time.perf_counter() - t0) / samples * 1e3


def _sharded_accum(ds, camera, options, mesh, steps, dev):
    """Whole accumulation of `steps` sharded steps from seed 0 (each adds
    mesh.sp samples), and ms per frame, after a warm-up step."""
    from caitlynrenderer_tpu_torch.parallel import render as pr

    w, h = options.width, options.height
    st = pr.sharded_render_step(ds, camera, pr.init_sharded_state(mesh, w, h, 0, dev), mesh, w,
                                h, options)  # warm-up
    torch.cuda.synchronize(dev)
    st = pr.init_sharded_state(mesh, w, h, 0, dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        st = pr.sharded_render_step(ds, camera, st, mesh, w, h, options)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / (steps * mesh.sp) * 1e3
    return pr.gather_accum(st, mesh)[: w * h], ms


@contextlib.contextmanager
def captured_queries(*names):
    """Wrap the integrator's ray-query entry points `names` (e.g.
    "brute_closest", "mega_anyhit") for the block: every call still runs,
    and its (name, args, kwargs) is appended to the yielded list, so the
    kernels can be held against their twins on the very inputs a path gave
    them.  The tensor arguments are copies taken at the call: B6 writes the
    next rays and the path state into the loop's buffers."""
    from caitlynrenderer_tpu_torch.render import integrator

    calls, real = [], {n: getattr(integrator, n) for n in names}

    def wrap(name):
        def query(*args, **kw):
            kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            calls.append((name, kept, kw))
            return real[name](*args, **kw)
        return query

    for n in names:
        setattr(integrator, n, wrap(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(integrator, n, fn)


def hold_to_twins(calls, module):
    """Run each captured query again through its kernel and through the
    kernel's plain twin (`module.<name>_plain`) on the same inputs; returns
    (queries, largest ray count, number of queries whose outputs differ
    anywhere, bit for bit)."""
    differ, rays = 0, 0
    for name, args, kw in calls:
        got = getattr(module, name)(*args, **kw)
        want = getattr(module, name + "_plain")(*args, **kw)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        differ += not all(torch.equal(a, b) for a, b in zip(got, want))
        rays = max(rays, args[0].shape[0])
    return len(calls), rays, differ


def _call_ms(fn):
    """(fn(), milliseconds of the call on the card's clock, CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gloo_rank(rank, world, init, out_dir):
    """Phase 19d, one of two ranks sharing cuda:0 over gloo (all-reduce on
    CUDA tensors): the cornell demo on the 2x1 and the 1x2 mesh, the whole
    accumulation, ms per frame, B1's launches and B1 against its twin on
    one sample's queries of the rank's block saved for the parent."""
    from datetime import timedelta

    import torch.distributed as dist

    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.ops import mt_brute as mt
    from caitlynrenderer_tpu_torch.ops import threefry
    from caitlynrenderer_tpu_torch.parallel import distributed as pd
    from caitlynrenderer_tpu_torch.parallel import render as pr
    from caitlynrenderer_tpu_torch.parallel.mesh import make_mesh
    from caitlynrenderer_tpu_torch.scene import upload_scene

    dev = torch.device("cuda:0")
    pd.init_distributed(init_method=init, world_size=world, rank=rank, backend="gloo",
                        device=dev, timeout=timedelta(seconds=300))
    try:
        with open(CORNELL_TOML, "rb") as f:
            cfg = tomllib.load(f)
        scene, camera, options = render_setup(cfg, os.path.dirname(CORNELL_TOML), width=DEMO,
                                              height=DEMO, max_depth=3, accel="auto")
        ds = upload_scene(scene, options.accel, dev)
        out = {"backend": dist.get_backend()}
        for shape in ((2, 1), (1, 2)):
            mesh = make_mesh(shape)
            with captured_queries("brute_closest", "brute_anyhit") as calls:
                pr.sharded_render_step(ds, camera, pr.init_sharded_state(mesh, DEMO, DEMO, 0, dev),
                                       mesh, DEMO, DEMO, options)
            twins = hold_to_twins(calls, mt)
            mt.reset_launches()
            threefry.reset_launches()
            accum, ms = _sharded_accum(ds, camera, options, mesh, SHARD_STEPS // mesh.sp, dev)
            out[shape] = {"accum": accum.cpu(), "ms": ms, "launches": dict(mt.launches),
                          "b5_launches": dict(threefry.launches), "b1_vs_twin": twins}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase19(dev, setup, camera, grid, grid_cam, g3, go, gd, gact, guni, b3o, b3d, b3act, smi):
    """Phase 19 (a)-(f); returns (record, B1/B2/B3 launches of its main
    paths under "auto").  B5 must draw every sample of each path."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from caitlynrenderer_tpu_torch.cli import render_setup, turntable_camera
    from caitlynrenderer_tpu_torch.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.io.image import load_png, save_png
    from caitlynrenderer_tpu_torch.ops import mt_brute as mt
    from caitlynrenderer_tpu_torch.ops import threefry
    from caitlynrenderer_tpu_torch.ops import traverse_cw8 as cw8
    from caitlynrenderer_tpu_torch.ops import traverse_cwbvh as walk
    from caitlynrenderer_tpu_torch.ops import traverse_mega as mega
    from caitlynrenderer_tpu_torch.parallel import distributed as pd
    from caitlynrenderer_tpu_torch.parallel import render as pr
    from caitlynrenderer_tpu_torch.parallel.mesh import SINGLE, make_mesh
    from caitlynrenderer_tpu_torch.render import progressive, tiled
    from caitlynrenderer_tpu_torch.scene import required_stack, scene_families, upload_scene
    from caitlynrenderer_tpu_torch.utils import config

    t19 = time.perf_counter()
    rec = {"device": smi}
    totals = {"mt_brute": {"closest": 0, "anyhit": 0}, "traverse_mega": {"closest": 0, "anyhit": 0},
              "traverse_cw8": {"closest": 0, "anyhit": 0}}
    modules = {"mt_brute": mt, "traverse_mega": mega, "traverse_cw8": cw8, SAMPLER: threefry}

    def reset():
        for m in modules.values():
            m.reset_launches()

    def read(name, want_min, label, samples):
        """Add kernel `name`'s launches since reset() to the totals; the
        kernel must have run, B5 once a sample (`samples` pixel draws),
        their twins and the other kernels not."""
        runs = {k: dict(m.launches) for k, m in modules.items()}
        check(runs[name]["closest"] >= want_min and runs[name]["anyhit"] >= want_min,
              f"{label}: {name} not launched: {runs}")
        check(runs[SAMPLER]["pixel"] == samples,
              f"{label}: B5 drew {runs[SAMPLER]['pixel']} times, not {samples}")
        check(only_path(runs, name), f"{label}: another path ran: {runs}")
        for q in ("closest", "anyhit"):
            totals[name][q] += runs[name][q]
        return runs[name]

    # (a) the cornell demo tiled 4x4 through B1, against the untiled render.
    sc_demo, _, opts = setup(DEMO, DEMO)
    ds = upload_scene(sc_demo, opts.accel, dev)
    tiled_opts = opts._replace(num_tiles_x=4, num_tiles_y=4)
    with captured_queries("brute_closest", "brute_anyhit") as calls:
        tiled.accumulate_tiled(ds, camera, tiled_opts, spp=1)  # warm-up
    n_q, n_rays, differ = hold_to_twins(calls, mt)
    check(n_q == 16 * 3 * 2 and differ == 0,
          f"(a) B1 against its twin on the tiles' queries: {differ} of {n_q} differ")
    print(f"  (a) B1 against its twin on one tiled sample's {n_q} queries ({n_rays} rays "
          f"each): equal bit for bit", flush=True)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    acc_t = tiled.accumulate_tiled(ds, camera, tiled_opts, spp=SHARD_STEPS)
    torch.cuda.synchronize()
    ms_tiled = (time.perf_counter() - t0) / SHARD_STEPS * 1e3
    runs = read("mt_brute", 16 * 3 * SHARD_STEPS, "(a) tiled cornell", 16 * SHARD_STEPS)
    reset()
    captures = progressive.graph_counts["captures"]
    acc_u, ms_untiled = _progressive_accum(ds, camera, opts, SHARD_STEPS, dev)
    read("mt_brute", 3 * SHARD_STEPS, "(a) untiled cornell",
         2 * SHARD_STEPS + progressive.graph_counts["captures"] - captures)
    check(torch.equal(acc_t, acc_u), "(a) the tiled cornell differs from the untiled one")
    rec["a_tiled_cornell"] = {"ms_per_frame_tiled": ms_tiled, "ms_per_frame_untiled": ms_untiled,
                              "tiles": 16, "b1_launches": runs, "bit_equal": True,
                              "b1_vs_twin": {"queries": n_q, "rays": n_rays, "differ": differ}}
    print(f"  (a) cornell {DEMO}x{DEMO}, 3 bounces, 4x4 tiles through B1: {ms_tiled:.3f} ms/frame "
          f"tiled, {ms_untiled:.3f} untiled; accumulations equal bit for bit; B1 {runs}",
          flush=True)

    # (b) grid100k: the node8 torch walk (traversal "xla") against B3.
    gc = cw_args(g3)
    _, gtri, _ = cw8.cw8_closest(go, gd, gact, *gc)
    sets = {"primary": (go, gd, gact, None), "bounce": (b3o, b3d, b3act, None),
            "shadow": shadow_rays(g3, go, gd, gtri, guni)}
    rng19 = np.random.default_rng(19)
    walk_rec = {}
    for label, (qo, qd, qa, qt) in sets.items():
        if qt is None:
            qt = torch.as_tensor(rng19.uniform(0, 20, qo.shape[0]), dtype=torch.float32,
                                 device=dev)
        # The walk's time: one call as its caller sees it (it syncs the host
        # every step, so there is no device time apart from the host's).
        reset()
        (tw, triw, _, _), walk_closest_ms = _call_ms(lambda: walk.cwbvh_closest(
            qo, qd, qa, g3.cw_nodes, g3.tris9, g3.cw_depth))
        occw, walk_anyhit_ms = _call_ms(lambda: walk.cwbvh_anyhit(
            qo, qd, qt, qa, g3.cw_nodes, g3.tris9, g3.cw_depth))
        check(all(v == 0 for m in modules.values() for v in m.launches.values()),
              f"(b) {label}: the node8 walk launched a kernel or a twin")
        t3, tri3, _ = cw8.cw8_closest(qo, qd, qa, *gc)
        occ3 = cw8.cw8_anyhit(qo, qd, qt, qa, *gc)
        torch.cuda.synchronize()

        def cracks(bad):
            i = bad.nonzero()[:, 0]
            tt, trt, _ = cw8.cw8_closest_plain(qo[i], qd[i], qa[i], *gc)
            ot = cw8.cw8_anyhit_plain(qo[i], qd[i], qt[i], qa[i], *gc)
            twin_equal = (torch.equal(tt, t3[i]) and torch.equal(trt, tri3[i])
                          and torch.equal(ot, occ3[i]))
            return twin_equal, torch.minimum(edge_distance(qo[i], qd[i], g3.tris9, triw[i]),
                                             edge_distance(qo[i], qd[i], g3.tris9, tri3[i]))

        check_vs_b1(f"(b) grid100k {label}, B3 against the node8 walk", t3, tri3, occ3, tw,
                    triw, occw, qt, g3.tris9, g3.tris9, None if label == "primary" else qd,
                    cracks)
        walk_rec[label] = {
            "rays": int(qa.sum()), "walk_closest_ms": walk_closest_ms,
            "walk_anyhit_ms": walk_anyhit_ms,
            "b3_closest_ms": event_ms(lambda: cw8.cw8_closest(qo, qd, qa, *gc), 20),
            "b3_anyhit_ms": event_ms(lambda: cw8.cw8_anyhit(qo, qd, qt, qa, *gc), 20)}
        print(f"    {label}: " + ", ".join(f"{k} {v:.4f}" if k != "rays" else f"{k} {v}"
                                           for k, v in walk_rec[label].items()), flush=True)
    gopts = RenderOptions(width=BENCH, height=BENCH, max_depth=BENCH_DEPTH, accel="cwbvh",
                          families=scene_families(grid))
    progressive.render_step(g3, grid_cam, progressive.init_state(BENCH, BENCH, 0, dev), BENCH,
                            BENCH, gopts)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    progressive.render_step(g3, grid_cam, progressive.init_state(BENCH, BENCH, 0, dev), BENCH,
                            BENCH, gopts)
    torch.cuda.synchronize()
    ms_auto = (time.perf_counter() - t0) * 1e3
    runs = read("traverse_cw8", BENCH_DEPTH, "(b) grid100k cwbvh, auto", 1)
    check(runs["closest"] == BENCH_DEPTH and runs["anyhit"] == BENCH_DEPTH,
          f"(b) auto: B3 launches {runs}")
    # "xla" is the reference's plain walks for CPU tensors: on the card it
    # refuses to run, so no frame walks past B3.
    reset()
    refused = None
    try:
        progressive.render_step(g3, grid_cam, progressive.init_state(BENCH, BENCH, 0, dev),
                                BENCH, BENCH, gopts._replace(traversal="xla"))
    except ValueError as e:
        refused = str(e)
    check(refused is not None, '(b) traversal "xla" rendered on the card')
    check(all(v == 0 for k, m in modules.items() for q, v in m.launches.items()
              if (k, q) != (SAMPLER, "pixel")) and threefry.launches["pixel"] == 1,
          '(b) traversal "xla": a kernel but B5\'s draw, or a twin, ran before the refusal')
    rec["b_node8_walk"] = {"rays": walk_rec, "frames": {
        "auto": {"ms_per_frame": ms_auto, "b3_launches": runs}, "xla": {"refused": refused}}}
    print(f"  (b) grid100k {BENCH}x{BENCH}, {BENCH_DEPTH} bounces, cwbvh: ms/frame auto (B3) "
          f"{ms_auto:.3f}, B3 launches {runs}; xla on the card refused: {refused}", flush=True)

    # (c) a 1x1 mesh under NCCL: the cornell demo (B1) and grid100k wide (B2).
    pd.init_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
                        backend="nccl", device=pd.rank_device("cuda"))
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    mesh = make_mesh((1, 1))
    check(mesh.group is not None, "the 1x1 mesh has no process group")
    wds = upload_scene(grid, "wide", dev)
    wopts = gopts._replace(accel="wide")
    rec["c_nccl_1x1"] = {}
    for label, cds, copts, name in (("cornell", ds, opts, "mt_brute"),
                                    ("grid100k wide", wds, wopts, "traverse_mega")):
        # The kernel against its twin on the queries of one sharded sample:
        # every one of B1's; B2's first bounce (its twin takes about a
        # second a query at this size).
        queries = ("brute_closest", "brute_anyhit") if name == "mt_brute" else (
            "mega_closest", "mega_anyhit")
        with captured_queries(*queries) as calls:
            pr.sharded_render_step(cds, camera if label == "cornell" else grid_cam,
                                   pr.init_sharded_state(mesh, copts.width, copts.height, 0, dev),
                                   mesh, copts.width, copts.height, copts)
        n_q, n_rays, differ = hold_to_twins(calls if name == "mt_brute" else calls[:2],
                                            modules[name])
        check(differ == 0, f"(c) {label}: {differ} of {n_q} queries differ from the twin")
        reset()
        acc_s, ms_s = _sharded_accum(cds, camera if label == "cornell" else grid_cam, copts, mesh,
                                     SHARD_STEPS, dev)
        runs = read(name, copts.max_depth * SHARD_STEPS, f"(c) {label} sharded",
                    SHARD_STEPS + 1)
        reset()
        captures = progressive.graph_counts["captures"]
        acc_p, ms_p = _progressive_accum(cds, camera if label == "cornell" else grid_cam, copts,
                                         SHARD_STEPS, dev)
        read(name, copts.max_depth * SHARD_STEPS, f"(c) {label} progressive",
             2 * SHARD_STEPS + progressive.graph_counts["captures"] - captures)
        check(torch.equal(acc_s, acc_p), f"(c) {label}: the 1x1 NCCL mesh differs")
        rec["c_nccl_1x1"][label] = {"ms_per_frame_sharded": ms_s, "ms_per_frame_progressive": ms_p,
                                    "launches": runs, "bit_equal": True,
                                    "kernel_vs_twin": {"queries": n_q, "rays": n_rays,
                                                       "differ": differ}}
        print(f"  (c) {label} on a 1x1 NCCL mesh: {ms_s:.3f} ms/frame, progressive loop "
              f"{ms_p:.3f}; accumulations equal bit for bit; {name} {runs}; the kernel equal "
              f"to its twin bit for bit on {n_q} of the mesh's queries ({n_rays} rays)",
              flush=True)
    img = pd.assemble_image(pr.init_sharded_state(mesh, 8, 8, 0, dev)._replace(frame_count=1),
                            mesh, 8, 8, opts)
    check(img.shape == (8, 8, 3), "assemble_image")
    rep = pd.scaling_report(wds, grid_cam, wopts, BENCH, BENCH, spp=4)
    check(rep["devices"] == 1 and rep["scaling_efficiency"] == 1.0, f"scaling {rep}")
    rec["c_scaling_report"] = rep
    print(f"  (c) scaling_report, grid100k wide on one card: {rep}", flush=True)
    dist.destroy_process_group()

    # (d) two ranks sharing the card over gloo, against (a)'s progressive
    # accumulation of the same SHARD_STEPS samples.
    want = acc_u.cpu()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        ctx = mp.start_processes(gloo_rank, args=(2, "file://" + os.path.join(tmp, "rdv"), tmp),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError("(d) the gloo ranks did not finish in 600 s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    rec["d_gloo_two_ranks"] = {"backend": ranks[0]["backend"]}
    for shape in ((2, 1), (1, 2)):
        for r in ranks:
            got = r[shape]["accum"]
            if shape[1] == 1:
                check(torch.equal(got, want), f"(d) {shape}: differs from the loop")
            else:
                check(torch.allclose(got, want, rtol=SHARD_RTOL, atol=SHARD_ATOL),
                      f"(d) {shape}: beyond rtol {SHARD_RTOL}")
            runs = r[shape]["launches"]
            check(runs["closest"] > 0 and runs["anyhit"] > 0 and runs["closest_twin"] == 0
                  and runs["anyhit_twin"] == 0, f"(d) {shape}: B1 launches {runs}")
            b5 = r[shape]["b5_launches"]
            check(b5 == {"pixel": SHARD_STEPS // shape[1] + 1, "lane": 0, "pixel_twin": 0,
                         "lane_twin": 0}, f"(d) {shape}: B5 launches {b5}")
            n_q, n_rays, differ = r[shape]["b1_vs_twin"]
            check(n_q == 2 * opts.max_depth and n_rays == DEMO * DEMO // shape[0] and differ == 0,
                  f"(d) {shape}: B1 against its twin on the rank's queries: {differ} of "
                  f"{n_q} differ ({n_rays} rays)")
            for q in ("closest", "anyhit"):
                totals["mt_brute"][q] += runs[q]
        err = float((ranks[0][shape]["accum"] - want).abs().max())
        rec["d_gloo_two_ranks"][f"{shape[0]}x{shape[1]}"] = {
            "ms_per_frame": [r[shape]["ms"] for r in ranks], "max_abs_err": err,
            "b1_launches": [r[shape]["launches"] for r in ranks],
            "b1_vs_twin": [r[shape]["b1_vs_twin"] for r in ranks]}
        print(f"  (d) cornell on a {shape[0]}x{shape[1]} mesh, two gloo ranks on cuda:0: ms/frame "
              f"{[round(r[shape]['ms'], 3) for r in ranks]} (progressive loop "
              f"{ms_untiled:.3f}); max |diff| {err:.3e}; B1 equal to its twin bit for bit on "
              f"each rank's {ranks[0][shape]['b1_vs_twin'][0]} queries of "
              f"{ranks[0][shape]['b1_vs_twin'][1]} rays", flush=True)

    # (e) one sharded training step (1x1 mesh), card against CPU: the same
    # target, parameters and key; the CPU runs B1's twin.
    cpu, side = torch.device("cpu"), 64
    sc64, cam64, o64 = setup(side, side)
    uploads = {w.type: upload_scene(sc64, o64.accel, w) for w in (dev, cpu)}
    target = progressive.render_steps(uploads["cpu"], cam64,
                                      progressive.init_state(side, side, 0, cpu), side, side,
                                      o64, 2).accum / 2.0
    albedo = uploads["cpu"].scene.materials.albedo.clone()
    albedo[:, :3] *= 0.5
    params0 = {"albedo": albedo, "cam_position": torch.tensor(cam64.position)}
    res = {}
    for where in (dev, cpu):
        reset()
        new, loss = pr.sharded_train_step({k: v.to(where) for k, v in params0.items()},
                                          uploads[where.type], cam64, target.to(where), (0, 11),
                                          0, SINGLE, side, side, o64, lr=2.0)
        res[where.type] = ({k: v.cpu() for k, v in new.items()}, loss)
        if where.type == "cuda":
            runs = read("mt_brute", 3, "(e) train step", 1)
    (new_c, loss_c), (new_h, loss_h) = res["cuda"], res["cpu"]
    check(abs(loss_c - loss_h) <= 1e-4 * abs(loss_h), f"(e) losses {loss_c} / {loss_h}")
    for k, v in params0.items():
        sw, sg = new_h[k] - v, new_c[k] - v
        check(torch.allclose(sg, sw, rtol=1e-3, atol=1e-6 * float(sw.abs().max())),
              f"(e) {k}: the card's step differs from the CPU's")
    rec["e_train_step"] = {"loss_card": loss_c, "loss_cpu": loss_h, "b1_launches": runs}
    print(f"  (e) sharded_train_step, cornell {side}x{side}: loss card {loss_c:.7f} CPU "
          f"{loss_h:.7f}; steps within rtol 1e-3; B1 {runs}", flush=True)

    # (f) the turntable and benchmark commands, and a --mesh render under
    # torchrun (one NCCL rank), three subprocesses at once.
    rec["f_cli"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        toml = os.path.join("scenes", "cornell.toml")
        cli = ["-m", "caitlynrenderer_tpu_torch.cli"]
        cmds = {"turntable": [*cli, "render", toml, "--turntable", "2", "--spp", "4", "-o",
                              os.path.join(tmp, "tt.png")],
                "benchmark": [*cli, "benchmark", "--scene", "cornell", "--steps", "2"],
                "mesh": ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                         *cli, "render", toml, "--mesh", "1x1", "--spp", "4", "-o",
                         os.path.join(tmp, "mesh.png")]}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen([sys.executable, *cmd], cwd=ROOT, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                 for name, cmd in cmds.items()}
        try:  # all run at once; communicate() reads each one's pipes to its end
            outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        seconds = time.perf_counter() - t0
        for name, (stdout, stderr) in outs.items():
            code = procs[name].returncode
            print(f"  (f) {' '.join(cmds[name][1:])}: exit {code}", flush=True)
            for line in stdout.splitlines()[-4:]:
                print("    " + line)
            check(code == 0, f"(f) cli {name} failed: {stderr[-2000:]}")
            rec["f_cli"][name] = {"exit": code}
        print(f"  (f) the three commands done in {seconds:.3f} s", flush=True)
        rec["f_cli"]["seconds_all"] = seconds
        # Each image against the same render made here, from the same
        # config, camera and seed through the same kernel: equal PNGs.
        # (The turntable's second frame looks at the box from behind, so a
        # brightness floor would not hold for it.)
        with open(CORNELL_TOML, "rb") as f:
            cfg = tomllib.load(f)
        base = os.path.dirname(CORNELL_TOML)
        sc_f, cam_f, o_f = render_setup(cfg, base)
        ds_f = upload_scene(sc_f, o_f.accel, dev, max_leaf=o_f.max_leaf)
        o_f = o_f._replace(max_stack=required_stack(ds_f))
        translation = config.scene_from_config(cfg, base)[1]
        wants = {f"tt_{k:03d}.png": turntable_camera(cfg, translation, k, 2) for k in range(2)}
        wants["mesh.png"] = cam_f
        for png, cam in wants.items():
            st = progressive.render_steps(ds_f, cam, progressive.init_state(o_f.width, o_f.height,
                                                                            0, dev),
                                          o_f.width, o_f.height, o_f, 4)
            save_png(os.path.join(tmp, "want_" + png),
                     progressive.resolve(st, o_f.width, o_f.height, o_f).cpu().numpy())
            got = os.path.join(tmp, png)
            check(os.path.exists(got) and load_png(got).shape == (256, 256, 3),
                  f"(f) {png} missing or not 256x256")
            check(np.array_equal(load_png(got), load_png(os.path.join(tmp, "want_" + png))),
                  f"(f) {png} differs from the same render made in this process")
        check(load_png(os.path.join(tmp, "mesh.png")).mean() > 0.05, "(f) mesh.png is black")
        print("  (f) the turntable's two frames and mesh.png equal, PNG for PNG, the same renders "
              "made in this process", flush=True)
        rec["f_cli"]["benchmark"]["result"] = json.loads(
            outs["benchmark"][0].strip().splitlines()[-1])
    rec["seconds"] = time.perf_counter() - t19
    print(f"  phase 19: {rec['seconds']:.3f} s", flush=True)
    return rec, totals


# Phase 21 (a)'s main paths under B4: (label, scene, accel).
BINARY_MAIN_PATHS = (("grid100k bvh2", "grid100k", "bvh2"), ("grid1m bvh2", "grid1m", "bvh2"),
                     ("grid100k sbvh", "grid100k", "sbvh"), ("grid1m sbvh", "grid1m", "sbvh"))

# Phase 20: samples per launch (render/progressive.py's CUDA graphs).
GRAPH_SPP = 16  # samples a replay of phase 20's graphs


def graph_pool_bytes():
    """Bytes the caching allocator holds in CUDA graph pools (those of
    render/progressive.py's graphs, the only graphs this script makes)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


class CaptureRecords(logging.Handler):
    """The port's "graph_capture" log records, as dicts, while installed
    with `with`."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rows = []
        self.logger = logging.getLogger("caitlynrenderer_tpu_torch")

    def emit(self, record):
        kind, _, body = record.getMessage().partition(" ")
        if kind == "graph_capture":
            self.rows.append(json.loads(body))

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def phase20(dev, smi, runs, binary_runs, cfg, base_dir):
    """Phase 20 (a)-(e).  runs: [(label, upload, camera, options)] for (a);
    the first is the cornell demo through B1, whose graph (b) reuses;
    binary_runs likewise for (d), under "bvh2"/"sbvh" (B4).  Returns
    (record, kernel launches of (a), (b), (d) and (e) by module)."""
    from caitlynrenderer_tpu_torch.cli import render_setup, turntable_camera
    from caitlynrenderer_tpu_torch.io.image import load_png, save_png
    from caitlynrenderer_tpu_torch.render import progressive
    from caitlynrenderer_tpu_torch.scene import required_stack, upload_scene
    from caitlynrenderer_tpu_torch.utils import config

    t20 = time.perf_counter()
    modules = kernel_modules()
    mt = modules["mt_brute"]
    totals = {k: {"closest": 0, "anyhit": 0} for k in modules}
    rec = {"device": smi, "spp_per_launch": GRAPH_SPP, "a_graph_vs_eager": {},
           "d_binary_graph_vs_eager": {}}

    def reset():
        for m in modules.values():
            m.reset_launches()

    def eager(ds, camera, options, n):
        w, h = options.width, options.height
        st = progressive.init_state(w, h, 0, dev)
        for _ in range(n):
            st = progressive.render_step(ds, camera, st, w, h, options)
        return st

    def graph_vs_eager(tag, label, ds, camera, options):
        """2 replays of a graph of 16 samples against 32 eager samples, bit
        for bit; both paths' ms/frame, the capture's numbers."""
        name = PATH_KERNEL[options.accel][0]
        w, h, depth = options.width, options.height, options.max_depth
        eager(ds, camera, options, 1)  # the eager path warm
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        want = eager(ds, camera, options, 2 * GRAPH_SPP)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / (2 * GRAPH_SPP) * 1e3
        counts = dict(progressive.graph_counts)
        alloc0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with CaptureRecords() as captured:
            st = progressive.render_steps(ds, camera, progressive.init_state(w, h, 0, dev),
                                          w, h, options, GRAPH_SPP)
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - alloc0
        st = progressive.render_steps(ds, camera, st, w, h, options, GRAPH_SPP)
        torch.cuda.synchronize()
        check(st.frame_count == 2 * GRAPH_SPP and torch.equal(st.accum, want.accum),
              f"({tag}) {label}: two replays of {GRAPH_SPP} samples differ from "
              f"{2 * GRAPH_SPP} eager samples")
        t0 = time.perf_counter()
        for _ in range(2):
            st = progressive.render_steps(ds, camera, st, w, h, options, GRAPH_SPP)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) / (2 * GRAPH_SPP) * 1e3
        check(progressive.graph_counts == {"captures": counts["captures"] + 1,
                                           "replays": counts["replays"] + 4},
              f"({tag}) {label}: graphs {progressive.graph_counts}, before {counts}")
        check(len(captured.rows) == 1, f"({tag}) {label}: capture records {captured.rows}")
        g = captured.rows[0]
        per_replay = g["launches"][name]
        check(g["nodes"] > 0 and g["spp"] == GRAPH_SPP
              and g["device"] == f"cuda:{torch.cuda.current_device()}"
              and per_replay["closest"] == per_replay["anyhit"] == depth * GRAPH_SPP
              and g["launches"][SAMPLER]["pixel"] == GRAPH_SPP
              and only_path(g["launches"], name), f"({tag}) {label}: the graph holds {g}")
        launches = {k: dict(m.launches) for k, m in modules.items()}
        samples = 2 * GRAPH_SPP + 1 + 4 * GRAPH_SPP  # eager, the warm-up, 4 replays
        check(launches[name]["closest"] == launches[name]["anyhit"] == depth * samples
              and launches[SAMPLER]["pixel"] == samples,
              f"({tag}) {label}: launches {launches}")
        check(only_path(launches, name), f"({tag}) {label}: another path ran: {launches}")
        for q in ("closest", "anyhit"):
            totals[name][q] += launches[name][q]
        nodes = g["nodes"]
        row = {"eager_ms_per_frame": eager_ms, "graph_ms_per_frame": graph_ms,
               "first_launch_s": first_s, "capture_s": g["capture_s"],
               "instantiate_s": g["instantiate_s"], "nodes": nodes,
               "nodes_per_sample": nodes / GRAPH_SPP, "pool_bytes": graph_pool_bytes(),
               "peak_bytes_first_launch": peak, "launches_per_replay": per_replay}
        print(f"  ({tag}) {label}: eager {eager_ms:.3f} ms/frame, graph {graph_ms:.3f} "
              f"({eager_ms / graph_ms:.2f}x); first launch {first_s:.3f} s (capture "
              f"{g['capture_s']:.3f} s, instantiate {g['instantiate_s']:.3f} s); {nodes} nodes "
              f"({nodes / GRAPH_SPP:.1f} a sample); graph pool {row['pool_bytes'] / 2**20:.1f} "
              f"MiB, peak over the first launch {peak / 2**20:.1f} MiB; kernel nodes of "
              f"{name}, which a replay adds: {per_replay}; 2 replays equal {2 * GRAPH_SPP} "
              "eager samples bit for bit", flush=True)
        return row

    # (a) 2 replays of a graph of 16 samples against 32 eager samples.
    for label, ds, camera, options in runs:
        rec["a_graph_vs_eager"][label] = graph_vs_eager("a", label, ds, camera, options)

    # (b) a turntable of three orbit cameras through (a)'s first graph, each
    # frame equal to its eager render.
    label, ds, _, options = runs[0]
    w, h = options.width, options.height
    translation = config.scene_from_config(cfg, base_dir)[1]
    counts = dict(progressive.graph_counts)
    reset()
    state = progressive.init_state(w, h, 0, dev)
    for k in range(3):
        cam_k = turntable_camera(cfg, translation, k, 3)
        state = progressive.render_steps(ds, cam_k, progressive.reset(state), w, h, options,
                                         GRAPH_SPP)
        want = eager(ds, cam_k, options, GRAPH_SPP)
        check(torch.equal(state.accum, want.accum), f"(b) turntable frame {k} differs from "
              "its eager render")
    check(progressive.graph_counts == {"captures": counts["captures"],
                                       "replays": counts["replays"] + 3},
          f"(b) the turntable captured again: {progressive.graph_counts}")
    for q in ("closest", "anyhit"):
        totals["mt_brute"][q] += mt.launches[q]
    rec["b_turntable"] = {"frames": 3, "captures": 0, "bit_equal": True}
    print(f"  (b) turntable of 3 orbit cameras, {label}: one cached graph, no capture, each "
          "frame equal to its eager render bit for bit", flush=True)

    # (c) cli render at 700x700, 64 samples in one launch, in a subprocess,
    # its log records on stderr; its PNG against the eager render.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spl_") as tmp:
        out = os.path.join(tmp, "cli.png")
        argv = ["render", CORNELL_TOML, "--spp", "64", "--spp-per-launch", "64", "--width",
                str(DEMO), "--height", str(DEMO), "-o", out]
        code = ("import logging, sys; logging.basicConfig(level=logging.INFO, "
                "format='%(message)s'); from caitlynrenderer_tpu_torch.cli import main; "
                "sys.exit(main(sys.argv[1:]))")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"(c) cli render failed: {proc.stderr[-2000:]}")
        progress = [json.loads(line.split(" ", 1)[1]) for line in proc.stderr.splitlines()
                    if line.startswith("progress ")]
        check(progress and progress[-1]["spp"] == 64 and progress[-1]["samples"] == 64,
              f"(c) progress records {progress}")
        capture = [json.loads(line.split(" ", 1)[1]) for line in proc.stderr.splitlines()
                   if line.startswith("graph_capture ")]
        check(len(capture) == 1 and capture[0]["spp"] == 64 and capture[0]["nodes"] > 0,
              f"(c) capture records {capture}")
        sc, cam, opts = render_setup(cfg, base_dir, width=DEMO, height=DEMO)
        cds = upload_scene(sc, opts.accel, dev, max_leaf=opts.max_leaf)
        opts = opts._replace(max_stack=required_stack(cds))
        st = eager(cds, cam, opts, 64)
        save_png(os.path.join(tmp, "eager.png"), progressive.resolve(st, DEMO, DEMO, opts)
                 .cpu().numpy())
        check(np.array_equal(load_png(out), load_png(os.path.join(tmp, "eager.png"))),
              "(c) the CLI's PNG differs from the eager render")
    rec["c_cli"] = {"seconds": cli_s, "accel": opts.accel, "progress": progress,
                    "capture": capture[0]}
    print(f"  (c) cli render {os.path.relpath(CORNELL_TOML, ROOT)} at {DEMO}x{DEMO}, --spp 64 "
          f"--spp-per-launch 64 (accel {opts.accel}): {cli_s:.3f} s in a subprocess; "
          f"progress {progress}; the 64-sample graph: {capture[0]['nodes']} nodes, capture "
          f"{capture[0]['capture_s']:.3f} s, instantiate {capture[0]['instantiate_s']:.3f} s; "
          "its PNG equal to the eager render", flush=True)

    # (d) the same under "bvh2" and "sbvh": B4 in the graph.
    for label, ds, camera, options in binary_runs:
        rec["d_binary_graph_vs_eager"][label] = graph_vs_eager("d", label, ds, camera, options)

    # (e) the cornell at 1920x1080 in launches of 4, 2 and 2 samples (the
    # --resume loop's halving) through two graphs sharing one pool, against
    # 8 eager samples; the pool's bytes after each launch.
    progressive.clear_graphs()
    torch.cuda.empty_cache()
    label, ds, camera, options = runs[0]
    big = options._replace(width=1920, height=1080)
    reset()
    want = eager(ds, camera, big, 8)
    pools = []
    with CaptureRecords() as captured:
        st = progressive.init_state(1920, 1080, 0, dev)
        for n in (4, 2, 2):
            st = progressive.render_steps(ds, camera, st, 1920, 1080, big, n)
            torch.cuda.synchronize()
            pools.append(graph_pool_bytes())
    check(st.frame_count == 8 and torch.equal(st.accum, want.accum),
          "(e) launches of 4, 2 and 2 samples differ from 8 eager samples")
    check([r["spp"] for r in captured.rows] == [4, 2], f"(e) captures {captured.rows}")
    check(pools[1] <= 1.1 * pools[0], f"(e) the second graph grew the shared pool from "
          f"{pools[0]} to {pools[1]} bytes")
    for q in ("closest", "anyhit"):
        totals["mt_brute"][q] += mt.launches[q]
    rec["e_shared_pool"] = {"resolution": [1920, 1080], "launches": [4, 2, 2],
                            "pool_bytes_after_each_launch": pools, "captures": captured.rows}
    caps = [(r["spp"], r["nodes"], r["capture_s"]) for r in captured.rows]
    print(f"  (e) cornell 1920x1080 (B1), launches of 4, 2, 2 samples equal to 8 eager samples "
          f"bit for bit; graph pool after each launch {[round(p / 2**20, 1) for p in pools]} "
          f"MiB (two graphs, one pool); captures (spp, nodes, seconds) {caps}", flush=True)
    rec["seconds"] = time.perf_counter() - t20
    print(f"  phase 20: {rec['seconds']:.3f} s", flush=True)
    return rec, totals


# Phase 21: kernel B4, the binary-BVH walk (ops/traverse_bvh.py).

SBVH_BUILD = """\
import sys, time
import numpy as np
from caitlynrenderer_tpu_torch.bench import bench_scene
from caitlynrenderer_tpu_torch.accel.sbvh import build_sbvh
scene = bench_scene("grid1m")[0]
t0 = time.perf_counter()
bvh = build_sbvh(scene.vertices, scene.tri_v, max_leaf=4)
np.savez(sys.argv[1], seconds=time.perf_counter() - t0, node_bounds=bvh.node_bounds,
         node_meta=bvh.node_meta, tri_order=bvh.tri_order)
"""


class SbvhBuild:
    """grid1m's SBVH (numpy, on the host's CPU) built in a process of its
    own while the card runs the earlier phases, as upload_scene's "sbvh"
    branch builds it; `start` launches it, `tree` waits for it, and leaving
    the `with` block stops it."""

    def __enter__(self):
        self.tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sbvh_")
        self.path = os.path.join(self.tmp.name, "sbvh.npz")
        self.proc = None
        return self

    def start(self):
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        self.proc = subprocess.Popen([sys.executable, "-c", SBVH_BUILD, self.path], cwd=ROOT,
                                     env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)

    def tree(self):
        """(FlatBVH, the build's seconds on the host), for main_path's
        `prebuilt`."""
        from caitlynrenderer_tpu_torch.accel.bvh import FlatBVH

        out, _ = self.proc.communicate(timeout=600)
        check(self.proc.returncode == 0, f"the SBVH build of grid1m failed: {out[-2000:]}")
        z = np.load(self.path)
        print(f"  grid1m sbvh: built on the host in {float(z['seconds']):.3f} s, in a process "
              "of its own during the earlier phases", flush=True)
        return FlatBVH(z["node_bounds"], z["node_meta"], z["tri_order"]), float(z["seconds"])

    def __exit__(self, *exc):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.tmp.cleanup()


def axis_rays(ds, rng, n, cuda):
    """Axis-parallel rays (±0 in the two zero components, so d_inv = ±inf)
    at random points inside the scene's triangles, from 0.5-3 units off,
    the origin on the target's two other coordinates: on the cornell's
    axis-aligned walls and boxes such a ray runs in a box face's plane,
    where (face - o) * d_inv = 0 * inf = NaN in the slab test."""
    verts = ds.scene.vertices.cpu().numpy()
    tv = ds.scene.tri_v.cpu().numpy()
    k = rng.integers(0, tv.shape[0], n)
    b1, b2 = rng.uniform(0.1, 0.45, n), rng.uniform(0.1, 0.45, n)
    v0, v1, v2 = (verts[tv[k, j]] for j in range(3))
    target = v0 + b1[:, None] * (v1 - v0) + b2[:, None] * (v2 - v0)
    along = np.arange(3)[None, :] == rng.integers(0, 3, n)[:, None]
    sign = rng.choice(np.array([-1.0, 1.0], np.float32), n)[:, None]
    zero = np.where(rng.random((n, 3)) < 0.5, np.float32(-0.0), np.float32(0.0))
    d = np.where(along, sign, zero).astype(np.float32)
    o = np.where(along, target - d * rng.uniform(0.5, 3.0, n)[:, None], target)
    return cuda(o), cuda(d)


def bvh_stats(tb, qo, qd, qa, tree, t_max, kw):
    """B4's stats variant on one ray set, closest and any-hit, each as the
    timed walk and as the oracle walk seeded with the closest t; checks
    that all four return the plain launch's answers.  Returns {"closest",
    "anyhit", "closest_oracle", "anyhit_oracle": st}."""
    want = tb.traverse_closest(qo, qd, qa, *tree, **kw)
    occ = tb.traverse_anyhit(qo, qd, t_max, qa, *tree, **kw)
    out = {}
    for tag, seed in (("", None), ("_oracle", want[0])):
        *got, out["closest" + tag] = tb.traverse_closest(qo, qd, qa, *tree, **kw, stats=True,
                                                         t_seed=seed)
        occs, out["anyhit" + tag] = tb.traverse_anyhit(qo, qd, t_max, qa, *tree, **kw,
                                                       stats=True, t_seed=seed)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(occs, occ),
              f"B4's stats variant{' (oracle walk)' if seed is not None else ''} differs from "
              "the plain launch")
    return out


# Bytes of one row of each table B4 reads, by its stats variant's flag: a
# node's meta (left, count), a node's bounds, a tri_v row, a vertex.
BVH_ROW_BYTES = {"meta_seen": 8, "bounds_seen": 24, "tri_seen": 16, "vert_seen": 12}


def bvh_bound(st, anyhit):
    """B4's work at the bound's rates from its stats variant's counts `st`:
    given the oracle walk's (children culled against the known closest t,
    acceptance unchanged), B4's bound, the work the query needs; given the
    timed walk's own, the work that walk did.  Operations: BOX_OPS for each
    of the two child boxes of an inner node visited, MT_OPS per leaf
    triangle tested.  Bytes: rays in and results out, and each distinct
    row read, once: a node's meta where the walk stood on it, its bounds
    where it was slab-tested as a child, a triangle's tri_v row, and each
    vertex (shared by ~6 triangles of a grid) once (BVH_ROW_BYTES)."""
    inner, tris = (float(x) for x in st["counts"][:, 0:2].double().sum(dim=0))
    n = st["counts"].shape[0]
    nbytes = n * (24 + 1 + (4 + 1 if anyhit else 16)) + sum(
        b * int(st[k].sum()) for k, b in BVH_ROW_BYTES.items())
    return bound(nbytes, 2 * inner * BOX_OPS + tris * MT_OPS)


def compare_bvh(label, tb, o, d, active, tree, t_max, kw):
    """B4 vs its twin on one input: t, tri, u, v equal bit for bit and
    occlusion on every ray; the stats variant, as the timed walk and as
    the oracle walk, equal to the plain launch.  Returns the largest |dt|
    and the occlusion mismatch (0 or 1)."""
    got = tb.traverse_closest(o, d, active, *tree, **kw)
    want = tb.traverse_closest_plain(o, d, active, *tree[:4], **kw)
    occ = tb.traverse_anyhit(o, d, t_max, active, *tree, **kw)
    occ_t = tb.traverse_anyhit_plain(o, d, t_max, active, *tree[:4], **kw)
    torch.cuda.synchronize()
    bits = {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for k, a, b in zip(("t", "tri", "u", "v"), got, want)}
    bits["occluded"] = int((occ != occ_t).sum())
    worst = float((got[0] - want[0]).abs().max()) if o.shape[0] else 0.0
    axis = int(((d == 0).sum(dim=1) == 2).sum())
    print(f"  {label}: rays {o.shape[0]} ({int(active.sum())} live, {axis} axis-parallel), "
          f"{tree[1].shape[0]} nodes, max_leaf {kw['max_leaf']}, stack {kw['max_stack']}: hits "
          f"{int((want[1] >= 0).sum())} occluded {int(occ_t.sum())} | bit mismatches {bits}",
          flush=True)
    check(all(v == 0 for v in bits.values()), f"{label}: B4 and its twin differ: {bits}")
    if tree[3].shape[0] and o.shape[0]:
        bvh_stats(tb, o, d, active, tree, t_max, kw)
    return worst, float(bits["occluded"] > 0)


def phase21(dev, smi, scene, camera, o, d, uni, grid, grid1m, grid_cam, go, gd, gact, guni,
            cuda, sbvh_grid1m):
    """Phase 21 (a)-(c).  Returns (record, B4's largest |dt| and occlusion
    mismatch against the twin)."""
    from caitlynrenderer_tpu_torch.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.ops import traverse_bvh as tb
    from caitlynrenderer_tpu_torch.scene import required_stack, scene_families, upload_scene

    t21 = time.perf_counter()
    rng = np.random.default_rng(21)
    rec = {"device": smi, "a_main_path": {}, "c_times": {}}

    from caitlynrenderer_tpu_torch.render.integrator import _bvh as tree

    def kw(ds, max_leaf=4):
        return {"max_leaf": max_leaf, "max_stack": required_stack(ds)}

    # (a) The main path at full size through a graph, and its eager split.
    uploads = {}
    for name, sc, accel in BINARY_MAIN_PATHS:
        sc = {"grid100k": grid, "grid1m": grid1m}[sc]
        opts = RenderOptions(width=BENCH, height=BENCH, max_depth=BENCH_DEPTH, accel=accel,
                             families=scene_families(sc))
        prebuilt = sbvh_grid1m.tree() if name == "grid1m sbvh" else None
        _, uploads[name], r = main_path(name, sc, grid_cam, opts, dev, MAIN_SPP,
                                        prebuilt=prebuilt)
        r["b4_share_of_graph_frame"] = r["kernel_device_ms"] / r["ms_per_frame"]
        rec["a_main_path"][name] = r
        print(f"  {name}: graph {r['ms_per_frame']:.3f} ms/frame, eager render_step "
              f"{r['eager_ms']['progressive.render_step']:.3f} ms "
              f"({r['eager_ms']['progressive.render_step'] / r['ms_per_frame']:.1f}x), through "
              f"the twin walk {r['eager_twin_walk_ms']:.3f} ms "
              f"({r['eager_twin_walk_ms'] / r['ms_per_frame']:.1f}x); upload "
              f"{r['upload_s']:.3f} s; B4 {r['kernel_device_ms']:.3f} ms a sample on the device, "
              f"{r['b4_share_of_graph_frame']:.1%} of the graph frame", flush=True)

    # (b) B4 against its twin, bit for bit.
    n, nb = o.shape[0], go.shape[0]
    cds = upload_scene(scene, "bvh2", dev)
    ck = kw(cds)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    results = [compare_bvh(f"cornell {DEMO}x{DEMO} primary", tb, o, d, act, tree(cds),
                           cuda(rng.uniform(0, 20, n)), ck)]
    tri = tb.traverse_closest(o, d, act, *tree(cds), **ck)[1]
    results.append(compare_bvh("cornell bounce", tb, *bounce_rays(cds, o, d, tri, uni), tree(cds),
                               cuda(rng.uniform(0, 8, n)), ck))
    shadow = shadow_rays(cds, o, d, tri, uni)
    results.append(compare_bvh("cornell shadow", tb, *shadow[:3], tree(cds), shadow[3], ck))
    sets = {f"cornell {DEMO}x{DEMO} primary bvh2": (o, d, act, cds)}
    for name, ds in uploads.items():
        gk = kw(ds)
        results.append(compare_bvh(f"{name} primary", tb, go, gd, gact, tree(ds),
                                   cuda(rng.uniform(0, 20, nb)), gk))
        tri = tb.traverse_closest(go, gd, gact, *tree(ds), **gk)[1]
        bo, bd, ba = bounce_rays(ds, go, gd, tri, guni)
        results.append(compare_bvh(f"{name} bounce", tb, bo, bd, ba, tree(ds),
                                   cuda(rng.uniform(0, 8, nb)), gk))
        sets[f"{name} primary"] = (go, gd, gact, ds)
        sets[f"{name} bounce"] = (bo, bd, ba, ds)
    # The edge set on the cornell: ragged N, ~10 % inactive lanes, rays at
    # vertices and edge midpoints, along edges and axis-aligned (edge_rays),
    # and axis-parallel rays with ±0 components in the planes of box faces;
    # at the build's leaf width 4 and at 2, below it; an all-dead batch; an
    # empty scene.
    ne = 3001
    eo, ed = edge_rays(cds, camera, rng, ne)
    ao, ad = axis_rays(cds, rng, ne, cuda)
    eo, ed = torch.cat([cuda(eo), ao]).contiguous(), torch.cat([cuda(ed), ad]).contiguous()
    ea = cuda(rng.random(2 * ne) < 0.9, torch.bool)
    et = cuda(rng.uniform(0, 30, 2 * ne))
    check(int(cds.node_meta[:, 1].max()) > 2, "the cornell's leaves are no wider than 2")
    results.append(compare_bvh("edge set", tb, eo, ed, ea, tree(cds), et, ck))
    results.append(compare_bvh("edge set, max_leaf 2", tb, eo, ed, ea, tree(cds), et,
                               kw(cds, 2)))
    results.append(compare_bvh("all dead", tb, eo, ed, torch.zeros_like(ea), tree(cds), et, ck))
    empty = upload_scene(scene._replace(tri_v=scene.tri_v[:0], tri_vn=scene.tri_vn[:0],
                                        tri_vt=scene.tri_vt[:0]), "bvh2", dev)
    results.append(compare_bvh("empty scene", tb, eo, ed, ea, tree(empty), et, kw(empty)))
    err = {"closest": max(r[0] for r in results), "anyhit": max(r[1] for r in results)}

    # (c) B4 and its twin timed, beside the bound from the oracle walk.
    for label, (qo, qd, qa, ds) in sets.items():
        qk, qt = kw(ds), tree(ds)
        tmax = torch.full((qo.shape[0],), 20.0, device=dev)
        r = {"closest": event_ms(lambda: tb.traverse_closest(qo, qd, qa, *qt, **qk), 20),
             "anyhit": event_ms(lambda: tb.traverse_anyhit(qo, qd, tmax, qa, *qt, **qk), 20),
             "closest_stats": event_ms(lambda: tb.traverse_closest(qo, qd, qa, *qt, **qk,
                                                                   stats=True), 5),
             "anyhit_stats": event_ms(lambda: tb.traverse_anyhit(qo, qd, tmax, qa, *qt, **qk,
                                                                 stats=True), 5),
             # the twin reads the host every step: timed as a caller issues it
             "closest_plain": event_ms(lambda: tb.traverse_closest_plain(qo, qd, qa, *qt[:4],
                                                                         **qk),
                                       2, host_ahead=False),
             "anyhit_plain": event_ms(lambda: tb.traverse_anyhit_plain(qo, qd, tmax, qa, *qt[:4],
                                                                       **qk), 2,
                                      host_ahead=False)}
        st = bvh_stats(tb, qo, qd, qa, qt, tmax, qk)
        bounds = {q: bvh_bound(st[q + "_oracle"], q == "anyhit") for q in ("closest", "anyhit")}
        walk = {q: bvh_bound(st[q], q == "anyhit") for q in ("closest", "anyhit")}
        rec["c_times"][label] = {"rays": qo.shape[0], "live": int(qa.sum()), "ms": r,
                                 "bound": bounds, "walk": walk}
        print(f"  {label}, {qo.shape[0]} rays ({int(qa.sum())} live), {qt[1].shape[0]} nodes: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in r.items()) + "; bound " + ", ".join(
                  f"{q} {bounds[q][0]:.4f} ms by {bounds[q][1]} ({bounds[q][0] / r[q]:.1%}), walk "
                  f"{walk[q][0] / bounds[q][0]:.2f}x it" for q in bounds), flush=True)
        for q in ("closest", "anyhit"):
            print(f"    B4 stats, {q}: walk {stats_line(st[q], tb.STATS)} | oracle walk "
                  f"{stats_line(st[q + '_oracle'], tb.STATS)} | rows read (walk / oracle): "
                  + ", ".join(f"{k} {int(st[q][k].sum())} / {int(st[q + '_oracle'][k].sum())}"
                              for k in tb.SEEN), flush=True)
    rec["seconds"] = time.perf_counter() - t21
    print(f"  phase 21: {rec['seconds']:.3f} s", flush=True)
    return rec, err


# Phase 22: kernel B5, the threefry sampler (ops/threefry.py).
# The least instructions of the sampler's arithmetic, split by the pipes of
# an H100 SM that can run them.  Rotations (funnel shifts) and xors run on
# the integer ALU pipe only, 64 a clock an SM.  An add runs there (IADD3,
# three operands) or on the FMA pipe (IMAD), and so can the uniform's
# shift-and-or (one funnel shift whose high word is 0x7F, or one IMAD.HI
# by 2^23 plus 0x3F800000); the float subtraction runs on the FMA pipes.
# Every instruction takes one of the SM's 128 issue slots a clock (four
# schedulers, a warp of 32 each).  A threefry of (0, x1) under a folded
# key: 20 rotations and 20 xors (ALU), 21 adds on x0 (one a round and the
# last key injection: the other four injections fold into the next
# round's add) and 6 on x1 (the counter's, and five injections of a key
# word plus a constant).  An element adds its uniform (an xor on the ALU,
# the shift-and-or, the subtraction); a key adds its schedule word k1 ^ k2
# ^ parity (one three-input xor, ALU), once a fold and once for the base
# key.
THREEFRY_ALU, THREEFRY_OTHER = 40, 27
UNIFORM_ALU, UNIFORM_OTHER = 1, 2
SCHEDULE_ALU = 1
ALU_PER_CLOCK, ISSUE_PER_CLOCK = 64, 128  # thread instructions a clock an SM


def sm_clock():
    """(SMs, the card's highest SM clock in MHz)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return sms, mhz


def threefry_ops(elements, folds):
    """(ALU-pipe instructions, all instructions) the sampler's arithmetic
    needs at the least for `elements` uniforms drawn from `folds` folded
    keys (0: the base key for all, the lane kernel)."""
    alu = (elements * (THREEFRY_ALU + UNIFORM_ALU) + folds * (THREEFRY_ALU + SCHEDULE_ALU)
           + SCHEDULE_ALU)
    other = elements * (THREEFRY_OTHER + UNIFORM_OTHER) + folds * THREEFRY_OTHER
    return alu, alu + other


def threefry_bound(elements, folds, id_bytes, sms, mhz):
    """(bound_ms, bound_by) of `elements` uniforms from `folds` folded keys:
    the larger of the bytes (the float32 out and the `id_bytes` of ids in)
    at PEAK_BYTES and the operations (`threefry_ops`) at the larger of
    their ALU instructions over ALU_PER_CLOCK and all of them over
    ISSUE_PER_CLOCK clocks, on `sms` SMs at `mhz`."""
    alu, ops = threefry_ops(elements, folds)
    clocks = max(alu / ALU_PER_CLOCK, ops / ISSUE_PER_CLOCK)
    b_ms, o_ms = (4 * elements + id_bytes) / PEAK_BYTES * 1e3, clocks / (sms * mhz * 1e3)
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def phase22(dev, smi, frame_runs):
    """Phase 22 (a)-(d).  frame_runs: [(label, upload, camera, options)]
    for (c).  Returns (record, B5's largest |difference| from the twin,
    pixel and lane, and its times and bounds at the main path's shapes)."""
    from caitlynrenderer_tpu_torch.core.camera import has_lens
    from caitlynrenderer_tpu_torch.parallel.render import tile_pixel_order
    from caitlynrenderer_tpu_torch.render import progressive, sampling
    from caitlynrenderer_tpu_torch.render.tiled import tile_grid

    t22 = time.perf_counter()
    rec = {"device": smi, "a_bit_equal": {}, "b_times": {}, "c_frames": {}}
    errs = {"pixel": 0.0, "lane": 0.0}

    def same(kind, label, got, want):
        torch.cuda.synchronize()
        check(tuple(got.shape) == tuple(want.shape)
              and torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"(a) {label}: B5 and its twin differ")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        errs[kind] = max(errs[kind], err)
        rec["a_bit_equal"][label] = {"shape": list(got.shape), "max_abs_err": err}

    # (a) B5 against its twin, bit for bit.
    key0 = sampling.sample_key(sampling.prng_key(0), 0)
    demo_ids = torch.arange(DEMO * DEMO, dtype=torch.int32, device=dev)
    bench_ids = torch.arange(BENCH * BENCH, dtype=torch.int32, device=dev)
    tile = list(tile_grid(DEMO, DEMO, 4, 4))[9]
    yy, xx = torch.meshgrid(torch.arange(tile.h, dtype=torch.int32, device=dev),
                            torch.arange(tile.w, dtype=torch.int32, device=dev), indexing="ij")
    tile_ids = (tile.y0 + yy.reshape(-1)) * DEMO + (tile.x0 + xx.reshape(-1))
    order, n_pad = tile_pixel_order(DEMO, DEMO, 4, 4, 64)
    padded = torch.clamp(torch.tensor(order, device=dev), min=0)
    check(n_pad > DEMO * DEMO, "(a) the tile-major order has no padding")
    pixel_sets = [(f"{DEMO}x{DEMO} ids, depth 3", demo_ids, 3),
                  (f"{BENCH}x{BENCH} ids, depth 4", bench_ids, 4),
                  (f"a {tile.h}x{tile.w} tile's ids, depth 3", tile_ids, 3),
                  (f"{DEMO}x{DEMO} tile-major ids padded to {n_pad}", padded, 3),
                  (f"{BENCH}x{BENCH} ids, depth 0", bench_ids, 0),
                  (f"{BENCH}x{BENCH} ids, depth 8", bench_ids, 8)]
    for label, ids, depth in pixel_sets:
        same("pixel", label, sampling.pixel_uniforms(key0, ids, depth),
             sampling.pixel_uniforms_plain(key0, ids, depth))
    base = sampling.prng_key(0)
    frames = (0, 1, 2**31 - 1, 2**32 - 1)
    keys = sampling.sample_key(tuple(torch.tensor(w, dtype=torch.int64, device=dev)
                                     for w in base),
                               torch.tensor(frames, dtype=torch.int64, device=dev))
    for i, frame in enumerate(frames):
        key = sampling.sample_key(base, frame)
        want = sampling.pixel_uniforms_plain(key, demo_ids, 3)
        same("pixel", f"{DEMO}x{DEMO}, depth 3, frame {frame}, int key",
             sampling.pixel_uniforms(key, demo_ids, 3), want)
        same("pixel", f"{DEMO}x{DEMO}, depth 3, frame {frame}, 0-d tensor views",
             sampling.pixel_uniforms((keys[0][i], keys[1][i]), demo_ids, 3), want)
    for rows in (BENCH * BENCH, 1001):  # config #5's; a last block not full
        same("lane", f"draw_uniforms {rows} x 25",
             sampling.draw_uniforms(key0, rows, 3, dev),
             sampling.draw_uniforms_plain(key0, rows, 3, dev))
    print(f"  (a) B5 = twin bit for bit (int32 views) on {len(rec['a_bit_equal'])} sets: "
          + "; ".join(f"{k} {v['shape']}" for k, v in rec["a_bit_equal"].items())
          + f"; max |err| {errs}", flush=True)

    # (b) B5 and its twin timed at the main path's shapes, beside B5's bound.
    sms, mhz = sm_clock()
    rec["int_rates"] = {"sms": sms, "max_sm_clock_mhz": mhz, "alu_per_clock": ALU_PER_CLOCK,
                        "issue_per_clock": ISSUE_PER_CLOCK}
    print(f"  {sms} SMs at {mhz:.0f} MHz: ALU pipe {ALU_PER_CLOCK} and issue {ISSUE_PER_CLOCK} "
          f"instructions a clock an SM", flush=True)
    # (kind, label, kernel call, twin call, their arguments, pixels, depth)
    shapes = [("pixel", f"cornell {DEMO}x{DEMO} x 25 (3 bounces)", sampling.pixel_uniforms,
               sampling.pixel_uniforms_plain, (key0, demo_ids, 3), DEMO * DEMO, 3),
              ("pixel", f"grids {BENCH}x{BENCH} x 32 (4 bounces)", sampling.pixel_uniforms,
               sampling.pixel_uniforms_plain, (key0, bench_ids, BENCH_DEPTH), BENCH * BENCH,
               BENCH_DEPTH),
              ("lane", f"config #5 {BENCH}x{BENCH} x 25 (3 bounces)", sampling.draw_uniforms,
               sampling.draw_uniforms_plain, (key0, BENCH * BENCH, 3, dev), BENCH * BENCH, 3)]
    rows = {}
    for kind, label, kernel_fn, twin_fn, args, n, depth in shapes:
        n_u = sampling.uniforms_per_sample(depth)
        folds = n if kind == "pixel" else 0  # int32 ids, one fold each
        bnd = threefry_bound(n * n_u, folds, 4 * folds, sms, mhz)
        alu, ops = threefry_ops(n * n_u, folds)
        r = {"elements": n * n_u, "alu_ops": alu, "ops": ops, "ms": event_ms(lambda: kernel_fn(*args), 50), "per_call_ms":
             event_ms(lambda: kernel_fn(*args), 50, host_ahead=False),
             "plain_ms": event_ms(lambda: twin_fn(*args), 3),
             "bound_ms": bnd[0], "bound_by": bnd[1]}
        rec["b_times"][label] = r
        if label.startswith(("cornell", "config")):
            rows[kind] = r
        print(f"  (b) {label}: {n * n_u} elements, B5 {r['ms']:.4f} ms (per call, host "
              f"included, {r['per_call_ms']:.4f}), twin {r['plain_ms']:.4f} ms "
              f"({r['plain_ms'] / r['ms']:.0f}x); bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({bnd[0] / r['ms']:.1%} of it)", flush=True)

    # (c), (d) Graph frames with the twin ("before") and with B5, in turns
    # twin, B5, B5, twin; the two graphs' accumulations equal; the graphs'
    # nodes a sample.
    def capture(ds, camera, options):
        w, h = options.width, options.height
        state = progressive.init_state(w, h, 0, dev)
        graph = progressive.SampleGraph(ds, camera, state, w, h, options, GRAPH_SPP,
                                        has_lens(camera))
        return graph, state

    def frame_ms(graph, camera, state):
        state = graph.run(camera, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state = graph.run(camera, state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (2 * GRAPH_SPP) * 1e3

    for label, ds, camera, options in frame_runs:
        with twin_sampler():
            g_twin, state = capture(ds, camera, options)
        g_b5, _ = capture(ds, camera, options)
        check(g_twin.launches[SAMPLER]["pixel"] == 0
              and g_b5.launches[SAMPLER]["pixel"] == GRAPH_SPP,
              f"(c) {label}: B5 nodes {g_twin.launches[SAMPLER]} / {g_b5.launches[SAMPLER]}")
        out_twin, out_b5 = g_twin.run(camera, state), g_b5.run(camera, state)
        torch.cuda.synchronize()
        check(torch.equal(out_twin.accum, out_b5.accum),
              f"(c) {label}: the graph through B5 differs from the graph through the twin")
        ms = {"twin": [], "b5": []}
        for side in ("twin", "b5", "b5", "twin"):
            ms[side].append(frame_ms({"twin": g_twin, "b5": g_b5}[side], camera, state))
        row = {"twin_ms_per_frame": ms["twin"], "b5_ms_per_frame": ms["b5"],
               "nodes_per_sample": {"twin": g_twin.nodes / GRAPH_SPP,
                                    "b5": g_b5.nodes / GRAPH_SPP}}
        rec["c_frames"][label] = row
        print(f"  (c) {label}: graph ms/frame, twin {ms['twin'][0]:.3f} {ms['twin'][1]:.3f}, "
              f"B5 {ms['b5'][0]:.3f} {ms['b5'][1]:.3f}; (d) nodes a sample, twin "
              f"{g_twin.nodes / GRAPH_SPP:.1f}, B5 {g_b5.nodes / GRAPH_SPP:.1f}; the two "
              f"graphs' accumulations equal bit for bit", flush=True)
        del g_twin, g_b5
        progressive.clear_graphs()
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t22
    print(f"  phase 22: {rec['seconds']:.3f} s", flush=True)
    return rec, errs, rows


# Shading-table columns a live lane of B6 reads: v0, e1, e2, the smooth
# flag, the albedo, the emissive flag (0-8, 18, 26-28, 33); the vertex
# normals (9-17) where the row is smooth; the light index and emission
# (25, 30-32) where it is emissive.  The Disney and the delta
# instantiations also read the material type (29) of a row that is not
# emissive, the Disney one the Disney parameters (37-44) of a Disney row,
# the delta ones the ior (37) of a glass row.
B6_ROW_COLS, B6_SMOOTH_COLS, B6_EMISSIVE_COLS = 14, 9, 4
B6_TYPE_COLS, B6_DISNEY_COLS, B6_IOR_COLS = 1, 8, 1


def shade_bound(ds, tri, alive, sh, prev, bounce, families=("lambert",), specular=None):
    """B6's bound, (ms, "bytes"), and the lane counts it rests on: the
    bytes a bounce needs over PEAK_BYTES.  Each lane's state is read and
    written as its outcome needs it: every lane reads its alive flag and
    writes its any-hit flag; a live lane reads o, d, T, its triangle and,
    where it goes on, five uniforms; L where it adds to it, prev_pdf for an
    emissive hit after bounce 0, the previous NEE's flags and pending where
    its candidate saw the light; it writes what it changes, and t_max and
    the direction only where the any-hit query runs.  Plus the used columns
    of each distinct shading row once, and the light table.  Where
    `families` holds "disney" (the Disney instantiation), a Disney lane
    that goes on reads a sixth uniform, and a row its type and, for a
    Disney row, its eight Disney parameters.  Where they hold "mirror" or
    "glass" (the delta instantiations), a row that a lane goes on from
    reads its type, a glass row its ior, a glass lane its sixth uniform;
    an emissive hit after bounce 0 reads the entering delta flag
    `specular` and prev_pdf only where that is false; and every lane that
    goes on writes its flag."""
    from caitlynrenderer_tpu_torch.ops import shade
    from caitlynrenderer_tpu_torch.render import integrator

    count = lambda m: int(m.sum())  # noqa: E731
    disney, delta = "disney" in families, shade.has_delta(families)
    n = int(alive.numel())
    live = alive & (tri >= 0)
    rows = ds.shade_tab[torch.clamp(tri, min=0).long()]
    emissive = live & (rows[:, 33] != -1)
    cont = live & ~emissive
    visible = (prev[0] & ~prev[1]) if prev is not None else torch.zeros_like(alive)
    adds = emissive | visible
    type_of = lambda r: torch.round(r[:, 29]).long()  # noqa: E731
    spec_row = lambda r: (integrator._type_is(type_of(r), integrator._SPECULAR_IDS)  # noqa: E731
                          if delta else torch.zeros_like(r[:, 29], dtype=torch.bool))
    glass_row = lambda r: (integrator._type_is(type_of(r), integrator._GLASS_IDS)  # noqa: E731
                           if "glass" in families else torch.zeros_like(r[:, 29],
                                                                        dtype=torch.bool))
    dis_row = lambda r: (~integrator._type_is(type_of(r), integrator._LAMBERT_IDS)  # noqa: E731
                         & ~spec_row(r))
    dis_lanes = cont & dis_row(rows) if disney else torch.zeros_like(cont)
    glass_lanes = cont & glass_row(rows)
    mirror_lanes = (cont & (type_of(rows) == 1) if "mirror" in families
                    else torch.zeros_like(cont))
    read = n + 4 * count(alive) + 36 * count(live) + 20 * count(cont) + 12 * count(adds)
    read += 4 * count(dis_lanes) + 4 * count(glass_lanes)  # u_lobe
    if bounce:  # the previous NEE's flags and pending; prev_pdf for the MIS
        after_delta = specular if delta else torch.zeros_like(alive)
        read += (n + count(prev[0]) + 12 * count(visible) + 4 * count(emissive & ~after_delta)
                 + (count(emissive) if delta else 0))
    write = n + 16 * count(sh.cand) + 12 * count(sh.cand)  # cand, t_max + ldir, pending
    write += 40 * count(cont) + 12 * count(adds) + count(alive & ~cont)  # o d T pdf, L, alive
    write += count(cont) if delta else 0  # the delta flag
    distinct = torch.unique(tri[live]).long()
    drows = ds.shade_tab[distinct]
    cols = (B6_ROW_COLS + B6_SMOOTH_COLS * (drows[:, 18] > 0.5).long()
            + B6_EMISSIVE_COLS * (drows[:, 33] != -1).long())
    if disney or delta:
        shaded = drows[:, 33] == -1
        cols = cols + shaded.long() * (B6_TYPE_COLS + B6_DISNEY_COLS * dis_row(drows).long()
                                       * disney + B6_IOR_COLS * glass_row(drows).long())
    table = 4 * int(cols.sum()) + 4 * ds.light_tab.numel()
    total = read + write + table
    return (total / PEAK_BYTES * 1e3, "bytes"), {
        "bytes": total, "live": count(live), "emissive": count(emissive),
        "cand": count(sh.cand), "visible_prev": count(visible),
        "disney": count(dis_lanes), "mirror": count(mirror_lanes), "glass": count(glass_lanes),
        "distinct_rows": int(distinct.numel())}


def finish_bound(cand, shadowed):
    """B6's finishing add's bound, (ms, "bytes"): every lane reads its
    any-hit flag, a candidate its answer, and a lane that saw the light
    reads its pending and L and writes L."""
    visible = int((cand & ~shadowed).sum())
    total = int(cand.numel()) + int(cand.sum()) + 36 * visible
    return (total / PEAK_BYTES * 1e3, "bytes"), {"bytes": total, "visible": visible}


def restored_ms(fn, restore, reps):
    """Median and least ms of fn() by CUDA events over `reps` calls after
    two warm-ups, restore() before each outside the events.  A device sleep
    ahead of the start event keeps the card busy while the host queues the
    call, so a kernel's time leaves out the host's; an eager twin that
    issues for longer than the sleep is timed with its host issue."""
    times = []
    for _ in range(reps + 2):
        restore()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # about a millisecond
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times = sorted(times[2:])
    return times[len(times) // 2], times[0]


def _max_abs_err(pairs):
    """The largest |a - b| over (a, b) float pairs; inf where shapes differ."""
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            return float("inf")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def phase23(dev, smi, runs, reps=30):
    """B6 against its twins, bit for bit, and its times beside its bound, on
    bounces 0 and 1 and the finishing add of each of `runs`' scenes: (label,
    ds, camera, options) at the main path's size.  On a run under "bvh2"
    or "sbvh", also B4 against its twins on the same queries (each
    bounce's closest-hit rays and its shadow rays), and B4 and the twins
    timed on bounce 0's, beside B4's bound.  Returns (record, the largest
    |B6 - twin| of the bounces and of the finishing adds, the times of the
    first run's bounce 0 and finishing add, B4's largest |dt| and
    occlusion mismatch against its twins, and B4's times and bounds on
    bounce 0's queries of the last binary run, None without one)."""
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.ops import shade
    from caitlynrenderer_tpu_torch.ops import traverse_bvh as tb
    from caitlynrenderer_tpu_torch.render import integrator, sampling

    t23 = time.perf_counter()
    rec = {"device": smi, "bounces": [], "finish": [], "b4": []}
    err = {"bounce": 0.0, "finish": 0.0}
    err_b4 = {"closest": 0.0, "anyhit": 0.0}
    b4_row = None

    def hold_b4(label, ds, options, closest, shadow, time_it):
        """B4's closest-hit answers (t, tri, u, v) on `closest` (o, d,
        active) and its occlusion on `shadow` (o, d, t_max, active) against
        its twins' on the same rays, bit for bit; with `time_it`, B4 and
        the twins timed there beside B4's bound from its stats variant's
        oracle walk."""
        tree = integrator._bvh(ds)
        kw = {"max_leaf": options.max_leaf, "max_stack": options.max_stack}
        (o, d, act), (so, sd, st, sa) = closest, shadow
        got = tb.traverse_closest(o, d, act, *tree, **kw)
        want = tb.traverse_closest_plain(o, d, act, *tree[:4], **kw)
        occ = tb.traverse_anyhit(so, sd, st, sa, *tree, **kw)
        occ_t = tb.traverse_anyhit_plain(so, sd, st, sa, *tree[:4], **kw)
        torch.cuda.synchronize()
        bits = {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
                for k, a, b in zip(("t", "tri", "u", "v"), got, want)}
        bits["occluded"] = int((occ != occ_t).sum())
        check(all(v == 0 for v in bits.values()), f"{label}: B4 and its twins differ: {bits}")
        err_b4["closest"] = max(err_b4["closest"], float((got[0] - want[0]).abs().max()))
        row = {"scene": label, "closest_rays": int(act.sum()), "hits": int((want[1] >= 0).sum()),
               "shadow_rays": int(sa.sum()), "occluded": int(occ_t.sum()), "bit_mismatches": bits}
        if time_it:
            ms = {"closest": event_ms(lambda: tb.traverse_closest(o, d, act, *tree, **kw), 20),
                  "anyhit": event_ms(lambda: tb.traverse_anyhit(so, sd, st, sa, *tree, **kw), 20),
                  # the twins read the host every step: timed as a caller issues them
                  "closest_plain": event_ms(lambda: tb.traverse_closest_plain(
                      o, d, act, *tree[:4], **kw), 1, host_ahead=False),
                  "anyhit_plain": event_ms(lambda: tb.traverse_anyhit_plain(
                      so, sd, st, sa, *tree[:4], **kw), 1, host_ahead=False)}
            tmax = torch.full((o.shape[0],), 1e30, device=dev)
            bounds = {"closest": bvh_bound(bvh_stats(tb, o, d, act, tree, tmax, kw)
                                           ["closest_oracle"], False),
                      "anyhit": bvh_bound(bvh_stats(tb, so, sd, sa, tree, st, kw)
                                          ["anyhit_oracle"], True)}
            row.update(ms=ms, bound=bounds)
        rec["b4"].append(row)
        print(f"  {label}: B4 = twins bit for bit on {row['closest_rays']} closest-hit rays "
              f"({row['hits']} hits) and {row['shadow_rays']} shadow rays "
              f"({row['occluded']} occluded)" + ("; " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in row["ms"].items()) + "; bound " + ", ".join(
                  f"{q} {row['bound'][q][0]:.4f} ms by {row['bound'][q][1]} "
                  f"({row['bound'][q][0] / row['ms'][q]:.1%})" for q in ("closest", "anyhit"))
                  if time_it else ""), flush=True)
        return row

    for label, ds, camera, options in runs:
        w, h = options.width, options.height
        n = w * h
        uni = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0),
                                      torch.arange(n, dtype=torch.int32, device=dev),
                                      options.max_depth)
        o, d = generate_rays(camera, w, h, uni)
        check(integrator.fused_shading(ds, o, d, uni, options),
              f"{label}: the main path does not shade through B6")
        exact, fams = options.exact_reference_nee, options.families
        delta = shade.has_delta(fams)
        # B6's state: alive, T, L, prev_pdf and, for the delta lobes, the flag.
        state = shade.PathState(torch.ones(n, dtype=torch.bool, device=dev),
                                torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
                                torch.ones(n, device=dev),
                                torch.zeros(n, dtype=torch.bool, device=dev) if delta else None)
        kind = shade.bounce_key(fams).replace("bounce_", "").replace("bounce", "lambert")
        prev = None
        for bounce in (0, 1):
            rays_in = (o, d, state.alive)
            tri = integrator._closest_hit_raw(ds, o, d, state.alive, options)[1]
            saved = shade.PathState(*(x.clone() if x is not None else None for x in state))
            work = shade.PathState(*(x.clone() if x is not None else None for x in state))
            rays = (torch.empty_like(o), torch.empty_like(d))

            def restore():
                for x, y in zip(work, saved):
                    if x is not None:
                        x.copy_(y)

            def kernel(tri=tri, prev=prev, bounce=bounce, rays=rays):
                return shade.shade_bounce(ds.shade_tab, ds.light_tab, o, d, tri, uni, bounce,
                                          work, prev, exact, rays, fams)

            def plain(tri=tri, prev=prev, bounce=bounce):
                # The twin returns new tensors and leaves `saved` as it is.
                return integrator.shade_bounce_plain(ds, o, d, tri, uni, bounce, saved, options,
                                                     prev)

            k_ms, k_min = restored_ms(kernel, restore, reps)
            t_ms, t_min = restored_ms(plain, lambda: None, max(reps // 3, 3))
            restore()
            sh, want = kernel(), plain()
            twin = want.state
            torch.cuda.synchronize()
            # Compared where the loop reads them: o, d and prev_pdf on the
            # lanes that went on shading, ldir and pending where cand.
            went_on = (saved.alive & (tri >= 0)
                       & (ds.shade_tab[tri.clamp(min=0).long(), 33] == -1))
            pairs = [(work.T, twin.T), (work.L, twin.L), (sh.t_max, want.t_max),
                     (work.prev_pdf[went_on], twin.prev_pdf[went_on]),
                     (sh.o[went_on], want.o[went_on]), (sh.d[went_on], want.d[went_on]),
                     (sh.ldir[sh.cand], want.ldir[sh.cand]),
                     (sh.pending[sh.cand], want.pending[sh.cand])]
            on = twin.alive  # the delta flag where the path goes on
            equal = (torch.equal(work.alive, twin.alive) and torch.equal(sh.cand, want.cand)
                     and all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                             for x, y in pairs)
                     and (not delta or torch.equal(work.specular[on], twin.specular[on])))
            e = _max_abs_err(pairs)
            check(equal and e == 0.0, f"{label} bounce {bounce}: B6 differs from its twin "
                  f"(max |diff| {e})")
            err["bounce"] = max(err["bounce"], e)
            bound, counts = shade_bound(ds, tri, saved.alive, sh, prev, bounce, fams,
                                        saved.specular)
            row = {"scene": label, "instantiation": kind, "bounce": bounce, "lanes": n,
                   **counts, "bound_ms": bound[0],
                   "ms": k_ms, "min_ms": k_min, "share_pct": 100.0 * bound[0] / k_ms,
                   "plain_ms": t_ms, "plain_min_ms": t_min, "max_abs_err": e}
            rec["bounces"].append(row)
            print(f"  {label} bounce {bounce} ({kind}): {n} lanes, {counts['live']} live, "
                  f"{counts['disney']} Disney, {counts['mirror']} mirror, {counts['glass']} glass, "
                  f"{counts['cand']} any-hit; B6 {k_ms:.4f} ms (least {k_min:.4f}), bound "
                  f"{bound[0]:.4f} ms by {counts['bytes']} bytes ({row['share_pct']:.1f} %), "
                  f"twin {t_ms:.3f} ms; outputs equal bit for bit", flush=True)
            shadowed = integrator._occluded(ds, sh.o, sh.ldir, sh.t_max, sh.cand, options)
            if options.accel in ("bvh2", "sbvh"):
                row = hold_b4(f"{label} bounce {bounce}", ds, options, rays_in,
                              (sh.o, sh.ldir, sh.t_max, sh.cand), bounce == 0)
                b4_row = row if bounce == 0 else b4_row
            state, o, d, prev = work, sh.o, sh.d, (sh.cand, shadowed, sh.pending)

        # The finishing add of bounce 1's NEE, on copies of the path's L.
        L0 = state.L.clone()
        L_k = L0.clone()
        f_ms, f_min = restored_ms(lambda: shade.shade_finish(L_k, *prev),
                                  lambda: L_k.copy_(L0), reps)
        p_ms, p_min = restored_ms(lambda: integrator.shade_finish_plain(L0, *prev),
                                  lambda: None, max(reps // 3, 3))
        L_k.copy_(L0)
        shade.shade_finish(L_k, *prev)
        L_t = integrator.shade_finish_plain(L0, *prev)
        torch.cuda.synchronize()
        e = _max_abs_err([(L_k, L_t)])
        check(torch.equal(L_k.view(torch.int32), L_t.view(torch.int32)) and e == 0.0,
              f"{label}: B6's finishing add differs from its twin (max |diff| {e})")
        err["finish"] = max(err["finish"], e)
        bound, counts = finish_bound(prev[0], prev[1])
        row = {"scene": label, "after_bounce": 1, "lanes": n, **counts, "bound_ms": bound[0],
               "ms": f_ms, "min_ms": f_min, "share_pct": 100.0 * bound[0] / f_ms,
               "plain_ms": p_ms, "plain_min_ms": p_min, "max_abs_err": e}
        rec["finish"].append(row)
        print(f"  {label} finishing add: {counts['visible']} lanes see the light; B6 "
              f"{f_ms:.4f} ms, bound {bound[0]:.4f} ms ({row['share_pct']:.1f} %), twin "
              f"{p_ms:.3f} ms; L equal bit for bit", flush=True)
    rec["seconds"] = time.perf_counter() - t23
    print(f"  phase 23: {rec['seconds']:.3f} s", flush=True)
    return rec, err, {"bounce": rec["bounces"][0], "finish": rec["finish"][0]}, err_b4, b4_row


# Phase 24: the configuration of cellbench's cornell_specular700.offline cell.
SPECULAR_CFG = os.path.join(ROOT, "cellbench", "configs", "cornell_specular700.json")


def specular_scene():
    """(scene arrays, camera, options) of the cornell_specular700 cell:
    cellbench's scene and camera, the configuration's size and depth, the
    accelerator `auto_accel` takes and the scene's families."""
    from cellbench import program
    from cellbench.scenes import builtin, cornell_specular
    from caitlynrenderer_tpu_torch.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.scene import auto_accel, scene_families

    with open(SPECULAR_CFG) as f:
        cfg = json.load(f)
    scene = program.scene_arrays(cornell_specular.make())
    camera = program.camera(builtin.make_camera(**cfg["camera"]))
    options = RenderOptions(width=cfg["width"], height=cfg["height"], max_depth=cfg["max_depth"],
                            accel=auto_accel(scene), families=scene_families(scene))
    return scene, camera, options


def specular_run(dev):
    """phase23's run of the cornell_specular700 cell: (label, ds, camera,
    options) at 700x700 under bvh2 (B4), 8 bounces, B6's delta
    instantiation."""
    from caitlynrenderer_tpu_torch.scene import required_stack, upload_scene

    scene, camera, options = specular_scene()
    ds = upload_scene(scene, options.accel, dev)
    return (f"cornell_specular {options.width}x{options.height} auto (B4)", ds, camera,
            options._replace(max_stack=required_stack(ds)))


def phase24(dev, smi):
    """The cornell_specular700.offline cell's path: cellbench's scene (the
    box with a mirror and a glass UV sphere, interpolated vertex normals,
    7,948 triangles) and camera, at the configuration's 700x700 and 8
    bounces.  `auto_accel` gives "bvh2" (B4), and B6's delta instantiation
    shades; `main_path` runs one launch of MAIN_SPP samples after the
    capture's, counters reset just before (B4 8 + 8 launches a sample, B6
    8 + 1).  Then one eager sample through B6 against the same sample on
    the plain shading step (`fused_shading` off), radiance bit for bit, and
    its queries, captured (copied) as `trace_paths` issues them, held
    against B4's twins bit for bit: every bounce's closest-hit rays (the
    camera rays, then the continuation rays, refracted ones leaving 2
    RAY_OFFSET inside a sphere) and every bounce's shadow rays.  Returns
    (record, B4's launches in the main path)."""
    from caitlynrenderer_tpu_torch.core import math as cm
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.ops import traverse_bvh as tb
    from caitlynrenderer_tpu_torch.render import integrator, sampling
    from caitlynrenderer_tpu_torch.scene import required_stack

    t24 = time.perf_counter()
    scene, camera, options = specular_scene()
    accel, fams = options.accel, options.families
    check(scene.num_triangles == 7948, f"the specular scene has {scene.num_triangles} triangles")
    check(accel == "bvh2", f"auto_accel takes {accel!r} on the specular scene, not 'bvh2'")
    check(fams == ("lambert", "mirror", "glass"), f"the specular scene's families {fams}")
    label = f"cornell_specular {options.width}x{options.height} auto (B4)"
    runs, ds, rec = main_path(label, scene, camera, options, dev, MAIN_SPP, split_stages=False)
    options = options._replace(max_stack=required_stack(ds))
    n, depth = options.width * options.height, options.max_depth

    uni = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0),
                                  torch.arange(n, dtype=torch.int32, device=dev), depth)
    o, d = generate_rays(camera, options.width, options.height, uni)
    check(integrator.fused_shading(ds, o, d, uni, options),
          f"{label}: B6 does not shade the scene with mirror and glass")
    # Bounce 0's continuation rays as `trace_paths` makes them, to count the
    # refracted ones among the queries held below.
    tri0 = integrator._closest_hit_raw(ds, o, d, torch.ones(n, dtype=torch.bool, device=dev),
                                       options)[1]
    bo, bd, ba = bounce_rays(ds, o, d, tri0, uni, fams)
    hf, surf, _ = vertex(ds, o, d, tri0, fams)
    refracted = int((ba & surf.glass & (cm.dot(bd, hf.n_flip) < 0)).sum())
    mirrored = int((ba & surf.mirror).sum())
    check(refracted > 1000, f"{label}: too few refracted rays at bounce 0 ({refracted})")

    with captured_queries("traverse_closest", "traverse_anyhit") as calls:
        L_b6 = integrator.trace_paths(ds, o, d, uni, options)
    # The same sample on the plain shading step.
    fused = integrator.fused_shading
    integrator.fused_shading = lambda *a, **k: False
    try:
        L_twin = integrator.trace_paths(ds, o, d, uni, options)
    finally:
        integrator.fused_shading = fused
    torch.cuda.synchronize()
    b6_bits = int((L_b6.view(torch.int32) != L_twin.view(torch.int32)).sum())
    check(b6_bits == 0, f"{label}: the sample through B6 differs from the plain step's in "
          f"{b6_bits} of {L_b6.numel()} values (max |diff| {_max_abs_err([(L_b6, L_twin)])})")
    closest = [c for c in calls if c[0] == "traverse_closest"]
    anyhit = [c for c in calls if c[0] == "traverse_anyhit"]
    check(len(closest) == depth and len(anyhit) == depth,
          f"{label}: {len(closest)} closest and {len(anyhit)} any-hit queries a sample")
    # The second closest-hit query is bounce 0's continuation.
    _, args1, _ = closest[1]
    check(torch.equal(args1[2], ba) and torch.equal(args1[0][ba], bo[ba])
          and torch.equal(args1[1][ba], bd[ba]),
          f"{label}: the path's bounce-1 rays are not the continuation rays")
    rows = []
    t_twin = time.perf_counter()
    for name, args, kw in calls:
        # The twins take the tree without B4's records and slab; a query's
        # active mask comes after o, d (and the any-hit's t_max).
        k, act = (7, args[2]) if name == "traverse_closest" else (8, args[3])
        got = getattr(tb, name)(*args, **kw)
        want = getattr(tb, name + "_plain")(*args[:k], **kw)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        bits = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                   if a.dtype == torch.float32 else int((a != b).sum())
                   for a, b in zip(got, want))
        answered = (("hits", int((want[1] >= 0).sum())) if name == "traverse_closest"
                    else ("occluded", int(want[0].sum())))
        rows.append({"query": name, "rays": int(act.sum()), "bit_mismatches": bits,
                     answered[0]: answered[1]})
    twin_s = time.perf_counter() - t_twin
    bad = [r for r in rows if r["bit_mismatches"]]
    check(not bad, f"{label}: B4 differs from its twins on {bad}")
    rec.update(accel=accel, max_stack=options.max_stack, launches=runs,
               b6_vs_plain={"values": L_b6.numel(), "bit_mismatches": b6_bits,
                            "radiance_sum": float(L_twin.sum())},
               bounce0={"continuation": int(ba.sum()), "refracted": refracted,
                        "mirrored": mirrored},
               queries=rows, twin_s=twin_s, seconds=time.perf_counter() - t24)
    print(f"  {label}: one sample through B6 = the plain step bit for bit; bounce 0 "
          f"{int(ba.sum())} continuation rays ({refracted} refracted, "
          f"{mirrored} off the mirror); B4 = twins bit for bit on one sample's "
          f"{len(closest)} closest-hit queries (live rays "
          f"{[r['rays'] for r in rows if r['query'] == 'traverse_closest']}) and "
          f"{len(anyhit)} any-hit queries (shadow rays "
          f"{[r['rays'] for r in rows if r['query'] == 'traverse_anyhit']}); twins "
          f"{twin_s:.1f} s", flush=True)
    print(f"  phase 24: {rec['seconds']:.3f} s", flush=True)
    return rec, runs["traverse_bvh"]


def main():
    with SbvhBuild() as sbvh_grid1m:
        return run(sbvh_grid1m)


def run(sbvh_grid1m):
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
    from caitlynrenderer_tpu_torch.ops import shade as b6
    from caitlynrenderer_tpu_torch.ops import threefry as tf
    from caitlynrenderer_tpu_torch.ops import traverse_bvh as tb
    from caitlynrenderer_tpu_torch.ops import traverse_cw8 as cw8
    from caitlynrenderer_tpu_torch.ops import traverse_mega as mega
    from caitlynrenderer_tpu_torch.bench import bench_scene
    from caitlynrenderer_tpu_torch.core.types import MaterialType, RenderOptions
    from caitlynrenderer_tpu_torch.render import progressive, sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths
    from caitlynrenderer_tpu_torch.scene import (
        auto_accel,
        required_stack,
        scene_families,
        upload_scene,
    )

    dev = get_device("cuda")
    sbvh_grid1m.start()  # phase 21's SBVH of grid1m, on the host meanwhile

    # -------------------------------------------------------------- phase 2
    phase("2 build")
    names = ("mt_brute", "traverse_mega", "traverse_cw8", "traverse_bvh", "threefry", "shade")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc each, all at once
        infos = list(pool.map(lambda name: _build.build(name, force=True), names))
    for info in infos:
        print(f"  built {os.path.relpath(info['path'], ROOT)} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "ptxas" in line or "spill" in line:  # registers, stack, spills
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
    # Bounce rays (the integrator's continuation rays) and scattered rays
    # from each primary hit; t_max up to the box size (shadow-ray-like).
    # The scattered directions are drawn where earlier runs drew their
    # bounce directions, so that rng's later draws (phase 8's rays) stay
    # those of earlier runs; so in phase 7.
    _, tri, _, _ = mt.brute_closest_plain(o, d, act, ds.tris9)
    scattered = scattered_rays(ds, o, d, tri, rng, cuda)
    btmax = cuda(rng.uniform(0, 8, n))
    results.append(compare("cornell bounce", mt, *bounce_rays(ds, o, d, tri, uni), ds.tris9,
                           btmax))
    results.append(compare("cornell scattered", mt, *scattered, ds.tris9, btmax))
    shadow = shadow_rays(ds, o, d, tri, uni)
    results.append(compare("cornell shadow", mt, *shadow[:3], ds.tris9, shadow[3]))

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
    # Ties: the 2048-triangle soup twice, stacked (a triangle and its copy in
    # one lane's share) and interleaved (in two lanes' shares), rays aimed at
    # centroids, at ray counts that take 4, 16 and 32 lanes per ray.
    rng3 = np.random.default_rng(3)  # later phases keep earlier runs' inputs
    stacked = torch.cat([soup_tris, soup_tris]).contiguous()
    interleaved = torch.stack([soup_tris, soup_tris], dim=1).reshape(-1, 9).contiguous()
    cen = (soup_tris[:, 0:3] + (soup_tris[:, 3:6] + soup_tris[:, 6:9]) / 3.0).cpu().numpy()
    for nt in (ns, 16384, 1001):
        to = rng3.uniform(0, 10, (nt, 3)).astype(np.float32)
        td = cen[rng3.integers(0, 2048, nt)] - to
        td[nt // 2:] = rng3.standard_normal((nt - nt // 2, 3))
        for name, tt in (("stacked", stacked), ("interleaved", interleaved)):
            results.append(compare(f"ties, {name}", mt, cuda(to), cm.normalize(cuda(td)),
                                   torch.ones(nt, dtype=torch.bool, device=dev), tt,
                                   cuda(rng3.uniform(0, 12, nt))))
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
    tf.reset_launches()
    b6.reset_launches()
    captures = progressive.graph_counts["captures"]
    ds_main = upload_scene(scene, options.accel, dev)
    state = progressive.init_state(DEMO, DEMO, 0, dev)
    # A warm-up launch of the same length: the capture of the graph.
    state = progressive.render_steps(ds_main, camera, state, DEMO, DEMO, options, spp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = progressive.render_steps(ds_main, camera, state, DEMO, DEMO, options, spp)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    img = progressive.resolve(state, DEMO, DEMO, options)
    torch.cuda.synchronize()
    launches = dict(mt.launches)
    b5_main = dict(tf.launches)  # B5 on the main path: the kernels line's count
    b6_main = dict(b6.launches)  # and B6's
    samples = 2 * spp + progressive.graph_counts["captures"] - captures
    check(launches["closest"] == 3 * samples and launches["anyhit"] == 3 * samples,
          f"unexpected launch counts {launches}")
    check(launches["closest_twin"] == 0 and launches["anyhit_twin"] == 0,
          "the twin ran on the card's path")
    check(b5_main == {"pixel": samples, "lane": 0, "pixel_twin": 0, "lane_twin": 0},
          f"B5 did not draw every sample of the main path: {b5_main}")
    check(b6_main == b6_launches(ds_main, o0, d0, u0, options, samples)
          and b6_main["bounce"] == 3 * samples,
          f"B6 did not shade every bounce of the main path: {b6_main}")
    check(bool(torch.isfinite(state.accum).all()), "non-finite radiance")
    check(tuple(img.shape) == (DEMO, DEMO, 3), f"image shape {tuple(img.shape)}")
    check(float(img.mean()) > 0.05, "image is black")
    rays_per_sec = rays_per_sample * spp / elapsed
    ms_per_frame = elapsed / spp * 1e3
    print(f"  rays_per_sample {rays_per_sample} rays_per_sec {rays_per_sec:.1f} "
          f"ms_per_frame {ms_per_frame:.3f} alive_per_bounce {alive_per_bounce} "
          f"mean pixel {float(img.mean()):.4f} launches {launches}, B5 {b5_main}, B6 {b6_main}")

    # -------------------------------------------------------------- phase 6
    phase("6 kernel and twin times")
    # Each shape's time beside its bound (`mt_bound`); any-hit with t_max 20,
    # or, on the shadow rays (the main path's any-hit), the light's distance.
    times, b1_bounds = {}, {}
    shapes = {"36": (o, d, act, ds.tris9, None),
              "36 bounce": (*bounce_rays(ds, o, d, tri, uni), ds.tris9, None),
              "36 shadow": (*shadow[:3], ds.tris9, shadow[3]),
              "2048": (so, sd, torch.ones(ns, dtype=torch.bool, device=dev), soup_tris, None)}
    for tag, (qo, qd, qa, qt, tm) in shapes.items():
        if tm is None:
            tm = torch.full((qo.shape[0],), 20.0, device=dev)
        row = {
            "closest_plain": event_ms(lambda: mt.brute_closest_plain(qo, qd, qa, qt), 3),
            "closest": event_ms(lambda: mt.brute_closest(qo, qd, qa, qt), 20),
            "anyhit": event_ms(lambda: mt.brute_anyhit(qo, qd, tm, qa, qt), 20),
            "anyhit_plain": event_ms(lambda: mt.brute_anyhit_plain(qo, qd, tm, qa, qt), 3),
            "closest_per_call": event_ms(lambda: mt.brute_closest(qo, qd, qa, qt), 20, False),
            "anyhit_per_call": event_ms(lambda: mt.brute_anyhit(qo, qd, tm, qa, qt), 20, False),
        }
        times[tag] = row
        b1_bounds[tag] = {"closest": mt_bound(qo, qd, qa, qt),
                          "anyhit": mt_bound(qo, qd, qa, qt, tm)}
        print(f"  {tag}: {qo.shape[0]} rays ({int(qa.sum())} live) x {qt.shape[0]} tris, "
              f"{mt._lanes(qo.shape[0], qt.shape[0], dev)} lanes per ray: " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in row.items()) + "; bound " + ", ".join(
                  f"{q} {b[0]:.4f} ms by {b[1]} ({b[0] / row[q]:.1%})"
                  for q, b in b1_bounds[tag].items()), flush=True)

    # -------------------------------------------------------------- phase 7
    phase("7 B2 vs twin")
    grid, grid_cam = bench_scene("grid100k")
    gds = upload_scene(grid, "wide", dev)
    nb = BENCH * BENCH
    guni = sampling.pixel_uniforms(
        sampling.sample_key(sampling.prng_key(0), 0),
        torch.arange(nb, dtype=torch.int32, device=dev), BENCH_DEPTH,
    )
    go, gd = generate_rays(grid_cam, BENCH, BENCH, guni)
    gact = torch.ones(nb, dtype=torch.bool, device=dev)
    gw = wide_args(gds)
    mega_results = [compare_mega("grid100k primary", mega, go, gd, gact, gw,
                                 cuda(rng.uniform(0, 20, nb)))]
    _, gtri, _ = mega.mega_closest_plain(go, gd, gact, *gw)
    scattered = scattered_rays(gds, go, gd, gtri, rng, cuda)
    btmax = cuda(rng.uniform(0, 8, nb))
    bo, bd, bact = bounce_rays(gds, go, gd, gtri, guni)
    mega_results.append(compare_mega("grid100k bounce", mega, bo, bd, bact, gw, btmax))
    mega_results.append(compare_mega("grid100k scattered", mega, *scattered, gw, btmax))

    soup20k, _ = bench_scene("soup")
    sds = upload_scene(soup20k, "wide", dev)
    mega_results.append(compare_mega(
        "soup 20000", mega, so, sd, cuda(rng.random(ns) < 0.9, torch.bool), wide_args(sds),
        cuda(rng.uniform(0, 12, ns))))

    cds = upload_scene(scene, "wide", dev, wide_group_tris=64)
    cw = wide_args(cds)
    mega_results.append(compare_mega("cornell wide primary", mega, o, d, act, cw,
                                     cuda(rng.uniform(0, 20, n))))
    _, tri, _ = mega.mega_closest_plain(o, d, act, *cw)
    scattered = scattered_rays(cds, o, d, tri, rng, cuda)
    mega_results.append(compare_mega("cornell wide bounce", mega, *bounce_rays(cds, o, d, tri, uni),
                                     cw, cuda(rng.uniform(0, 8, n))))

    # Two-triangle groups: each wall quad is its own group with a flat box.
    fds = upload_scene(scene, "wide", dev, wide_group_tris=2)
    fw = wide_args(fds)
    mega_results.append(compare_mega("cornell 2-triangle groups scattered", mega, *scattered, fw,
                                     cuda(rng.uniform(0, 8, n))))

    # Edge set on cornell with flat 2-triangle group boxes: ragged N,
    # ~10 % inactive lanes, rays at vertices and edge midpoints, rays along
    # edges, axis-aligned directions (1/0 = inf in the exit clamp); then an
    # all-dead batch.
    origin, direction = edge_rays(fds, camera, rng, ne)
    mega_results.append(compare_mega(
        "edge cases", mega, cuda(origin), cuda(direction), cuda(rng.random(ne) < 0.9, torch.bool),
        fw, cuda(rng.uniform(0, 30, ne))))
    dead = torch.zeros(ne, dtype=torch.bool, device=dev)
    mega_results.append(compare_mega("all dead", mega, cuda(origin), cuda(direction), dead, fw,
                                     cuda(rng.uniform(0, 30, ne))))
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
    check_vs_b1(f"B2, {nm} rays x {grid1m.num_triangles} tris ({mds.wb_mega.shape[0]} groups)",
                t2, tri2, occ2, t1, tri1, occ1, mtmax, mds.tris9, mds.tris9)

    # ------------------------------------------------------------- phase 8b
    phase("8b grid1m at the main path's shapes: B2 vs B1 and twin, B3 vs B1")
    rng8 = np.random.default_rng(8)  # phase 12's inputs stay those of earlier runs
    m3 = upload_scene(grid1m, "cwbvh", dev)
    mc = cw_args(m3)
    sets1m = {"primary": (go, gd, gact)}  # grid1m has grid100k's bench camera
    sub = slice(0, nb, 16)
    for label in ("primary", "bounce"):
        qo, qd, qa = sets1m[label]
        surface_d = qd if label == "bounce" else None
        qtmax = cuda(rng8.uniform(0, 20, nb))
        t2, tri2, _ = mega.mega_closest(qo, qd, qa, *mw)
        occ2 = mega.mega_anyhit(qo, qd, qtmax, qa, *mw)
        t3, tri3, _ = cw8.cw8_closest(qo, qd, qa, *mc)
        occ3 = cw8.cw8_anyhit(qo, qd, qtmax, qa, *mc)
        t1, tri1, _, _ = mt.brute_closest(qo, qd, qa, mds.tris9)
        occ1 = mt.brute_anyhit(qo, qd, qtmax, qa, mds.tris9)
        torch.cuda.synchronize()

        def cracks(bad, closest_plain, anyhit_plain, tk, trk, occk, ktris):
            i = bad.nonzero()[:, 0]
            tt, trt, _ = closest_plain(qo[i], qd[i], qa[i])
            ot = anyhit_plain(qo[i], qd[i], qtmax[i], qa[i])
            twin_equal = (torch.equal(tt, tk[i]) and torch.equal(trt, trk[i])
                          and torch.equal(ot, occk[i]))
            dist = torch.minimum(edge_distance(qo[i], qd[i], mds.tris9, tri1[i]),
                                 edge_distance(qo[i], qd[i], ktris, trk[i]))
            return twin_equal, dist

        check_vs_b1(
            f"grid1m {label}, B2", t2, tri2, occ2, t1, tri1, occ1, qtmax, mds.tris9, mds.tris9,
            surface_d, lambda bad: cracks(bad, lambda *r: mega.mega_closest_plain(*r, *mw),
                                          lambda *r: mega.mega_anyhit_plain(*r, *mw), t2, tri2,
                                          occ2, mds.tris9))
        check_vs_b1(  # B3's scene is in its own triangle order
            f"grid1m {label}, B3", t3, tri3, occ3, t1, tri1, occ1, qtmax, mds.tris9, m3.tris9,
            surface_d, lambda bad: cracks(bad, lambda *r: cw8.cw8_closest_plain(*r, *mc),
                                          lambda *r: cw8.cw8_anyhit_plain(*r, *mc), t3, tri3,
                                          occ3, m3.tris9))
        mega_results.append(compare_mega(
            f"grid1m {label}, every 16th ray", mega, qo[sub].contiguous(), qd[sub].contiguous(),
            qa[sub].contiguous(), mw, qtmax[sub].contiguous()))
        if label == "primary":
            sets1m["bounce"] = bounce_rays(mds, qo, qd, tri2, guni)
    err_b2 = {"closest": max(r[0] for r in mega_results),
              "anyhit": max(r[1] for r in mega_results)}

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
        runs, *_ = main_path(label, sc, grid_cam, opts, dev, MAIN_SPP)
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
    # B2 and B3 on the main path's four ray sets, in turns, and B2's walk.
    g3 = upload_scene(grid, "cwbvh", dev)
    gc = cw_args(g3)
    sets = {("grid100k", "primary"): (go, gd, gact, gw, gc, gds),
            ("grid100k", "bounce"): (bo, bd, bact, gw, gc, gds),
            ("grid1m", "primary"): (*sets1m["primary"], mw, mc, mds),
            ("grid1m", "bounce"): (*sets1m["bounce"], mw, mc, mds)}
    b2_sets = {}
    for (scene_name, label), (qo, qd, qa, qw, qc, qds) in sets.items():
        kp = qds.wb_mega.shape[2] // 3
        r = {
            "B2 closest": event_ms(lambda: mega.mega_closest(qo, qd, qa, *qw), 20),
            "B3 closest": event_ms(lambda: cw8.cw8_closest(qo, qd, qa, *qc), 20),
            "B2 anyhit": event_ms(lambda: mega.mega_anyhit(qo, qd, tmax, qa, *qw), 20),
            "B3 anyhit": event_ms(lambda: cw8.cw8_anyhit(qo, qd, tmax, qa, *qc), 20),
        }
        t2, _, _, st = mega.mega_closest(qo, qd, qa, *qw, stats=True)
        occ2, sta = mega.mega_anyhit(qo, qd, tmax, qa, *qw, stats=True)
        st3, hits3 = cw8_stats(cw8, qo, qd, qa, qc, tmax)
        bounds = {"B2 closest": mega_bound(qw, qo, qd, qa, t_hit=t2),
                  "B2 anyhit": mega_bound(qw, qo, qd, qa, t_max=tmax, occluded=occ2),
                  "B3 closest": cw8_bound(st3["closest_oracle"], False, hits3["closest"]),
                  "B3 anyhit": cw8_bound(st3["anyhit_oracle"], True, hits3["anyhit"])}
        walk = {"B2 closest": mega_walk(st, nb, kp, False),
                "B2 anyhit": mega_walk(sta, nb, kp, True),
                "B3 closest": cw8_bound(st3["closest"], False, hits3["closest"]),
                "B3 anyhit": cw8_bound(st3["anyhit"], True, hits3["anyhit"])}
        b2_sets[(scene_name, label)] = {"ms": r, "bound": bounds}
        print(f"  {scene_name} {label}, {nb} rays ({int(qa.sum())} live), "
              f"{qds.wb_mega.shape[0]} groups of {kp} columns: " + ", ".join(
                  f"{k} {v:.4f} ms (bound {bounds[k][0]:.4f} ms by {bounds[k][1]}, "
                  f"{bounds[k][0] / v:.1%})" for k, v in r.items()), flush=True)
        print("    each walk, the same rates over its own work: " + ", ".join(
            f"{k} {w[0]:.4f} ms by {w[1]} ({w[0] / bounds[k][0]:.1f}x the bound)"
            for k, w in walk.items()), flush=True)
        print(f"    B2 stats, mean/p50/p99/max per ray: closest {stats_line(st, mega.STATS)} | touched "
              f"{int(st['grp_seen'].sum())} groups, {int(st['ent_seen'].sum())} entries, "
              f"{int(st['blk_seen'].sum())} blocks", flush=True)
        print(f"    B2 stats, any-hit {stats_line(sta, mega.STATS)} | touched {int(sta['grp_seen'].sum())} "
              f"groups", flush=True)
        for q in ("closest", "anyhit"):
            print(f"    B3 stats, {q}: walk {stats_line(st3[q], cw8.STATS)} | oracle walk "
                  f"{stats_line(st3[q + '_oracle'], cw8.STATS)} | touched "
                  f"{int(st3[q]['node_seen'].sum())} / {int(st3[q + '_oracle']['node_seen'].sum())}"
                  f" nodes of {qc[0].shape[0]}", flush=True)

    # ------------------------------------------------------------- phase 12
    phase("12 B3 vs twin")
    cwds = upload_scene(scene, "cwbvh", dev)
    cc = cw_args(cwds)
    cw_results = [compare_cw8("cornell cwbvh primary", cw8, o, d, act, cc,
                              cuda(rng.uniform(0, 20, n)))]
    _, tri, _ = cw8.cw8_closest_plain(o, d, act, *cc)
    co, cd, cact = bounce_rays(cwds, o, d, tri, uni)
    cw_results.append(compare_cw8("cornell cwbvh bounce", cw8, co, cd, cact, cc,
                                  cuda(rng.uniform(0, 8, n))))
    s20 = upload_scene(soup20k, "cwbvh", dev)
    cw_results.append(compare_cw8(
        "soup 20000", cw8, so, sd, cuda(rng.random(ns) < 0.9, torch.bool), cw_args(s20),
        cuda(rng.uniform(0, 12, ns))))
    del s20
    cw_results.append(compare_cw8("grid100k primary", cw8, go, gd, gact, gc,
                                  cuda(rng.uniform(0, 20, nb))))
    _, tri, _ = cw8.cw8_closest_plain(go, gd, gact, *gc)
    b3o, b3d, b3act = bounce_rays(g3, go, gd, tri, guni)
    cw_results.append(compare_cw8("grid100k bounce", cw8, b3o, b3d, b3act, gc,
                                  cuda(rng.uniform(0, 8, nb))))
    cw_results.append(compare_cw8("grid100k scattered", cw8,
                                  *scattered_rays(g3, go, gd, tri, rng, cuda), gc,
                                  cuda(rng.uniform(0, 8, nb))))
    # Edge set on cornell: ragged N, ~10 % inactive lanes, rays at vertices
    # and along edges, axis-aligned directions; an all-dead batch; an empty
    # scene.
    origin, direction = edge_rays(cwds, camera, rng, ne)
    cw_results.append(compare_cw8(
        "edge cases", cw8, cuda(origin), cuda(direction), cuda(rng.random(ne) < 0.9, torch.bool),
        cc, cuda(rng.uniform(0, 30, ne))))
    cw_results.append(compare_cw8("all dead", cw8, cuda(origin), cuda(direction), dead, cc,
                                  cuda(rng.uniform(0, 30, ne))))
    empty = upload_scene(scene._replace(tri_v=scene.tri_v[:0], tri_vn=scene.tri_vn[:0],
                                        tri_vt=scene.tri_vt[:0]), "cwbvh", dev)
    cw_results.append(compare_cw8("empty scene", cw8, cuda(origin), cuda(direction),
                                  cuda(rng.random(ne) < 0.9, torch.bool), cw_args(empty),
                                  cuda(rng.uniform(0, 30, ne))))
    err_b3 = {"closest": max(r[0] for r in cw_results),
              "anyhit": max(r[1] for r in cw_results)}

    # ------------------------------------------------------------- phase 13
    phase("13 B3 vs B1 at grid1m")
    t3, tri3, _ = cw8.cw8_closest(mo, md, mact, *mc)  # m3: phase 8b's upload
    t1, tri1, _, _ = mt.brute_closest(mo, md, mact, m3.tris9)  # the same triangle order
    occ3 = cw8.cw8_anyhit(mo, md, mtmax, mact, *mc)
    occ1 = mt.brute_anyhit(mo, md, mtmax, mact, m3.tris9)
    torch.cuda.synchronize()
    check_vs_b1(f"B3, {nm} rays x {grid1m.num_triangles} tris ({m3.cw_nodes.shape[0]} node8s, "
                f"depth {m3.cw_depth})", t3, tri3, occ3, t1, tri1, occ1, mtmax, m3.tris9, m3.tris9)

    # ------------------------------------------------------------- phase 14
    phase("14 golden through B3 and B4 (cwbvh, bvh2, sbvh)")
    for accel in ("cwbvh", "bvh2", "sbvh"):
        _, _, options = setup(64, 64)
        ads = upload_scene(scene, accel, dev)
        options = options._replace(accel=accel, max_stack=required_stack(ads))
        for m in (mt, mega, cw8, tb):
            m.reset_launches()
        captures = progressive.graph_counts["captures"]
        # render_image's default: 8 samples a launch, a CUDA graph's replay.
        img, _ = progressive.render_image(ads, camera, options, spp=48, seed=0)
        img = img.cpu().numpy()
        gerr = np.abs(img - golden)
        print(f"  {accel} vs golden: mean {gerr.mean():.3e} max {gerr.max():.3e}; B4 launches "
              f"{tb.launches}, B3 {cw8.launches}, B2 {mega.launches}, B1 {mt.launches}",
              flush=True)
        check(gerr.mean() < 2e-3 and gerr.max() < 0.06, f"golden through {accel} out of bounds")
        check(img[32, 4, 0] > img[32, 4, 1] and img[32, 60, 1] > img[32, 60, 0],
              f"{accel}: walls are not red / green dominant")
        want = (48 + progressive.graph_counts["captures"] - captures) * 3
        mine = cw8 if accel == "cwbvh" else tb
        check(mine.launches == {"closest": want, "anyhit": want, "closest_twin": 0,
                                "anyhit_twin": 0}, f"{accel}: launches {mine.launches}")
        check(all(v == 0 for m in (mt, mega, cw8, tb) if m is not mine
                  for v in m.launches.values()), f"{accel}: another kernel or twin ran")

    # ------------------------------------------------------------- phase 15
    phase("15 cwbvh main path on the large scenes")
    cw_launches = {"closest": 0, "anyhit": 0}
    for label, sc in (("grid100k", grid), ("grid1m", grid1m)):
        opts = RenderOptions(width=BENCH, height=BENCH, max_depth=BENCH_DEPTH, accel="cwbvh",
                             families=scene_families(sc))
        runs, *_ = main_path(f"{label} cwbvh", sc, grid_cam, opts, dev, MAIN_SPP)
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

    # ------------------------------------------------------------- phase 17
    phase("17 shading on the card")
    from caitlynrenderer_tpu_torch.ops import bsdf
    from caitlynrenderer_tpu_torch.render.integrator import render_sample

    base_dir = os.path.dirname(CORNELL_TOML)

    def cornell_cfg(floor):
        return {**cfg, "scene": {**cfg["scene"], "floor": floor}}

    sky_cfg = {"scene": {"builtin": "grid", "resolution": 224, "env": "sky"},
               "camera": {"position": [5.0, 9.0, 11.0], "look_at": [5.0, 2.0, 5.0], "fov": 50.0},
               "render": {"use_env_map": True}}
    # a. Full width: the three shaded floors through auto -> B1, the
    # cornell config as written (its accel "wide": B2), grid100k lit by the
    # sky through B2; the Disney floor, and the Lambert one beside it, with
    # the split of a sample.
    runs17 = [(f"cornell {f} floor", cornell_cfg(f), {"accel": "auto"})
              for f in ("diffuse", "disney", "mirror", "glass")]
    runs17 += [("scenes/cornell.toml", cfg, {}),
               ("grid100k under the sky", sky_cfg, {"accel": "wide"})]
    for label, c, over in runs17:
        size, depth = (BENCH, BENCH_DEPTH) if "grid" in label else (DEMO, 3)
        sc, cam, opts = render_setup(c, base_dir, width=size, height=size, max_depth=depth, **over)
        check(opts.accel == ("brute" if "floor" in label else "wide"),
              f"{label}: accel {opts.accel}")
        runs, *_ = main_path(label, sc, cam, opts, dev, MAIN_SPP,
                            split_stages=label in ("cornell diffuse floor",
                                                   "cornell disney floor"))
        if opts.accel == "brute":
            for q in ("closest", "anyhit"):
                launches[q] += runs["mt_brute"][q]
        else:
            for q in mega_launches:
                mega_launches[q] += runs["traverse_mega"][q]

    # b. B1, B2 and B3 against their twins on the new rays, each from its
    # own upload: the glass floor's continuation rays (the refracted ones
    # leave 2 RAY_OFFSET below the surface) and shadow rays (none from the
    # floor), and the continuation rays of a Disney floor with clearcoat 1
    # (diffuse, GGX and clearcoat samples).
    glass_sc, _, glass_opts = render_setup(cornell_cfg("glass"), base_dir)
    disney_sc, _, disney_opts = render_setup(cornell_cfg("disney"), base_dir)
    m = disney_sc.materials
    floor_row = int(np.nonzero(m.albedo[:, 3] == int(MaterialType.DISNEY))[0][0])
    disney2 = m.disney2.copy()
    disney2[floor_row, 0] = 1.0
    disney_sc = disney_sc._replace(materials=m._replace(disney2=disney2))
    kernels17 = (("brute", "B1", compare, mt, lambda x: x.tris9, err),
                 ("wide", "B2", compare_mega, mega, wide_args, err_b2),
                 ("cwbvh", "B3", compare_cw8, cw8, cw_args, err_b3))
    for accel, tag, cmp, mod, args, errs in kernels17:
        results = []
        for name, sc, fams in (("glass", glass_sc, glass_opts.families),
                               ("disney", disney_sc, disney_opts.families)):
            kds = upload_scene(sc, accel, dev, wide_group_tris=64)
            ka = args(kds)
            if accel == "brute":
                _, tri, _, _ = mt.brute_closest_plain(o, d, act, ka)
            elif accel == "wide":
                _, tri, _ = mega.mega_closest_plain(o, d, act, *ka)
            else:
                _, tri, _ = cw8.cw8_closest_plain(o, d, act, *ka)
            bo17, bd17, ba17 = bounce_rays(kds, o, d, tri, uni, fams)
            hf, surf, _ = vertex(kds, o, d, tri, fams)
            if name == "glass":
                refracted = int((ba17 & surf.glass & (cm.dot(bd17, hf.n_flip) < 0)).sum())
                print(f"  {tag} glass floor: {int(ba17.sum())} live continuation rays, "
                      f"{refracted} refracted", flush=True)
                check(refracted > 1000, f"{tag}: too few refracted rays ({refracted})")
                shadow17 = shadow_rays(kds, o, d, tri, uni, fams)
                from_floor = int((shadow17[2] & surf.specular).sum())
                check(from_floor == 0, f"{tag}: {from_floor} shadow rays leave the glass floor")
                results.append(cmp(f"{tag} glass floor shadow", mod, *shadow17[:3], ka,
                                   shadow17[3]))
            else:
                w_diff, w_spec, _ = bsdf._lobe_weights(surf.dis_p)
                u_lobe = uni[:, 9]
                lobes = [int((ba17 & surf.disney & k).sum()) for k in (
                    u_lobe < w_diff, (u_lobe >= w_diff) & (u_lobe < w_diff + w_spec),
                    u_lobe >= w_diff + w_spec)]
                print(f"  {tag} Disney floor (clearcoat 1): live continuation rays by lobe "
                      f"(diffuse, GGX, clearcoat) {lobes}", flush=True)
                check(min(lobes) > 1000, f"{tag}: a Disney lobe was barely sampled: {lobes}")
            results.append(cmp(f"{tag} {name} floor continuation", mod, bo17, bd17, ba17, ka,
                               cuda(rng.uniform(0, 8, n))))
        for i, q in enumerate(("closest", "anyhit")):
            errs[q] = max(errs[q], max(r[i] for r in results))

    # c. One sample at 128x128 of the Disney, glass and textured scenes with
    # the same uniforms: kernels on the card against the twins on the CPU,
    # under the CPU parity tests' per-pixel contract.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tex_") as tex_dir:
        tex_cfg = {"scene": {"obj": write_textured_scene(tex_dir)},
                   "camera": {"position": [0.0, 1.0, 4.0], "look_at": [0.0, 1.0, 3.0],
                              "fov": 40.0}}
        side = 128
        ids = torch.arange(side * side, dtype=torch.int32, device=dev)
        uni17 = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0), ids, 3)
        for label, c in (("disney floor", cornell_cfg("disney")),
                         ("glass floor", cornell_cfg("glass")), ("textured OBJ", tex_cfg)):
            sc, cam, opts = render_setup(c, base_dir, width=side, height=side, max_depth=3,
                                         accel="auto")
            mt.reset_launches()
            card = render_sample(upload_scene(sc, opts.accel, dev), cam, uni17, side, side,
                                 opts).cpu()
            k_launches = mt.launches["closest"]
            host = render_sample(upload_scene(sc, opts.accel, "cpu"), cam, uni17.cpu(), side,
                                 side, opts)
            diff = (card - host).abs().amax(dim=1)
            off = float((diff > 1e-4).double().mean())
            mean_c, mean_h = float(card.mean()), float(host.mean())
            print(f"  {label} {side}x{side}, one sample, card vs CPU: max |d| "
                  f"{float(diff.max()):.3e}, pixels beyond 1e-4 {off:.4%}, means {mean_c:.6f} / "
                  f"{mean_h:.6f}; B1 launches on the card {k_launches}", flush=True)
            check(bool(torch.isfinite(card).all()) and mean_h > 0, f"{label}: bad radiance")
            check(k_launches == 3 and mt.launches["closest_twin"] == 3,
                  f"{label}: launches {mt.launches}")
            check(off <= 0.005 and abs(mean_c - mean_h) <= 1e-3 * abs(mean_h),
                  f"{label}: the card's sample breaks the per-pixel contract")

    # d. The AOVs of cornell at 700x700 through B1: one closest-hit query per
    # sample, deterministic, so two runs give equal images.
    for aov in ("albedo", "normal", "depth"):
        aov_opts = setup(DEMO, DEMO)[2]._replace(aov=aov)
        mt.reset_launches()
        captures = progressive.graph_counts["captures"]
        t0 = time.perf_counter()
        imgs = [progressive.render_image(ds_main, camera, aov_opts, spp=2, seed=0)[0]
                for _ in range(2)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 4 * 1e3
        print(f"  AOV {aov}: mean {float(imgs[0].mean()):.4f}, {ms:.3f} ms per sample, "
              f"launches {mt.launches}", flush=True)
        check(torch.equal(imgs[0], imgs[1]), f"AOV {aov}: two runs differ")
        check(bool(torch.isfinite(imgs[0]).all()) and float(imgs[0].mean()) > 0.05
              and float(imgs[0].max()) <= 1.0, f"AOV {aov}: bad image")
        samples = 4 + progressive.graph_counts["captures"] - captures  # and a warm-up
        check(mt.launches["closest"] == samples and mt.launches["anyhit"] == 0
              and mt.launches["closest_twin"] == 0, f"AOV {aov}: launches {mt.launches}")

    # ------------------------------------------------------------- phase 18
    phase("18 gradients on the card")
    with open(os.path.join(ROOT, "scenes", "cornell_disney.toml"), "rb") as f:
        disney_cfg = tomllib.load(f)
    check(all(disney_cfg["render"][k] == v for k, v in
              (("width", 256), ("height", 256), ("max_depth", 3))),
          "scenes/cornell_disney.toml is no longer BASELINE config #5's 256x256, 3 bounces")
    t18 = time.perf_counter()
    grad = {"device": smi}
    grad["config5"], runs18 = grad_recovery(dev, disney_cfg, base_dir, mt)
    for q in ("closest", "anyhit"):
        launches[q] += runs18[q]
    grad["cli"] = grad_cli(dev)
    sc18, cam18, opts18 = render_setup(cornell_cfg("disney"), base_dir, width=DEMO, height=DEMO,
                                       max_depth=3, accel="auto")
    grid_cfg = {"scene": {"builtin": "grid", "resolution": 224}, "camera": sky_cfg["camera"]}
    grid_sc, grid_cam, grid_opts = render_setup(grid_cfg, base_dir, width=BENCH, height=BENCH,
                                                max_depth=BENCH_DEPTH, accel="wide")
    # (label, scene, camera, options, kernel module, its launch totals,
    # parameter sets, repetitions, warm-ups); B3: one call.  The first set
    # of B1's and B2's cases is also split under the profiler.
    cases = [("Disney floor 700x700, 3 bounces, B1", sc18, cam18, opts18, mt, launches,
              [GRAD_KEYS], 5, 2),
             ("grid100k 256x256, 4 bounces, wide (B2)", grid_sc, grid_cam, grid_opts, mega,
              mega_launches, [GRAD_KEYS, GRAD_KEYS + ("vertices",)], 5, 2),
             ("grid100k 256x256, 4 bounces, cwbvh (B3)", grid_sc, grid_cam,
              grid_opts._replace(accel="cwbvh"), cw8, cw_launches, [GRAD_KEYS], 1, 0)]
    grad["overhead"] = []
    for label, sc_, cam_, opts_, mod, totals, key_sets, reps, warmup in cases:
        ds_ = upload_scene(sc_, opts_.accel, dev)
        for i, keys in enumerate(key_sets):
            mod.reset_launches()
            rec = grad_overhead(label, ds_, cam_, opts_, keys, reps, warmup,
                                split=i == 0 and opts_.accel != "cwbvh")
            grad["overhead"].append(rec)
            runs_ = dict(mod.launches)
            want = rec["calls"] * opts_.max_depth
            check(runs_["closest"] == want and runs_["anyhit"] == want
                  and runs_["closest_twin"] == 0 and runs_["anyhit_twin"] == 0,
                  f"{label}: launches {runs_}, expected {want} each and no twin")
            for q in ("closest", "anyhit"):
                totals[q] += runs_[q]
    grad["card_vs_cpu"] = grad_card_vs_cpu(dev, disney_cfg, base_dir, 64)
    grad["seconds"] = time.perf_counter() - t18
    print(f"  phase 18: {grad['seconds']:.3f} s", flush=True)
    print(json.dumps({"grad": grad}))

    # ------------------------------------------------------------- phase 19
    phase("19 tooling and multi-device on the card")
    rec19, runs19 = phase19(dev, setup, camera, grid, bench_scene("grid100k")[1], g3, go, gd,
                            gact, guni, b3o, b3d, b3act, smi)
    for q in ("closest", "anyhit"):
        launches[q] += runs19["mt_brute"][q]
        mega_launches[q] += runs19["traverse_mega"][q]
        cw_launches[q] += runs19["traverse_cw8"][q]
    print(json.dumps({"phase19": rec19}))

    # ------------------------------------------------------------- phase 20
    phase("20 samples per launch: one CUDA graph replay")
    # grid1m as accel "auto" takes it, the path of the grid1m.offline cell:
    # the policy's accelerator, B4's stack sized from the build, at the
    # cell's 1024x1024 and 6 bounces, one launch of 16 spp after the
    # capture's (counts reset just before); B4's launches on the kernels'
    # line are this run's.  Phases 20, 22 and 23 run grid1m on its upload.
    accel1m = auto_accel(grid1m)
    check(accel1m == "bvh2", f"auto_accel takes {accel1m!r} on grid1m, not 'bvh2'")
    opts1m = RenderOptions(width=1024, height=1024, max_depth=6, accel=accel1m,
                           families=scene_families(grid1m))
    runs1m, a1m, rec_auto = main_path("grid1m 1024x1024 auto (B4)", grid1m, grid_cam, opts1m,
                                      dev, MAIN_SPP, split_stages=False)
    b4_main = runs1m["traverse_bvh"]
    opts1m = opts1m._replace(max_stack=required_stack(a1m))
    auto256 = opts1m._replace(width=BENCH, height=BENCH, max_depth=BENCH_DEPTH)
    _, _, demo_opts = setup(DEMO, DEMO)
    grid_opts = {accel: RenderOptions(width=BENCH, height=BENCH, max_depth=BENCH_DEPTH,
                                      accel=accel, families=scene_families(grid))
                 for accel in ("wide", "cwbvh", "bvh2")}
    binary_runs = []
    for accel in ("bvh2", "sbvh"):
        bds = upload_scene(scene, accel, dev)
        binary_runs.append((f"cornell {DEMO}x{DEMO} {accel} (B4)", bds, camera,
                            demo_opts._replace(accel=accel, max_stack=required_stack(bds))))
    g4 = upload_scene(grid, "bvh2", dev)
    binary_runs.append((f"grid100k {BENCH}x{BENCH} bvh2 (B4)", g4, grid_cam,
                        grid_opts["bvh2"]._replace(max_stack=required_stack(g4))))
    rec20, runs20 = phase20(dev, smi, [
        (f"cornell {DEMO}x{DEMO} brute (B1)", ds_main, camera, demo_opts),
        (f"grid100k {BENCH}x{BENCH} wide (B2)", gds, grid_cam, grid_opts["wide"]),
        (f"grid100k {BENCH}x{BENCH} cwbvh (B3)", g3, grid_cam, grid_opts["cwbvh"]),
        (f"grid1m {BENCH}x{BENCH} auto (B4)", a1m, grid_cam, auto256),
    ], binary_runs, cfg, os.path.dirname(CORNELL_TOML))
    del binary_runs
    for q in ("closest", "anyhit"):
        launches[q] += runs20["mt_brute"][q]
        mega_launches[q] += runs20["traverse_mega"][q]
        cw_launches[q] += runs20["traverse_cw8"][q]
    rec20["grid1m_auto_main_path"] = {"accel": accel1m, "max_stack": opts1m.max_stack,
                                      **rec_auto, "launches": runs1m}
    print(json.dumps({"phase20": rec20}))

    # ------------------------------------------------------------- phase 21
    phase("21 B4: the binary walk")
    rec21, err_b4 = phase21(dev, smi, scene, camera, o, d, uni, grid, grid1m, grid_cam, go, gd,
                            gact, guni, cuda, sbvh_grid1m)
    print(json.dumps({"phase21": rec21}))

    # ------------------------------------------------------------- phase 22
    phase("22 B5: the threefry sampler")
    rec22, err_b5, b5_rows = phase22(dev, smi, [
        (f"cornell {DEMO}x{DEMO} brute (B1)", ds_main, camera, demo_opts),
        (f"grid100k {BENCH}x{BENCH} wide (B2)", gds, grid_cam, grid_opts["wide"]),
        (f"grid100k {BENCH}x{BENCH} cwbvh (B3)", g3, grid_cam, grid_opts["cwbvh"]),
        (f"grid100k {BENCH}x{BENCH} bvh2 (B4)", g4, grid_cam,
         grid_opts["bvh2"]._replace(max_stack=required_stack(g4))),
        (f"grid1m {BENCH}x{BENCH} auto (B4)", a1m, grid_cam, auto256),
    ])
    del g4
    print(json.dumps({"phase22": rec22}))

    # ------------------------------------------------------------- phase 23
    phase("23 B6: the shading kernel")
    sc23, cam23, opts23 = render_setup(cornell_cfg("disney"), base_dir, width=DEMO, height=DEMO,
                                       max_depth=4, accel="brute")
    rec23, err_b6, b6_rows, err_path, b4_row = phase23(dev, smi, [
        (f"cornell {DEMO}x{DEMO} brute (B1)", ds_main, camera, demo_opts),
        specular_run(dev),
        ("grid1m 1024x1024 auto (B4)", a1m, grid_cam, opts1m),
        (f"cornell_disney {DEMO}x{DEMO} brute (B1)", upload_scene(sc23, "brute", dev), cam23,
         opts23),
    ])
    print(json.dumps({"phase23": rec23}))
    check(b4_row is not None, "phase 23 held no binary path against B4's twins")
    err_b4 = {q: max(err_b4[q], err_path[q]) for q in err_b4}

    # ------------------------------------------------------------- phase 24
    phase("24 the specular cell's path: mirror and glass through B4 and B6")
    rec24, _ = phase24(dev, smi)
    print(json.dumps({"phase24": rec24}))

    # Bounds at the shapes each row's time was taken at: B1 on the 700x700
    # cornell primary rays (closest) and their shadow rays (any-hit), B2 and
    # B3 on grid100k's 65536 primary rays, B4 on the grid1m.offline path's
    # 1024x1024 camera rays (closest) and their shadow rays (any-hit).
    b23_bounds = b2_sets[("grid100k", "primary")]["bound"]

    def kernel_row(name, mod, q, n_launch, err_q, ms, plain_ms, bnd):
        return {"name": f"{name}_{q}", "route": "cuda", "source": mod.SOURCE,
                "replaces": mod.REPLACES, "launches": n_launch, "max_abs_err": err_q,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None}  # no single PyTorch call computes a closest hit

    b1_shape = {"closest": "36", "anyhit": "36 shadow"}
    record = {"kernels": [
        kernel_row("mt_brute", mt, q, launches[q], err[q], times[b1_shape[q]][q],
                   times[b1_shape[q]][f"{q}_plain"], b1_bounds[b1_shape[q]][q])
        for q in ("closest", "anyhit")
    ] + [
        kernel_row("mega", mega, q, mega_launches[q], err_b2[q], b2_times[q],
                   b2_times[f"{q}_plain"], b23_bounds[f"B2 {q}"]) for q in ("closest", "anyhit")
    ] + [
        kernel_row("cw8", cw8, q, cw_launches[q], err_b3[q], b3_times[q],
                   b3_times[f"{q}_plain"], b23_bounds[f"B3 {q}"]) for q in ("closest", "anyhit")
    ] + [
        # B4 on the grid1m.offline path (launches from phase 20's 1024x1024
        # main path under auto, times from phase 23).
        kernel_row("bvh", tb, q, b4_main[q], err_b4[q], b4_row["ms"][q],
                   b4_row["ms"][f"{q}_plain"], b4_row["bound"][q]) for q in ("closest", "anyhit")
    ] + [
        # B5 at the main paths' shapes: the cornell demo's pixel-keyed
        # uniforms (launches from phase 5), config #5's lane-keyed ones
        # (launches from `optimize` in phase 18a).  No PyTorch call computes
        # threefry: torch.rand is Philox.
        {"name": f"threefry_{q}", "route": "cuda", "source": tf.SOURCE,
         "replaces": tf.REPLACES if q == "pixel" else tf.REPLACES_LANE, "launches": n_launch,
         "max_abs_err": err_b5[q], "ms": b5_rows[q]["ms"], "plain_ms": b5_rows[q]["plain_ms"],
         "bound_ms": b5_rows[q]["bound_ms"], "bound_by": b5_rows[q]["bound_by"],
         "library_ms": None}
        for q, n_launch in (("pixel", b5_main["pixel"]),
                            ("lane", grad["config5"]["b5_launches"]["lane"]))
    ] + [
        # B6 on the 700x700 cornell's bounce 0 and the finishing add of
        # its bounce 1 (launches from phase 5).  No PyTorch call shades a
        # bounce.
        {"name": f"shade_{q}", "route": "cuda", "source": b6.SOURCE, "replaces": b6.REPLACES,
         "launches": b6_main[q], "max_abs_err": err_b6[q], "ms": b6_rows[q]["ms"],
         "plain_ms": b6_rows[q]["plain_ms"], "bound_ms": b6_rows[q]["bound_ms"],
         "bound_by": "bytes", "library_ms": None}
        for q in ("bounce", "finish")
    ]}
    loaded = sorted(k for k in sys.modules
                    if any(k == f or k.startswith(f + ".") for f in FORBIDDEN))
    check(not loaded, f"jax or the JAX package was imported: {loaded}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
