#!/usr/bin/env python3
"""Kernel B4 (csrc/traverse_bvh.cu) timed on the main path's ray sets, so that
two versions of the kernel can be compared in one run on one card.

    python3 tools/b4_times.py rays SETS.pt
        Make the sets with this checkout and save them: grid100k's and
        grid1m's 256x256 primary rays (the bench camera, sample 0, as
        chip_smoke.py's phases 7 and 21 make them) and the integrator's
        bounce rays from their hits (chip_smoke.bounce_rays) under "bvh2",
        and the 700x700 cornell's primary rays (490,000, more than the card
        holds threads); each with its FlatBVH and leaf-ordered scene, the
        plain twins' answers and each query's bound (chip_smoke.bvh_bound,
        from this checkout's stats variant's oracle walk).
    python3 tools/b4_times.py time SETS.pt [--root DIR] [--label NAME]
        Time the B4 of the checkout at DIR (default: this one) on them, and
        check its answers against the twins' bit for bit.  Prints the card's
        name and power limit, ptxas's registers, stack and spills of each
        build, then one JSON line per set and query: the device time (CUDA
        events, the host enqueuing ahead of the card), the time per call as
        a caller issues them back to back (host included), the bound and the
        share of it.

Both need an NVIDIA card.  The timing step uses only the wrapper module
`caitlynrenderer_tpu_torch.ops.traverse_bvh` of DIR and its `_build`: a
checkout whose wrapper has `pack_bvh_pairs` (v2) gets the records and the
tris9 slab, an earlier one (v1) the FlatBVH and the scene.  So DIR may hold
an earlier commit: `mkdir -p DIR && git archive <commit> | tar -x -C DIR`.
Any-hit takes t_max 20 on every set, as phase 21 (c) does.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
T_MAX = 20.0


def _chip_smoke():
    """chip_smoke.py of this checkout (its ray helpers, event_ms,
    bvh_bound), loaded by path so that another checkout on sys.path cannot
    shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_sets(path):
    import tomllib

    sys.path.insert(0, ROOT)
    from caitlynrenderer_tpu_torch.bench import bench_scene
    from caitlynrenderer_tpu_torch.cli import render_setup
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.ops import traverse_bvh as tb
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import _bvh
    from caitlynrenderer_tpu_torch.scene import required_stack, upload_scene

    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)

    def primary(camera, side, depth):
        n = side * side
        uni = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0),
                                      torch.arange(n, dtype=torch.int32, device=dev), depth)
        o, d = generate_rays(camera, side, side, uni)
        return o, d, torch.ones(n, dtype=torch.bool, device=dev), uni

    sets = {}
    for name in ("grid100k", "grid1m"):
        scene, camera = bench_scene(name)
        ds = upload_scene(scene, "bvh2", dev)
        o, d, act, uni = primary(camera, smoke.BENCH, smoke.BENCH_DEPTH)
        tri = tb.traverse_closest_plain(o, d, act, *_bvh(ds)[:4], max_stack=required_stack(ds))[1]
        sets[f"{name} bvh2 primary"] = (ds, o, d, act)
        sets[f"{name} bvh2 bounce"] = (ds, *smoke.bounce_rays(ds, o, d, tri, uni))
    with open(smoke.CORNELL_TOML, "rb") as f:
        cfg = tomllib.load(f)
    scene, camera, _ = render_setup(cfg, os.path.dirname(smoke.CORNELL_TOML), width=smoke.DEMO,
                                    height=smoke.DEMO, max_depth=3, accel="auto")
    sets[f"cornell {smoke.DEMO}x{smoke.DEMO} bvh2 primary"] = (
        upload_scene(scene, "bvh2", dev), *primary(camera, smoke.DEMO, 3)[:3])
    out = {}
    for name, (ds, o, d, act) in sets.items():
        kw = {"max_leaf": 4, "max_stack": required_stack(ds)}
        tree = _bvh(ds)
        tm = torch.full((o.shape[0],), T_MAX, device=dev)
        want = tb.traverse_closest_plain(o, d, act, *tree[:4], **kw)
        occ = tb.traverse_anyhit_plain(o, d, tm, act, *tree[:4], **kw)
        st = smoke.bvh_stats(tb, o, d, act, tree, tm, kw)
        out[name] = {
            "o": o, "d": d, "active": act, "t_max": tm, "kw": kw,
            "node_bounds": ds.node_bounds, "node_meta": ds.node_meta,
            "verts": ds.scene.vertices, "tri_v": ds.scene.tri_v,
            "want": want, "occ": occ,
            "bound": {q: smoke.bvh_bound(st[q + "_oracle"], q == "anyhit")
                      for q in ("closest", "anyhit")},
        }
        print(f"{name}: {o.shape[0]} rays ({int(act.sum())} live), {ds.node_meta.shape[0]} "
              f"nodes, {ds.scene.tri_v.shape[0]} tris: hits {int((want[1] >= 0).sum())}, "
              f"occluded {int(occ.sum())}, bound {out[name]['bound']}", flush=True)
    torch.save({k: {f: _to_cpu(v) for f, v in s.items()} for k, s in out.items()}, path)


def _to_cpu(v):
    if torch.is_tensor(v):
        return v.cpu()
    if isinstance(v, tuple):
        return tuple(_to_cpu(x) for x in v)
    return v


def _ptxas(log):
    """One line per kernel instance of ptxas's -v log: its mangled name's
    template part, registers, stack frame and spills."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            frame = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "bvh2_kernel" in name:
            inst = re.search(r"bvh2_kernelI(.*?E)E", name)
            lines.append(f"    {inst.group(1) if inst else name}: {m.group(1)} registers, "
                         f"{frame[0]} B stack, spills {frame[1]} / {frame[2]} B")
            name = None
    return "\n".join(lines)


def time_sets(path, root, label):
    smoke = _chip_smoke()
    sys.path.insert(0, os.path.abspath(root))
    from caitlynrenderer_tpu_torch.ops import _build
    from caitlynrenderer_tpu_torch.ops import traverse_bvh as tb
    from caitlynrenderer_tpu_torch.ops.intersect import pack_tris

    print(f"{label}: {tb.__file__}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    info = _build.build("traverse_bvh", force=True)
    print(f"  {label} build: {info['seconds']:.2f} s\n{_ptxas(info['log'])}", flush=True)
    v2 = hasattr(tb, "pack_bvh_pairs")
    dev = torch.device("cuda", 0)
    for name, s in torch.load(path).items():
        qo, qd, qa, tm = (s[k].to(dev) for k in ("o", "d", "active", "t_max"))
        tree = [s[k].to(dev) for k in ("node_bounds", "node_meta", "verts", "tri_v")]
        if v2:
            tree += [tb.pack_bvh_pairs(tree[0], tree[1]), pack_tris(tree[2], tree[3]).contiguous()]
        kw = s["kw"]
        got = tb.traverse_closest(qo, qd, qa, *tree, **kw)
        occ = tb.traverse_anyhit(qo, qd, tm, qa, *tree, **kw)
        torch.cuda.synchronize()
        bits = sum(int((a.cpu().view(torch.int32) != b.view(torch.int32)).sum())
                   for a, b in zip(got, s["want"])) + int((occ.cpu() != s["occ"]).sum())
        if bits:
            raise RuntimeError(f"{label}, {name}: {bits} bits differ from the twin's answers")
        calls = {"closest": lambda: tb.traverse_closest(qo, qd, qa, *tree, **kw),
                 "anyhit": lambda: tb.traverse_anyhit(qo, qd, tm, qa, *tree, **kw)}
        for q, fn in calls.items():
            ms = smoke.event_ms(fn, REPS)
            per_call = smoke.event_ms(fn, REPS, host_ahead=False)
            b_ms, b_by = s["bound"][q]
            print(json.dumps({"label": label, "set": name, "query": q, "rays": qo.shape[0],
                              "live": int(qa.sum()), "nodes": tree[1].shape[0], "ms": ms,
                              "per_call_ms": per_call, "bound_ms": b_ms, "bound_by": b_by,
                              "share": b_ms / ms}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("rays", "time"))
    parser.add_argument("sets", help="file of ray sets (.pt)")
    parser.add_argument("--root", default=ROOT, help="checkout whose B4 is timed")
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("b4_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.mode == "rays":
        make_sets(args.sets)
    else:
        time_sets(args.sets, args.root, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
