#!/usr/bin/env python3
"""Where a benchmark cell's device time goes, by the program's phases.

    python3 tools/phase_split.py CELL SEED OUT.json [--seconds S]

Sets the cell up and runs its loop for S seconds (default 2) as
`python3 -m cellbench.run` does (`cellbench.drive.Run`), traces one
segment of it as the benchmark does (`cellbench.trace.Segment`), and
gives each traced device operation its phase with the program's
`utils/metrics.attribute` against the phase maps of the graphs it
replayed.  Writes OUT.json: device milliseconds a sample by phase and by
phase group, each by kernel class (`cellbench.trace.kernel_class`); the
benchmark's own integrator and traversal times of the same segment; the
traced frame; the run's `upload` and `graph_capture` records; and the
instrumented pass's `rays` record (live lanes, those shading with the
Disney BRDF and any-hit candidates a bounce).  Prints the card's name and
power limit and a summary.  Needs an NVIDIA card; run from the
repository's root with PYTHONPATH=.
"""

import argparse
import json
import os
import subprocess
import tempfile
import time

T_START = time.perf_counter()

import torch  # noqa: E402

from caitlynrenderer_tpu_torch import cli  # noqa: E402
from caitlynrenderer_tpu_torch.render import progressive  # noqa: E402
from caitlynrenderer_tpu_torch.utils import metrics  # noqa: E402
from cellbench import drive, manifest, trace  # noqa: E402


def add(table, key, cls, ms):
    row = table.setdefault(key, {})
    row[cls] = row.get(cls, 0.0) + ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("out")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())

    run = drive.Run(manifest.load(), args.cell, args.seed, args.seconds, True, "cuda:0", T_START)
    run.setup()
    cli._rays_per_sample(run.r.ds, run.r.camera, run.r.options, args.seed, run.device)
    run.window()
    samples = 0
    with trace.Segment() as seg:
        t0 = time.perf_counter()
        while not samples or time.perf_counter() - t0 < drive.TRACE_SECONDS:
            samples += run.step()
        with trace.stage("sync"):
            run.sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        seg.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_phase, by_group = {}, {}
    for e, phase in metrics.attribute(events, progressive.phase_maps()):
        cls, ms = trace.kernel_class(e["name"]), e["dur"] / 1e3 / samples
        add(by_phase, phase or "none", cls, ms)
        add(by_group, metrics.phase_group(phase) or "none", cls, ms)
    render = seg.summary["stage_ms"].get("render", {})
    out = {
        "card": card.strip(), "cell": args.cell, "seed": args.seed, "samples_traced": samples,
        "frame_ms": run.spans["frame_ms"],
        "traced_frame_ms": seg.summary["window_s"] * 1e3 / samples,
        "integrator_ms_per_sample": render.get("other", 0.0) / samples,
        "trav_ms_per_sample": sum(render.get(c, 0.0) for c in trace.TRAVERSAL) / samples,
        "group_ms_per_sample": by_group, "phase_ms_per_sample": by_phase,
        "upload": metrics.last_records.get("upload"),
        "rays": metrics.last_records.get("rays"),
        "graph_capture": run.captures.records,
        "idle_gaps": seg.summary["idle_gaps"],
    }
    run.r.release()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    groups = {g: round(row.get("other", 0.0), 4) for g, row in by_group.items()}
    print(json.dumps({"cell": args.cell, "integrator_ms_per_sample":
                      round(out["integrator_ms_per_sample"], 4), "other_by_group": groups}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
