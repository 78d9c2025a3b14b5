"""Structured metrics and logging (counterpart of
caitlynrenderer_tpu/utils/metrics.py): BVH build statistics, wall time per
named pass with a derived rays/s, one-line JSON log records through the
stdlib logger, the program's phase spans, and a profiler trace around a
block.

Phase spans.  `span(name)` marks a phase of the program's work as
`caitlyn.<name>` (`render/progressive.py`, `render/integrator.py`: each
bounce's phases carry its index, `b2.nee`).  With no profiler and no
capture running it costs two checks.  Under `torch.profiler` it records a
host event of that name, in the trace that holds the card's kernels.
While a CUDA graph is captured under `capture_phases`, it marks the graph
under construction instead, so that each of the graph's nodes is given
the innermost span open when it was added: the graph's phase map, one
(phase, kernel name) per node that runs on the device, in the order they
run.  A replay runs the nodes in that order, so the map names the phase
of each kernel a profiler traces inside one `cudaGraphLaunch`.
`attribute` gives each device operation of a Chrome trace its phase.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import os
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from caitlynrenderer_tpu_torch.ops import _build

logger = logging.getLogger("caitlynrenderer_tpu_torch")

# The last record logged of each kind (`log_record`), for a caller in the
# same process.
last_records: Dict[str, Dict[str, Any]] = {}


def bvh_build_stats(bvh) -> Dict[str, Any]:
    """Build-quality record of a FlatBVH (or an SBVH's gather-list tree)."""
    from caitlynrenderer_tpu_torch.accel.bvh import sah_cost

    leaf = bvh.is_leaf()
    counts = bvh.node_meta[leaf, 1]
    n_refs = int(counts.sum())
    return {
        "nodes": int(bvh.num_nodes),
        "leaves": int(leaf.sum()),
        "max_leaf_size": int(counts.max()) if len(counts) else 0,
        "mean_leaf_size": float(counts.mean()) if len(counts) else 0.0,
        "sah_cost": round(sah_cost(bvh), 3),
        "refs": n_refs,
        "duplication_ratio": round(n_refs / max(len(bvh.tri_order), 1), 4)
        if len(bvh.tri_order) != n_refs
        else 1.0,
    }


@dataclass
class StepTimer:
    """Wall time per named pass, with a rays/s derived summary.  A span
    times the host: end it after `torch.cuda.synchronize()` to time the
    card's work.

        timer = StepTimer()
        with timer.span("trace"):
            ...
            torch.cuda.synchronize()
        timer.count("rays", n)
    """

    spans: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name: str, n: int):
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: round(v * 1e3, 3) for k, v in self.spans.items()}
        out.update(self.counts)
        total = sum(self.spans.values())
        if "rays" in self.counts and total > 0:
            out["rays_per_sec"] = round(self.counts["rays"] / total, 1)
        return out


def log_record(kind: str, record: Dict[str, Any]) -> None:
    """One structured JSON log line; kept in `last_records` too."""
    last_records[kind] = record
    logger.info("%s %s", kind, json.dumps(record, sort_keys=True))


# --------------------------------------------------------------------------
# Phase spans
# --------------------------------------------------------------------------

PREFIX = "caitlyn."
# The groups of phases, by what the card does in them.  "shade" is a
# bounce's kernel B6, which does the work of "hit", "nee" and "bounce"
# where it shades (render/integrator.fused_shading); elsewhere the plain
# bounce's spans hit, nee and bounce lie inside the shade span.  "bsdf" is
# the Disney BRDF's work in the plain bounce (its parameters, its value and
# pdf toward the light, its sample), a span inside its hit, nee and bounce.
# "specular" is the mirror and glass lanes' work in the plain bounce (their
# masks, the reflection, the Fresnel choice, the refraction and its
# origin), a span inside its hit and bounce.  "sky" is the environment
# map's lookup and add on a miss, and "texture" the atlas's lookup of a
# hit's albedo, both spans inside the plain bounce's hit.
GROUPS = ("raygen", "query", "hit", "nee", "bounce", "shade", "bsdf", "specular", "sky",
          "texture")
_BOUNCE_GROUPS = {"closest": "query", "anyhit": "query", "hit": "hit", "nee": "nee",
                  "rr": "bounce", "bounce": "bounce", "shade": "shade", "bsdf": "bsdf",
                  "specular": "specular", "sky": "sky", "texture": "texture"}
_BOUNCE_PHASE = re.compile(r"^b\d+\.(\w+)$")
_NULL = contextlib.nullcontext()
# The PhaseCapture of the CUDA-graph capture running, if any.
_capture: Optional["PhaseCapture"] = None


def span(name: str):
    """The context of phase `name` (module docstring): nothing with no
    profiler and no capture running; a host event `caitlyn.<name>` under
    `torch.profiler`; a mark on the graph under construction while
    `capture_phases` runs.  The profiler's event is a function-scope
    record, which the profiler does not mirror onto the card's timeline,
    so a trace's device operations are the card's own."""
    if _capture is not None:
        return _CaptureSpan(_capture, name)
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _NULL


def phase_group(phase: Optional[str]) -> Optional[str]:
    """The group (GROUPS) of a phase: "raygen" for `launch.*`, `sample.*`
    and `raygen`; "query" for a bounce's `closest` and `anyhit`; "hit";
    "nee" (its `anyhit` apart); "bounce" for `rr` and `bounce`; "shade"
    for a bounce's `shade` (kernel B6 on the fused path); "bsdf" for a
    bounce's `bsdf` (the Disney BRDF's work on the torch path); "specular"
    for a bounce's `specular` (the mirror and glass lanes'); "sky" and
    "texture" for a bounce's `sky` (the environment map on a miss) and
    `texture` (the atlas's albedo).  Any other phase is a group of its own
    (`capture`, `resolve`); None stays None."""
    if phase is None:
        return None
    if phase == "raygen" or phase.startswith(("launch.", "sample.")):
        return "raygen"
    m = _BOUNCE_PHASE.match(phase)
    return _BOUNCE_GROUPS.get(m.group(1), phase) if m else phase


class PhaseCapture:
    """The spans of one CUDA-graph capture on the stream `stream` (a
    cudaStream_t handle).  At each span's entry and exit it notes the node
    the capture's next node will follow (libcuda's
    cuStreamGetCaptureInfo; it adds no node) and the innermost span open
    from there on; `node_phases` reads them against the captured graph."""

    def __init__(self, stream: int):
        self.stream = stream
        self.open: list = []
        # (the node the next one will follow: a handle, 0 before the first
        # node, None after a fork; the innermost phase from then on)
        self.marks: list = []

    def mark(self) -> None:
        tail = _build.capture_tail(self.stream)
        self.marks.append((tail, self.open[-1] if self.open else None))

    def node_phases(self, raw_graph: int):
        """(nodes, phases) of the captured graph: `_build.graph_nodes`' nodes
        in the order they run and the phase of each (None outside every
        span); phases is None where the graph is not one chain."""
        nodes, chain = _build.graph_nodes(raw_graph)
        at = {handle: i for i, (handle, _, _) in enumerate(nodes)}
        if not chain or any(t is None or (t and t not in at) for t, _ in self.marks):
            return nodes, None
        # A node belongs to the last mark made before it was added: the
        # last whose node it follows lies before it.
        marks = [(at[t] if t else -1, phase) for t, phase in self.marks]
        phases, k, phase = [], 0, None
        for i in range(len(nodes)):
            while k < len(marks) and marks[k][0] < i:
                phase = marks[k][1]
                k += 1
            phases.append(phase)
        return nodes, phases


class _CaptureSpan:
    __slots__ = ("cap", "name", "rf")

    def __init__(self, cap: PhaseCapture, name: str):
        self.cap, self.name, self.rf = cap, name, None

    def __enter__(self):
        self.cap.open.append(self.name)
        self.cap.mark()
        if torch.autograd._profiler_enabled():
            self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.cap.open.pop()
        self.cap.mark()
        return False


@contextmanager
def capture_phases(stream: int):
    """Mark the spans of the block against the CUDA graph that `stream` (a
    cudaStream_t handle) is capturing; yields the PhaseCapture."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a CUDA-graph capture is already marking its phases")
    _capture = PhaseCapture(stream)
    try:
        yield _capture
    finally:
        _capture = None


def run_length(pairs) -> list:
    """[(phase, name), ...] -> [[phase, name, n], ...] with n the length of
    each run of equal pairs."""
    out = []
    for p in pairs:
        if out and out[-1][0] == p[0] and out[-1][1] == p[1]:
            out[-1][2] += 1
        else:
            out.append([p[0], p[1], 1])
    return out


def expand(runs) -> list:
    """The inverse of `run_length`."""
    return [(phase, name) for phase, name, n in runs for _ in range(n)]


_kernel_bases: list = []


def kernel_family(name: str) -> str:
    """The family of a kernel by name, mangled (a graph node's) or as a
    profiler names it: "copy" for a memcpy or memset, the base name of a
    hand-written kernel ("mega_kernel"), else "other"."""
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    if not _kernel_bases:
        # Each kernel module registers its kernels' names at import.
        from caitlynrenderer_tpu_torch.ops import (  # noqa: F401
            mt_brute, shade, threefry, traverse_bvh, traverse_cw8, traverse_mega)

        _kernel_bases.extend(sorted({re.match(r"\w*?_kernel", fragment).group(0)
                                     for _, kernels in _build.COUNTERS.values()
                                     for fragment in kernels.values()}))
    return next((base for base in _kernel_bases if base in name), "other")


# Chrome-trace categories of the card's operations and of the host's calls
# into the CUDA runtime and driver.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def attribute(events, phase_maps=()):
    """The phase of each device operation of a Chrome trace's events (the
    dicts of its "traceEvents"): [(event, phase or None)] in the trace's
    order.  An operation of one `cudaGraphLaunch` takes its phase by
    position from the one map of `phase_maps` ([(phase, name), ...], as
    `expand` gives) whose length and kernel families (`kernel_family`)
    equal those of the launch's operations in order of start; where no map
    does, every operation of the launch has phase None, never a guess.
    Any other operation takes the innermost `caitlyn.` span open on the
    host when its host call was made."""
    device, calls, spans = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in RUNTIME_CATS:
            calls[e.get("args", {}).get("correlation")] = e
        elif name.startswith(PREFIX):
            spans.append((e["ts"], e["ts"] + e["dur"], name[len(PREFIX):]))
    starts, parent = _nest(spans)
    launches, phases = {}, {}
    for e in device:
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is not None and call["name"].startswith("cudaGraphLaunch"):
            launches.setdefault(id(call), []).append(e)
        else:
            phases[id(e)] = (_innermost(spans, starts, parent, call["ts"])
                             if call is not None else None)
    maps = [[(phase, kernel_family(name)) for phase, name in m] for m in phase_maps]
    for ops in launches.values():
        ops.sort(key=lambda e: e["ts"])
        families = [kernel_family(e["name"]) for e in ops]
        found = next((m for m in maps if [f for _, f in m] == families), None)
        for i, e in enumerate(ops):
            phases[id(e)] = found[i][0] if found else None
    return [(e, phases[id(e)]) for e in device]


def _nest(spans):
    """Sort `spans` ((start, end, phase), properly nested) by start; returns
    their starts and the index of each one's parent (-1 for none)."""
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    parent, open_ = [], []
    for i, (start, _, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] < start:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)
    return [sp[0] for sp in spans], parent


def _innermost(spans, starts, parent, t):
    """The phase of the innermost span holding time t, or None: the last
    span to start before t, else its nearest ancestor, that has not ended."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0 and spans[j][1] < t:
        j = parent[j]
    return spans[j][2] if j >= 0 else None


@contextmanager
def profile_trace(log_dir: Optional[str], phase_maps=None):
    """torch.profiler trace of the block (CPU, and CUDA where a card is
    visible), written as `log_dir`/trace.json (Chrome trace format, for
    Perfetto): the program's `caitlyn.*` spans and the card's kernels on
    one clock.  `phase_maps`, a function called after the block, gives the
    phase maps of the CUDA graphs it may have replayed (expanded, as
    `attribute` takes them): each device operation that `attribute` gives
    a phase gets it as its argument "caitlyn.phase", and each run of the
    card's operations in one phase is drawn as a `caitlyn.<phase>` span
    above them.  Logs a "profile" record: device milliseconds in all, by
    phase group, and by phase and kernel family (`kernel_family`; phase
    "none" for operations `attribute` gives none).  No-op when log_dir is
    None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    attributed = attribute(events, phase_maps() if phase_maps else ())
    runs, by_phase, groups = [], {}, {}
    for e, phase in sorted(attributed, key=lambda a: a[0]["ts"]):
        ms = e["dur"] / 1e3
        row = by_phase.setdefault(phase or "none", {})
        family = kernel_family(e["name"])
        row[family] = row.get(family, 0.0) + ms
        group = phase_group(phase) or "none"
        groups[group] = groups.get(group, 0.0) + ms
        if phase is None:
            continue
        e.setdefault("args", {})["caitlyn.phase"] = phase
        key = (e["pid"], e["tid"], phase)
        if runs and runs[-1][0] == key and e["ts"] >= runs[-1][2]:
            runs[-1][2] = max(runs[-1][2], e["ts"] + e["dur"])
        else:
            runs.append([key, e["ts"], e["ts"] + e["dur"]])
    events += [{"ph": "X", "cat": "caitlyn_phase", "name": PREFIX + phase, "pid": pid,
                "tid": tid, "ts": t0, "dur": t1 - t0} for (pid, tid, phase), t0, t1 in runs]
    with open(path, "w") as f:
        json.dump(trace, f)
    log_record("profile", {
        "trace": path, "device_ms": round(sum(groups.values()), 6),
        "group_ms": {k: round(v, 6) for k, v in groups.items()},
        "phase_ms": {p: {k: round(v, 6) for k, v in row.items()}
                     for p, row in by_phase.items()}})
