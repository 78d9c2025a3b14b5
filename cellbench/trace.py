"""The device trace of a traced segment, reduced to what the per-layer
readers and the result line take: device time by kernel class in each
stage of the loop and in each of the program's phase groups, the
device's busy seconds in the window, the device operations that took
most time and the longest idle gaps.

A segment runs under `torch.profiler` (CPU and CUDA activities), each
stage of the loop inside `record_function("cellbench.<stage>")` and the
whole inside "cellbench.window".  Kernels inside a CUDA-graph replay are
traced one by one.  A device operation belongs to the stage whose span
holds the host call that issued it (matched by correlation id).  Its
phase group is the program's to give: a segment given `attribute` (the
program adapter's `phase_groups`, which this module does not import)
hands it the segment's Chrome trace.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.autograd import DeviceType

PREFIX = "cellbench."
WINDOW = PREFIX + "window"
TOP = 10  # entries in each list of the breakdown

# The program's hand-written kernels, by a fragment of their names.
KERNELS = {
    "b1": ("mt_brute_kernel",),
    "b2": ("mega_kernel",),
    "b3": ("cw8_kernel",),
    "b4": ("bvh2_kernel",),
    "b5": ("threefry_pixel_kernel", "threefry_lane_kernel"),
}
TRAVERSAL = ("b1", "b2", "b3", "b4")


def kernel_class(name: str) -> str:
    """"b1" .. "b5" for the hand-written kernels, "copy" for a memcpy or a
    memset, else "other" (the program's elementwise and library kernels)."""
    for cls, fragments in KERNELS.items():
        if any(f in name for f in fragments):
            return cls
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "other"


@contextmanager
def stage(name: str):
    with torch.profiler.record_function(PREFIX + name):
        yield


class Segment:
    """Profiles the block of `with Segment() as seg:`; on exit reads the
    trace into `summary` (None when the profiler saw no device work).
    With `attribute` (Chrome trace events -> [(device event, phase group
    or None)]) the summary also has "phase_ms": {group: {class: ms}},
    the None group holding what no phase places."""

    def __init__(self, attribute=None):
        self.attribute = attribute

    def __enter__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        self._window.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self.prof.profiler.kineto_results.events())
            if self.summary is not None and self.attribute is not None:
                self.summary["phase_ms"] = phase_ms(self.attribute(self.chrome_events()))
        return False

    def chrome_events(self) -> list:
        """The trace's "traceEvents", as `export_chrome_trace` writes them."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]


def phase_ms(attributed) -> dict:
    """{group: {kernel class: device ms}} of [(Chrome trace event, group)]."""
    out = defaultdict(lambda: defaultdict(float))
    for e, group in attributed:
        out[group][kernel_class(e["name"])] += e["dur"] / 1e3
    return {g: dict(row) for g, row in out.items()}


def short_name(name: str) -> str:
    """A kernel's name without the namespaces that every one repeats."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "c10::", "std::"):
        name = name.replace(noise, "")
    return name[:160]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events):
    """{"window_s", "busy_s", "stage_ms": {stage: {class: ms}},
    "device_ops": [[name, s]], "idle_gaps": [[label, s]]} of kineto
    events, or None without a window span or device events."""
    cpu, dev = [], []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            cpu.append(e)
        elif not e.name().startswith(PREFIX):  # not the device's mirror of a stage span
            dev.append(e)
    window = [e for e in cpu if e.name() == WINDOW]
    if not window or not dev:
        return None
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    stages = sorted((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]) for e in cpu
                    if e.name().startswith(PREFIX) and e.name() != WINDOW)
    starts = [s for s, _, _ in stages]

    def stage_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return stages[i][2] if i >= 0 and stages[i][1] >= t else "other"

    issued = {e.correlation_id(): e.start_ns() for e in cpu if e.correlation_id()}
    stage_ms = defaultdict(lambda: defaultdict(float))
    by_name = defaultdict(float)
    spans = []
    for e in dev:
        s, d = e.start_ns(), e.duration_ns()
        when = issued.get(e.correlation_id())
        st = stage_at(when) if when is not None else "other"
        stage_ms[st][kernel_class(e.name())] += d / 1e6
        by_name[e.name()] += d / 1e9
        spans.append((max(s, w0), min(s + d, w1)))
    busy = _merge([(s, e) for s, e in spans if e > s])
    busy_ns = sum(e - s for s, e in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((g1 - g0, g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0),
                  reverse=True)[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "stage_ms": {k: dict(v) for k, v in stage_ms.items()},
        "device_ops": [[short_name(name), sec] for name, sec in ops],
        "idle_gaps": [[_host_label(cpu, (g0 + g1) // 2), ns / 1e9] for ns, g0, g1 in gaps],
    }


def _host_label(cpu, t):
    """What the host was doing at time t: the stage span and the innermost
    other host event that hold t."""
    holding = [e for e in cpu if e.start_ns() <= t <= e.end_ns() and e.name() != WINDOW]
    st = [e for e in holding if e.name().startswith(PREFIX)]
    inner = [e for e in holding if not e.name().startswith(PREFIX)]
    label = st[-1].name()[len(PREFIX):] if st else "outside any stage"
    if inner:
        label += ": " + max(inner, key=lambda e: e.start_ns()).name()[:120]
    return label
