"""One run of one cell: set-up, warm-up, the measured window, the traced
segment, the output check and the result line.  One general driver for
every traffic mix; a mix is the data file of its parameters:

    spp_per_launch    samples added by one launch from the host
    in_flight         launches issued and not yet completed, at most: the
                      next launch is issued once the one `in_flight - 1`
                      before it has completed (1: a launch, then a wait)
    display_each      after every launch, resolve the display image and
                      copy it to host memory (a viewer showing each frame)

The loop is closed.  Every `image_spp` samples (the configuration's
samples per image) the image is resolved and copied to the host and the
accumulation restarts under the next image's key.
"""

from __future__ import annotations

import collections
import statistics
import time

import numpy as np
import torch

from cellbench import check, manifest, seeds, trace
from cellbench.program import CaptureLog, Renderer, phase_groups
from cellbench.reference import sampler
from cellbench.scenes import builtin

TRACE_SECONDS = 0.3  # length of the traced segment, at least one launch


class Context:
    """What a per-layer reader reads: `spans` (host-clock seconds and lists
    of them, by name), `records` (the program's graph_capture records) and
    `record(kind)`, `trace` (trace.summarize's dict of the traced segment,
    or None) through `trace_ms` and `phase_ms`, `samples_traced`, the
    cell's `cfg` and `mix`, and `sample_queries()`: the closest-hit and
    any-hit rays of one sample of every pixel, traced by the
    configuration's reference."""

    def __init__(self, run: "Run"):
        self.cfg, self.mix = run.cfg, run.mix
        self.spans, self.records = run.spans, run.captures.records
        self.trace, self.samples_traced = run.trace, run.samples_traced
        self._run = run

    def sample_queries(self):
        return self._run.sample_queries()

    def record(self, kind: str) -> dict | None:
        """The program's last record of kind `kind` (`upload`,
        `graph_capture`, ...) logged during set-up; None where none was."""
        recs = self._run.captures.by_kind.get(kind)
        return recs[-1] if recs else None

    def trace_ms(self, stage: str, *classes) -> float | None:
        """Device milliseconds a sample of the kernel classes `classes` in
        stage `stage` of the traced segment; None where none ran."""
        if not self.trace or not self.samples_traced:
            return None
        return self._per_sample(self.trace["stage_ms"].get(stage, {}), classes)

    def phase_ms(self, group: str | None, *classes) -> float | None:
        """Device milliseconds a sample of the kernel classes `classes`
        (every class where none are given) in the program's phase group
        `group` (utils/metrics.phase_group: raygen, query, hit, nee,
        bounce, shade, ...; None for what no phase places) over the
        traced segment; None where no such operation fell in it."""
        if not self.trace or not self.samples_traced or "phase_ms" not in self.trace:
            return None
        row = self.trace["phase_ms"].get(group, {})
        return self._per_sample(row, classes or tuple(row))

    def _per_sample(self, row: dict, classes) -> float | None:
        if not any(c in row for c in classes):
            return None
        return sum(row.get(c, 0.0) for c in classes) / self.samples_traced


class Run:
    def __init__(self, bench: dict, cell: str, seed: int, seconds: float, traced: bool, device,
                 t_start: float, renderer=Renderer):
        self.w = manifest.workload(bench, cell)
        self.bench, self.seed, self.seconds, self.traced = bench, seed, seconds, traced
        self.cfg = manifest.config(bench, self.w["config"])
        self.mix = manifest.traffic(self.w["traffic"])
        self.device = torch.device(device)
        self.t_start = t_start
        self.spans = {}
        self.captures = CaptureLog()
        self.trace = None
        self.samples_traced = 0
        self.image = 0
        self.shown = None  # (image, samples, host display image) last copied to the host
        self.pending = collections.deque()  # completion events of launches in flight
        self.sc = builtin.make_scene(self.cfg["scene"])
        self.cam = builtin.make_camera(**self.cfg["camera"])
        self.r = renderer(self.cfg, self.sc, self.cam, self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pending.clear()

    def wait(self):
        """Wait until fewer than `in_flight` launches are in flight."""
        if self.device.type != "cuda":
            return
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self.pending.append(done)
        while len(self.pending) >= self.mix["in_flight"]:
            self.pending.popleft().synchronize()

    # -- the loop -----------------------------------------------------------

    def step(self, display_ms=None, latency_ms=None):
        """One launch of the mix, then what follows it: the display copy
        when the mix shows every frame, and the image's end when it is
        complete.  Returns the samples added."""
        spp = self.mix["spp_per_launch"]
        t0 = time.perf_counter()
        with trace.stage("render"):
            self.r.launch(spp)
        if self.mix["display_each"]:
            t1 = time.perf_counter()
            with trace.stage("display"):
                img = self.r.display()
            t2 = time.perf_counter()
            self.shown = (self.image, self.r.frame_count, img)
            if display_ms is not None:
                display_ms.append((t2 - t1) * 1e3)
                latency_ms.append((t2 - t0) * 1e3)
        else:
            with trace.stage("sync"):
                self.wait()
        if self.r.frame_count >= self.cfg["image_spp"]:
            if not self.mix["display_each"]:
                with trace.stage("display"):
                    self.shown = (self.image, self.r.frame_count, self.r.display())
            with trace.stage("restart"):
                self.image += 1
                self.r.new_image(seeds.image_seed(self.seed, self.image))
        return spp

    def setup(self):
        with self.captures:
            t = time.perf_counter()
            self.r.upload()
            self.sync()
            self.spans["upload_s"] = time.perf_counter() - t
            # Warm-up: one launch of the window's size (which captures its
            # graph) and one display; then the window starts image 0 afresh.
            self.r.new_image(seeds.image_seed(self.seed, 0))
            self.r.launch(self.mix["spp_per_launch"])
            self.r.display()
            self.r.new_image(seeds.image_seed(self.seed, 0))
            self.sync()
        self.shown = None
        self.spans["setup_s"] = time.perf_counter() - self.t_start

    def window(self):
        display_ms, latency_ms = [], []
        samples = launches = 0
        t0 = time.perf_counter()
        while True:
            samples += self.step(display_ms, latency_ms)
            launches += 1
            if time.perf_counter() - t0 >= self.seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        self.spans.update(window_s=elapsed, samples=samples, launches=launches,
                          frame_ms=elapsed / samples * 1e3, display_ms=display_ms,
                          latency_ms=latency_ms)

    def traced_segment(self):
        samples = 0
        with trace.Segment(attribute=phase_groups) as seg:
            t0 = time.perf_counter()
            while not samples or time.perf_counter() - t0 < TRACE_SECONDS:
                samples += self.step()
            with trace.stage("sync"):
                self.sync()
        self.trace, self.samples_traced = seg.summary, samples

    # -- after the window -----------------------------------------------------

    def answers(self, pixels: np.ndarray) -> dict:
        out = {}
        if self.r.frame_count > 0:
            out["accum"] = (self.image, self.r.frame_count, self.r.accum_rows(pixels))
        if self.shown is not None:
            out["display"] = self.shown
        return out

    def sample_queries(self):
        """The rays of the queries of sample 0 of image 0, every pixel,
        as the configuration's reference traces them."""
        tracer = manifest.reference(self.cfg)
        ref = tracer.load_scene(self.sc, self.device)
        w, h, depth = self.cfg["width"], self.cfg["height"], self.cfg["max_depth"]
        ids = torch.arange(w * h, dtype=torch.int64, device=self.device)
        uni = sampler.uniforms(sampler.base_key(seeds.image_seed(self.seed, 0)),
                               torch.zeros(1, dtype=torch.int64, device=self.device), ids,
                               depth)[0]
        o, d = tracer.camera_rays(self.cam, w, h, ids, uni[:, 0:4], torch.float32)
        record = []
        tracer.trace(ref, o, d, uni, depth, record)
        return ref, record


def metric(value, unit):
    return {"value": value, "unit": unit}


def run_cell(bench: dict, cell: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, chips: int = 1, renderer=Renderer):
    """(result dict, [stderr lines]) of one run."""
    run = Run(bench, cell, seed, seconds, traced, device, t_start, renderer)
    run.setup()
    run.window()
    if traced:
        run.traced_segment()
    dev = run.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    pixels = seeds.check_pixels(seed, run.cfg["width"] * run.cfg["height"],
                                run.cfg["check"]["pixels"])
    answers = run.answers(pixels)
    run.r.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    metrics = {}
    if traced:
        ctx = Context(run)
        for m in manifest.cell_metrics(bench, cell, "per_layer"):
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = metric(value, m["unit"])

    t_ref = time.perf_counter()
    ref = check.Reference(run.cfg, run.sc, run.cam, seed, dev)
    values = check.compare(ref, answers)
    t_ref = time.perf_counter() - t_ref
    correct, rows = check.judge(values, run.cfg["check"]["limits"])
    if not traced:
        e2e = {"frame_ms": run.spans["frame_ms"], "setup_s": run.spans["setup_s"]}
        if run.spans["latency_ms"]:
            lat = run.spans["latency_ms"]
            e2e["display_ms_p95"] = (statistics.quantiles(lat, n=20, method="inclusive")[18]
                                     if len(lat) > 1 else lat[0])
        for m in manifest.cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = metric(e2e[m["name"]], m["unit"])
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name,
                   "count": chips, "memory_peak_bytes": int(peak)}
    if traced and run.trace:
        device_info.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    result = {"correct": correct, "attempted": run.spans["launches"],
              "failed": 0 if correct else run.spans["launches"],
              "metrics": metrics, "device": device_info}
    if traced and run.trace:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    info = [f"cell {cell} seed {seed}: {run.spans['launches']} launches, "
            f"{run.spans['samples']} samples in {run.spans['window_s']:.3f} s; "
            f"compared {len(pixels)} pixels: "
            + ", ".join(f"{k} image {a[0]} of {a[1]} samples" for k, a in answers.items())
            + f"; the reference took {t_ref:.3f} s"]
    if traced and run.trace and "phase_ms" in run.trace:
        n = run.samples_traced
        stages = {st: sum(row.values()) / n for st, row in run.trace["stage_ms"].items()}
        groups = {g: sum(row.values()) / n for g, row in run.trace["phase_ms"].items()}
        info.append(f"device ms a sample: render stage {stages.get('render', 0.0)!r} of all "
                    f"stages {sum(stages.values())!r}; by phase group "
                    + ", ".join(f"{g} {v!r}" for g, v in sorted(
                        (g, v) for g, v in groups.items() if g is not None))
                    + f"; in no phase group {groups.get(None, 0.0)!r}")
    info += [f"check {k} {v!r} limit {lim!r}" for k, v, lim in rows]
    return result, info
