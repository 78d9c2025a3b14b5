"""Progressive rendering: accumulation state, sample loop and resolve
(counterpart of caitlynrenderer_tpu/render/progressive.py).

The state is explicit — accumulation buffer, sample counter, base key — so
a render resumes exactly (convert.state_from_numpy reads the reference's
checkpoint fields).

`render_steps` is the reference's one-launch contract: `spp` samples for
one launch from the host, bit for bit `spp` `render_step` calls.  The
reference scans the samples inside one jitted launch; on the card they
are captured once into a CUDA graph (`accumulate`, with the frame
counter, the base key and the camera in the graph's static buffers on
the card) and replayed with one host call, under every accelerator.  On
CPU tensors the samples run as a loop.
"""

from __future__ import annotations

import time
from collections import Counter, OrderedDict
from typing import NamedTuple, Tuple

import torch

from caitlynrenderer_tpu_torch.core.camera import camera_tensors, copy_camera, has_lens
from caitlynrenderer_tpu_torch.core.types import Camera, RenderOptions
from caitlynrenderer_tpu_torch.ops import _build, shade
from caitlynrenderer_tpu_torch.render import sampling
from caitlynrenderer_tpu_torch.render.integrator import (check_supported, render_sample,
                                                          torch_families)
from caitlynrenderer_tpu_torch.scene import DeviceScene
from caitlynrenderer_tpu_torch.utils import metrics

# Graphs kept, the least recently used dropped first.  The graphs of a
# device share one memory pool, so together they hold about what the
# largest of them needs, not the sum.
MAX_GRAPHS = 8
# Graphs captured and replayed; a capture also runs one warm-up sample.
graph_counts = {"captures": 0, "replays": 0}
_graphs: "OrderedDict[tuple, SampleGraph]" = OrderedDict()
# device -> (the memory pool its graphs share, their capture stream): the
# caching allocator reuses a freed block only on the stream it was used
# on, so the graphs of a pool are captured on one stream.
_pools: dict = {}


class RenderState(NamedTuple):
    """accum:       (H*W, 3) f32 tensor — sum of per-sample radiance
    frame_count: int — samples accumulated so far
    base_key:    (k1, k2) uint32 values — per-sample keys are folded from
                 it, so a resumed render continues the same sample sequence
    """

    accum: torch.Tensor
    frame_count: int
    base_key: Tuple[int, int]


def init_state(width: int, height: int, seed: int, device) -> RenderState:
    return RenderState(
        accum=torch.zeros((width * height, 3), dtype=torch.float32, device=device),
        frame_count=0,
        base_key=sampling.prng_key(seed),
    )


def reset(state: RenderState) -> RenderState:
    """Camera moved: clear the accumulation."""
    return state._replace(accum=torch.zeros_like(state.accum), frame_count=0)


def render_pixels(ds: DeviceScene, camera: Camera, key, pixel_ids, width: int, height: int,
                  options: RenderOptions):
    """One sample (`key`, an int pair) of the global pixel ids `pixel_ids`
    ((N,) int32; ids past the image trace throwaway rays): (N, 3) radiance.
    A pixel's uniforms depend only on the key and its id, so any split of
    the pixels (tiles, shards) renders each the same."""
    with metrics.span("sample.uniforms"):
        uniforms = sampling.pixel_uniforms(key, pixel_ids, options.max_depth)
    return render_sample(ds, camera, uniforms, width, height, options, pixel_ids)


def render_step(ds: DeviceScene, camera: Camera, state: RenderState, width: int,
                height: int, options: RenderOptions) -> RenderState:
    """Add one sample per pixel to the accumulation."""
    with metrics.span("sample.keys"):
        key = sampling.sample_key(state.base_key, state.frame_count)
        pixel_ids = torch.arange(width * height, dtype=torch.int32, device=state.accum.device)
    radiance = render_pixels(ds, camera, key, pixel_ids, width, height, options)
    with metrics.span("sample.accumulate"):
        accum = state.accum + radiance
    return RenderState(accum, state.frame_count + 1, state.base_key)


def accumulate(ds: DeviceScene, camera: Camera, accum, frame, base_key, width: int,
               height: int, options: RenderOptions, spp: int, lens: bool):
    """The body a CUDA graph captures: `accum` plus `spp` samples, the
    first of them sample number `frame`.  Everything is a tensor on the
    accumulation's device: frame a 0-d int64, base_key a pair of 0-d int64
    words, camera from `camera_tensors` (lens: `has_lens` of the host's
    camera).  It reads nothing back to the host and copies nothing to the
    device, and adds the samples in render_step's order, so it returns
    what `spp` render_step calls accumulate, bit for bit."""
    dev = accum.device
    with metrics.span("sample.keys"):
        keys = sampling.sample_key(base_key,
                                   frame + torch.arange(spp, dtype=torch.int64, device=dev))
        ids = torch.arange(width * height, dtype=torch.int32, device=dev)
    for i in range(spp):
        with metrics.span("sample.uniforms"):
            uniforms = sampling.pixel_uniforms((keys[0][i], keys[1][i]), ids, options.max_depth)
        radiance = render_sample(ds, camera, uniforms, width, height, options, ids, lens)
        with metrics.span("sample.accumulate"):
            accum = accum + radiance
        # Freed before the next sample, as a temporary of the sum would be:
        # the graph's memory pool holds what is alive at its peak.
        del radiance
    return accum


class SampleGraph:
    """`spp` samples of one scene, size, options and lens captured as one
    CUDA graph on the accumulation's device, replayed by `run`.  Its
    static buffers (accumulation, frame counter, base key, camera) are
    written before each replay; it holds the scene, whose tensors it
    reads.

    warmup_s, capture_s, instantiate_s: host seconds of one warm-up sample
    of the same body on a side stream (it loads each kernel before
    capture, under the sync debug mode "error"; ended by synchronizing
    that stream), of the capture and of the graph's instantiation.  nodes:
    the graph's node count.  launches: the kernel launches one replay
    adds, {module: {counter key: n}}, counted from the graph's kernel
    nodes and held equal to the wrappers' own counts during capture.
    phases: the graph's phase map (utils/metrics), run-length encoded
    ([[phase, kernel name, n], ...], `metrics.expand` lists it), one entry
    per node that runs on the device in the order a replay runs them;
    None where the graph is not one chain of nodes.  phase_nodes: the
    graph's nodes by phase group, {group: n}, "none" for nodes outside
    every span.  fused_shading: whether the graph shades with kernel B6
    (render/integrator.fused_shading), read from its kernel nodes.
    torch_families: the shading families that keep a graph without B6 on
    the torch path (integrator.torch_families; empty where it has B6).
    Each capture logs a "graph_capture" record of them."""

    def __init__(self, ds: DeviceScene, camera: Camera, state: RenderState, width: int,
                 height: int, options: RenderOptions, spp: int, lens: bool):
        dev = self.device = state.accum.device
        self.ds, self.spp = ds, spp
        # Everything below runs with the scene's device current: a capture
        # records only the work of its stream's device, and work queued on
        # another device would run at once, outside the graph.
        with torch.no_grad(), torch.cuda.device(dev), metrics.span("capture"):
            self.accum = torch.empty_like(state.accum)
            self.frame = torch.zeros((), dtype=torch.int64, device=dev)
            self.key = (torch.zeros_like(self.frame), torch.zeros_like(self.frame))
            self.camera = camera_tensors(camera, dev)
            self._load(camera, state)
            body = (ds, self.camera, self.accum, self.frame, self.key, width, height, options)
            # The warm-up raises where the body would wait for the card,
            # which would break the capture.
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                with torch.cuda.stream(side):
                    accumulate(*body, 1, lens)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            side.synchronize()
            self.warmup_s = time.perf_counter() - t0
            torch.cuda.current_stream(dev).wait_stream(side)
            # keep_graph: the captured graph stays readable for its nodes.
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            if str(dev) not in _pools:
                _pools[str(dev)] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev))
            pool, stream = _pools[str(dev)]
            before = _build.launch_counts()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph, pool=pool, stream=stream), \
                        metrics.capture_phases(stream.cuda_stream) as marks:
                    self.out = accumulate(*body, spp, lens)
            finally:
                # The capture ran nothing: take its counts back.
                counted = _build.launch_counts()
                _build.set_launch_counts(before)
            self.capture_s = time.perf_counter() - t0
            nodes, phases = marks.node_phases(self.graph.raw_cuda_graph())
            self.nodes = len(nodes)
            self.launches = _build.count_kernels(name for _, kernel, name in nodes if kernel)
            wrappers = {m: {k: counted[m][k] - before[m][k] for k in row}
                        for m, row in counted.items()}
            if self.nodes == 0 or self.launches != wrappers:
                raise RuntimeError(
                    f"the CUDA graph of {spp} samples on {dev} holds {self.nodes} nodes and the "
                    f"kernel launches {self.launches}; the wrappers launched {wrappers}")
            t0 = time.perf_counter()
            self.graph.instantiate()
            self.instantiate_s = time.perf_counter() - t0
        self.fused_shading = sum(self.launches["shade"][k] for k in shade.BOUNCE_KEYS) > 0
        self.torch_families = [] if self.fused_shading else list(torch_families(options))
        self.phases = self.phase_nodes = None
        if phases is not None:
            self.phases = metrics.run_length((phase, name) for (_, _, name), phase
                                             in zip(nodes, phases) if name is not None)
            self.phase_nodes = dict(Counter(
                metrics.phase_group(phase) or "none" for phase in phases))
        graph_counts["captures"] += 1
        metrics.log_record("graph_capture", {
            "spp": spp, "width": width, "height": height, "accel": options.accel,
            "device": str(dev), "nodes": self.nodes, "launches": self.launches,
            "warmup_s": round(self.warmup_s, 6), "capture_s": round(self.capture_s, 6),
            "instantiate_s": round(self.instantiate_s, 6), "phase_nodes": self.phase_nodes,
            "fused_shading": self.fused_shading, "torch_families": self.torch_families})

    def _load(self, camera: Camera, state: RenderState) -> None:
        self.accum.copy_(state.accum)
        self.frame.fill_(state.frame_count)
        self.key[0].fill_(state.base_key[0])
        self.key[1].fill_(state.base_key[1])
        copy_camera(self.camera, camera)

    def run(self, camera: Camera, state: RenderState) -> RenderState:
        """One replay from `state` under the host camera `camera`; the
        returned accumulation is a tensor of its own (the graphs of a
        device share their pool, so another graph's replay may overwrite
        this one's output)."""
        with torch.cuda.device(self.device):
            with metrics.span("launch.load"):
                self._load(camera, state)
            with metrics.span("launch.replay"):
                self.graph.replay()
            with metrics.span("launch.clone"):
                accum = self.out.clone()
        _build.add_launches(self.launches)
        graph_counts["replays"] += 1
        return RenderState(accum, state.frame_count + self.spp, state.base_key)


def phase_maps() -> list:
    """The phase maps of the cached graphs, expanded ([(phase, kernel
    name), ...] each), for `metrics.profile_trace`."""
    return [metrics.expand(g.phases) for g in _graphs.values() if g.phases is not None]


def clear_graphs() -> None:
    """Drop every cached graph, and with them their memory pools."""
    _graphs.clear()
    _pools.clear()


def render_steps(ds: DeviceScene, camera: Camera, state: RenderState, width: int,
                 height: int, options: RenderOptions, spp: int) -> RenderState:
    """Accumulate `spp` samples in one launch from the host, bit for bit
    `spp` render_step calls.  On CUDA tensors with spp > 1: one replay of
    a CUDA graph of the `spp` samples, captured at the first call for this
    scene, size, options, spp, lens and device and cached (MAX_GRAPHS
    kept).  Otherwise a loop of render_step.  `camera` is the host's
    (numpy) camera."""
    dev = state.accum.device
    if dev.type != "cuda" or spp <= 1:
        for _ in range(spp):
            state = render_step(ds, camera, state, width, height, options)
        return state
    check_supported(ds, options)
    lens = has_lens(camera)
    key = (id(ds), width, height, options, spp, lens, str(dev))
    graph = _graphs.get(key)
    if graph is None:
        graph = SampleGraph(ds, camera, state, width, height, options, spp, lens)
        _graphs[key] = graph
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
    _graphs.move_to_end(key)
    return graph.run(camera, state)


def tonemap(rgb, limit: float = 2.0):
    """Luminance-limited Reinhard (lum = .3r + .6g + .1b), then gamma 1/2.2."""
    lum = 0.3 * rgb[..., 0] + 0.6 * rgb[..., 1] + 0.1 * rgb[..., 2]
    c = rgb / (1.0 + lum / limit)[..., None]
    return torch.clamp(c, 0.0, 1.0) ** (1.0 / 2.2)


def resolve(state: RenderState, width: int, height: int, options: RenderOptions):
    """Accumulation → display image (H, W, 3) in [0, 1], row 0 at the top.
    The beauty pass is tonemapped; an AOV is a data view and resolves
    linearly, clipped to [0, 1], "depth" first normalized by the frame's
    largest value."""
    with metrics.span("resolve"):
        inv = 1.0 / max(float(state.frame_count), 1.0)
        return display(state.accum * inv * options.hdr_multiplier, width, height, options)


def display(hdr, width: int, height: int, options: RenderOptions):
    """Mean radiance (H*W, 3), row-major from the bottom row → display
    image (H, W, 3), as `resolve` describes."""
    if options.aov == "depth":
        img = torch.clamp(hdr / torch.clamp(hdr.max(), min=1e-8), 0.0, 1.0)
    elif options.aov != "beauty":
        img = torch.clamp(hdr, 0.0, 1.0)
    else:
        img = tonemap(hdr, options.tonemap_limit)
    return img.reshape(height, width, 3).flip(0)


def render_image(ds: DeviceScene, camera: Camera, options: RenderOptions, spp: int = 16,
                 seed: int = 0, spp_per_launch: int = 8):
    """Accumulate `spp` samples on the scene's device and resolve, as the
    reference does: `spp_per_launch` samples per render_steps launch, the
    remainder one render_step each.  Returns (image, state)."""
    w, h = options.width, options.height
    state = init_state(w, h, seed, ds.device)
    chunk = max(1, min(spp_per_launch, spp))
    for _ in range(spp // chunk):
        state = render_steps(ds, camera, state, w, h, options, chunk)
    for _ in range(spp % chunk):
        state = render_step(ds, camera, state, w, h, options)
    return resolve(state, w, h, options), state
