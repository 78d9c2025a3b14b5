"""CUDA tier of the phase spans: the phase map of a captured CUDA graph on
the card.  It covers every node that runs on the device, adds no node (a
capture of the same samples without it has as many), puts the traversal
kernels (B1, B2) in the query group and the sampler (B5) in raygen; and
in a traced replay the groups' kernels that are none of the traversal
kernels or B5 add up to the render stage's, as the benchmark's trace
reader counts them.  Both scenes are Lambert-only, so the card shades
them through kernel B6 (group shade; no node in hit, nee or bounce); each
test runs them again on the torch path (`fused_shading` patched false),
whose hit, nee and bounce groups the mirror, glass, textured and sky-lit
scenes still take.  The Disney-floor scene's graph is shaded by B6's
Disney instantiation, and on the torch path (patched) fills the bsdf
group; the benchmark's specular box (a mirror and a glass sphere) by its
delta instantiation, and on the torch path fills the specular group.

Marked `cuda`; every test skips (inside the fixture) when torch sees no
CUDA device: `python -m pytest tests/ -m cuda -q` on an NVIDIA card."""

import json
import os

import pytest
import torch

from caitlynrenderer_tpu_torch.cli import render_setup
from caitlynrenderer_tpu_torch.core.camera import camera_tensors
from caitlynrenderer_tpu_torch.io.builtin_scenes import displaced_grid
from caitlynrenderer_tpu_torch.core.types import RenderOptions, make_camera
from caitlynrenderer_tpu_torch.ops import _build
from caitlynrenderer_tpu_torch.render import integrator as integ
from caitlynrenderer_tpu_torch.render import progressive
from caitlynrenderer_tpu_torch.scene import required_stack, scene_families, upload_scene
from caitlynrenderer_tpu_torch.utils import config, metrics
from cellbench import trace

import test_torch_shade

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
DISNEY_TOML = os.path.join(ROOT, "scenes", "cornell_disney.toml")
SPP = 4
QUERY_KERNELS = {"mt_brute_kernel", "mega_kernel"}
# The groups a capture's nodes fall in, by shading path: B6 does the hit,
# nee and bounce groups' work, and rr issues nothing with roulette off;
# these Lambert scenes leave the Disney BRDF's group, bsdf, the mirror
# and glass lanes' group, specular, and the environment map's and the
# atlas's groups, sky and texture, empty.
SHADING_GROUPS = {"fused": {"raygen", "query", "shade"},
                  "torch": set(metrics.GROUPS) - {"shade", "bsdf", "specular", "sky",
                                                  "texture"}}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda", 0)


def _setup(accel, dev, shading, monkeypatch):
    if shading == "torch":
        monkeypatch.setattr(integ, "fused_shading", lambda *a, **k: False)
    if accel == "brute":
        cfg = config.load_config(TOML)
        scene, camera, options = render_setup(cfg, os.path.dirname(TOML), width=96, height=64,
                                              accel="brute")
    else:
        scene = displaced_grid(48)[0]
        camera = make_camera([5.0, 9.0, 11.0], [5.0, 2.0, 5.0], 50.0)
        options = RenderOptions(width=96, height=64, max_depth=4, accel=accel,
                                families=scene_families(scene))
    ds = upload_scene(scene, accel, dev)
    return ds, camera, options._replace(max_stack=required_stack(ds))


@pytest.mark.parametrize("shading", ["fused", "torch"])
@pytest.mark.parametrize("accel", ["brute", "wide"])
def test_graph_phase_map_covers_every_node_and_adds_none(dev, accel, shading, monkeypatch):
    progressive.clear_graphs()
    ds, camera, options = _setup(accel, dev, shading, monkeypatch)
    w, h = options.width, options.height
    state = progressive.init_state(w, h, 5, dev)
    progressive.render_steps(ds, camera, state, w, h, options, SPP)
    graph, = progressive._graphs.values()
    assert graph.phases is not None
    assert sum(graph.phase_nodes.values()) == graph.nodes and "none" not in graph.phase_nodes
    assert set(graph.phase_nodes) == SHADING_GROUPS[shading]
    assert graph.fused_shading is (shading == "fused")
    assert metrics.last_records["graph_capture"]["torch_families"] == []
    entries = metrics.expand(graph.phases)
    nodes, chain = _build.graph_nodes(graph.graph.raw_cuda_graph())
    assert chain and len(entries) == sum(name is not None for _, _, name in nodes)
    assert [name for _, name in entries] == [name for _, _, name in nodes if name is not None]
    for phase, name in entries:
        family = metrics.kernel_family(name)
        if family in QUERY_KERNELS:
            assert metrics.phase_group(phase) == "query", (phase, name)
        if family == "threefry_pixel_kernel":
            assert phase == "sample.uniforms"
        if family.startswith("shade_"):
            assert metrics.phase_group(phase) == "shade", (phase, name)
    assert sum(metrics.kernel_family(n) in QUERY_KERNELS for _, n in entries) == 2 * SPP * (
        options.max_depth)

    # The same samples captured without the phase map: as many nodes.
    plain = torch.cuda.CUDAGraph(keep_graph=True)
    accum = torch.zeros_like(state.accum)
    frame = torch.zeros((), dtype=torch.int64, device=dev)
    key = (torch.zeros_like(frame), torch.ones_like(frame))
    body = (ds, camera_tensors(camera, dev), accum, frame, key, w, h, options)
    before = _build.launch_counts()
    with torch.no_grad(), torch.cuda.graph(plain):
        progressive.accumulate(*body, SPP, False)
    _build.set_launch_counts(before)
    assert len(_build.graph_nodes(plain.raw_cuda_graph())[0]) == graph.nodes
    progressive.clear_graphs()


@pytest.mark.parametrize("shading", ["fused", "torch"])
@pytest.mark.parametrize("accel", ["brute", "wide"])
def test_traced_replay_groups_add_up_to_the_integrator(dev, accel, shading, monkeypatch,
                                                       tmp_path):
    progressive.clear_graphs()
    ds, camera, options = _setup(accel, dev, shading, monkeypatch)
    w, h = options.width, options.height
    state = progressive.init_state(w, h, 5, dev)
    state = progressive.render_steps(ds, camera, state, w, h, options, SPP)
    torch.cuda.synchronize(dev)
    launches = 3
    with trace.Segment() as seg:
        for _ in range(launches):
            with trace.stage("render"):
                state = progressive.render_steps(ds, camera, state, w, h, options, SPP)
        torch.cuda.synchronize(dev)
    integrator = seg.summary["stage_ms"]["render"]["other"]
    path = str(tmp_path / "trace.json")
    seg.prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    attributed = metrics.attribute(events, progressive.phase_maps())
    other = {}
    for e, phase in attributed:
        if trace.kernel_class(e["name"]) == "other":
            group = metrics.phase_group(phase)
            other[group] = other.get(group, 0.0) + e["dur"] / 1e3
    # Under brute force the queries are B1 alone: no other kernel.
    assert None not in other and set(other) >= SHADING_GROUPS[shading] - {"query"}
    assert set(other) <= SHADING_GROUPS[shading]
    assert sum(other.values()) == pytest.approx(integrator, rel=0.01)
    progressive.clear_graphs()


def _specular_box(dev):
    """The benchmark's cornell_specular700 scene and camera at 96x64 and
    its 8 bounces, under bvh2 (the cell's `auto`)."""
    scene, camera, options = test_torch_shade._specular_scene("bvh2", 96, 64)
    ds = upload_scene(scene, "bvh2", dev)
    return ds, camera, options._replace(max_stack=required_stack(ds))


def test_fused_specular_graph_shades_through_b6(dev, monkeypatch):
    """The specular box's graph (families lambert, mirror and glass): B6's
    delta instantiation shades it, so its record reads fused_shading and
    no torch family, its nodes lie in raygen, query and shade alone
    (max_depth + 1 B6 nodes a sample), its launches are max_depth x spp
    delta bounces and spp finishing adds, and its accumulation equals the
    torch path's graph of the same samples bit for bit, whose specular
    group holds nodes."""
    progressive.clear_graphs()
    ds, camera, options = _specular_box(dev)
    w, h = options.width, options.height
    state = progressive.init_state(w, h, 5, dev)
    got = progressive.render_steps(ds, camera, state, w, h, options, SPP)
    torch.cuda.synchronize(dev)
    graph, = progressive._graphs.values()
    rec = metrics.last_records["graph_capture"]
    assert graph.fused_shading and rec["fused_shading"] is True and rec["torch_families"] == []
    assert set(graph.phase_nodes) == {"raygen", "query", "shade"}
    want = dict.fromkeys(graph.launches["shade"], 0)
    want.update(bounce_delta=options.max_depth * SPP, finish=SPP)
    assert graph.launches["shade"] == want
    assert graph.phase_nodes["shade"] == (options.max_depth + 1) * SPP
    progressive.clear_graphs()
    with monkeypatch.context() as m:
        m.setattr(integ, "fused_shading", lambda *a, **k: False)
        torch_path = progressive.render_steps(ds, camera, state, w, h, options, SPP)
        graph, = progressive._graphs.values()
        assert not graph.fused_shading and graph.phase_nodes["specular"] > 0
    torch.cuda.synchronize(dev)
    assert float(got.accum.sum()) > 0 and torch.equal(got.accum, torch_path.accum)
    progressive.clear_graphs()


def _disney_box(dev):
    cfg = config.load_config(DISNEY_TOML)
    scene, camera, options = render_setup(cfg, os.path.dirname(DISNEY_TOML), width=96,
                                          height=64, accel="brute")
    return upload_scene(scene, "brute", dev), camera, options._replace(max_depth=4)


def test_disney_graph_names_its_families_and_its_bsdf_nodes(dev, monkeypatch):
    """The Disney-floor cornell at 4 bounces on the card, on the torch path
    (`fused_shading` patched false): its record reads no fused shading and
    no family B6 leaves to the torch path (B6 takes Disney: only the patch
    keeps it off), its bsdf group holds nodes (the span adds none: a
    capture without the phase map has as many) and it has no specular
    group (no mirror or glass), and its accumulation is finite and equals
    the same samples rendered eagerly, bit for bit."""
    progressive.clear_graphs()
    monkeypatch.setattr(integ, "fused_shading", lambda *a, **k: False)
    ds, camera, options = _disney_box(dev)
    w, h = options.width, options.height
    state = progressive.init_state(w, h, 5, dev)
    got = progressive.render_steps(ds, camera, state, w, h, options, SPP)
    eager = state
    for _ in range(SPP):
        eager = progressive.render_step(ds, camera, eager, w, h, options)
    torch.cuda.synchronize(dev)
    graph, = progressive._graphs.values()
    rec = metrics.last_records["graph_capture"]
    assert not graph.fused_shading and rec["torch_families"] == []
    assert set(graph.phase_nodes) == set(metrics.GROUPS) - {"shade", "specular", "sky",
                                                             "texture"}
    assert rec["phase_nodes"]["bsdf"] == graph.phase_nodes["bsdf"] > 0
    assert bool(torch.isfinite(got.accum).all()) and float(got.accum.sum()) > 0
    assert torch.equal(got.accum, eager.accum)
    plain = torch.cuda.CUDAGraph(keep_graph=True)
    frame = torch.zeros((), dtype=torch.int64, device=dev)
    key = (torch.zeros_like(frame), torch.ones_like(frame))
    body = (ds, camera_tensors(camera, dev), torch.zeros_like(state.accum), frame, key, w, h,
            options)
    before = _build.launch_counts()
    with torch.no_grad(), torch.cuda.graph(plain):
        progressive.accumulate(*body, SPP, False)
    _build.set_launch_counts(before)
    assert len(_build.graph_nodes(plain.raw_cuda_graph())[0]) == graph.nodes
    progressive.clear_graphs()


def test_fused_disney_graph_shades_through_b6(dev, monkeypatch):
    """The same Disney-floor graph without the patch: B6's Disney
    instantiation shades it, so its record reads fused_shading and no
    torch family, its nodes lie in raygen, query and shade alone, and its
    accumulation equals the torch path's graph of the same samples bit for
    bit."""
    progressive.clear_graphs()
    ds, camera, options = _disney_box(dev)
    w, h = options.width, options.height
    state = progressive.init_state(w, h, 5, dev)
    got = progressive.render_steps(ds, camera, state, w, h, options, SPP)
    torch.cuda.synchronize(dev)
    graph, = progressive._graphs.values()
    rec = metrics.last_records["graph_capture"]
    assert graph.fused_shading and rec["fused_shading"] is True and rec["torch_families"] == []
    assert set(graph.phase_nodes) == {"raygen", "query", "shade"}
    shade_launches = graph.launches["shade"]
    assert shade_launches["bounce_disney"] == options.max_depth * SPP > 0
    assert shade_launches["bounce"] == 0 and shade_launches["finish"] == SPP
    assert graph.phase_nodes["shade"] == (options.max_depth + 1) * SPP
    progressive.clear_graphs()
    with monkeypatch.context() as m:
        m.setattr(integ, "fused_shading", lambda *a, **k: False)
        want = progressive.render_steps(ds, camera, state, w, h, options, SPP)
    torch.cuda.synchronize(dev)
    assert float(got.accum.sum()) > 0 and torch.equal(got.accum, want.accum)
    progressive.clear_graphs()
