"""The port's phase spans (utils/metrics.span) on the CPU: silent with no
profiler, host events under torch.profiler; every aten op of an eager
sample inside a named phase, each bounce's phases carrying its index, and
the radiance unchanged by the profiler; the phase map of a CUDA-graph
capture, emulated here with one node per dispatched op; `attribute` on
synthetic Chrome-trace events (a graph launch's operations by position,
eager ones by the innermost span, nothing on a mismatch); the Disney
BRDF's `bsdf` span and the mirror and glass lanes' `specular` span (no
node added, no phase on a Lambert scene), the live Disney and specular
lanes `trace_paths` counts and the families `torch_families` names; the "upload" record of `upload_scene`; and `cli render --profile`
with its "scene", "rays" and "profile" records.  The graph itself runs on the card:
tests/test_torch_cuda_phases.py."""

import json
import logging
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu_torch import cli
from caitlynrenderer_tpu_torch.cli import render_setup
from caitlynrenderer_tpu_torch.core.camera import camera_tensors
from caitlynrenderer_tpu_torch.ops import _build
from caitlynrenderer_tpu_torch.render import progressive
from caitlynrenderer_tpu_torch.scene import UPLOAD_STEPS, upload_scene
from caitlynrenderer_tpu_torch.utils import config, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
DISNEY_TOML = os.path.join(ROOT, "scenes", "cornell_disney.toml")
W, H = 12, 10
BOUNCE_PHASES = ("rr", "closest", "hit", "nee", "anyhit", "bounce")


def _cornell(accel="brute", toml=TOML, **overrides):
    cfg = config.load_config(toml)
    scene, camera, options = render_setup(cfg, os.path.dirname(toml), width=W, height=H,
                                          accel=accel, **overrides)
    ds = upload_scene(scene, accel, "cpu")
    return ds, camera, options


def _profiled(fn):
    """fn() under torch.profiler (CPU): (its result, the kineto events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def test_span_records_nothing_without_a_profiler(monkeypatch):
    """With no profiler and no capture running a span opens no record:
    the shared null context, whatever the name."""
    opened = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *a, **k: opened.append(a))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: opened.append(a))
    assert not torch.autograd._profiler_enabled() and metrics._capture is None
    for name in ("raygen", "b3.nee", "launch.replay"):
        with metrics.span(name) as ctx:
            torch.ones(3).sum()
        assert ctx is None and metrics.span(name) is metrics._NULL
    assert opened == []


def test_span_under_the_profiler_is_a_caitlyn_event():
    """Under torch.profiler a span is a host event `caitlyn.<name>` that
    holds the ops of its block, nested as the spans are."""
    def block():
        with metrics.span("outer"):
            with metrics.span("inner"):
                return torch.ones(8) * 2

    _, events = _profiled(block)
    spans = {e.name(): e for e in events if e.name().startswith(metrics.PREFIX)}
    assert set(spans) == {"caitlyn.outer", "caitlyn.inner"}
    outer, inner = spans["caitlyn.outer"], spans["caitlyn.inner"]
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()
    mul = [e for e in events if e.name() == "aten::mul"]
    assert mul and all(inner.start_ns() <= e.start_ns() <= e.end_ns() <= inner.end_ns()
                       for e in mul)


@pytest.mark.parametrize("accel", ["brute", "bvh2", "wide"])
def test_eager_sample_ops_all_inside_named_phases(accel):
    """An eager cornell render_step under the profiler: every aten op lies
    inside a `caitlyn.` span; the spans are the sample's, raygen and each
    bounce's six phases and its shade span (which holds hit, nee and
    bounce) with its index; and the accumulation is the same, bit for bit,
    with the profiler and without."""
    ds, camera, options = _cornell(accel)
    state = progressive.init_state(W, H, 11, "cpu")
    want = progressive.render_step(ds, camera, state, W, H, options)
    got, events = _profiled(lambda: progressive.render_step(ds, camera, state, W, H, options))
    assert torch.equal(got.accum, want.accum)
    spans = [(e.start_ns(), e.end_ns()) for e in events if e.name().startswith(metrics.PREFIX)]
    names = {e.name()[len(metrics.PREFIX):] for e in events
             if e.name().startswith(metrics.PREFIX)}
    expected = {"sample.keys", "sample.uniforms", "sample.accumulate", "raygen"} | {
        f"b{b}.{p}" for b in range(options.max_depth) for p in (*BOUNCE_PHASES, "shade")}
    assert names == expected
    ops = [e for e in events if e.name().startswith("aten::")]
    assert len(ops) > 100
    outside = [e.name() for e in ops
               if not any(s <= e.start_ns() and e.end_ns() <= t for s, t in spans)]
    assert outside == []


def test_phase_groups():
    """Each phase's group: launch, sample and raygen phases are raygen; a
    bounce's queries are query; rr and bounce are bounce; B6's shade is
    shade; the Disney BRDF's bsdf is bsdf; the mirror and glass lanes'
    specular is specular; others stand alone."""
    group = metrics.phase_group
    assert [group(p) for p in ("launch.replay", "sample.keys", "raygen")] == ["raygen"] * 3
    assert [group(f"b{b}.{p}") for b, p in ((0, "closest"), (5, "anyhit"))] == ["query"] * 2
    assert [group(p) for p in ("b1.hit", "b2.nee", "b3.rr", "b12.bounce", "b2.shade",
                               "b2.bsdf", "b7.specular")] == [
        "hit", "nee", "bounce", "bounce", "shade", "bsdf", "specular"]
    assert "bsdf" in metrics.GROUPS and "specular" in metrics.GROUPS
    assert group("resolve") == "resolve" and group(None) is None


class _FakeCapture(TorchDispatchMode):
    """A stand-in for a CUDA-graph capture on the CPU: one chain node per
    dispatched op, its name the op's."""

    def __init__(self):
        super().__init__()
        self.nodes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.nodes.append((len(self.nodes) + 1, True, str(func)))
        return func(*args, **(kwargs or {}))

    def tail(self, stream):
        return self.nodes[-1][0] if self.nodes else 0


@pytest.mark.parametrize("accel", ["brute", "wide"])
def test_capture_phase_map_covers_every_node(monkeypatch, accel):
    """`progressive.accumulate` (the body a graph captures) under
    capture_phases, with one node an op: every node falls in a named
    phase, the map follows the nodes one for one, the queries' ops sit in
    the query group, the sampler's in raygen, and the run-length code
    expands back to the map."""
    ds, camera, options = _cornell(accel)
    fake = _FakeCapture()
    monkeypatch.setattr(_build, "capture_tail", fake.tail)
    monkeypatch.setattr(_build, "graph_nodes", lambda raw: (fake.nodes, True))
    accum = torch.zeros((W * H, 3))
    frame = torch.zeros((), dtype=torch.int64)
    key = (torch.zeros_like(frame), torch.ones_like(frame))
    body = (ds, camera_tensors(camera, "cpu"), accum, frame, key, W, H, options)
    with torch.no_grad(), fake, metrics.capture_phases(0) as marks:
        got = progressive.accumulate(*body, 2, False)
    assert metrics._capture is None
    nodes, phases = marks.node_phases(0)
    assert len(phases) == len(nodes) == len(fake.nodes) > 100
    assert None not in phases
    # CPU tensors shade with B6's plain twin, whose spans hold all its ops:
    # no "shade" group (B6's), and a Lambert scene no "bsdf" group (the
    # Disney BRDF), no "specular" group (mirror and glass), and without an
    # environment map or an atlas no "sky" and no "texture" group.
    groups = {metrics.phase_group(p) for p in phases}
    assert groups == set(metrics.GROUPS) - {"shade", "bsdf", "specular", "sky", "texture"}
    assert {p for p in phases if p.startswith("b")} >= {
        f"b{b}.{p}" for b in range(options.max_depth) for p in BOUNCE_PHASES}
    pairs = [(p, name) for (_, _, name), p in zip(nodes, phases)]
    assert metrics.expand(metrics.run_length(pairs)) == pairs
    # The sampler's ops are raygen's; the queries' twin ops are the query group's.
    assert all(metrics.phase_group(p) == "raygen" for p in phases[:3])
    want = progressive.accumulate(*body, 2, False)
    assert torch.equal(got, want)


def _fake_capture_of_accumulate(monkeypatch, ds, camera, options, marked):
    """The fake capture's nodes of `progressive.accumulate` (2 samples), and
    its phases where `marked` (under capture_phases), else None."""
    fake = _FakeCapture()
    monkeypatch.setattr(_build, "capture_tail", fake.tail)
    monkeypatch.setattr(_build, "graph_nodes", lambda raw: (fake.nodes, True))
    accum = torch.zeros((W * H, 3))
    frame = torch.zeros((), dtype=torch.int64)
    key = (torch.zeros_like(frame), torch.ones_like(frame))
    body = (ds, camera_tensors(camera, "cpu"), accum, frame, key, W, H, options)
    if not marked:
        with torch.no_grad(), fake:
            progressive.accumulate(*body, 2, False)
        return fake.nodes, None
    with torch.no_grad(), fake, metrics.capture_phases(0) as marks:
        progressive.accumulate(*body, 2, False)
    return marks.node_phases(0)


@pytest.mark.parametrize("floor", ["lambert", "disney"])
def test_bsdf_span_adds_no_node(monkeypatch, floor):
    """The Disney BRDF's span marks the graph and adds no node: a capture
    with the phase map has as many nodes as one without.  A Lambert scene
    has no bsdf phase; the Disney floor's has each bounce's, inside its
    hit, nee and bounce, and the bsdf group holds the BRDF's nodes."""
    ds, camera, options = _cornell(toml=TOML if floor == "lambert" else DISNEY_TOML)
    assert ("disney" in options.families) is (floor == "disney")
    plain, _ = _fake_capture_of_accumulate(monkeypatch, ds, camera, options, False)
    nodes, phases = _fake_capture_of_accumulate(monkeypatch, ds, camera, options, True)
    assert len(nodes) == len(plain) and None not in phases
    bsdf = {p for p in phases if metrics.phase_group(p) == "bsdf"}
    if floor == "lambert":
        assert bsdf == set()
    else:
        assert bsdf == {f"b{b}.bsdf" for b in range(options.max_depth)}
        share = sum(metrics.phase_group(p) == "bsdf" for p in phases) / len(phases)
        assert 0.2 < share < 0.8, share


@pytest.mark.parametrize("floor", ["lambert", "disney"])
def test_disney_per_bounce_counts_live_disney_lanes(floor):
    """`trace_paths`' disney_per_bounce: at bounce 0 the camera rays that hit
    the Disney floor (the box's first two triangles), found here by the
    plain brute-force query; at every bounce no more than the live lanes;
    0 on every bounce of a Lambert scene."""
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.ops.intersect import intersect_brute
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths

    ds, camera, options = _cornell(toml=TOML if floor == "lambert" else DISNEY_TOML)
    options = options._replace(width=48, height=40, max_depth=4)
    uni = sampling.draw_uniforms(sampling.prng_key(3), 48 * 40, options.max_depth, "cpu")
    o, d = generate_rays(camera, 48, 40, uni)
    _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
    dis, alive = stats["disney_per_bounce"], stats["alive_per_bounce"]
    assert dis.shape == alive.shape == (options.max_depth,)
    assert bool((dis <= alive).all())
    if floor == "lambert":
        assert dis.tolist() == [0] * options.max_depth
        return
    _, tri, _, _ = intersect_brute(o, d, ds.scene.vertices, ds.scene.tri_v)
    assert int(dis[0]) == int(((tri >= 0) & (tri <= 1)).sum()) > 0
    assert bool((dis[1:] > 0).all()) and bool((dis < alive).all())


def _floored(floor, accel="brute"):
    """`_cornell`'s box with its floor of family `floor` (the port's
    built-in box, `cornell_box(floor_type=...)`), options traced for the
    scene's families."""
    from caitlynrenderer_tpu_torch.core.types import MaterialType
    from caitlynrenderer_tpu_torch.io.builtin_scenes import cornell_box
    from caitlynrenderer_tpu_torch.scene import scene_families

    _, camera, options = _cornell(accel)
    ftype = {"lambert": MaterialType.DIFFUSE, "mirror": MaterialType.MIRROR,
             "glass": MaterialType.GLASS}[floor]
    scene = cornell_box(floor_type=int(ftype))[0]
    return (upload_scene(scene, accel, "cpu"), camera,
            options._replace(families=scene_families(scene)))


@pytest.mark.parametrize("floor", ["lambert", "mirror", "glass"])
def test_specular_span_adds_no_node(monkeypatch, floor):
    """The mirror and glass lanes' span marks the graph and adds no node:
    a capture with the phase map has as many nodes as one without.  It
    opens only where the families hold mirror or glass: a Lambert scene
    has no specular phase; a mirror or glass floor's has each bounce's,
    inside its hit and bounce, holding the masks and the delta lobes."""
    ds, camera, options = _floored(floor)
    assert options.families == (("lambert",) if floor == "lambert" else ("lambert", floor))
    plain, _ = _fake_capture_of_accumulate(monkeypatch, ds, camera, options, False)
    nodes, phases = _fake_capture_of_accumulate(monkeypatch, ds, camera, options, True)
    assert len(nodes) == len(plain) and None not in phases
    spec = {p for p in phases if metrics.phase_group(p) == "specular"}
    if floor == "lambert":
        assert spec == set()
        return
    assert spec == {f"b{b}.specular" for b in range(options.max_depth)}
    share = sum(p in spec for p in phases) / len(phases)
    # The glass's Fresnel and refraction take more ops than the mirror's
    # one reflection.
    assert (0.01 < share < 0.1) if floor == "mirror" else (0.1 < share < 0.4), share


@pytest.mark.parametrize("floor", ["lambert", "mirror", "glass"])
def test_specular_per_bounce_counts_live_specular_lanes(floor):
    """`trace_paths`' specular_per_bounce: at bounce 0 the camera rays that
    hit the mirror or glass floor (the box's first two triangles), found
    here by the plain brute-force query; at every bounce no more than the
    live lanes; 0 on every bounce of a Lambert scene, whose Disney count
    is 0 too."""
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.ops.intersect import intersect_brute
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths

    ds, camera, options = _floored(floor)
    options = options._replace(width=48, height=40, max_depth=4)
    uni = sampling.draw_uniforms(sampling.prng_key(5), 48 * 40, options.max_depth, "cpu")
    o, d = generate_rays(camera, 48, 40, uni)
    _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
    spec, alive = stats["specular_per_bounce"], stats["alive_per_bounce"]
    assert spec.shape == alive.shape == (options.max_depth,)
    assert bool((spec <= alive).all())
    assert stats["disney_per_bounce"].tolist() == [0] * options.max_depth
    if floor == "lambert":
        assert spec.tolist() == [0] * options.max_depth
        return
    _, tri, _, _ = intersect_brute(o, d, ds.scene.vertices, ds.scene.tri_v)
    assert int(spec[0]) == int(((tri >= 0) & (tri <= 1)).sum()) > 0
    assert bool((spec[1:] > 0).all()) and bool((spec < alive).all())


def test_torch_families_name_what_keeps_the_torch_path():
    """`integrator.torch_families`, which the graph_capture record carries
    beside fused_shading: the families kernel B6 does not shade, from the
    scene's own families (B6 shades Lambert, Disney, mirror and glass, so
    none of the four keeps the torch path)."""
    from caitlynrenderer_tpu_torch.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.render.integrator import torch_families

    _, _, lambert = _cornell()
    _, _, dis = _cornell(toml=DISNEY_TOML)
    assert torch_families(lambert) == ()
    assert torch_families(dis) == ()
    assert torch_families(RenderOptions()) == ()
    assert torch_families(RenderOptions(families=("lambert", "glass"))) == ()
    assert torch_families(RenderOptions(families=("lambert", "plastic"))) == ("plastic",)


def test_capture_phase_map_refuses_a_fork(monkeypatch):
    """A capture whose next node would follow several nodes (a fork) has
    no phase map."""
    fake = _FakeCapture()
    monkeypatch.setattr(_build, "capture_tail", lambda stream: None)
    monkeypatch.setattr(_build, "graph_nodes", lambda raw: (fake.nodes, True))
    with fake, metrics.capture_phases(0) as marks:
        with metrics.span("raygen"):
            torch.ones(3) + 1
    assert marks.node_phases(0)[1] is None


def _op(cat, name, ts, dur, corr, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 7,
            "args": {"correlation": corr, **args}}


def _events(graph_kernels):
    """A synthetic trace: spans launch.load (an eager fill), launch.replay
    (one cudaGraphLaunch of `graph_kernels`) and launch.clone (a memcpy)
    inside a render stage, and an eager add inside b0.nee inside b0.hit's
    sibling, outside the launch."""
    ev = [
        _op("user_annotation", "cellbench.render", 0, 100, None),
        _op("cpu_op", "caitlyn.launch.load", 1, 9, None),
        _op("cuda_runtime", "cudaLaunchKernel", 2, 1, 10),
        _op("cpu_op", "caitlyn.launch.replay", 10, 10, None),
        _op("cuda_runtime", "cudaGraphLaunch", 11, 5, 20),
        _op("cpu_op", "caitlyn.launch.clone", 20, 10, None),
        _op("cuda_runtime", "cudaMemcpyAsync", 21, 1, 30),
        _op("cpu_op", "caitlyn.b0.hit", 40, 5, None),
        _op("cpu_op", "caitlyn.b0.nee", 50, 20, None),
        _op("cpu_op", "caitlyn.b0.anyhit", 52, 3, None),
        _op("cuda_runtime", "cudaLaunchKernel", 60, 1, 40),
        _op("kernel", "fill_kernel", 3, 2, 10),
        _op("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 90, 1, 30),
        _op("kernel", "add_kernel", 95, 1, 40),
    ]
    ev += [_op("kernel", name, 30 + 2 * i, 1, 20) for i, name in reversed(
        list(enumerate(graph_kernels)))]
    return ev


MAP = [("raygen", "_Z21threefry_pixel_kernelPfi"), ("b0.closest", "_Z15mt_brute_kernelILb0E"),
       ("b0.hit", "_Z10mul_kernel"), ("b0.anyhit", "_Z15mt_brute_kernelILb1E"),
       ("b0.nee", "Memset")]
TRACED = ["void threefry_pixel_kernel(float*, int)", "void mt_brute_kernel<false, 1>()",
          "void elementwise_kernel<MulFunctor>", "void mt_brute_kernel<true, 1>()",
          "Memset (Device)"]


def test_attribute_graph_launch_by_position_and_eager_by_innermost_span():
    """A cudaGraphLaunch's operations take the map's phases in order of
    start (the trace lists them out of order); eager operations take the
    innermost span open at their host call; a mangled node name and the
    profiler's name of one kernel fall in one family."""
    got = metrics.attribute(_events(TRACED), [MAP[:2], MAP])
    phase = {e["name"]: p for e, p in got}
    assert phase == {"fill_kernel": "launch.load", "Memcpy DtoD (Device -> Device)":
                     "launch.clone", "add_kernel": "b0.nee", **dict(zip(TRACED, [
                         "raygen", "b0.closest", "b0.hit", "b0.anyhit", "b0.nee"]))}
    families = {e["name"]: metrics.kernel_family(e["name"]) for e, _ in got}
    assert [families[n] for n in TRACED] == [
        "threefry_pixel_kernel", "mt_brute_kernel", "other", "mt_brute_kernel", "copy"]


@pytest.mark.parametrize("traced", [TRACED[:-1], TRACED + ["void extra_kernel"],
                                    [TRACED[1], TRACED[0]] + TRACED[2:]],
                         ids=["fewer", "more", "swapped"])
def test_attribute_gives_no_phase_on_a_mismatch(traced):
    """A launch whose operations differ from every map in count or in
    kernel family at some position gets no phase at all; the eager
    operations keep theirs."""
    got = metrics.attribute(_events(traced), [MAP])
    phase = {e["name"]: p for e, p in got}
    assert all(phase[name] is None for name in traced)
    assert phase["fill_kernel"] == "launch.load" and phase["add_kernel"] == "b0.nee"


@pytest.mark.parametrize("accel", ["brute", "bvh2", "wide"])
def test_upload_record(caplog, accel):
    """upload_scene logs one "upload" record with its steps' seconds, the
    accel and the triangles: no tree and no pack under brute, no pack
    under bvh2, both under wide; no device start on the CPU."""
    cfg = config.load_config(TOML)
    scene, _, _ = render_setup(cfg, os.path.dirname(TOML))
    with caplog.at_level(logging.INFO, logger="caitlynrenderer_tpu_torch"):
        upload_scene(scene, accel, "cpu")
    msgs = [r.getMessage() for r in caplog.records if r.getMessage().startswith("upload ")]
    assert len(msgs) == 1
    rec = json.loads(msgs[0][len("upload "):])
    assert rec == metrics.last_records["upload"]
    assert set(rec) == {"accel", "triangles", *UPLOAD_STEPS}
    assert rec["accel"] == accel and rec["triangles"] == scene.num_triangles
    assert all(rec[k] >= 0 for k in UPLOAD_STEPS) and rec["copy_s"] > 0
    assert rec["device_init_s"] == 0
    if accel == "brute":
        assert rec["tree_s"] == rec["pack_s"] == rec["reorder_s"] == 0
    else:
        assert rec["tree_s"] > 0 and rec["reorder_s"] > 0
        assert (rec["pack_s"] > 0) == (accel == "wide")


def test_cli_render_profile_and_records(tmp_path, caplog):
    """`cli render --profile DIR --device cpu`: a Chrome trace with each
    bounce's spans beside the ops, a "profile" record; the "scene" record
    carries the upload's steps (no build_s); the "rays" record the live
    lanes and any-hit candidates of each bounce."""
    prof = tmp_path / "prof"
    with caplog.at_level(logging.INFO, logger="caitlynrenderer_tpu_torch"):
        rc = cli.main(["render", TOML, "--device", "cpu", "--width", "8", "--height", "6",
                       "--spp", "2", "--accel", "brute", "--profile", str(prof),
                       "-o", str(tmp_path / "c.png")])
    assert rc == 0
    recs = {}
    for r in caplog.records:
        kind, _, body = r.getMessage().partition(" ")
        recs.setdefault(kind, []).append(json.loads(body))
    scene, = recs["scene"]
    assert "build_s" not in scene and set(UPLOAD_STEPS) <= set(scene)
    assert {k: scene[k] for k in UPLOAD_STEPS} == {k: recs["upload"][0][k] for k in UPLOAD_STEPS}
    rays, = recs["rays"]
    assert rays["rays"] == 48 and len(rays["alive_per_bounce"]) == len(
        rays["anyhit_per_bounce"]) == 3
    assert rays["alive_per_bounce"][0] == 48
    assert rays["disney_per_bounce"] == rays["specular_per_bounce"] == [0, 0, 0]
    assert sum(rays["alive_per_bounce"]) == rays["rays_closest"]
    assert sum(rays["anyhit_per_bounce"]) == rays["rays_anyhit"]
    profile, = recs["profile"]
    assert profile["trace"] == str(prof / "trace.json")
    with open(prof / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    assert {f"caitlyn.b{b}.{p}" for b in range(3) for p in BOUNCE_PHASES} <= names
    assert "aten::mul" in names


def test_cli_refuses_profile_where_not_carried(tmp_path):
    """--profile with --turntable or --mesh raises, as the other options
    those paths do not carry."""
    with pytest.raises(ValueError, match="--turntable with --profile"):
        cli.main(["render", TOML, "--device", "cpu", "--width", "8", "--height", "6",
                  "--spp", "1", "--turntable", "2", "--profile", str(tmp_path),
                  "-o", str(tmp_path / "t.png")])
    with pytest.raises(ValueError, match="--mesh with --profile"):
        cli.main(["render", TOML, "--device", "cpu", "--mesh", "1x1", "--profile",
                  str(tmp_path), "-o", str(tmp_path / "m.png")])
