"""What a configuration may bring as new files: its own plain reference
(cellbench/reference/<name>.py, named by the file's "reference") and its
own scene generator (cellbench/scenes/<generator>.py), each found by
file; and what a per-layer reader may read of the program: its phase
groups (`Context.phase_ms`) and its records by kind (`Context.record`)."""

from __future__ import annotations

import json
import logging
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from cellbench import check, control, drive, manifest, program, trace
from cellbench.scenes import builtin
from cellbench.tests.conftest import SEED, run_on_cpu, tiny_bench

# A reference that re-exports tracer's functions and notes each call, and
# a generator that makes the built-in box and notes its arguments, in the
# recorder module the fixture below puts in place.
PROBE_REFERENCE = '''
import cellbench_probe
from cellbench.reference import tracer


def _noted(name):
    def call(*args, **kwargs):
        cellbench_probe.calls.append(name)
        return getattr(tracer, name)(*args, **kwargs)
    return call


load_scene, camera_rays, trace, accumulate, display = map(
    _noted, ("load_scene", "camera_rays", "trace", "accumulate", "display"))
refuse_camera = tracer.refuse_camera
'''
PROBE_SCENE = '''
import cellbench_probe
from cellbench.scenes import builtin


def make(**args):
    cellbench_probe.calls.append(("make",) + tuple(sorted(args.items())))
    return builtin.cornell_box()
'''


MADE = ("make", ("size", 5.56))


def _with_reference(bench, tmp_path, config, reference):
    """A copy of configuration `config`'s file whose "reference" is
    `reference` (left out where None), put in `bench` in its place."""
    entry = next(c for c in bench["configs"] if c["name"] == config)
    cfg = manifest.config(bench, config)
    cfg.pop("reference", None)
    if reference is not None:
        cfg["reference"] = reference
    path = tmp_path / f"{config}.{reference}.json"
    path.write_text(json.dumps(cfg))
    entry["file"] = str(path)
    return cfg


def _queries(bench, cell):
    run = drive.Run(bench, cell, SEED, 0.1, True, "cpu", 0.0)
    ref, record = run.sample_queries()
    return ref.geo.tris9, record


@pytest.mark.parametrize("config", ["cornell700", "grid1m"])
def test_no_reference_key_is_tracer(tmp_path, config):
    numbers, queries = [], []
    for reference in (None, "tracer"):
        bench = tiny_bench(tmp_path)
        cfg = _with_reference(bench, tmp_path, config, reference)
        sc = builtin.make_scene(cfg["scene"])
        cam = builtin.make_camera(**cfg["camera"])
        ref = check.Reference(cfg, sc, cam, SEED, "cpu")
        answers = {"accum": (0, 3, ref.accum(0, 3) * 1.001)}
        numbers.append((check.compare(ref, answers),
                        control.control_numbers(cfg, SEED, 3, 3, "cpu", torch.bfloat16)))
        queries.append(_queries(bench, f"{config}.offline"))
    assert numbers[0] == numbers[1] and numbers[0][0]["accum_rel_l1"] > 0
    (tris_a, rec_a), (tris_b, rec_b) = queries
    assert torch.equal(tris_a, tris_b) and len(rec_a) == len(rec_b) > 0
    for qa, qb in zip(rec_a, rec_b):
        assert qa[0] == qb[0] and all(torch.equal(x, y) for x, y in zip(qa[1:], qb[1:]))


@pytest.fixture
def probe(tmp_path, monkeypatch):
    """A copy of the benchmark's folders under tmp_path with the probe
    reference and generator added as new files, the lookup pointed at it,
    and a configuration `probe` (the cornell box at a tiny size) and cell
    `probe.offline` naming both; yields (bench, the calls noted)."""
    calls = []
    monkeypatch.setitem(sys.modules, "cellbench_probe", types.SimpleNamespace(calls=calls))
    here = tmp_path / "cellbench"
    for folder in ("reference", "scenes", "traffic", "metrics"):
        shutil.copytree(f"{manifest.HERE}/{folder}", here / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (here / "reference" / "probe.py").write_text(PROBE_REFERENCE)
    (here / "scenes" / "probe_box.py").write_text(PROBE_SCENE)
    monkeypatch.setattr(manifest, "HERE", str(here))
    bench = tiny_bench(tmp_path, image_spp=24)
    cfg = dict(manifest.config(bench, "cornell700"), name="probe", reference="probe",
               scene={"generator": "probe_box", "args": {"size": 5.56}})
    (tmp_path / "probe.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="probe",
                                 file=str(tmp_path / "probe.json")))
    bench["workloads"].append(dict(bench["workloads"][0], name="probe.offline", config="probe"))
    for m in bench["per_layer"]:
        m["workloads"].append("probe.offline")
    assert manifest.validate(bench) == []
    yield bench, calls


def test_modules_found_by_file_are_the_ones_called(probe):
    bench, calls = probe
    cfg = manifest.config(bench, "probe")
    sc = builtin.make_scene(cfg["scene"])
    assert calls == [MADE]
    for k, v in builtin.cornell_box().items():
        assert all(np.array_equal(v[f], sc[k][f]) for f in v) if isinstance(v, dict) \
            else np.array_equal(v, sc[k])

    calls.clear()
    values = control.control_numbers(cfg, SEED, 4, 4, "cpu", torch.bfloat16)
    assert values["accum_rel_l1"] > 0
    assert calls.count("load_scene") == 2 and {"accumulate", "display"} <= set(calls)

    calls.clear()
    ref, record = _queries(bench, "probe.offline")
    assert calls[:1] == [MADE]
    assert calls[1:] == ["load_scene", "camera_rays", "trace"] and record

    # A whole run through the probe: the check's reference is the probe's,
    # and it reads the program's output exact, as cornell700.offline does.
    calls.clear()
    result, _ = run_on_cpu(bench, "probe.offline", seconds=0.2)
    assert MADE in calls and {"load_scene", "accumulate"} <= set(calls)
    assert result["correct"] and result["checked"]
    assert all(v["value"] == 0.0 for v in result["checked"].values())


def test_unknown_names_fail_naming_the_file(bench):
    cfg = manifest.config(bench, "cornell700")
    with pytest.raises(FileNotFoundError, match=r"reference/no_such\.py"):
        manifest.reference(dict(cfg, reference="no_such"))
    sc = builtin.make_scene(cfg["scene"])
    cam = builtin.make_camera(**cfg["camera"])
    with pytest.raises(FileNotFoundError, match=r"reference/no_such\.py"):
        check.Reference(dict(cfg, reference="no_such"), sc, cam, SEED, "cpu")
    with pytest.raises(FileNotFoundError, match=r"scenes/no_such\.py"):
        builtin.make_scene({"generator": "no_such"})
    with pytest.raises(FileNotFoundError, match=r"metrics/no_such\.py"):
        manifest.reader("no_such")


@pytest.mark.parametrize("what,match", [
    ("disney", "Lambert"), ("env_map", "environment map"), ("atlas", "untextured"),
    ("texture", "untextured"), ("lens", "pinhole")])
def test_tracer_refuses_what_it_does_not_trace(bench, what, match):
    """A configuration with a Disney floor, an environment map, a texture
    or a thin lens that names no reference is refused where its reference
    is built, rather than be compared against Lambert physics that drops
    part of its light or its lens."""
    cfg = manifest.config(bench, "cornell700")
    sc = builtin.make_scene(cfg["scene"])
    cam = builtin.make_camera(**cfg["camera"], aperture=0.1 if what == "lens" else 0.0)
    if what == "disney":
        sc["materials"]["albedo"][0, 3] = 17  # the program's Disney material type
    elif what == "env_map":
        sc["env_map"] = np.full((2, 4, 3), 0.5, np.float32)
    elif what == "atlas":
        sc["textures"] = np.full((1, 2, 2, 3), 0.5, np.float32)
    elif what == "texture":
        sc["materials"]["tex_ind"][0, 0] = 0
    with pytest.raises(ValueError, match=match):
        check.Reference(cfg, sc, cam, SEED, "cpu")


def test_a_generator_may_bring_an_atlas_and_an_environment(tmp_path, monkeypatch):
    """A generator's `textures` and `env_map` pass `make_scene` as they are;
    a textured floor's triangles index the scene's texture coordinates."""
    (tmp_path / "scenes").mkdir()
    (tmp_path / "scenes" / "sky_box.py").write_text(
        "import numpy as np\n"
        "from cellbench.scenes import builtin\n\n\n"
        "def make(layers):\n"
        "    sc = builtin.cornell_box()\n"
        "    sc['textures'] = np.full((layers, 4, 4, 3), 0.25, np.float32)\n"
        "    sc['env_map'] = np.full((8, 16, 3), 2.0, np.float32)\n"
        "    sc['materials']['tex_ind'][0, 0] = layers - 1\n"
        "    sc['texcoords'] = np.array([[0, 0], [1, 0], [1, 1]], np.float32)\n"
        "    sc['tri_vt'][sc['tri_v'][:, 3] == 0, :3] = [0, 1, 2]\n"
        "    return sc\n")
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    sc = builtin.make_scene({"generator": "sky_box", "args": {"layers": 2}})
    assert sc["textures"].shape == (2, 4, 4, 3) and (sc["textures"] == 0.25).all()
    assert sc["env_map"].shape == (8, 16, 3) and (sc["env_map"] == 2.0).all()
    assert builtin.layout_problems(sc) == []
    arrays = program.scene_arrays(sc)
    assert np.array_equal(arrays.textures, sc["textures"])
    assert np.array_equal(arrays.env_map, sc["env_map"])


def test_a_generator_is_held_to_the_layout(tmp_path, monkeypatch):
    (tmp_path / "scenes").mkdir()
    (tmp_path / "scenes" / "short.py").write_text(
        "from cellbench.scenes import builtin\n\n\n"
        "def make():\n"
        "    sc = builtin.cornell_box()\n"
        "    sc['tri_vn'] = sc['tri_vn'][:3]\n"
        "    del sc['lights']['e']\n"
        "    return sc\n")
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    with pytest.raises(ValueError, match="lights fields"):
        builtin.make_scene({"generator": "short"})
    for sc in (builtin.cornell_box(), builtin.displaced_grid(12)):
        assert builtin.layout_problems(sc) == []
    sc = builtin.cornell_box()
    sc["tri_vn"] = sc["tri_vn"][:3]
    sc["materials"]["disney"] = sc["materials"]["disney"].astype(np.float64)
    assert builtin.layout_problems(sc) == ["materials.disney is not an array of 4 float32 columns",
                                           "triangles of unequal rows [3, 36]"]


# -- the program's phases and records --------------------------------------------


def _op(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# A traced launch: eager buffer writes in launch.load, one cudaGraphLaunch
# of four kernels (a map of four phases), an eager add in no span.
EVENTS = [
    _op("cpu_op", "caitlyn.launch.load", 0, 9, None),
    _op("cuda_runtime", "cudaMemcpyAsync", 1, 1, 1),
    _op("cpu_op", "caitlyn.launch.replay", 10, 10, None),
    _op("cuda_runtime", "cudaGraphLaunch", 11, 5, 2),
    _op("cuda_runtime", "cudaLaunchKernel", 40, 1, 3),
    _op("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2, 4, 1),
    _op("kernel", "void threefry_pixel_kernel(long long const*)", 20, 50, 2),
    _op("kernel", "void mt_brute_kernel<false, 1>()", 80, 250, 2),
    _op("kernel", "void shade_bounce_kernel(ShadeArgs)", 340, 120, 2),
    _op("kernel", "void mt_brute_kernel<true, 1>()", 470, 30, 2),
    _op("kernel", "void vectorized_elementwise_kernel<4, add>()", 510, 6, 3),
]
TABLE = {"raygen": {"copy": 0.004, "b5": 0.05}, "query": {"b1": 0.28}, "shade": {"other": 0.12},
         None: {"other": 0.006}}
MAP = [("sample.uniforms", "_Z21threefry_pixel_kernelPx"), ("b0.closest", "_Z15mt_brute_kernelILb0E"),
       ("b0.shade", "_Z18shade_bounce_kernel8ShadeArgs"), ("b0.anyhit", "_Z15mt_brute_kernelILb1E")]


def test_phase_groups_are_the_programs_attribution(monkeypatch):
    monkeypatch.setattr(program.progressive, "phase_maps", lambda: [MAP])
    table = trace.phase_ms(program.phase_groups(EVENTS))
    assert set(table) == set(TABLE)
    for group, row in TABLE.items():
        assert table[group] == pytest.approx(row)
    # Without the launch's map its kernels are placed nowhere, never guessed.
    monkeypatch.setattr(program.progressive, "phase_maps", lambda: [MAP[:3]])
    assert set(trace.phase_ms(program.phase_groups(EVENTS))) == {"raygen", None}


def _context(phase_table=None, samples=2, records=()):
    log = program.CaptureLog()
    with log:
        for kind, rec in records:
            logging.getLogger(program.LOGGER).info("%s %s", kind, json.dumps(rec))
        logging.getLogger(program.LOGGER).info("a line that is no record")
    summary = None
    if phase_table is not None:
        summary = {"stage_ms": {"render": {"b1": 0.56, "other": 0.2}}, "phase_ms": phase_table}
    run = types.SimpleNamespace(cfg={}, mix={}, spans={}, captures=log, trace=summary,
                                samples_traced=samples)
    return drive.Context(run)


def test_context_phase_ms_by_group_and_class():
    ctx = _context(TABLE)
    assert ctx.phase_ms("raygen") == pytest.approx(0.027)
    assert ctx.phase_ms("raygen", "b5") == pytest.approx(0.025)
    assert ctx.phase_ms("query", "b1", "other") == pytest.approx(0.14)
    assert ctx.phase_ms(None) == pytest.approx(0.003)
    assert ctx.phase_ms("hit") is None and ctx.phase_ms("query", "other") is None
    assert ctx.trace_ms("render", "b1") == pytest.approx(0.28)
    # On the CPU, or without a trace, nothing to read.
    assert _context(None).phase_ms("raygen") is None
    assert _context({"raygen": {"b5": 1.0}}, samples=0).phase_ms("raygen") is None


def test_context_record_by_kind():
    ctx = _context(records=[("upload", {"copy_s": 0.1}), ("graph_capture", {"nodes": 80}),
                            ("upload", {"copy_s": 0.2}), ("graph_capture", {"nodes": 90})])
    assert ctx.record("upload") == {"copy_s": 0.2}
    assert ctx.record("graph_capture") == {"nodes": 90}
    assert ctx.records == [{"nodes": 80}, {"nodes": 90}]
    assert ctx.record("rays") is None
    assert _context().records == [] and _context().record("upload") is None


@pytest.mark.cuda
def test_phase_groups_add_up_to_the_render_stage(card):
    """On the card, in one traced segment of cornell700.offline, the
    three phase metrics cover the render stage's device time a sample,
    the groups hold every device operation the stages hold, and the
    operations no phase places are a small part of it."""
    bench = manifest.load()
    run = drive.Run(bench, "cornell700.offline", SEED, 1.0, True, card, 0.0)
    run.setup()
    run.window()
    run.traced_segment()
    ctx = drive.Context(run)
    parts = [manifest.reader(f"{g}_ms_per_sample")(ctx) for g in ("raygen", "query", "shade")]
    stages, groups = run.trace["stage_ms"], run.trace["phase_ms"]
    render = ctx.trace_ms("render", *stages["render"])
    unplaced = ctx.phase_ms(None) or 0.0
    run.r.release()
    assert all(p and p > 0 for p in parts)
    assert sum(parts) >= 0.98 * render
    assert sum(sum(row.values()) for row in groups.values()) == pytest.approx(
        sum(sum(row.values()) for row in stages.values()), rel=0.01)
    assert unplaced <= 0.02 * render
