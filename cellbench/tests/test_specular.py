"""The mirror-and-glass configuration's own files: it is the published
one; `tracer` and `disney` refuse its scene and the specular reference
refuses what it does not trace; and at a tiny size on the CPU the
specular reference renders what the program renders.  That the frozen
scene's box is the program's built-in box, and the reference's lobes the
program's, are held by tests/test_torch_specular_reference.py (a test
here may not import the program)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from cellbench import manifest
from cellbench.reference import disney, specular, tracer
from cellbench.scenes import builtin
from cellbench.tests.conftest import run_on_cpu, tiny_bench

BENCH = manifest.load()
CELL = "cornell_specular700.offline"
SPEC = {"generator": "cornell_specular"}


def test_configuration_is_the_published_one():
    assert manifest.validate(BENCH) == []
    cfg = manifest.config(BENCH, "cornell_specular700")
    assert cfg["scene"] == dict(SPEC, args={}) and cfg["reference"] == "specular"
    assert (cfg["width"], cfg["height"], cfg["max_depth"], cfg["image_spp"]) == (700, 700, 8, 1024)
    assert cfg["accel"] == "auto" and cfg["precision"] == "float32" and cfg["reduced"] == []
    assert cfg["camera"] == manifest.config(BENCH, "cornell700")["camera"]
    assert cfg["check"]["pixels"] == 4096
    assert manifest.reference(cfg).trace.__module__ == manifest.by_file(
        "reference", "specular", "plain reference").trace.__module__
    assert manifest.workload(BENCH, CELL)["chips"] == 1
    # Kernel B6 shades the cell: its phase group is `shade`, and the plain
    # step's groups (`hit`, `nee`, `bounce`, `bsdf`, `specular`) have no reader.
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert CELL in layer["shade_ms_per_sample"]["workloads"]
    assert not {f"{g}_ms_per_sample" for g in ("hit", "nee", "bounce", "bsdf", "specular")} \
        & set(layer)


def test_lambert_and_disney_references_refuse_the_scene():
    sc = builtin.make_scene(SPEC)
    with pytest.raises(ValueError, match="Lambert"):
        tracer.load_scene(sc, "cpu")
    with pytest.raises(ValueError, match="Disney"):
        disney.load_scene(sc, "cpu")
    ref = specular.load_scene(sc, "cpu")
    assert int(ref.mirror.sum()) == int(ref.glass.sum()) == 3968
    assert int(ref.smooth.sum()) == 2 * 3968 and not bool(ref.smooth[:12].any())


def _altered(kind):
    sc = builtin.make_scene(SPEC)
    if kind == "texture":
        sc["materials"]["tex_ind"][4, 0] = 0
    else:
        sc["materials"]["albedo"][4, 3] = kind
    return sc


# The Disney BRDF (17), and every type of disney.REFUSED but mirror and glass.
@pytest.mark.parametrize("kind", [17, 3, 4, 5, 6, 13, 14, "texture"])
def test_specular_reference_refuses_what_it_does_not_trace(kind):
    with pytest.raises(ValueError):
        specular.load_scene(_altered(kind), "cpu")


@pytest.mark.parametrize("traced", [False, True])
def test_specular_reference_renders_what_the_program_renders(tmp_path, traced):
    bench = tiny_bench(tmp_path, image_spp=24)
    # 8 bounces through the binary BVH's CPU walk: 10x8 pixels.
    path = tmp_path / "cornell_specular700.json"
    cfg = manifest.config(bench, "cornell_specular700")
    cfg.update(width=10, height=8)
    cfg["check"]["pixels"] = 80
    path.write_text(json.dumps(cfg))
    result, _ = run_on_cpu(bench, CELL, seconds=0.2, traced=traced)
    assert result["correct"]
    assert result["checked"] and all(v["value"] == 0.0 for v in result["checked"].values())
    assert np.isfinite([v["value"] for v in result["checked"].values()]).all()
