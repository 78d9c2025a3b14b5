"""The Disney-floor configuration's own files: `tracer` refuses its scene
and the Disney reference refuses what it does not trace; the
configuration is the published one; and at a tiny size on the CPU the
Disney reference renders what the program renders, bit for bit.  That the
frozen scene is the program's built-in box with a Disney floor, bit for
bit, is held by tests/test_torch_disney_reference.py (a test here may not
import the program)."""

from __future__ import annotations

import numpy as np
import pytest

from cellbench import manifest
from cellbench.reference import disney, tracer
from cellbench.scenes import builtin
from cellbench.tests.conftest import run_on_cpu, tiny_bench

BENCH = manifest.load()
CELL = "cornell_disney700.offline"
SPEC = {"generator": "cornell_disney"}


def test_configuration_is_the_published_one():
    assert manifest.validate(BENCH) == []
    cfg = manifest.config(BENCH, "cornell_disney700")
    assert cfg["scene"] == dict(SPEC, args={}) and cfg["reference"] == "disney"
    assert (cfg["width"], cfg["height"], cfg["max_depth"], cfg["image_spp"]) == (700, 700, 4, 1024)
    assert cfg["accel"] == "auto" and cfg["precision"] == "float32" and cfg["reduced"] == []
    assert manifest.reference(cfg).trace.__module__ == manifest.by_file(
        "reference", "disney", "plain reference").trace.__module__
    assert manifest.workload(BENCH, CELL)["chips"] == 1


def _altered(kind):
    sc = builtin.make_scene(SPEC)
    if kind == "mirror":
        sc["materials"]["albedo"][0, 3] = 1
    elif kind == "glass":
        sc["materials"]["albedo"][0, 3] = 2
    elif kind == "texture":
        sc["materials"]["tex_ind"][0, 0] = 0
    elif kind == "normals":
        sc["tri_vn"][0, 3] = 1
    return sc


@pytest.mark.parametrize("kind", ["mirror", "glass", "texture", "normals"])
def test_disney_reference_refuses_what_it_does_not_trace(kind):
    with pytest.raises(ValueError):
        disney.load_scene(_altered(kind), "cpu")


def test_lambert_tracer_still_refuses_the_disney_scene():
    with pytest.raises(ValueError, match="Lambert"):
        tracer.load_scene(builtin.make_scene(SPEC), "cpu")
    ref = disney.load_scene(builtin.make_scene(SPEC), "cpu")
    assert ref.disney.tolist() == [True, True] + [False] * 34


@pytest.mark.parametrize("traced", [False, True])
def test_disney_reference_renders_what_the_program_renders(tmp_path, traced):
    result, _ = run_on_cpu(tiny_bench(tmp_path, image_spp=24), CELL, seconds=0.2, traced=traced)
    assert result["correct"]
    assert result["checked"] and all(v["value"] == 0.0 for v in result["checked"].values())
    assert np.isfinite([v["value"] for v in result["checked"].values()]).all()
