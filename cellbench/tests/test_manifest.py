"""BENCHMARK.json against the benchmark's contract, and the discovery of
configurations, traffic mixes and per-layer readers by name."""

from __future__ import annotations

import copy
import json
import os

import pytest

from cellbench import manifest

BENCH = manifest.load()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_manifest_keeps_to_the_contract():
    assert manifest.validate(BENCH) == []
    assert BENCH["paths"] == ["cellbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_is_found_by_name(entry):
    cfg = manifest.config(BENCH, entry["name"])
    assert entry["file"].startswith("cellbench/configs/")
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    for key in ("scene", "camera", "width", "height", "max_depth", "accel", "image_spp",
                "precision", "check", "assumed"):
        assert key in cfg
    assert set(cfg["check"]["limits"]) <= {"accum_rel_l1", "accum_worst_pixel", "image_rel_l1"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_traffic_mix_is_found_by_name(cell):
    mix = manifest.traffic(cell["traffic"])
    assert set(mix) == {"spp_per_launch", "in_flight", "display_each"}
    assert manifest.workload(BENCH, cell["name"]) is cell


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_is_found_by_name(metric):
    assert callable(manifest.reader(metric["name"]))


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        manifest.reader("no_such_metric")
    with pytest.raises(KeyError):
        manifest.workload(BENCH, "no_such.cell")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_names_and_units_use_the_allowed_characters(metric):
    assert manifest.NAME.match(metric["name"])
    assert manifest.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")


def test_files_are_named_from_the_characters_of_a_name():
    for dirpath, _, files in os.walk(manifest.HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), manifest.ROOT)
            if "__pycache__" in rel:
                continue
            assert all(ch.isascii() and (ch.isalnum() or ch in "_.-/") for ch in rel), rel


def _broken(edit):
    bench = copy.deepcopy(BENCH)
    edit(bench)
    return manifest.validate(bench)


@pytest.mark.parametrize("edit", [
    lambda b: b["end_to_end"][0].update(name="frame ms"),
    lambda b: b["end_to_end"][0].update(unit="ms per frame"),
    lambda b: b["end_to_end"][0].update(bound=0.3),
    lambda b: b["per_layer"][0].update(moves="no_such_metric"),
    lambda b: b["per_layer"][0].update(why="a key a metric may not have"),
    lambda b: b["end_to_end"][0].update(workloads=["grid1m.offline"]),
    lambda b: b["workloads"][0].update(chips=2),
    lambda b: b["workloads"].append(dict(b["workloads"][0])),
    lambda b: b["end_to_end"].pop(),
], ids=["space-in-name", "unit", "bound", "moves", "extra-key", "cell-lacks-moves", "chips",
        "duplicate-cell", "no-setup_s"])
def test_validate_refuses(edit):
    assert _broken(edit)


def test_a_cell_added_by_entries_alone_is_valid(tmp_path):
    bench = copy.deepcopy(BENCH)
    cfg = manifest.config(bench, "cornell700")
    cfg["width"] = cfg["height"] = 512
    path = tmp_path / "cornell512.json"
    path.write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="cornell512", file=str(path)))
    bench["workloads"].append(dict(bench["workloads"][0], name="cornell512.offline",
                                   config="cornell512"))
    # Every per-layer metric names its cells: a new cell reports those that
    # name it, and none without asking.
    assert manifest.validate(bench) == ["cell 'cornell512.offline' reports too few metrics"]
    phases = ("raygen_ms_per_sample", "query_ms_per_sample", "shade_ms_per_sample")
    for m in bench["per_layer"]:
        if m["name"] in phases:
            m["workloads"].append("cornell512.offline")
    assert manifest.validate(bench) == []
    assert manifest.config(bench, "cornell512")["width"] == 512
    assert {m["name"] for m in manifest.cell_metrics(bench, "cornell512.offline", "end_to_end")} \
        == {"frame_ms", "setup_s"}
    assert {m["name"] for m in manifest.cell_metrics(bench, "cornell512.offline", "per_layer")} \
        == set(phases)
