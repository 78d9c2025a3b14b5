"""Helpers of the benchmark's own tests: the manifest with its
configurations cut to a size the CPU renders in seconds."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from cellbench import manifest

# The tests run in several workers at once: one thread each.
torch.set_num_threads(1)

SEED = 2**31 + 977  # beyond 32 signed bits, as the benchmark's seeds may be
CELLS = ["cornell700.offline", "grid1m.offline", "cornell700.interactive"]


def tiny_bench(tmp_path, pixels=None, image_spp=40):
    """BENCHMARK.json with each configuration in a file of its own under
    tmp_path at a tiny size: the cornell box at 24x20, the grid at 47x47
    vertices (4,232 triangles: the program's binary BVH, which `auto`
    picks above 2048 triangles, and the reference's own BVH walk) and 2
    bounces at 16x16."""
    bench = manifest.load()
    # The interactive mix (one sample a launch, every frame shown) has no
    # cell of its own in BENCHMARK.json yet; its path is held here.
    bench["workloads"].append({"name": "cornell700.interactive", "config": "cornell700",
                               "traffic": "interactive", "chips": 1,
                               "why": "one sample a launch, every frame resolved to host"})
    for m in bench["per_layer"]:
        if "cornell700.offline" in m["workloads"]:
            m["workloads"].append("cornell700.interactive")
    for c in bench["configs"]:
        cfg = manifest.config(bench, c["name"])
        if c["name"] == "grid1m":
            cfg.update(width=16, height=16, max_depth=2)
            cfg["scene"]["args"]["resolution"] = 47
        else:
            cfg.update(width=24, height=20)
        cfg["image_spp"] = image_spp
        cfg["check"]["pixels"] = pixels or cfg["width"] * cfg["height"]
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return bench


@pytest.fixture
def bench(tmp_path):
    return tiny_bench(tmp_path)


def run_on_cpu(bench, cell, seconds=0.3, traced=False, seed=SEED, renderer=None):
    """One run of `cell` on the CPU, past the harness's look for a card."""
    from cellbench import drive
    from cellbench.program import Renderer

    return drive.run_cell(bench, cell, seed, seconds, traced, "cpu", time.perf_counter(),
                          renderer=renderer or Renderer)


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


ROOT = os.path.dirname(manifest.HERE)
