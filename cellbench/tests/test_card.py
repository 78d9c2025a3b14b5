"""Each cell on the card, as the driver runs it, for a short window."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from cellbench import manifest
from cellbench.tests.conftest import SEED

BENCH = manifest.load()


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, cell, traced):
    p = subprocess.run([sys.executable, "-m", "cellbench.run", "--workload", cell, "--seed",
                        str(SEED), "--seconds", "2", "--trace", str(traced)],
                       cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, p.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    kind = "per_layer" if traced else "end_to_end"
    assert set(line["metrics"]) == {m["name"] for m in manifest.cell_metrics(BENCH, cell, kind)}
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
