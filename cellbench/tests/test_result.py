"""The result line: its keys, the metrics each cell reports, and the
numbers compared, each beside its limit, last."""

from __future__ import annotations

import json

import pytest

from cellbench import manifest
from cellbench.tests.conftest import CELLS, run_on_cpu

BENCH = manifest.load()


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(bench, cell, traced):
    result, info = run_on_cpu(bench, cell, traced=bool(traced))
    line = json.loads(json.dumps(result))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    kind = "per_layer" if traced else "end_to_end"
    units = {m["name"]: m["unit"] for m in manifest.cell_metrics(bench, cell, kind)}
    if traced:
        # On the CPU only the host's readings exist; the device's are left out.
        assert "upload_s" in line["metrics"] and set(line["metrics"]) <= set(units)
    else:
        assert set(line["metrics"]) == set(units)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert all(line["metrics"][k]["unit"] == units[k] for k in line["metrics"])
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert info[-len(line["checked"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in line["checked"].items()]
