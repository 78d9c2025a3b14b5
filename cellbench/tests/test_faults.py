"""The output check reads a broken timed path as not correct: the runs
below drive the rest of a run on the CPU with a fault planted in the
program's loop, and the control (the reference in bfloat16) fails the
configuration's limits.  The cells run on one card, so there is no
exchange between cards to leave out."""

from __future__ import annotations

import pytest
import torch

from cellbench import check, control, manifest
from cellbench.program import Renderer
from cellbench.tests.conftest import CELLS, SEED, run_on_cpu, tiny_bench

BENCH = manifest.load()


class Unchanged(Renderer):
    """A launch that counts its samples but returns the accumulation it
    was given."""

    def launch(self, spp):
        before = self.state.accum
        super().launch(spp)
        self.state = self.state._replace(accum=before)


class HalfTheBatch(Renderer):
    """Every other launch left out, the ones kept counted twice."""

    launches = 0

    def launch(self, spp):
        before = self.state.accum
        super().launch(spp)
        self.launches += 1
        delta = self.state.accum - before
        self.state = self.state._replace(
            accum=before + (2.0 * delta if self.launches % 2 else 0.0 * delta))


class AlteredAnswer(Renderer):
    """One pixel's radiance raised by half where the launch adds it."""

    def launch(self, spp):
        before = self.state.accum
        super().launch(spp)
        accum = self.state.accum.clone()
        accum[7] = before[7] + 1.5 * (accum[7] - before[7])
        self.state = self.state._replace(accum=accum)


@pytest.mark.parametrize("fault", [Unchanged, HalfTheBatch, AlteredAnswer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tmp_path, cell, fault):
    result, _ = run_on_cpu(tiny_bench(tmp_path, image_spp=4096), cell, seconds=0.2,
                           renderer=fault)
    assert result["correct"] is False


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_control_is_not_correct(tmp_path, name):
    bench = tiny_bench(tmp_path)
    cfg = manifest.config(bench, name)
    values = control.control_numbers(cfg, SEED, 16, 16, "cpu", torch.bfloat16)
    correct, rows = check.judge(values, cfg["check"]["limits"])
    assert not correct and len(rows) == 3
    # The float32 reference in the control's place reads exact.
    same = control.control_numbers(cfg, SEED, 16, 16, "cpu", torch.float32)
    assert all(v == 0.0 for v in same.values())
