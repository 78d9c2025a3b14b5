"""The benchmark imports neither JAX nor the JAX package nor the old TPU
benchmarks (whole top-level names), and its reference nothing of the
program; without the program or a card it prints no result."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from cellbench import manifest
from cellbench.run import FORBIDDEN

BANNED = set(FORBIDDEN) | {"benchmarks"}
PROGRAM = "caitlynrenderer_tpu_torch"
# Modules that may import the program: the adapter and what runs it.
DRIVERS = {"program.py", "drive.py", "run.py", os.path.join("tests", "test_reference.py"),
           os.path.join("tests", "test_faults.py"), os.path.join("tests", "test_scene_inputs.py")}


def _modules():
    for dirpath, _, files in os.walk(manifest.HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                yield os.path.relpath(path, manifest.HERE), path


def top_names(path):
    """Top-level names of every module `path` imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel,path", list(_modules()), ids=[rel for rel, _ in _modules()])
def test_no_banned_import(rel, path):
    names = top_names(path)
    assert not names & BANNED, f"{rel} imports {sorted(names & BANNED)}"
    if PROGRAM in names:
        assert rel in DRIVERS, f"{rel} imports the program"


def test_whole_names_are_compared():
    # The program's name begins with the JAX package's and is allowed.
    assert PROGRAM.startswith("caitlynrenderer_tpu") and PROGRAM not in BANNED
    assert "jax" in BANNED and "caitlynrenderer_tpu" in BANNED


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, cellbench.reference.tracer, cellbench.roofline, cellbench.check, "
            "cellbench.control, cellbench.scenes.builtin\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(BANNED | {PROGRAM})!r}))\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "cellbench.run", "--workload",
                           "cornell700.offline", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=120)


def test_no_result_without_the_program(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(manifest.ROOT, env=env)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
