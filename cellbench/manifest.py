"""BENCHMARK.json and the files it names: the manifest's checks, and the
discovery of a cell's configuration, traffic mix and per-layer readers
by the names the manifest gives them.

    cellbench/configs/<config>.json   a configuration (the manifest's "file")
    cellbench/traffic/<mix>.json      a traffic mix's parameters
    cellbench/metrics/<metric>.py     a per-layer metric's reader: read(ctx)
    cellbench/reference/<name>.py     a plain reference, named by a configuration's
                                      "reference" (tracer where it names none)
    cellbench/scenes/<generator>.py   a scene generator outside builtin.GENERATORS:
                                      make(**args)
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        bench = json.load(f)
    problems = validate(bench)
    if problems:
        raise ValueError(f"{path}: " + "; ".join(problems))
    return bench


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def validate(bench: dict) -> list:
    """The manifest's faults, as messages; empty when it keeps to the
    benchmark's contract (keys, names, units, references between
    entries, which cells report which metrics)."""
    bad = []
    if set(bench) != TOP_KEYS:
        bad.append(f"top-level keys {sorted(bench)}")
    names = {}
    for kind, keys, extra in (("configs", CONFIG_KEYS, set()), ("workloads", WORKLOAD_KEYS, set()),
                              ("end_to_end", E2E_KEYS, {"workloads"}),
                              ("per_layer", LAYER_KEYS, {"workloads"})):
        for e in bench.get(kind, []):
            if not keys <= set(e) <= keys | extra:
                bad.append(f"{kind} entry {e.get('name')!r} has keys {sorted(e)}")
            if not NAME.match(str(e.get("name", ""))):
                bad.append(f"{kind} name {e.get('name')!r}")
            group = "metric" if kind in ("end_to_end", "per_layer") else kind
            if (group, e.get("name")) in names:
                bad.append(f"two {group} named {e.get('name')!r}")
            names[(group, e.get("name"))] = e
            if "unit" in e and not UNIT.match(str(e["unit"])):
                bad.append(f"unit {e['unit']!r} of {e.get('name')!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                bad.append(f"better {e['better']!r} of {e.get('name')!r}")
            for k in {"configs": ("why", "source"), "workloads": ("why",)}.get(kind, ()):
                if not _line(e.get(k)):
                    bad.append(f"{k} of {e.get('name')!r}")
    configs = {c["name"]: c for c in bench.get("configs", [])}
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    for c in configs.values():
        if not all(NAME.match(k) for k in c.get("reduced", [])) or len(c.get("reduced", [])) > 16:
            bad.append(f"reduced of {c['name']!r}")
    for w in cells.values():
        if w.get("config") not in configs:
            bad.append(f"cell {w['name']!r} names no configuration {w.get('config')!r}")
        if not NAME.match(str(w.get("traffic", ""))):
            bad.append(f"traffic {w.get('traffic')!r}")
        if w.get("chips") not in (1, 4):
            bad.append(f"chips of {w['name']!r}")
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for m in e2e.values():
        if m.get("source") not in ("host_clock", "device_trace"):
            bad.append(f"source of {m['name']!r}")
        if not (isinstance(m.get("bound"), (int, float)) and 0.01 <= m["bound"] <= 0.25):
            bad.append(f"bound of {m['name']!r}")
    for m in bench.get("per_layer", []):
        if m.get("source") not in SOURCES:
            bad.append(f"source of {m['name']!r}")
        if not _line(m.get("layer")):
            bad.append(f"layer of {m['name']!r}")
        if m.get("moves") not in e2e:
            bad.append(f"{m['name']!r} moves no end-to-end metric {m.get('moves')!r}")
            continue
        for cell in m.get("workloads", list(cells)):
            if cell not in cells:
                bad.append(f"{m['name']!r} names no cell {cell!r}")
            elif m["moves"] not in [e["name"] for e in cell_metrics(bench, cell, "end_to_end")]:
                bad.append(f"cell {cell!r} reports {m['name']!r} but not {m['moves']!r}")
    for cell in cells:
        if len(cell_metrics(bench, cell, "end_to_end")) < 2 or not cell_metrics(
                bench, cell, "per_layer"):
            bad.append(f"cell {cell!r} reports too few metrics")
    return bad


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics cell `cell` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(known: {', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str) -> dict:
    """The configuration file of configuration `name`, as run."""
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    """The parameters of traffic mix `name`."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def by_file(folder: str, name: str, what: str):
    """The module of file cellbench/<folder>/<name>.py, loaded from its
    path; FileNotFoundError naming that path where there is none (a name
    never falls back to another module)."""
    path = os.path.join(HERE, folder, f"{name}.py")
    if not NAME.match(name) or not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"cellbench.{folder}." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The `read(ctx)` function of per-layer metric `name`."""
    return by_file("metrics", name, "reader for per-layer metric").read


def reference(cfg: dict):
    """The plain reference module of configuration file `cfg`: the one its
    "reference" names, `tracer` where it names none (the interface is in
    cellbench/reference/__init__.py)."""
    return by_file("reference", cfg.get("reference", "tracer"), "plain reference")
