"""Find a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
the configuration's `file` is a JSON file of sizes under `configs/` whose
`entry` names the module under `entries/` that drives it; the traffic is
`traffic/<traffic>.json`; the limits of the cell's output check are
`limits/<cell>.json`; every metric is `metrics/<name>.py`, a reader with a
`read(run)` function, or, for a name `<base>.<suffix>` with no file of its
own, `metrics/<base>.py`, one reader shared by the entries. Adding a cell, a traffic mix, a configuration or a
metric therefore adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    base = name.rsplit(".", 1)[0]
    own = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    return _module("metrics", name if os.path.exists(own) or base == name else base)


def entry(name: str):
    return _module("entries", name)


def applies(metric_entry: dict, cell: str, e2e_of_cell: set | None = None) -> bool:
    """Whether a metric is reported in a cell: listed in its `workloads`,
    or, without that key, an end-to-end metric everywhere and a per-layer
    metric wherever the metric it moves is reported."""
    if "workloads" in metric_entry:
        return cell in metric_entry["workloads"]
    return e2e_of_cell is None or metric_entry.get("moves") in e2e_of_cell


def resolve(cell: str, bench: dict | None = None) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"unknown workload {cell!r}; known: {sorted(cells)}")
    w = cells[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = _json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(BENCH_DIR, "limits", f"{cell}.json"))
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, cell, names)]
    return {"cell": w, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer}
