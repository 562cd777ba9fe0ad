"""The harness finds every cell, configuration, traffic mix, limit and
metric of BENCHMARK.json by name, and BENCHMARK.json keeps the required
names, units and sizes. Run: python -m pytest benchmark/tests -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_helpers import BENCH, CELLS, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return spec.load_benchmark()


def test_top_level_keys_and_paths():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    b = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for x in b["configs"] + b["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    b = _bench()
    r = spec.resolve(cell, b)
    assert r["cell"]["chips"] == 1
    spec.entry(r["config"]["entry"])
    assert r["limits"] and all(isinstance(v, (int, float)) for v in r["limits"].values())
    e2e = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and r["per_layer"]
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(spec.metric(m["name"]).read)


def test_every_config_file_and_metric_file_exists():
    b = _bench()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for m in b["end_to_end"] + b["per_layer"]:
        own = os.path.join(BENCH, "metrics", m["name"] + ".py")
        shared = os.path.join(BENCH, "metrics", m["name"].rsplit(".", 1)[0] + ".py")
        assert os.path.exists(own) or os.path.exists(shared), m["name"]
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in b["workloads"]}


def test_a_cell_is_added_by_files_and_entries_alone():
    """A new traffic mix, limits file, metric and workloads entry: the
    harness resolves the new cell without an edit to any existing file."""
    b = _bench()
    traffic = os.path.join(BENCH, "traffic", "test_default_cli.json")
    limits = os.path.join(BENCH, "limits", "helmet_cli_1024.test_default_cli.json")
    metric = os.path.join(BENCH, "metrics", "test_frames.cli.py")
    try:
        json.dump({"argv": ["-V", "--seed", "{seed}", "--bg", "{bg}", "-O", "{out}",
                            "{model}"]}, open(traffic, "w"))
        json.dump({"max_abs_u8": 0}, open(limits, "w"))
        open(metric, "w").write("def read(run):\n    return len(run.frames)\n")
        cell = "helmet_cli_1024.test_default_cli"
        b["workloads"].append({"name": cell, "config": "helmet_cli_1024",
                               "traffic": "test_default_cli", "chips": 1, "why": "test"})
        b["per_layer"].append({"name": "test_frames.cli", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "cli_frame_s", "workloads": [cell]})
        b["end_to_end"][[m["name"] for m in b["end_to_end"]].index("cli_frame_s")][
            "workloads"].append(cell)
        r = spec.resolve(cell, b)
        assert r["traffic"]["argv"][0] == "-V"
        assert "test_frames.cli" in {m["name"] for m in r["per_layer"]}
        assert spec.metric("test_frames.cli").read(type("R", (), {"frames": [1, 2]})) == 2
    finally:
        for p in (traffic, limits, metric):
            if os.path.exists(p):
                os.remove(p)


def test_a_suffixed_metric_falls_back_to_the_shared_reader():
    """`<base>.<suffix>` with no file of its own is read by `<base>.py`; a
    file of its own wins."""
    shared = spec.metric("peak_mem_gib.some_new_entry")
    assert shared.__file__.endswith(os.path.join("metrics", "peak_mem_gib.py"))
    own = spec.metric("mrays_per_s.cli")
    assert own.__file__.endswith(os.path.join("metrics", "mrays_per_s.cli.py"))
    with pytest.raises(FileNotFoundError):
        spec.metric("no_such_metric.cli")


def test_run_refuses_without_a_card():
    """No CUDA device: exit code 2 and no result line."""
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_tree_without_the_program(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: a non-zero exit."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_c_tpu")


@pytest.mark.parametrize("package,also", [("reference", ("raytracing_c_tpu_torch",)),
                                           ("roofline", ("raytracing_c_tpu_torch",)),
                                           ("harness", ())])
def test_no_forbidden_imports(package, also):
    """Importing every module of a benchmark package loads no JAX and no
    JAX package, compared by whole top-level module name; the reference
    and the yardstick load nothing of the program either."""
    mods = [f"{package}.{f[:-3]}" for f in sorted(os.listdir(os.path.join(BENCH, package)))
            if f.endswith(".py")]
    code = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import json; print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & set(FORBIDDEN + also), sorted(top & set(FORBIDDEN + also))
