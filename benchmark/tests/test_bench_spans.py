"""The readers of the program's spans (metrics/_spans.py and the metric
files that use it): None where the program has no spans module, their
arithmetic and the counters' split on a synthetic span list, and a whole
traced run of each cell at a CPU test's size. Run:
python -m pytest benchmark/tests -p no:cacheprovider
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from bench_helpers import CELLS, small_run
from harness import runner, spec
from metrics import _spans

FRAME_METRICS = ("rng_ms", "shade_ms", "intersect_ms", "sync_wait_ms", "device_lag_ms")
LOAD_METRICS = ("decode_s.cli", "bvh_s.cli")
NEW = [f"{m}.{s}" for m in FRAME_METRICS for s in ("render", "cli")] + list(LOAD_METRICS)


def test_every_new_metric_is_declared_for_its_cell():
    declared = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"] == [CELLS[0] if name.endswith(".render") else CELLS[1]]


def test_readers_give_none_without_the_spans_module(monkeypatch):
    import raytracing_c_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "raytracing_c_tpu_torch.utils.spans", None)
    run = SimpleNamespace()
    for name in NEW:
        assert spec.metric(name).read(run) is None, name
    assert run.span_pass is None


def _rec(i, name, start_us, dur_us, parent=None, batch=None, lag_us=None, **attrs):
    r = {"name": name, "id": i, "parent": parent, "frame": None, "batch": batch,
         "start": start_us * 1000, "end": (start_us + dur_us) * 1000, "attrs": attrs}
    if lag_us is not None:
        r["dev_start"] = r["start"] + lag_us * 1000
        r["dev_end"] = r["end"] + lag_us * 1000
    return r


def _frame():
    """Two batches of 10 ms under one group. In each (us): rng 1000,
    raygen 500, one bounce of intersect 2000, attrs 500, shade 3000,
    background 400, advance 300, compact 200, sync 250, then encode 350:
    8,500 of the batch's 10,000 in leaves. Device lags 10-80 us."""
    recs = [_rec(0, "group", 0, 20_500)]
    leaves = [("rng", 1000), ("raygen", 500), ("intersect", 2000), ("attrs", 500),
              ("shade", 3000), ("background", 400), ("advance", 300), ("compact", 200),
              ("sync", 250), ("encode", 350)]
    counters = {"intersect": dict(kind="camera", kernel="thread", rays=4096),
                "sync": dict(what="compaction")}
    for b in range(2):
        t = 100 + b * 10_100
        bid = len(recs)
        recs.append(_rec(bid, "batch", t, 10_000, parent=0, batch=b + 1))
        bounce = None
        for j, (name, dur) in enumerate(leaves):
            if name == "intersect":
                bounce = len(recs)
                recs.append(_rec(bounce, "bounce", t, 6_850, parent=bid, batch=b + 1,
                                 index=0, lanes=64 * (b + 1)))
            parent = bounce if name in ("intersect", "attrs", "shade", "background", "advance",
                                        "compact", "sync") else bid
            recs.append(_rec(len(recs), name, t, dur, parent=parent, batch=b + 1,
                             lag_us=10 * (j % 8 + 1), **counters.get(name, {})))
            t += dur
    # a key fold in the group and the frame's ray count, outside any batch:
    # counted in rng_ms and sync_wait_ms, not in the leaves' cover
    recs.append(_rec(len(recs), "rng", 20_300, 100, parent=0))
    recs.append(_rec(len(recs), "sync", 20_500, 50, what="rays"))
    return recs


def _host(recs):
    """The same spans as the host pass has them: no device events."""
    return [{k: v for k, v in r.items() if not k.startswith("dev_")} for r in recs]


def test_the_arithmetic_for_each_batch():
    load = [_rec(0, "load", 0, 3_000_000), _rec(1, "parse", 0, 1_500_000, parent=0),
            _rec(2, "decode", 10, 600_000, parent=1), _rec(3, "decode", 700_000, 400_000,
                                                            parent=1),
            _rec(4, "decode", 1_600_000, 200_000, parent=0),
            _rec(5, "bvh", 1_900_000, 500_000, parent=0),
            _rec(6, "upload", 2_400_000, 100_000, parent=0),
            _rec(7, "k1_tables", 2_500_000, 250_000, parent=0)]
    frame = _frame()
    # the host pass's frame holds the load; the device pass's lags are
    # read alone, and its times not at all
    run = SimpleNamespace(span_pass={"host": load + _host(frame), "walls": {},
                                     "device": [dict(r, start=r["start"] + 7) for r in frame]})
    read = lambda name: spec.metric(name).read(run)  # noqa: E731
    for suffix in ("render", "cli"):
        assert read(f"rng_ms.{suffix}") == pytest.approx(1.0 + 0.1 / 2)
        assert read(f"shade_ms.{suffix}") == pytest.approx(3.0)
        assert read(f"intersect_ms.{suffix}") == pytest.approx(2.5)
        assert read(f"sync_wait_ms.{suffix}") == pytest.approx(0.25 + 0.05 / 2)
        # lags 10..80, 10, 20 us over the 10 leaves of each batch: median 35
        assert read(f"device_lag_ms.{suffix}") == pytest.approx(0.035 - 7e-6)
    assert read("decode_s.cli") == pytest.approx(1.2)
    assert read("bvh_s.cli") == pytest.approx(0.75)
    assert _spans.leaf_cover(frame) == pytest.approx(0.85)


def test_the_counters_split_as_the_report_prints_them(capsys):
    recs = _frame()
    assert _spans.by_attr_ms(recs, "sync", "what") == pytest.approx(
        {"compaction": 0.25, "rays": 0.025})
    assert _spans.by_attr_ms(recs, "shade", "kind") == pytest.approx({"-": 3.0})
    assert _spans.rays_by_kernel(recs) == {"camera": {"thread": 4096.0}}
    assert _spans.lanes_by_bounce(recs) == {0: 96.0}
    _spans._report({"host": _host(recs), "device": recs, "walls": {"host": 1.0}})
    err = capsys.readouterr().err
    assert "sync ms a batch by what: compaction 0.250, rays 0.025" in err
    assert "intersect by kind: camera 2.000 ms, thread 4096 rays (a batch)" in err
    assert "lanes entering each bounce (mean): 0: 96" in err
    assert "device lag 0.035 ms" in err


def test_no_batch_or_no_load_span_reads_none():
    run = SimpleNamespace(span_pass={"host": [_rec(0, "shade", 0, 10)], "device": None,
                                     "walls": {}})
    assert spec.metric("shade_ms.render").read(run) is None
    assert spec.metric("decode_s.cli").read(run) is None
    assert spec.metric("device_lag_ms.cli").read(run) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_span_metrics(cell, capsys):
    """A whole --trace 1 run on the CPU: the span metrics are in its line
    (device_lag_ms needs CUDA events: left out here), read from one more
    frame of the timed path, the run stays correct, and spans are off
    after it."""
    from raytracing_c_tpu_torch.utils import spans

    run = small_run(cell, 2**31 + 17, trace=True)
    out = runner.run_cell(run)
    assert out["correct"] is True, out["checks"]
    suffix = "render" if cell == CELLS[0] else "cli"
    want = {f"{m}.{suffix}" for m in FRAME_METRICS if m != "device_lag_ms"}
    if suffix == "cli":
        want |= set(LOAD_METRICS)
    assert want <= set(out["metrics"]), sorted(out["metrics"])
    assert f"device_lag_ms.{suffix}" not in out["metrics"]
    assert all(out["metrics"][m]["value"] > 0 for m in want)
    assert not spans.enabled()
    err = capsys.readouterr().err
    assert "spans: frame wall (s): host" in err and "leaves cover" in err
    assert "lanes entering each bounce (mean): 0: " in err
    # the frames render the compacted tracer: its compaction sync is there
    assert "compaction" in err.split("sync ms a batch by what:")[1].split("\n")[0]
    if suffix == "cli":
        assert "spans: load (s): load" in err
