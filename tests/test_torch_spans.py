"""The port's spans (raytracing_c_tpu_torch/utils/spans.py): off by default
and invisible there, on without changing a pixel or a ray count, nested by
layer, shown to torch.profiler, and written by the CLI's --profile.

The file imports neither jax nor the JAX package, so its card test also
runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import json
import time

import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_c_tpu_torch import cli
from raytracing_c_tpu_torch.io.loader import load_scene
from raytracing_c_tpu_torch.render.renderer import render
from raytracing_c_tpu_torch.utils import spans

#: the leaves of a bounce and of a batch (PERF.md section 3)
BOUNCE_LEAVES = {"rng", "intersect", "attrs", "shade", "background", "advance", "compact",
                 "sync"}
BATCH_LEAVES = {"rng", "raygen", "encode", "sync"}
SMALL = dict(spp=2, max_bounces=3, seed=5)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    chip_smoke.write_obj_mtl(str(d), n=6, tex=32)
    chip_smoke.write_env_map(str(d / "background.png"), 64, 32)
    return d


@pytest.fixture(scope="module")
def scene(model_dir):
    return load_scene(str(model_dir / "standin.obj"),
                      background_path=str(model_dir / "background.png"), device="cpu")


@pytest.fixture
def spans_off():
    spans.disable()
    yield
    spans.disable()


def _recorded(fn):
    spans.enable()
    try:
        out = fn()
        return out, spans.collect()
    finally:
        spans.disable()


def test_collect_is_empty_while_off(scene, spans_off):
    assert not spans.enabled()
    with spans.span("shade", kind="x"):
        pass
    render(scene, 8, 8, **SMALL)
    assert spans.collect() == []


def test_note_and_timed_share_the_span(spans_off):
    with spans.span("intersect", kind="camera"):
        spans.note(kernel="thread")
    with spans.timed("env_table") as off:
        time.sleep(0.001)
    assert off.seconds >= 0.001 and spans.collect() == []
    spans.enable()
    try:
        spans.note(kernel="outside")  # outside every span: kept nowhere
        with spans.span("intersect", kind="camera"):
            spans.note(kernel="thread", rays=8)
        with spans.timed("env_table") as on:
            time.sleep(0.001)
        recs = spans.collect()
    finally:
        spans.disable()
    assert [r["name"] for r in recs] == ["intersect", "env_table"]
    assert recs[0]["attrs"] == {"kind": "camera", "kernel": "thread", "rays": 8}
    # one clock: the stage's seconds are its span's interval
    assert on.seconds == (recs[1]["end"] - recs[1]["start"]) / 1e9 >= 0.001


@pytest.mark.parametrize("mode", ["compacted", "dense", "nee"])
def test_render_is_the_same_with_spans_on(scene, spans_off, mode):
    kw = dict(SMALL, compact=mode != "dense", nee=mode == "nee")
    img_off, st_off = render(scene, 16, 12, **kw)
    (img_on, st_on), recs = _recorded(lambda: render(scene, 16, 12, **kw))
    assert img_on.tobytes() == img_off.tobytes() and img_off.std() > 0
    assert st_on.rays_traced == st_off.rays_traced
    names = {r["name"] for r in recs}
    assert {"render", "group", "batch", "bounce", "readback"} <= names
    assert BOUNCE_LEAVES - {"compact"} - ({"rng"} if mode == "dense" else set()) <= names
    if mode == "nee":
        assert {r["attrs"]["kind"] for r in recs if r["name"] == "intersect"} == \
            {"camera", "bounce", "shadow"}
        assert "shadow_lanes" in {r["attrs"].get("what") for r in recs if r["name"] == "sync"}


def test_spans_nest_by_layer_and_share_their_batch_id(scene, spans_off):
    (_, stats), recs = _recorded(lambda: render(scene, 16, 16, k_group=2, batch_pixels=64,
                                                **SMALL))
    by_id = {r["id"]: r for r in recs}

    def path(r):
        out = [r]
        while out[-1]["parent"] is not None:
            out.append(by_id[out[-1]["parent"]])
        return out

    batches = [r for r in recs if r["name"] == "batch"]
    assert len(batches) == stats.batches == 4
    assert len({r["batch"] for r in batches}) == 4
    assert len({r["frame"] for r in recs}) == 1 and recs[0]["name"] == "render"
    leaves = 0
    for r in recs:
        names = [x["name"] for x in path(r)]
        assert r["start"] <= r["end"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start"] <= r["start"] and r["end"] <= p["end"]
        if "batch" in names:
            # every span of a batch carries the id of the batch it is in
            assert r["batch"] == path(r)[names.index("batch")]["batch"]
        if r["name"] == "bounce":
            assert names == ["bounce", "batch", "group", "render"]
        elif names[1:2] == ["bounce"]:
            assert r["name"] in BOUNCE_LEAVES
            assert names == [r["name"], "bounce", "batch", "group", "render"]
            leaves += 1
        elif names[1:2] == ["batch"]:
            assert r["name"] in BATCH_LEAVES | {"bounce"}
    assert leaves > 0
    bounce = [r for r in recs if r["name"] == "bounce"]
    assert bounce[0]["attrs"] == {"index": 0, "lanes": 64 * SMALL["spp"]}
    hits = [r["attrs"] for r in recs if r["name"] == "intersect"]
    assert hits[0] == {"kind": "camera", "kernel": "plain", "rays": 64 * SMALL["spp"]}
    kinds = [h["kind"] for h in hits]
    assert kinds.count("camera") == 4 and set(kinds) == {"camera", "bounce"}


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


#: every name the program gives a span
SPAN_NAMES = {"render", "group", "batch", "bounce", "rng", "raygen", "intersect", "attrs",
              "shade", "background", "advance", "compact", "sync", "encode", "accumulate",
              "scatter", "readback", "load", "parse", "decode", "bvh", "upload", "k1_tables",
              "env_table", "denoise", "write"}


def test_profiler_sees_no_span_while_off_and_shade_over_aten_while_on(scene, spans_off):
    run = lambda: render(scene, 8, 8, **SMALL)  # noqa: E731
    off = _profiled(run)
    assert off and not {n for n, _, _ in off} & SPAN_NAMES
    spans.enable()
    try:
        on = _profiled(run)
    finally:
        spans.disable()
    shade = [(s, e) for n, s, e in on if n == "shade"]
    aten = [(s, e) for n, s, e in on if n.startswith("aten::")]
    assert shade
    for s, e in shade:
        assert any(s <= a and b <= e for a, b in aten)


def test_cli_profile_trace_holds_the_layers(model_dir, monkeypatch, spans_off):
    monkeypatch.chdir(model_dir)
    assert cli.main(["-W", "8", "-H", "8", "-S", "1", "-B", "2", "--profile", "sprof",
                     "-O", "s.png", "standin.obj"], device="cpu") == 0
    with open(model_dir / "sprof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"bounce", "shade", "load", "decode", "bvh", "write"} <= names
    assert not spans.enabled()


def test_loaders_record_their_stages(model_dir, spans_off):
    _, recs = _recorded(lambda: load_scene(str(model_dir / "standin.obj"),
                                           background_path=str(model_dir / "background.png"),
                                           device="cpu"))
    names = [r["name"] for r in recs]
    assert names[0] == "load" and recs[0]["parent"] is None
    assert {"parse", "decode", "bvh", "upload"} <= set(names)
    assert all(r["parent"] is not None for r in recs[1:])
    # the MTL's three maps (norm, map_Kd, map_Pr) and the env map
    assert names.count("decode") == 4


@pytest.mark.cuda
def test_device_events_on_the_host_clock(spans_off):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    x = torch.ones((1 << 20,), device="cuda")
    spans.enable(device=True)
    try:
        for i in range(20):
            with spans.span("batch"):
                with spans.span("shade", i=i):
                    y = (x * 2.0 + 1.0).sqrt()
                with spans.span("sync", what="test"):
                    float(y.sum())
        recs = spans.collect()
    finally:
        spans.disable()
    assert len(recs) == 60
    err = max(r["dev_err_ns"] for r in recs) + 50_000  # and a launch's latency
    for r in recs:
        assert r["dev_start"] <= r["dev_end"]
        assert r["dev_start"] >= r["start"] - err
        if r["name"] == "sync":
            # the host read waited for the device
            assert r["end"] >= r["dev_end"] - err
    # in the order they were recorded on one stream
    assert np.all(np.diff([r["dev_start"] for r in recs]) >= 0)
    tops = [r for r in recs if r["parent"] is None]
    assert all(a["dev_end"] <= b["dev_start"] for a, b in zip(tops, tops[1:]))
