"""The cells `sponza_lightmap_2048.bake` and `helmet_1080p.render_nee`: the
atlas of lightmap UVs on the full Sponza stand-in, the bake's plain
reference against the program, small runs of both cells, their controls,
faults planted under the bake's timed path, and the new readers without
their spans. Run: python -m pytest benchmark/tests -p no:cacheprovider
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_helpers import small_run
from test_bench_control import FAULTS
from harness import lightmap_atlas, runner, spec
from harness import sponza_standin as ss
from reference import lightmap as rlm

BAKE = "sponza_lightmap_2048.bake"
NEE = "helmet_1080p.render_nee"
#: the atrium cut to a depth-5 tree, a 256^2 atlas (its 1,501 charts fit
#: at 1.8 texels a metre), 2 samples, 3 bounces, batches of 512 texels
SMALL_BAKE = {"bake": {"width": 256, "height": 256, "samples": 2, "max_bounces": 3,
                       "batch_texels": 512},
              "scene": {"triangles": 36_000, "texture": 16, "env_width": 64, "env_height": 32}}


def _bake_run(seed: int, trace_on: bool = False) -> runner.Run:
    return runner.Run(BAKE, seed, 0.0, trace_on, "cpu", time.perf_counter(),
                      overrides=SMALL_BAKE)


def test_atlas_of_the_full_standin_keeps_its_charts_apart():
    """On the whole stand-in at 2048^2: every chart's texel box lies in the
    atlas GUTTER texels from its edges and from every other chart's box;
    the reference's rasterization has no texel written by two charts, and
    covers about 2.9 M texels at about 21 texels a metre."""
    pos, nrm, _, _ = ss.sponza_mesh()
    uvs, atlas = lightmap_atlas.atlas_uvs(pos, 2048, 2048)
    chart = atlas["chart"]
    assert atlas["charts"] > 1000 and (chart >= 0).all()
    assert 19.0 < atlas["texels_per_m"] < 23.0 and 0.6 < atlas["fill"] <= 1.0
    t = uvs.astype(np.float64) * 2048
    lo = np.full((atlas["charts"], 2), np.inf)
    hi = np.full((atlas["charts"], 2), -np.inf)
    np.minimum.at(lo, np.repeat(chart, 3), t.reshape(-1, 2))
    np.maximum.at(hi, np.repeat(chart, 3), t.reshape(-1, 2))
    lo, hi = np.floor(lo), np.floor(hi)
    g = lightmap_atlas.GUTTER
    assert (lo >= g).all() and (hi <= 2048 - 1 - g).all()
    apart = ((lo[:, None, 0] > hi[None, :, 0] + g) | (hi[:, None, 0] + g < lo[None, :, 0])
             | (lo[:, None, 1] > hi[None, :, 1] + g) | (hi[:, None, 1] + g < lo[None, :, 1]))
    np.fill_diagonal(apart, True)
    assert apart.all()
    slot_map = rlm.slot_map(pos)
    slots = slot_map[slot_map >= 0]
    texels = rlm.rasterize(pos, nrm, uvs, slots, 2048, 2048)
    assert lightmap_atlas.cross_chart_texels(texels["index"], chart[slots][texels["tri"]]) == 0
    assert 2.7e6 < len(np.unique(texels["index"])) < 3.1e6
    assert len(np.unique(slots[texels["tri"]])) > 0.9 * len(pos)


def test_cross_chart_texels_counts_shared_texels():
    index = np.array([5, 5, 7, 9, 9, 9, 2])
    chart = np.array([1, 1, 3, 0, 0, 4, 2])
    assert lightmap_atlas.cross_chart_texels(index, chart) == 1


def test_small_bake_run_is_correct_with_no_difference():
    """The whole cell (set-up, window, traced part, check) at SMALL_BAKE's
    size: correct, every number of the check 0, the new per-layer metrics
    read, and the bake span reads every triangle."""
    run = _bake_run(2**31 + 77, trace_on=True)
    out = runner.run_cell(run)
    assert out["correct"] is True and all(c["value"] == 0.0 for c in out["checks"].values())
    assert out["checks"]["mismatch_share"]["value"] == 0.0
    for name in ("mrays_per_s.bake", "rasterize_s.bake", "readback_ms.bake", "rng_ms.bake",
                 "intersect_ms.bake", "shade_ms.bake", "sync_wait_ms.bake"):
        assert out["metrics"][name]["value"] > 0, name
    bake = [r for r in run.span_pass["host"] if r["name"] == "bake"][0]
    assert bake["attrs"]["triangles"] == 36_000
    assert bake["attrs"]["batches"] == run.entry.n_batches(run)
    assert bake["attrs"]["texels"] == len(np.unique(run.state["ref_texels"]["index"]))


def _controls(run):
    run.entry.make_inputs(run)
    run.frames = [{"seed": runner.frame_seed(run.seed, 0)}]
    fails = lambda n: any(n[k] > run.spec["limits"][k] for k in run.spec["limits"])  # noqa: E731
    return (fails(runner.check_outputs(run, torch.bfloat16)),
            fails(runner.check_outputs(run, torch.float64)))


@pytest.mark.parametrize("cell", [BAKE, NEE])
def test_control_fails_and_the_sound_variant_passes_small(cell):
    run = _bake_run(5) if cell == BAKE else small_run(cell, 5)
    control_fails, variant_fails = _controls(run)
    assert control_fails and not variant_fails


def _first_n_slots(mp, run):
    """The bake reads the first n_triangles slots, as the JAX package does
    (the fault this cell came with): the records of the slots below n."""
    from raytracing_c_tpu_torch.render import lightmap

    original = lightmap._rasterize

    def first_n(scene, width, height):
        t = original(scene, width, height)
        return t.select(t.slot < scene.n_triangles)

    mp.setattr(lightmap, "_rasterize", first_n)


def _one_chart_dropped(mp, run):
    """The largest chart's triangles lose their lightmap UVs in the
    program's scene (its set is in the slot order of the benchmark's own
    tree, which is the program's)."""
    chart = run.state["atlas"]["chart"]
    big = np.bincount(chart[chart >= 0]).argmax()
    slot_map = rlm.slot_map(run.state["parts"][0][0])
    scene = run.state["scene"]
    uvs = scene.lightmap_uvs.copy()
    uvs[(slot_map >= 0) & (chart[np.maximum(slot_map, 0)] == big)] = 0.0
    mp.setattr(scene, "lightmap_uvs", uvs)


BAKE_FAULTS = {"first_n_slots": _first_n_slots, "one_chart_dropped": _one_chart_dropped,
               "state_unchanged": FAULTS["state_unchanged"]}


@pytest.mark.parametrize("fault", sorted(BAKE_FAULTS))
def test_a_fault_under_the_bakes_timed_path_makes_it_incorrect(fault, monkeypatch):
    run = _bake_run(9)
    out = runner.run_cell(run, hooks={"after_setup":
                                      lambda r: BAKE_FAULTS[fault](monkeypatch, r)})
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_makes_render_nee_incorrect(fault, monkeypatch):
    run = small_run(NEE, 9)
    out = runner.run_cell(run, hooks={"after_setup": lambda r: FAULTS[fault](monkeypatch, r)})
    assert out["correct"] is False, out["checks"]


def test_small_render_nee_run_is_correct():
    out = runner.run_cell(small_run(NEE, 2**31 + 55))
    assert out["correct"] is True and all(c["value"] == 0.0 for c in out["checks"].values())
    assert {"frame_s", "setup_s"} <= set(out["metrics"])


def test_new_cells_resolve_with_their_metrics():
    b = spec.load_benchmark()
    r = spec.resolve(BAKE, b)
    assert r["cell"]["chips"] == 1 and r["config"]["reduced"] == []
    assert {m["name"] for m in r["end_to_end"]} == {"frame_s", "setup_s"}
    assert {m["name"] for m in r["per_layer"]} == {f"{m}.bake" for m in (
        "mrays_per_s", "rasterize_s", "readback_ms", "launches_per_batch", "k1_roofline",
        "device_idle_share", "peak_mem_gib", "rng_ms", "intersect_ms", "shade_ms",
        "sync_wait_ms", "device_lag_ms")}
    assert r["config"]["bake"] == {"width": 2048, "height": 2048, "samples": 16,
                                   "max_bounces": 8, "batch_texels": 16384}
    r = spec.resolve(NEE, b)
    assert r["cell"]["chips"] == 1 and r["traffic"]["nee"] is True
    assert {m["name"] for m in r["end_to_end"]} == {"frame_s", "setup_s"}
    assert {m["name"] for m in r["per_layer"]} == {f"{m}.render" for m in (
        "mrays_per_s", "launches_per_batch", "k1_roofline", "device_idle_share", "peak_mem_gib")}


class _Bare:
    """A run that has nothing to read: no frames, no state, no traced pass."""
    frames: list = []
    state: dict = {}
    span_pass = None


@pytest.mark.parametrize("name", ["mrays_per_s.bake", "rasterize_s.bake", "readback_ms.bake"])
def test_new_readers_return_none_without_their_spans(name):
    assert spec.metric(name).read(_Bare()) is None
