"""The cells `sponza_1080p.render_nee` and `helmet_cli_1024.default`: the
Sponza stand-in's shape, the culled reference against brute force, small
runs of both cells, their controls, and the new readers without their
spans. Run: python -m pytest benchmark/tests -p no:cacheprovider
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_helpers import SMALL, small_run
from test_bench_control import FAULTS
from harness import runner, spec
from harness import sponza_standin as ss
from reference import culled
from reference import scene as ref_scene
from reference import trace
from reference.vec3 import Vec3
from roofline.bvh import required_depth

SPONZA = "sponza_1080p.render_nee"
DEFAULT = "helmet_cli_1024.default"
#: the atrium cut to a depth-5 tree, its maps and sky to a CPU test's size
SMALL_SPONZA = {"render": SMALL["render"],
                "scene": {"triangles": 36_000, "texture": 32, "env_width": 64, "env_height": 32}}


def _sponza_run(seed: int, trace_on: bool = False) -> runner.Run:
    return runner.Run(SPONZA, seed, 0.0, trace_on, "cpu", time.perf_counter(),
                      overrides=SMALL_SPONZA)


def test_standin_has_sponzas_count_depth_and_materials():
    pos, nrm, uv, mat = ss.sponza_mesh()
    assert pos.shape == (262_267, 3, 3) and nrm.shape == pos.shape and uv.shape == (262_267, 3, 2)
    assert required_depth(len(pos)) == 6
    assert len(ss.MATERIAL_NAMES) == 25 and set(np.unique(mat)) == set(range(25))
    rows = ss.material_rows()
    assert sum(r["tex_normal"] >= 0 for r in rows) == 8
    assert sum(r["tex_mr"] >= 0 for r in rows) == 4
    assert sum(r["sheen"] > 0 for r in rows) == 6 and not any(any(r["emission"]) for r in rows)
    lo, hi = pos.reshape(-1, 3).min(0), pos.reshape(-1, 3).max(0)
    np.testing.assert_allclose(hi - lo, [37.0, 15.0, 23.0])
    # every face's winding agrees with its vertex normals
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    assert ((ng * nrm.sum(1)).sum(-1) >= 0).all()


def test_standin_is_deterministic_in_the_seed():
    a = ss.sponza_parts(2**31 + 9, 36_000, 32)
    b = ss.sponza_parts(2**31 + 9, 36_000, 32)
    c = ss.sponza_parts(2**31 + 10, 36_000, 32)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    for x, z in zip(a[0], c[0]):
        np.testing.assert_array_equal(x, z)  # the shape never depends on the seed
    assert len(a[1]) == 37 and all(t.shape == (32, 32, 3) for t in a[1])
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert not all(np.array_equal(x, z) for x, z in zip(a[1], c[1]))
    np.testing.assert_array_equal(ss.sponza_env(64, 32, 5), ss.sponza_env(64, 32, 5))


def test_the_sun_reaches_the_courtyard_floor():
    """The rolled sky's brightest texel lies at the sun's azimuth, 40
    degrees up, and a ray from the courtyard floor toward it leaves
    through the open roof."""
    env = ss.sponza_env(2048, 1024, 3)
    lum = env.astype(np.float64).sum(-1)
    v, u = np.unravel_index(np.argmax(lum), lum.shape)
    azim = ((u + 0.5) / 2048 - 0.5) * 360.0
    elev = (0.5 - (v + 0.5) / 1024) * 180.0
    assert abs(azim - ss.SUN_AZIMUTH_DEG) < 2.5 and abs(elev - 40.0) < 2.5
    d = np.array([np.cos(np.radians(azim)) * np.cos(np.radians(elev)), np.sin(np.radians(elev)),
                  np.sin(np.radians(azim)) * np.cos(np.radians(elev))])
    p = np.array([10.0, 0.0, 0.0]) + d * (ss.ATTIC / d[1])
    assert abs(p[0]) < ss.COURT_X and abs(p[2]) < ss.COURT_Z


def _cut_scene(ft=torch.float32):
    (pos, nrm, uv, mat), tex, view = ss.sponza_parts(7, 33_000, 16)
    fov = np.float32(ss.FOV_DEG / 360.0 * 2.0 * np.pi)
    focal = np.float32(1.0 / np.tan(fov * 0.5))
    env = ss.sponza_env(64, 32, 7)
    scene = ref_scene.build({"positions": pos, "normals": nrm, "uvs": uv, "mat_id": mat},
                            ss.material_rows(), [*tex, env], len(tex) + 1, view, focal, "cpu", ft)
    return ref_scene.with_env(scene, env)


def test_culled_intersection_equals_brute_force_bit_for_bit():
    """Random rays over the cut atrium, some along an axis and some from a
    slab's plane, a quarter inactive: every field of the hit equals the
    unculled brute force's."""
    scene = _cut_scene()
    r = np.random.default_rng(1)
    n = 2000
    o = r.uniform([-18, 0, -11], [18, 14, 11], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:40] = [1.0, 0.0, 0.0]
    o[:20, 1] = ss.SLAB_LO
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    origin, direction = Vec3(*(t(o[:, k]) for k in range(3))), Vec3(*(t(d[:, k]) for k in range(3)))
    active = t(r.uniform(size=n) > 0.25)
    want = trace.intersect(scene, origin, direction, active)
    got = culled.intersect(scene, origin, direction, active)
    for k in ("t", "tri", "u", "v"):
        assert torch.equal(got[k], want[k]), k
    assert torch.isfinite(got["t"]).float().mean() > 0.5


def test_culled_render_equals_brute_force_render():
    """Two batches of a 24 x 16 frame with NEE, 2 spp, 3 bounces: the
    culled reference's pixels are the brute-force reference's."""
    scene = _cut_scene()
    kw = dict(width=24, height=16, spp=2, max_bounces=3, nee=True)
    want = trace.render_batches(scene, 11, [0, 1], **kw)
    got = culled.render_batches(scene, 11, [0, 1], **kw)
    for b in want:
        for x, y in zip(got[b], want[b]):
            np.testing.assert_array_equal(x, y)
    assert want[0][2].mean() > 1.0


def test_small_sponza_run_is_correct_with_no_difference():
    """The whole cell (set-up, window, traced part, check) at 32 x 32, 2
    spp, 3 bounces on the atrium cut to a depth-5 tree: correct, every
    number of the check 0, and the new per-layer metrics read."""
    run = _sponza_run(2**31 + 77, trace_on=True)
    out = runner.run_cell(run)
    assert out["correct"] is True and out["checks"]["max_abs_u8"]["value"] == 0.0
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    for name in ("mrays_per_s.sponza", "bvh_s.sponza", "shadow_ms.sponza", "rng_ms.sponza",
                 "shade_ms.sponza", "intersect_ms.sponza", "sync_wait_ms.sponza"):
        assert out["metrics"][name]["value"] > 0, name
    assert run.state["rebuild_spans"][0]["name"] == "bvh"
    assert run.state["rebuild_spans"][0]["attrs"]["depth"] == 5


def test_small_default_cli_run_is_correct():
    run = small_run(DEFAULT, 2**31 + 55)
    out = runner.run_cell(run)
    assert out["correct"] is True, out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert "cli_frame_s" in out["metrics"] and "setup_s" in out["metrics"]


def _controls(run):
    run.entry.make_inputs(run)
    run.frames = [{"seed": runner.frame_seed(run.seed, 0)}]
    fails = lambda n: any(n[k] > run.spec["limits"][k] for k in run.spec["limits"])  # noqa: E731
    return (fails(runner.check_outputs(run, torch.bfloat16)),
            fails(runner.check_outputs(run, torch.float64)))


@pytest.mark.parametrize("cell", [SPONZA, DEFAULT])
def test_control_fails_and_the_sound_variant_passes_small(cell):
    run = _sponza_run(5) if cell == SPONZA else small_run(cell, 5)
    control_fails, variant_fails = _controls(run)
    assert control_fails and not variant_fails


def test_new_cells_resolve_with_their_metrics():
    b = spec.load_benchmark()
    r = spec.resolve(SPONZA, b)
    assert r["cell"]["chips"] == 1 and r["config"]["reduced"] == []
    assert {m["name"] for m in r["end_to_end"]} == {"frame_s", "setup_s"}
    names = {m["name"] for m in r["per_layer"]}
    assert names == {f"{m}.sponza" for m in (
        "mrays_per_s", "bvh_s", "shadow_ms", "k1_roofline", "launches_per_batch",
        "device_idle_share", "peak_mem_gib", "rng_ms", "shade_ms", "intersect_ms",
        "sync_wait_ms", "device_lag_ms")}
    r = spec.resolve(DEFAULT, b)
    assert {m["name"] for m in r["end_to_end"]} == {"cli_frame_s", "setup_s"}
    assert {m["name"] for m in r["per_layer"]} == {f"{m}.cli" for m in (
        "mrays_per_s", "launches_per_batch", "k1_roofline", "device_idle_share", "peak_mem_gib",
        "load_s", "write_s")}
    assert "--nee" not in r["traffic"]["argv"] and "-D" not in r["traffic"]["argv"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [SPONZA, DEFAULT])
def test_a_fault_under_the_timed_path_makes_a_new_cell_incorrect(cell, fault, monkeypatch):
    """test_bench_control.py's planted faults, in the new cells' small
    runs: correct is false."""
    run = _sponza_run(9) if cell == SPONZA else small_run(cell, 9)
    out = runner.run_cell(run, hooks={"after_setup": lambda r: FAULTS[fault](monkeypatch, r)})
    assert out["correct"] is False, out["checks"]


class _Bare:
    """A run that has nothing to read: no frames, no state, no traced pass."""
    frames: list = []
    state: dict = {}
    span_pass = None


@pytest.mark.parametrize("name", ["mrays_per_s.sponza", "bvh_s.sponza", "shadow_ms.sponza"])
def test_new_readers_return_none_without_their_spans(name):
    assert spec.metric(name).read(_Bare()) is None
