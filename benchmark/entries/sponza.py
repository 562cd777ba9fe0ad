"""Entry `sponza`: whole frames through the library's render() on the
Sponza stand-in (`harness/sponza_standin.py`), with the traffic's NEE.

`render(scene, width, height, spp=, max_bounces=, seed=, nee=)` with its
defaults (the compacted tracer, groups of k_group batches into the device
accumulator, the image back on the host), on the scene built in memory
under the rolled equirect sky: 262,267 triangles, a depth-6 BVH, 25
materials and 37 maps. The frames are render() frames, so set-up tells
the readers so (`run.config["entry"]`, which `metrics/frame_s.py` reads).

Set-up makes the stand-in and the sky from the seed, builds the
program's scene (the BVH, its tables and the atlas on the device), prints
the tree's shape, and warms up: one render() of the first batch (which
also builds the env light's table) and one group of k_group batches at
the frame's centre rows through `render_batches_grouped_acc` with the
tracer render() runs. The traced part rebuilds the scene once under the
program's spans (`extra_spans`: the `bvh` and `k1_tables` spans that
`bvh_s.sponza` reads). The reference is the culled one
(`reference/culled.py`): brute force is minutes a batch at this size.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from entries import render as _render
from harness import sponza_standin as ss
from reference import culled
from reference import scene as ref_scene

#: what the frames, the traced group's inputs and the check share with
#: entries/render.py: the same render() call on another scene
frame_params, n_batches, frame = _render.frame_params, _render.n_batches, _render.frame
prepare_group, frame_shape = _render.prepare_group, _render.frame_shape
program_pixels, cleanup = _render.program_pixels, _render.cleanup


def make_inputs(run) -> None:
    """The stand-in and the sky from the run's seed (run.state)."""
    s = run.config["scene"]
    run.state = {"parts": ss.sponza_parts(run.seed, s["triangles"], s["texture"]),
                 "env": ss.sponza_env(s["env_width"], s["env_height"], run.seed)}


def build(run):
    """The program's scene of the stand-in, on the run's device."""
    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    (pos, nrm, uv, mat), textures, view = run.state["parts"]
    mats = ss.material_rows()
    f = lambda k: torch.tensor([m[k] for m in mats], dtype=torch.float32)  # noqa: E731
    i = lambda k: torch.tensor([m[k] for m in mats], dtype=torch.int32)  # noqa: E731
    rgb = lambda k: Vec3(*(torch.tensor([m[k][c] for m in mats], dtype=torch.float32)  # noqa: E731
                           for c in range(3)))
    table = ps.MaterialTable(
        base_color=rgb("base_color"), emission=rgb("emission"),
        roughness=f("roughness"), metalness=f("metalness"),
        normal_strength=f("normal_strength"), sheen=f("sheen"), sheen_tint=f("sheen_tint"),
        anisotropic=f("anisotropic"), tex_albedo=i("tex_albedo"), tex_normal=i("tex_normal"),
        tex_mr=i("tex_mr"), tex_emission=i("tex_emission"),
        shader_kind=torch.zeros(len(mats), dtype=torch.int32),
    ).with_rows()
    return ps.build_scene(ps.HostMesh(pos, nrm, uv, mat), table,
                          ps.TextureAtlas.pack([*textures, run.state["env"]]),
                          ps.Background.equirect(len(textures) + 1),
                          ps.Camera.look(view, ss.FOV_DEG), device=run.device)


def tree_shape(scene) -> dict:
    """The tree's depth, its triangle slots, the occupied leaf blocks and
    the bytes of the padded triangle store."""
    tri = scene.triangles
    blocks = int((tri.mat_id.view(-1, 8) >= 0).any(1).sum())
    planes = [p for v in vars(tri).values()
              for p in ((v,) if isinstance(v, torch.Tensor) else (v.x, v.y, v.z))]
    store = sum(p.numel() * p.element_size() for p in planes)
    return {"triangles": scene.n_triangles, "depth": scene.bvh.depth, "slots": tri.capacity,
            "blocks": blocks, "store_bytes": store}


def setup(run) -> None:
    from raytracing_c_tpu_torch.render.renderer import render

    # the frames are whole render() frames: frame_s reads them as such
    run.config["entry"] = "render"
    make_inputs(run)
    scene = run.state["scene"] = build(run)
    shape = tree_shape(scene)
    print("sponza tree: " + ", ".join(f"{k} {v}" for k, v in shape.items()), file=sys.stderr)
    p = frame_params(run)
    render(scene, p["width"], p["height"], spp=p["spp"], max_bounces=p["max_bounces"],
           seed=0, nee=p["nee"], limit_batches=1)
    group(run, prepare_group(run))
    run.sync()


def group(run, g) -> None:
    """One group as render() runs it: its default method and the compacted
    tracer (render()'s compact=None)."""
    from raytracing_c_tpu_torch.render.renderer import render_batches_grouped_acc

    p = frame_params(run)
    render_batches_grouped_acc(run.state["scene"], g["xs"], g["ys"], g["key"], g["b0"],
                               g["acc"], g["rays"], width=p["width"], height=p["height"],
                               spp=p["spp"], max_bounces=p["max_bounces"], batch_px=g["bp"],
                               k_group=g["k"], method="auto", compact=True, nee=p["nee"])


def extra_spans(run) -> list:
    """The scene rebuilt once with the program's spans on: its `bvh`,
    `upload` and `k1_tables` spans are kept on run.state["rebuild_spans"]."""
    from raytracing_c_tpu_torch.utils import spans

    def rebuild():
        spans.enable()
        try:
            scene = build(run)
            run.state["rebuild_spans"] = spans.collect()
        finally:
            spans.disable()
        del scene

    return [("rebuild", rebuild)]


def _report(run) -> None:
    """What the traced pass saw of the tree, the shadow test and the
    lanes, on stderr."""
    say = lambda text: print("sponza: " + text, file=sys.stderr)  # noqa: E731
    for r in run.state.get("rebuild_spans") or []:
        if r["name"] == "bvh":
            say("bvh span: " + ", ".join(f"{k} {v}" for k, v in r["attrs"].items())
                + f", {(r['end'] - r['start']) / 1e9:.3f} s")
    host = (getattr(run, "span_pass", None) or {}).get("host") or []
    for r in host:
        if r["name"] == "render" and "shadow_rays" in r["attrs"]:
            a = r["attrs"]
            say(f"shadow rays {a['shadow_rays']}, occluded {a['shadow_occluded']} "
                f"({100.0 * a['shadow_occluded'] / max(a['shadow_rays'], 1):.2f}%)")
    lanes = {}
    for r in host:
        if r["name"] == "bounce":
            lanes.setdefault(r["attrs"]["index"], []).append(r["attrs"]["lanes"])
    if lanes:
        say("lanes entering each bounce (mean): " + ", ".join(
            f"{i}: {np.mean(v):.0f}" for i, v in sorted(lanes.items())))


def release(run) -> None:
    _report(run)
    run.state["scene"] = None


def scene_positions(run) -> np.ndarray:
    """The triangles (n, 3, 3) float32, in the order the program gets them."""
    return run.state["parts"][0][0]


def reference_pixels(run, rec, batches, ft) -> dict:
    p = frame_params(run)
    (pos, nrm, uv, mat), textures, view = run.state["parts"]
    fov = np.float32(ss.FOV_DEG / 360.0 * 2.0 * np.pi)
    focal = np.float32(1.0 / np.tan(fov * 0.5))
    scene = ref_scene.build({"positions": pos, "normals": nrm, "uvs": uv, "mat_id": mat},
                            ss.material_rows(), [*textures, run.state["env"]],
                            len(textures) + 1, view, focal, run.device, ft)
    if p["nee"]:
        ref_scene.with_env(scene, run.state["env"])
    out = culled.render_batches(scene, rec["seed"], batches, width=p["width"],
                                height=p["height"], spp=p["spp"], max_bounces=p["max_bounces"],
                                nee=p["nee"])
    return {"ys": np.concatenate([o[1] for o in out.values()]),
            "xs": np.concatenate([o[0] for o in out.values()]),
            "rgb": np.concatenate([o[2] for o in out.values()])}

