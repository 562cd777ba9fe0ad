"""Entry `render`: whole frames through the library,
`raytracing_c_tpu_torch.render.renderer.render(scene, width, height,
spp=, max_bounces=, seed=, nee=)` with its defaults (groups of k_group
batches into the device accumulator, the image back on the host), on the
stand-in scene built in memory under an equirect env map.

Set-up makes the stand-in and the env map from the seed, builds the
program's scene from them (the BVH, its tables and the atlas on the
device), and warms up: one render() of its first batch (the tile tables
and the frame) and one group of k_group batches at the frame's centre
rows through `render_batches_grouped_acc`, the call render() makes, so
that every kernel the frames launch has run once.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import standin
from reference import scene as ref_scene
from reference import trace as ref_trace


def frame_params(run):
    p = dict(run.config["render"])
    p.update(run.traffic.get("render", {}))
    p["nee"] = bool(run.traffic.get("nee", False))
    return p


def n_batches(run) -> int:
    p = frame_params(run)
    return ref_trace.batch_layout(p["width"], p["height"], p["spp"])[1]


def make_inputs(run) -> None:
    """The stand-in and the env map from the run's seed (run.state)."""
    s = run.config["scene"]
    run.state = {"parts": standin.standin_parts(run.seed, s["sphere_quads"], s["texture"]),
                 "env": standin.make_env_map(s["env_width"], s["env_height"], run.seed)}


def setup(run) -> None:
    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.render.renderer import render
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    make_inputs(run)
    env = run.state["env"]
    (pos, nrm, uv, mat), textures, view = run.state["parts"]
    mats = standin.STANDIN_MATERIALS
    f = lambda k: torch.tensor([m[k] for m in mats], dtype=torch.float32)  # noqa: E731
    i = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    rgb = lambda k: Vec3(*(torch.tensor([m[k][c] for m in mats], dtype=torch.float32)  # noqa: E731
                           for c in range(3)))
    tex = {name: i(*(k + 1 if m["textured"] else -1 for m in mats))
           for k, name in enumerate(standin.MAPS)}
    table = ps.MaterialTable(
        base_color=rgb("base_color"), emission=rgb("emission"),
        roughness=f("roughness"), metalness=f("metalness"),
        normal_strength=f("normal_strength"), sheen=f("sheen"), sheen_tint=f("sheen_tint"),
        anisotropic=f("anisotropic"), tex_albedo=tex["albedo"], tex_normal=tex["normal"],
        tex_mr=tex["mr"], tex_emission=tex["emission"], shader_kind=i(0, 0, 0),
    ).with_rows()
    scene = ps.build_scene(ps.HostMesh(pos, nrm, uv, mat), table,
                           ps.TextureAtlas.pack([*textures, env]),
                           ps.Background.equirect(len(textures) + 1),
                           ps.Camera.look(view, standin.FOV_DEG), device=run.device)
    run.state["scene"] = scene
    p = frame_params(run)
    render(scene, p["width"], p["height"], spp=p["spp"], max_bounces=p["max_bounces"],
           seed=0, nee=p["nee"], limit_batches=1)
    group(run, prepare_group(run))
    run.sync()


def frame(run, seed: int) -> dict:
    from raytracing_c_tpu_torch.render.renderer import render

    p = frame_params(run)
    img, stats = render(run.state["scene"], p["width"], p["height"], spp=p["spp"],
                        max_bounces=p["max_bounces"], seed=seed, nee=p["nee"])
    return {"seed": seed, "img": img, "rays": stats.rays_traced, "wall_ms": stats.wall_ms}


def prepare_group(run):
    """The pixel tables on the device, the centre group's first batch and
    a device accumulator, made outside any timed or traced span."""
    p = frame_params(run)
    bp, nb, pad = ref_trace.batch_layout(p["width"], p["height"], p["spp"])
    k = min(run.config["k_group"], nb)
    xs, ys, _ = ref_trace.pixel_tables(p["width"], p["height"], pad)
    n_slots = -(-nb // k) * k
    dev = run.device
    return {"xs": torch.from_numpy(xs).to(dev), "ys": torch.from_numpy(ys).to(dev),
            "b0": (nb - k) // 2, "bp": bp, "k": k,
            "acc": torch.zeros((n_slots * bp, 3), dtype=torch.uint8, device=dev),
            "rays": torch.zeros((n_slots,), dtype=torch.float32, device=dev),
            "key": torch.tensor([0, run.seed % 2**32], dtype=torch.int64, device=dev)}


def group(run, g) -> None:
    from raytracing_c_tpu_torch.render.renderer import render_batches_grouped_acc

    p = frame_params(run)
    render_batches_grouped_acc(run.state["scene"], g["xs"], g["ys"], g["key"], g["b0"],
                               g["acc"], g["rays"], width=p["width"], height=p["height"],
                               spp=p["spp"], max_bounces=p["max_bounces"], batch_px=g["bp"],
                               k_group=g["k"], method="auto", nee=p["nee"])


def extra_spans(run) -> list:
    return []


def release(run) -> None:
    run.state["scene"] = None


def cleanup(run) -> None:
    pass


def scene_positions(run) -> np.ndarray:
    """The triangles (n, 3, 3) float32, in the order the program gets them."""
    return run.state["parts"][0][0]


def frame_shape(run) -> tuple:
    p = frame_params(run)
    return p["height"], p["width"]


def reference_pixels(run, rec, batches, ft) -> dict:
    p = frame_params(run)
    (pos, nrm, uv, mat), textures, view = run.state["parts"]
    mats = [dict(m, **{f"tex_{name}": k + 1 if m["textured"] else -1
                       for k, name in enumerate(standin.MAPS)})
            for m in standin.STANDIN_MATERIALS]
    fov = np.float32(standin.FOV_DEG / 360.0 * 2.0 * np.pi)
    focal = np.float32(1.0 / np.tan(fov * 0.5))
    scene = ref_scene.build({"positions": pos, "normals": nrm, "uvs": uv, "mat_id": mat}, mats,
                            [*textures, run.state["env"]], len(textures) + 1, view, focal,
                            run.device, ft)
    if p["nee"]:
        ref_scene.with_env(scene, run.state["env"])
    out = ref_trace.render_batches(scene, rec["seed"], batches, width=p["width"],
                                   height=p["height"], spp=p["spp"],
                                   max_bounces=p["max_bounces"], nee=p["nee"])
    return {"ys": np.concatenate([o[1] for o in out.values()]),
            "xs": np.concatenate([o[0] for o in out.values()]),
            "rgb": np.concatenate([o[2] for o in out.values()])}


def program_pixels(run, rec, ref) -> np.ndarray:
    return np.asarray(rec["img"])[ref["ys"], ref["xs"]]
