"""Entry `lightmap`: whole lightmap bakes through the library,
`raytracing_c_tpu_torch.render.lightmap.bake_lightmap(scene, width,
height, samples=, max_bounces=, seed=, batch_texels=)`, on the Sponza
stand-in (`harness/sponza_standin.py`) with lightmap UVs made from its
triangles (`harness/lightmap_atlas.py`), under the rolled equirect sky.
A frame is one bake, ending with the float32 lightmap on the host; the
frames are timed as render() frames are, so set-up tells the readers so
(`run.config["entry"]`, which `metrics/frame_s.py` reads).

Set-up makes the stand-in, the sky and the UVs from the seed, builds the
program's scene with its lightmap UV set, rasterizes the atlas with the
plain reference (`reference/lightmap.py`, kept for the check) and prints
the tree and the atlas (charts, texels a metre, covered texels, texels
written by two charts), and warms up with one group: k_group texel
batches at the bake's centre through `lightmap.bake_batches`, the loop
the bake runs. `n_batches` counts texel batches. The check compares the
program's map at the texels of the reference's two sampled batches (the
records that are their texel's last write) with the reference's, both
scaled by the configuration's `exposure` and written by the reference's
u8 encode.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from entries import sponza as _sponza
from harness import lightmap_atlas
from harness import sponza_standin as ss
from reference import lightmap as ref_lightmap
from reference import scene as ref_scene
from reference import shade as ref_shade

cleanup, tree_shape = _sponza.cleanup, _sponza.tree_shape


def bake_params(run) -> dict:
    p = dict(run.config["bake"])
    p.update(run.traffic.get("bake", {}))
    return p


def make_inputs(run) -> None:
    """The stand-in, the sky and the lightmap UVs from the run's seed
    (run.state)."""
    s, p = run.config["scene"], bake_params(run)
    parts = ss.sponza_parts(run.seed, s["triangles"], s["texture"])
    uvs, atlas = lightmap_atlas.atlas_uvs(parts[0][0], p["width"], p["height"])
    run.state = {"parts": parts, "env": ss.sponza_env(s["env_width"], s["env_height"], run.seed),
                 "lightmap_uvs": uvs, "atlas": atlas}


def build(run):
    """The program's scene of the stand-in with its lightmap UV set, on
    the run's device."""
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
    mesh = ps.HostMesh(pos, nrm, uv, mat, lightmap_uvs=run.state["lightmap_uvs"])
    return ps.build_scene(mesh, table, ps.TextureAtlas.pack([*textures, run.state["env"]]),
                          ps.Background.equirect(len(textures) + 1),
                          ps.Camera.look(view, ss.FOV_DEG), device=run.device)


def ref_texels(run) -> dict:
    """The reference's rasterization of the atlas (cached on run.state),
    with each record's chart and whether it is its texel's last write."""
    got = run.state.get("ref_texels")
    if got is None:
        (pos, nrm, _, _), _, _ = run.state["parts"]
        p = bake_params(run)
        slot_map = ref_lightmap.slot_map(pos)
        slots = slot_map[slot_map >= 0]
        got = ref_lightmap.rasterize(pos, nrm, run.state["lightmap_uvs"], slots, p["width"],
                                     p["height"])
        got["last"] = ref_lightmap.last_writes(got["index"])
        got["chart"] = run.state["atlas"]["chart"][slots][got["tri"]]
        run.state["ref_texels"] = got
    return got


def n_batches(run) -> int:
    return -(-len(ref_texels(run)["index"]) // bake_params(run)["batch_texels"])


def setup(run) -> None:
    # the frames are whole bakes, timed as render() frames are: frame_s reads them
    run.config["entry"] = "render"
    make_inputs(run)
    scene = run.state["scene"] = build(run)
    say = lambda text: print("lightmap: " + text, file=sys.stderr)  # noqa: E731
    say("tree: " + ", ".join(f"{k} {v}" for k, v in tree_shape(scene).items()))
    ref = ref_texels(run)
    a = run.state["atlas"]
    say(f"atlas {bake_params(run)['width']}x{bake_params(run)['height']}: charts {a['charts']}, "
        f"texels a metre {a['texels_per_m']:.4f}, fill {a['fill']:.4f}, texel records "
        f"{len(ref['index'])}, covered texels {len(np.unique(ref['index']))}, written by two "
        f"charts {lightmap_atlas.cross_chart_texels(ref['index'], ref['chart'])}")
    group(run, prepare_group(run))
    run.sync()


def frame(run, seed: int) -> dict:
    from raytracing_c_tpu_torch.render.lightmap import bake_lightmap

    p = bake_params(run)
    stats = {}
    t = time.perf_counter()
    lm = bake_lightmap(run.state["scene"], p["width"], p["height"], samples=p["samples"],
                       max_bounces=p["max_bounces"], seed=seed, batch_texels=p["batch_texels"],
                       stats=stats)
    return {"seed": seed, "lightmap": lm, "rays": stats["rays"], "texels": stats["covered"],
            "wall_ms": (time.perf_counter() - t) * 1e3}


def prepare_group(run):
    """The program's texel records and the centre group of k_group texel
    batches, a map to write and the bake's key, made outside any timed or
    traced span."""
    from raytracing_c_tpu_torch.render import lightmap
    from raytracing_c_tpu_torch.utils import rng

    p = bake_params(run)
    texels = lightmap.rasterize(run.state["scene"], p["width"], p["height"])
    nb = -(-len(texels) // p["batch_texels"])
    k = min(run.config["k_group"], nb)
    return {"texels": texels, "b0": (nb - k) // 2, "k": k,
            "map": np.zeros((p["width"] * p["height"], 3), np.float32),
            "key": rng.prng_key(run.seed % 2**32, run.device)}


def group(run, g) -> None:
    from raytracing_c_tpu_torch.render import lightmap

    p = bake_params(run)
    lightmap.bake_batches(run.state["scene"], g["texels"], g["map"], g["key"],
                          range(g["b0"], g["b0"] + g["k"]), samples=p["samples"],
                          max_bounces=p["max_bounces"], batch_texels=p["batch_texels"],
                          method="auto")


def extra_spans(run) -> list:
    return []


def _report(run) -> None:
    """What the traced pass saw of the bake, on stderr."""
    host = (getattr(run, "span_pass", None) or {}).get("host") or []
    for r in host:
        if r["name"] in ("bake", "rasterize"):
            print(f"lightmap: {r['name']} span: "
                  + ", ".join(f"{k} {v}" for k, v in r["attrs"].items())
                  + f", {(r['end'] - r['start']) / 1e9:.3f} s", file=sys.stderr)


def release(run) -> None:
    _report(run)
    run.state["scene"] = None


def scene_positions(run) -> np.ndarray:
    """The triangles (n, 3, 3) float32, in the order the program gets them."""
    return run.state["parts"][0][0]


def _encode(values: torch.Tensor, run) -> np.ndarray:
    """The configuration's exposure, then the reference's u8 write."""
    return ref_shade.encode_u8(values * run.config["exposure"]).cpu().numpy()


def reference_pixels(run, rec, batches, ft) -> dict:
    p = bake_params(run)
    (pos, nrm, uv, mat), textures, view = run.state["parts"]
    fov = np.float32(ss.FOV_DEG / 360.0 * 2.0 * np.pi)
    scene = ref_scene.build({"positions": pos, "normals": nrm, "uvs": uv, "mat_id": mat},
                            ss.material_rows(), [*textures, run.state["env"]],
                            len(textures) + 1, view, np.float32(1.0 / np.tan(fov * 0.5)),
                            run.device, ft)
    ref = ref_texels(run)
    out = ref_lightmap.bake_batches(scene, ref, rec["seed"], batches, samples=p["samples"],
                                    max_bounces=p["max_bounces"],
                                    batch_texels=p["batch_texels"])
    texels, values = [], []
    for b, (index, vals) in out.items():
        keep = ref["last"][b * p["batch_texels"]:b * p["batch_texels"] + len(index)]
        texels.append(index[keep])
        values.append(vals[keep])
    values = np.concatenate(values)
    rgb = _encode(torch.from_numpy(values).to(ft), run)
    if ft == torch.float32:
        print(f"lightmap check: {len(rgb)} texels of batches {list(out)}, channels at 255 "
              f"{float((rgb == 255).mean()):.6f}, irradiance quantiles 0.5/0.9/0.99 "
              f"{np.quantile(values, [0.5, 0.9, 0.99]).round(5).tolist()}", file=sys.stderr)
    return {"texels": np.concatenate(texels), "rgb": rgb}


def program_pixels(run, rec, ref) -> np.ndarray:
    got = rec["lightmap"].reshape(-1, 3)[ref["texels"]]
    return _encode(torch.from_numpy(np.ascontiguousarray(got)), run)
