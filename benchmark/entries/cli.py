"""Entry `cli`: whole frames through the command line,
`raytracing_c_tpu_torch.cli.main(argv)` in the run's own process, its
output captured. Each call loads the GLB (images decoded, BVH and K1's
tables built), reads the env map, builds the env-light table with --nee,
renders with a progress bar (so through `render_batches_grouped`, each
batch scattered into the frame), denoises with -D and writes the PNG.

Set-up makes the stand-in and the env map from the seed and writes them
as `standin.glb` and `background.png` in a directory of the run's own
under TMPDIR (removed when the run ends),
then warms up what the frames run: the loader, the env table, one
render() of the first batch with a progress callback, one group of
k_group batches at the centre rows through `render_batches_grouped`, and
the denoiser on a frame of the cell's size.

The traffic file gives the argv, with {seed}, {bg}, {out} and {model}
filled in per frame; the flags -W, -H, -S, -B, -D and --nee are read from
it (over the CLI defaults the configuration states) for the reference and
the traced group. Frame i writes out_<i>.png; the check decodes the
sampled frame's file with the benchmark's own PNG decoder.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile

import numpy as np
import torch

from harness import png, runner, standin
from reference import gltf
from reference import scene as ref_scene
from reference import trace as ref_trace

_FLAGS = {"-W": "width", "-H": "height", "-S": "spp", "-B": "max_bounces"}
_KNOWN = {"-V", "-D", "--nee", "--seed", "--bg", "-O", "-W", "-H", "-S", "-B"}
_LINES = {
    "wall_ms": r"^(\d+)ms$",
    "rays": r"\((\d+) rays traced\)",
    "load_ms": r"Bvh generated in (\d+)ms",
    "env_table_ms": r"Env light table built in (\d+)ms",
    "write_ms": r"Output file written in (\d+)ms",
    "denoise_ms": r"Denoising: (\d+)ms",
}


def frame_params(run) -> dict:
    p = dict(run.config["cli_defaults"])
    argv = run.traffic["argv"]
    p["nee"] = "--nee" in argv
    p["denoise"] = "-D" in argv
    for j, a in enumerate(argv):
        if a.startswith("-") and a not in _KNOWN:
            raise ValueError(f"cli entry: the reference cannot follow flag {a!r}")
        if a in _FLAGS:
            p[_FLAGS[a]] = int(argv[j + 1])
    return p


def n_batches(run) -> int:
    p = frame_params(run)
    return ref_trace.batch_layout(p["width"], p["height"], p["spp"])[1]


def _load(run):
    from raytracing_c_tpu_torch.io.loader import load_scene
    from raytracing_c_tpu_torch.ops import env_light

    st = run.state
    scene = load_scene(st["model"], background_path=st["bg"], warn=lambda *a, **k: None,
                       device=run.device)
    if frame_params(run)["nee"]:
        env_light.scene_env_light(scene)
    return scene


def make_inputs(run, write: bool = False) -> None:
    """The stand-in, the env map and what the GLB holds, from the run's
    seed (run.state); with write, the GLB and background.png too."""
    p = frame_params(run)
    s = run.config["scene"]
    parts = standin.standin_parts(run.seed, s["sphere_quads"], s["texture"])
    env = standin.make_env_map(s["env_width"], s["env_height"], run.seed)
    run.state = {"parts": parts, "env": env, "dir": None}
    if not write:
        run.state["desc"] = standin.glb_document(parts, p["width"] / p["height"])
        return
    d = run.state["dir"] = tempfile.mkdtemp(prefix="helmet_bench_")
    model, bg = os.path.join(d, "standin.glb"), os.path.join(d, "background.png")
    run.state.update(model=model, bg=bg)
    run.state["desc"] = standin.write_glb(model, parts, p["width"] / p["height"])
    standin.write_png(bg, env)


def setup(run) -> None:
    from raytracing_c_tpu_torch.ops.denoise import denoise_u8
    from raytracing_c_tpu_torch.render.renderer import render

    p = frame_params(run)
    make_inputs(run, write=True)
    scene = _load(run)
    render(scene, p["width"], p["height"], spp=p["spp"], max_bounces=p["max_bounces"], seed=0,
           nee=p["nee"], limit_batches=1, progress=lambda done, total: None)
    g = prepare_group(run, scene)
    group(run, g)
    if p["denoise"]:
        denoise_u8(torch.zeros((p["height"], p["width"], 3), dtype=torch.uint8,
                               device=run.device))
    run.sync()


def frame(run, seed: int) -> dict:
    from raytracing_c_tpu_torch import cli

    st = run.state
    out = os.path.join(st["dir"], f"out_{len(run.frames)}.png")
    argv = [a.format(seed=seed, bg=st["bg"], out=out, model=st["model"])
            for a in run.traffic["argv"]]
    rc, text = runner.capture_stdout(cli.main, argv, device=run.device)
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}:\n{text[-2000:]}")
    rec = {"seed": seed, "out": out}
    for k, pat in _LINES.items():
        m = re.search(pat, text, re.M)
        if m:
            rec[k] = int(m.group(1))
    return rec


def prepare_group(run, scene=None) -> dict:
    p = frame_params(run)
    bp, nb, pad = ref_trace.batch_layout(p["width"], p["height"], p["spp"])
    xs, ys, order = ref_trace.pixel_tables(p["width"], p["height"], pad)
    dev = run.device
    k = min(run.config["k_group"], nb)
    return {"scene": scene if scene is not None else _load(run),
            "xs": torch.from_numpy(xs).to(dev), "ys": torch.from_numpy(ys).to(dev),
            "perm": torch.from_numpy(order).to(dev), "b0": (nb - k) // 2,
            "bp": bp, "k": k,
            "frame": torch.zeros((p["width"] * p["height"], 3), dtype=torch.uint8, device=dev),
            "key": torch.tensor([0, run.seed % 2**32], dtype=torch.int64, device=dev)}


def group(run, g) -> None:
    """One group of the CLI's batch loop: render_batches_grouped, then
    each batch scattered into the frame."""
    from raytracing_c_tpu_torch.render.renderer import render_batches_grouped

    p = frame_params(run)
    rgb, _ = render_batches_grouped(g["scene"], g["xs"], g["ys"], g["key"], g["b0"],
                                    width=p["width"], height=p["height"], spp=p["spp"],
                                    max_bounces=p["max_bounces"], batch_px=g["bp"],
                                    k_group=g["k"], method="auto", nee=p["nee"])
    n = p["width"] * p["height"]
    for j in range(g["k"]):
        lo = (g["b0"] + j) * g["bp"]
        hi = min(lo + g["bp"], n)
        g["frame"][g["perm"][lo:hi]] = rgb[j, :hi - lo]


#: launches of the denoiser in the traced span, each cold; K3's time is
#: the mean over the records the profiler keeps
DENOISE_LAUNCHES = 5
#: bytes written between two launches to empty the L2 cache (50 MB on an H100)
L2_FLUSH_BYTES = 256 * 2**20


def extra_spans(run) -> list:
    """The denoiser on the window's last frame (-D only), DENOISE_LAUNCHES
    times, as the CLI launches it once a frame: each launch on its own copy
    of the image, made before the span, with the L2 cache emptied before
    it."""
    from raytracing_c_tpu_torch.ops.denoise import denoise_u8

    if not frame_params(run)["denoise"]:
        return []
    with open(run.frames[-1]["out"], "rb") as f:
        img = torch.from_numpy(png.decode(f.read())).to(run.device)
    copies = [img.clone() for _ in range(DENOISE_LAUNCHES)]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=run.device)

    def launches():
        for k, c in enumerate(copies):
            flush.fill_(k)
            denoise_u8(c)
        flush.fill_(0)  # no K3 record ends at the span's edge

    return [("denoise", launches)]


def release(run) -> None:
    pass


def cleanup(run) -> None:
    if run.state["dir"] is not None:
        shutil.rmtree(run.state["dir"], ignore_errors=True)


def scene_positions(run) -> np.ndarray:
    """The triangles (n, 3, 3) float32 as glTF's rules place them, in the
    order of the file's primitives."""
    return gltf.scene_inputs(run.state["desc"], len(run.state["parts"][1]))[0]["positions"]


def frame_shape(run) -> tuple:
    p = frame_params(run)
    return p["height"], p["width"]


def reference_pixels(run, rec, batches, ft) -> dict:
    p = frame_params(run)
    st = run.state
    textures = [*st["parts"][1], st["env"]]
    mesh, mats, view, focal = gltf.scene_inputs(st["desc"], len(st["parts"][1]))
    scene = ref_scene.build(mesh, mats, textures, len(textures), view, focal, run.device, ft)
    if p["nee"]:
        ref_scene.with_env(scene, st["env"])
    out = ref_trace.render_batches(scene, rec["seed"], batches, width=p["width"],
                                   height=p["height"], spp=p["spp"],
                                   max_bounces=p["max_bounces"], nee=p["nee"])
    h, w = p["height"], p["width"]
    canvas = np.zeros((h, w, 3), np.uint8)
    known = np.zeros((h, w), bool)
    for xs, ys, rgb in out.values():
        canvas[ys, xs] = rgb
        known[ys, xs] = True
    if p["denoise"]:
        img = ref_trace.denoise_u8(torch.from_numpy(canvas).to(run.device), ft).cpu().numpy()
        # a pixel is judged where its whole edge-clamped 3x3 neighbourhood
        # was rendered
        k = np.pad(known, 1, mode="edge")
        valid = np.ones_like(known)
        for dy in range(3):
            for dx in range(3):
                valid &= k[dy:dy + h, dx:dx + w]
    else:
        img, valid = canvas, known
    ys, xs = np.nonzero(valid)
    return {"ys": ys, "xs": xs, "rgb": img[ys, xs]}


def program_pixels(run, rec, ref) -> np.ndarray:
    with open(rec["out"], "rb") as f:
        return png.decode(f.read())[ref["ys"], ref["xs"]]
