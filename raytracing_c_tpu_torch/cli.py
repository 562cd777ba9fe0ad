"""Command-line renderer.

Counterpart of `raytracing_c_tpu/cli.py`, with the same flag surface
(driver.c:420-508):
  -W width -H height -S samples -T threads -B max_bounces -V -D
  -O output.(png|qoi|ppm) model.(obj|glb|gltf)
defaults 1024x1024, 16 spp, 8 bounces, output.png (driver.c:733-742), and
the double-dashed extensions --seed, --bg, --no-bg, --batch-pixels,
--brute-force, --method, --debug-normals, --tonemap, --profile, --nearest,
--rr, --nee, --save-scene, --load-scene. `main` renders on `device` (CUDA
unless the caller asks for the CPU) and, with -D, denoises the frame there
through the K3 kernel before its one read-back; a failure of the kernel is
fatal. --method takes the JAX package's names, mapped by
`ops/traverse.py:port_method`: every traversal to "bvh" (the exact K1
kernel), brute to the brute-force oracle. --profile
DIR records the whole run (load, env table, render, denoise, write) under
torch.profiler with the program's spans on (`utils/spans.py`) and writes
the chrome trace to DIR/trace.json: the layers (`load`, `decode`, `bvh`,
`render`, `batch`, `bounce`, `intersect`, `shade`, `sync`, ...) sit on the
timeline above the kernels they launch. The stages run
in the JAX CLI's order: --load-scene CACHE, else the model; then
--debug-normals; then --save-scene CACHE (the npz layout both packages
read, `models/serialization.py`); then the render. --nee (environment
next-event estimation with MIS) builds the env map's sampling table after
the load; -V prints its build time.

-T is accepted for CLI parity; device execution replaces host threads.
"""

from __future__ import annotations

import os
import sys
import time

def print_usage(prog: str) -> None:
    print(
        f"{prog} -W <width> -H <height> -S <samples> -T <threads> "
        "-B <max_bounces> <model.(obj|glb|gltf)> -O output.(qoi|png|ppm)",
        file=sys.stderr,
    )


def parse_args(argv: list[str]):
    cfg = {
        "width": 1024,
        "height": 1024,
        "samples": 16,
        "max_bounces": 8,
        "n_threads": 1,
        "verbose": False,
        "denoise": False,
        "output": "output.png",
        "model": None,
        "seed": 0,
        "background": "background.png",
        "batch_pixels": None,
        "brute_force": False,
        "debug_normals": False,
        "rr": False,
        "nee": False,
        "tonemap": None,
        "save_scene": None,
        "load_scene": None,
        "profile": None,
        "texture_mode": "bilinear",
        "method": None,  # --method: force a traversal method (default auto)
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-V":
            cfg["verbose"] = True
            i += 1
        elif a == "-D":
            cfg["denoise"] = True
            i += 1
        elif a in ("-W", "-H", "-S", "-T", "-B", "-O"):
            if i + 1 >= len(argv):
                return None
            v = argv[i + 1]
            key = {
                "-W": "width", "-H": "height", "-S": "samples",
                "-T": "n_threads", "-B": "max_bounces", "-O": "output",
            }[a]
            cfg[key] = v if a == "-O" else int(v)
            i += 2
        elif a == "--no-bg":
            cfg["background"] = None
            i += 1
        elif a in ("--seed", "--bg", "--batch-pixels", "--tonemap",
                   "--save-scene", "--load-scene", "--profile",
                   "--method"):
            if i + 1 >= len(argv):
                return None
            key = a[2:].replace("-", "_")
            if a == "--bg":
                key = "background"
            v = argv[i + 1]
            if a == "--method":
                # imported here: importing this module imports no torch
                from raytracing_c_tpu_torch.ops.traverse import JAX_METHODS

                if v not in ("auto", *JAX_METHODS):
                    print(f"unknown --method '{v}'", file=sys.stderr)
                    return None
            if a == "--tonemap" and v not in ("aces", "reinhard"):
                return None
            cfg[key] = int(v) if a in ("--seed", "--batch-pixels") else v
            i += 2
        elif a == "--brute-force":
            cfg["brute_force"] = True
            i += 1
        elif a == "--nearest":
            cfg["texture_mode"] = "nearest"
            i += 1
        elif a == "--debug-normals":
            cfg["debug_normals"] = True
            i += 1
        elif a == "--rr":
            cfg["rr"] = True
            i += 1
        elif a == "--nee":
            cfg["nee"] = True
            i += 1
        elif a.startswith("-"):
            return None
        else:
            if cfg["model"] is not None:
                return None
            cfg["model"] = a
            i += 1
    if cfg["model"] is None and cfg["load_scene"] is None:
        return None
    return cfg


def render_method(cfg: dict) -> str:
    """The port's render() method for the JAX CLI's --method/--brute-force."""
    from raytracing_c_tpu_torch.ops.traverse import port_method

    m = cfg["method"]
    if m is None:
        return "brute" if cfg["brute_force"] else "auto"
    return port_method(m)


def main(argv: list[str] | None = None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg = parse_args(argv)
    if cfg is None:
        print_usage(sys.argv[0])
        return 1
    if not cfg["profile"]:
        return _run(cfg, device)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracing_c_tpu_torch.utils import spans

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    was_on = spans.enabled()
    with profile(activities=acts) as prof:
        if not was_on:
            spans.enable()
        try:
            rc = _run(cfg, device)
        finally:
            if not was_on:
                spans.disable()
    os.makedirs(cfg["profile"], exist_ok=True)
    prof.export_chrome_trace(os.path.join(cfg["profile"], "trace.json"))
    return rc


def _run(cfg: dict, device) -> int:
    """The CLI's stages for a parsed config."""
    import dataclasses

    import torch

    from raytracing_c_tpu_torch.io.image_io import write_image
    from raytracing_c_tpu_torch.io.loader import load_scene
    from raytracing_c_tpu_torch.models import serialization
    from raytracing_c_tpu_torch.models.scene import SHADER_DEBUG_NORMAL
    from raytracing_c_tpu_torch.ops import env_light
    from raytracing_c_tpu_torch.ops.denoise import denoise_u8
    from raytracing_c_tpu_torch.render.renderer import render
    from raytracing_c_tpu_torch.utils import spans
    from raytracing_c_tpu_torch.utils.progress import ProgressBar

    warn = print if cfg["verbose"] else (lambda *a, **k: None)

    t0 = time.perf_counter()
    if cfg["load_scene"]:
        scene = serialization.load_scene_cache(cfg["load_scene"], device=device)
    else:
        try:
            scene = load_scene(cfg["model"], background_path=cfg["background"], warn=warn,
                               device=device)
        except FileNotFoundError as e:
            # missing env map is fatal, matching the reference's load_texture
            # error surface (driver.c:106-116)
            print(e, file=sys.stderr)
            return 1
    bvh_ms = (time.perf_counter() - t0) * 1e3
    dev = scene.device

    if cfg["debug_normals"]:
        mats = scene.materials
        kind = torch.full_like(mats.shader_kind, SHADER_DEBUG_NORMAL)
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(mats, shader_kind=kind).with_rows())

    if cfg["save_scene"]:
        serialization.save_scene_cache(cfg["save_scene"], scene)
        if cfg["verbose"]:
            print(f"scene cache written to {cfg['save_scene']}")

    if cfg["nee"]:
        t0 = time.perf_counter()
        env = env_light.scene_env_light(scene)
        if cfg["verbose"] and env is not None:
            print(f"Env light table built in {(time.perf_counter() - t0) * 1e3:.0f}ms "
                  f"({env.w}x{env.h} texels)")

    if cfg["verbose"]:
        print(f"Bvh generated in {bvh_ms:.0f}ms")
        print(f"Width:     {cfg['width']}")
        print(f"Height:    {cfg['height']}")
        print(f"Samples:   {cfg['samples']}")
        print(f"Bounces:   {cfg['max_bounces']}")
        print(f"Threads:   {cfg['n_threads']} (ignored: device execution)")
        print(f"BVH-Nodes: {scene.bvh.n_internal}")
        print(f"BVH-Depth: {scene.bvh.depth}")
        print(f"Triangles: {scene.n_triangles}")
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"Devices:   {dev} ({name})")
        print()

    bar = ProgressBar()
    img, stats = render(
        scene,
        cfg["width"],
        cfg["height"],
        spp=cfg["samples"],
        max_bounces=cfg["max_bounces"],
        seed=cfg["seed"],
        batch_pixels=cfg["batch_pixels"],
        method=render_method(cfg),
        texture_mode=cfg["texture_mode"],
        progress=bar,
        rr=cfg["rr"],
        nee=cfg["nee"],
        tonemap=cfg["tonemap"],
        to_host=False,
    )
    bar.finish()

    # --tonemap is applied on the float radiance inside the render
    # (renderer._batch_core), matching the reference's hook placement
    # before clamp+encode (raytracer.c:701), not on quantized u8.
    print(f"{stats.wall_ms:.0f}ms")
    if cfg["verbose"]:
        print(f"{stats.samples_per_sec:.0f} samples/second")
        print(f"{stats.mrays_per_sec:.2f} Mrays/second "
              f"({stats.rays_traced} rays traced)")

    if cfg["denoise"]:
        t0 = time.perf_counter()
        img = denoise_u8(img)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"Denoising: {(time.perf_counter() - t0) * 1e3:.0f}ms")

    t0 = time.perf_counter()
    with spans.span("readback"):
        host = img.cpu().numpy()
    write_image(cfg["output"], host, warn=print)
    if cfg["verbose"]:
        print(f"Output file written in {(time.perf_counter() - t0) * 1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
