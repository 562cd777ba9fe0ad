#!/usr/bin/env python3
"""Render the PyTorch port's 16-spp parity references with the JAX package
on the CPU.

    python tools/make_torch_parity_refs.py [--port-cpu]

Writes chip_smoke.py's parity scene (`write_parity_scene`: the helmet.glb
stand-in as standin.glb and as standin.obj/.mtl with PNG textures, and a
512x256 equirect env.png) into a temporary directory, then renders each
case of `chip_smoke.PARITY_CASES` through the JAX package (raytracing_c_tpu)
with seed 42, the reference, and seed 43, whose PSNR against seed 42 is the
case's noise floor:

- "cli" cases through `raytracing_c_tpu.cli.main(argv)` run in that
  directory, their PNG written by the JAX CLI's own writer;
- "render" (glb_dense) through `render/renderer.py:render`, written with
  the JAX package's `write_image`;
- "bake_lightmap" through `render/lightmap.py:bake_lightmap`, saved as
  float32 .npy.

Output goes to tests/goldens_torch16/: <case>.png and <case>_alt.png (or
.npy), and manifest.json with the writers' parameters, the sha256 of every
scene file, and per case its entry point and arguments, the image shape,
the seed-42-vs-seed-43 PSNR (floor_db) and the JAX wall seconds of each
render (the first render of a case includes its XLA compile). --port-cpu
renders nothing with JAX: it runs the cases through the port on the CPU
(chip_smoke.run_parity_case, seed 42) and prints each one's PSNR against
its reference, the share of byte-equal pixels and the wall seconds.

chip_smoke.py phase 11 renders the same cases through the port on a GPU
and holds each to its reference; tests/test_torch_parity.py checks the
files and the gate's code on the CPU. This is the one file beside the
tests that imports both JAX and the port (the port's PNG codec writes the
scene's textures).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import platform
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from raytracing_c_tpu import cli as jcli  # noqa: E402
from raytracing_c_tpu.io.image_io import load_image_rgb_u8, write_image  # noqa: E402
from raytracing_c_tpu.io.loader import load_scene  # noqa: E402
from raytracing_c_tpu.render.lightmap import bake_lightmap  # noqa: E402
from raytracing_c_tpu.render.renderer import render  # noqa: E402


def render_jax(case: str, scene_dir: str, seed: int, out_dir: str) -> np.ndarray:
    """One case through the JAX package; writes its file and returns the
    image or lightmap."""
    spec = chip_smoke.PARITY_CASES[case]
    out = os.path.join(out_dir, chip_smoke.parity_file(case, seed))
    if spec["entry"] == "cli":
        old = os.getcwd()
        os.chdir(scene_dir)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = jcli.main([*spec["argv"], "--seed", str(seed), "-O", out])
        finally:
            os.chdir(old)
        if rc != 0:
            raise RuntimeError(f"{case}: the JAX CLI exited {rc}")
        return load_image_rgb_u8(out)
    scene = load_scene(os.path.join(scene_dir, spec["model"]), background_path=None,
                       warn=lambda *a, **k: None)
    if spec["entry"] == "render":
        img = render(scene, seed=seed, **spec["kwargs"])[0]
        write_image(out, img)
        return img
    lm = bake_lightmap(scene, seed=seed, **spec["kwargs"])
    np.save(out, lm)
    return lm


def port_cpu() -> int:
    """The port on the CPU against the checked-in references."""
    seed = chip_smoke.PARITY_SEEDS[0]
    with tempfile.TemporaryDirectory(prefix="parity_port_") as tmp:
        scene_dir = os.path.join(tmp, "scene")
        os.makedirs(scene_dir)
        chip_smoke.write_parity_scene(scene_dir)
        for case in chip_smoke.PARITY_CASES:
            path = os.path.join(chip_smoke.PARITY_DIR, chip_smoke.parity_file(case, seed))
            ref = np.load(path) if path.endswith(".npy") else load_image_rgb_u8(path)
            t0 = time.perf_counter()
            got = chip_smoke.run_parity_case(case, scene_dir, seed, tmp, device="cpu")
            wall = time.perf_counter() - t0
            print(f"{case}: port on the CPU PSNR={chip_smoke.parity_psnr(np, got, ref):.2f} dB "
                  f"byte_equal={float((got == ref).all(-1).mean()):.5f} wall_s={wall:.2f}",
                  flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-cpu", action="store_true",
                    help="hold the port on the CPU to the references; render no refs")
    args = ap.parse_args(argv)
    if args.port_cpu:
        return port_cpu()
    out_dir = chip_smoke.PARITY_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "manifest.json")
    manifest = {"cases": {}}

    with tempfile.TemporaryDirectory(prefix="parity_scene_") as scene_dir:
        t0 = time.perf_counter()
        sha = chip_smoke.write_parity_scene(scene_dir)
        print(f"scene written in {time.perf_counter() - t0:.1f} s: {sorted(sha)}", flush=True)
        manifest.update({
            "generator": "tools/make_torch_parity_refs.py",
            "reference": f"raytracing_c_tpu (JAX {jax.__version__}, "
                         f"{jax.default_backend()}), numpy {np.__version__}",
            "host": f"{platform.machine()}, {os.cpu_count()} CPUs",
            "seeds": list(chip_smoke.PARITY_SEEDS),
            "bound_db": chip_smoke.PSNR_MIN,
            "scene": {"writers": chip_smoke.PARITY_SCENE, "sha256": sha},
        })
        for case in chip_smoke.PARITY_CASES:
            walls, imgs = [], []
            for seed in chip_smoke.PARITY_SEEDS:
                t0 = time.perf_counter()
                imgs.append(render_jax(case, scene_dir, seed, out_dir))
                walls.append(round(time.perf_counter() - t0, 3))
                print(f"{case} seed {seed}: {walls[-1]:.1f} s", flush=True)
            ref, alt = imgs
            manifest["cases"][case] = {
                **chip_smoke.PARITY_CASES[case],
                "files": [chip_smoke.parity_file(case, s) for s in chip_smoke.PARITY_SEEDS],
                "shape": list(ref.shape), "dtype": str(ref.dtype),
                "floor_db": round(chip_smoke.parity_psnr(np, alt, ref), 4),
                "jax_wall_s": walls,
            }
            print(f"{case}: shape {ref.shape}, floor "
                  f"{manifest['cases'][case]['floor_db']:.2f} dB", flush=True)
            with open(path, "w") as f:
                json.dump(manifest, f, indent=1)
                f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
