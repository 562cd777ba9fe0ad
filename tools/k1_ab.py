#!/usr/bin/env python3
"""K1 and K3 of this tree against those of another checkout, on one GPU.

    python3 tools/k1_ab.py --parent DIR [--out DIR] [--reps N]

DIR holds a checkout of the commit to compare with (made with
`git archive <commit> | tar -x -C DIR`). Its package is imported beside
this tree's (`other_package`), so that its own wrappers,
`ops/traverse_cuda.py: bvh_traverse` and `ops/denoise.py: denoise_u8`,
build and launch its own kernels through its own C interface; they must
take the arguments this tree's wrappers take.

1. compiles both trees' csrc/*.cu with the package's nvcc flags plus
   -Xptxas -v, all at once, and prints what ptxas says of each kernel
   (registers, stack frame, spills);
2. on chip_smoke.py's K1 ray sets (camera and random rays on the
   procedural helmet stand-in and on the soup, 262,144 each, the live
   rays entering bounces 1-7 of the image-centre batch, and the NEE shadow
   rays of its bounces 0 and 1 under the env map): the hits of the
   other tree's K1 and of both of this tree's K1 kernels (one thread per
   ray, eight lanes per ray, whatever the launch's size) against the
   brute-force oracle, then the device ms per launch (torch.profiler, L2
   emptied before each launch, as chip_smoke.device_ms) in turns parent,
   thread, wide, wide, thread, parent, each timed as the main path runs
   it (fused epilogue on camera rays), and the bound (utils/bounds.py
   k1_work) with each kernel's share. "auto" names the kernel the wrapper
   picks for the set's size;
3. K3 the same way on chip_smoke's 1920x1080 firefly image.

Prints one JSON object per line; writes them all to DIR/k1_ab.json.
"""

from __future__ import annotations

import copy
import glob
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PKG = "raytracing_c_tpu_torch"


def ptxas_report(cuda_build, trees: dict, out_dir: str, emit) -> None:
    """Compile every csrc/*.cu of each tree with -Xptxas -v, all nvcc at
    once, and emit ptxas' lines per kernel (the libraries are not used)."""
    jobs = []
    for label, tree in trees.items():
        os.makedirs(os.path.join(out_dir, f"ptxas_{label}"), exist_ok=True)
        for src in sorted(glob.glob(os.path.join(tree, PKG, "csrc", "*.cu"))):
            stem = os.path.splitext(os.path.basename(src))[0]
            so = os.path.join(out_dir, f"ptxas_{label}", f"lib{stem}.so")
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, src]
            jobs.append((label, stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for label, stem, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {label} {stem} failed:\n{out}{err}")
        said = [ln.strip() for ln in (out + err).splitlines()
                if "entry function" in ln or "stack frame" in ln or "Used" in ln]
        emit({"view": "ptxas", "tree": label, "source": stem, "lines": said})


def other_package(tree: str) -> dict:
    """The K1 and K3 wrapper modules of the package in `tree`, imported
    under the package's own name with this tree's modules set aside, then
    put back: the other modules keep their own imports, so each builds and
    loads its own kernels."""
    ours = {k: m for k, m in sys.modules.items() if k == PKG or k.startswith(PKG + ".")}
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, os.path.abspath(tree))
    try:
        return {m: importlib.import_module(f"{PKG}.ops.{m}") for m in ("traverse_cuda", "denoise")}
    finally:
        sys.path.remove(os.path.abspath(tree))
        for k in [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]:
            del sys.modules[k]
        sys.modules.update(ours)


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.ops import cuda_build
    from raytracing_c_tpu_torch.ops import denoise as dn
    from raytracing_c_tpu_torch.ops import env_light
    from raytracing_c_tpu_torch.ops import traverse_cuda as tc
    from raytracing_c_tpu_torch.utils import bounds

    if not torch.cuda.is_available() or "--parent" not in argv:
        print("k1_ab: needs an NVIDIA GPU and --parent DIR", file=sys.stderr)
        return 2
    parent = argv[argv.index("--parent") + 1]
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else "."
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 20
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"view": "gpu", "gpu": cs._gpu_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    ptxas_report(cuda_build, {"parent": parent, "new": ROOT}, out_dir, emit)
    other = other_package(parent)
    bvhs = {}

    def parent_k1(o, d, scene, fuse):
        """The other tree's K1 wrapper, on a copy of the BVH that lacks this
        tree's cached K1 tables."""
        if id(scene.bvh) not in bvhs:
            bvhs[id(scene.bvh)] = b = copy.copy(scene.bvh)
            vars(b).pop("_k1_tables", None)
        return other["traverse_cuda"].bvh_traverse(o, d, scene.triangles, bvhs[id(scene.bvh)],
                                                   fuse_attr=fuse)

    def errors(got, want):
        hit = want["tri"] >= 0
        bad = int((got["tri"] != want["tri"]).sum())
        if not bool(hit.any()):
            return bad, 0.0
        err = max(float((got[k] - want[k])[hit].abs().max()) for k in ("t", "u", "v"))
        err = max(err, float((got["attrs"] - want["attrs"])[:, hit].abs().max()))
        return bad, err

    dev = torch.device("cuda", 0)
    scene_d = cs.procedural_scene(ps, np, torch, dev)
    soup_d = cs.soup_scene(ps, np, dev)
    scene_env = cs.with_env_map(ps, torch, scene_d, cs.make_env_map())
    env_light.scene_env_light(scene_env)
    sets, shadow_sets, _ = cs.k1_ray_sets(scene_d, soup_d, scene_env, dev)
    sets += shadow_sets
    ok = True

    def ours(kernel, o, d, sc, fuse):
        """This tree's K1 wrapper held on one kernel."""
        keep = tc.WIDE_BELOW
        tc.WIDE_BELOW = 0 if kernel == "thread" else 2**31
        try:
            return tc.bvh_traverse(o, d, sc.triangles, sc.bvh, fuse_attr=fuse)
        finally:
            tc.WIDE_BELOW = keep

    for label, sc, o, d, fuse in sets:
        want = tc.bvh_traverse_plain(o, d, sc.triangles, fuse_attr=True)
        got = {"parent": parent_k1(o, d, sc, True), "thread": ours("thread", o, d, sc, True),
               "wide": ours("wide", o, d, sc, True)}
        torch.cuda.synchronize()
        checked = {k: errors(g, want) for k, g in got.items()}
        ok &= all(checked[k] == (0, 0.0) for k in ("thread", "wide"))
        runs = {"parent": lambda: parent_k1(o, d, sc, fuse),  # noqa: B023
                "thread": lambda: ours("thread", o, d, sc, fuse),  # noqa: B023
                "wide": lambda: ours("wide", o, d, sc, fuse)}  # noqa: B023
        ms = {k: [] for k in runs}
        for who in ("parent", "thread", "wide", "wide", "thread", "parent"):
            ms[who].append(cs.device_ms(torch, runs[who], reps, "bvh_traverse"))
        work = bounds.k1_work(sc, o, d, epilogue=fuse)
        b = bounds.bound(work)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        emit({"view": "k1", "set": label, "rays": o.shape[0], "epilogue": fuse,
              "auto": "wide" if o.shape[0] < tc.WIDE_BELOW else "thread",
              "tri_mismatch": {k: v[0] for k, v in checked.items()},
              "max_abs_err": {k: v[1] for k, v in checked.items()},
              "device_ms": ms, "mean_ms": mean,
              "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
              "share": {k: b["bound_ms"] / v for k, v in mean.items()},
              **{k: work[k] for k in work if k.endswith("_per_ray")}})

    fire, _ = cs.firefly_image(np, cs.HEIGHT, cs.WIDTH)
    x = torch.from_numpy(fire).to(dev)

    def parent_k3():
        return other["denoise"].denoise_u8(x)

    want = dn.denoise_u8_plain(x)
    got_new, got_old = dn.denoise_u8(x), parent_k3()
    torch.cuda.synchronize()
    diff = {k: int((g.int() - want.int()).abs().max()) for k, g in
            (("new", got_new), ("parent", got_old))}
    ok &= diff["new"] == 0
    runs = {"parent": parent_k3, "new": lambda: dn.denoise_u8(x)}
    ms = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        ms[who].append(cs.device_ms(torch, runs[who], reps * 2, "denoise_u8_kernel"))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    b = bounds.bound(bounds.k3_work(cs.HEIGHT, cs.WIDTH))
    emit({"view": "k3", "image": f"fireflies {cs.WIDTH}x{cs.HEIGHT}", "max_abs_err": diff,
          "device_ms": ms, "mean_ms": mean, "speedup": mean["parent"] / mean["new"],
          "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
          "share": {k: b["bound_ms"] / v for k, v in mean.items()}})
    emit({"view": "ok", "ok": bool(ok)})
    with open(os.path.join(out_dir, "k1_ab.json"), "w") as f:
        json.dump(lines, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
