#!/usr/bin/env python3
"""Where one render batch of the PyTorch port spends its time, on a GPU.

    python3 tools/torch_profile.py [--out DIR]

Renders the batch holding the image centre of chip_smoke.py's main path
(1920x1080, 16 spp -> 262,144 camera samples, 8 bounces, the procedural
helmet stand-in) three ways:

1. plain: wall seconds of the batch, rays traced, Mrays/s;
2. layers: the same batch with a synchronize around each layer
   (raygen, rng, intersect [K1], attrs [K2 / epilogue], shade, background,
   compaction and the rest), so each layer's time includes its own launch
   overhead; the sum exceeds the plain wall by the lost overlap;
3. torch.profiler: device time by kernel, and the device busy share of
   the batch's wall time.

Prints one JSON object per view; writes the profiler table to
DIR/torch_profile.txt (default: the current directory).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.render import camera, integrator, renderer
    from raytracing_c_tpu_torch.utils import rng

    if not torch.cuda.is_available():
        print("torch_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else "."
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    scene = cs.procedural_scene(ps, np, torch).to(dev)
    w, h, spp, bounces = cs.WIDTH, cs.HEIGHT, cs.SPP, cs.BOUNCES
    spp_px = cs.BATCH_RAYS // spp
    n_batches = math.ceil(w * h / spp_px)
    xs, ys, _ = renderer._pixel_tables(w, h, n_batches * spp_px - w * h)
    b = int(np.flatnonzero((xs == w // 2) & (ys == h // 2))[0]) // spp_px
    px = torch.from_numpy(xs[b * spp_px:(b + 1) * spp_px]).to(dev)
    py = torch.from_numpy(ys[b * spp_px:(b + 1) * spp_px]).to(dev)

    def batch():
        kb = rng.fold_in(rng.prng_key(0, dev), b)
        jitter, _ = renderer._draw_uniforms(kb, cs.BATCH_RAYS, bounces, skip_mat=True)
        return renderer._batch_core(
            scene, px, py, jitter, None, rng.fold_in(kb, 1), width=w, height=h, spp=spp,
            max_bounces=bounces, method="bvh", texture_mode="bilinear", compact=True, rr=False,
        )

    gpu = cs._gpu_line()
    batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rays = batch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"view": "plain", "gpu": gpu, "batch": b, "samples": cs.BATCH_RAYS,
                      "wall_s": wall, "rays": int(rays), "mrays_per_s": int(rays) / wall / 1e6}))

    # layers: wrap each stage with synchronize + host clock
    acc = defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - s
            return r
        return run

    patches = [
        (camera, "generate_rays", "raygen"),
        (rng, "uniform", "rng"),
        (rng, "fold_in", "rng"),
        (integrator.traverse, "intersect_scene", "intersect (K1)"),
        (integrator, "_gather_hit_geometry", "attrs (K2/epilogue)"),
        (integrator.disney, "shade", "shade"),
        (integrator.bg_ops, "eval_background", "background"),
        (integrator, "bounce_step", "bounce_step"),
        (renderer.color, "encode_u8", "encode"),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, name in patches:
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_layers = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    stages = ("intersect (K1)", "attrs (K2/epilogue)", "shade", "background")
    layers = {k: acc[k] for k in ("raygen", "rng", "encode", *stages)}
    layers["bounce glue (masks, throughput, origins)"] = acc["bounce_step"] - sum(
        acc[k] for k in stages)
    layers["compaction, scatter, spp mean"] = wall_layers - sum(
        acc[k] for k in ("raygen", "rng", "encode", "bounce_step"))
    print(json.dumps({"view": "layers_synchronized", "wall_s": wall_layers,
                      "seconds": {k: round(v, 6) for k, v in layers.items()}}))

    # profiler: device time by kernel and the busy share
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = defaultdict(float)
    n_kernels = 0
    for e in ka:
        t = getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)
        if t > 0 and e.device_type.name == "CUDA":
            dev_us[e.key] += t
            n_kernels += e.count
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    k1 = sum(v for k, v in dev_us.items() if "bvh_traverse" in k) / 1e6
    k2 = sum(v for k, v in dev_us.items() if "fetch_attrs" in k) / 1e6
    print(json.dumps({"view": "profiler", "wall_s": wall_prof, "device_busy_s": busy,
                      "device_busy_share": busy / wall_prof if wall_prof else None,
                      "kernel_launches": n_kernels, "k1_s": k1, "k2_s": k2,
                      "top_kernels_s": [[k[:80], v / 1e6] for k, v in top]}))
    with open(os.path.join(out_dir, "torch_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
