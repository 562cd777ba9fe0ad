#!/usr/bin/env python3
"""Where one render batch of the PyTorch port spends its time, on a GPU.

    python3 tools/torch_profile.py [--nee] [--out DIR]

Renders the batch holding the image centre of chip_smoke.py's main path
(1920x1080, 16 spp -> 262,144 camera samples, 8 bounces, the procedural
helmet stand-in) three ways, then counts K1's work on it:

1. plain: wall seconds of the batch, rays traced, Mrays/s;
2. layers: the same batch with a synchronize around each layer
   (raygen, rng, intersect [K1], attrs [K2 / epilogue], shade, background,
   compaction and the rest), so each layer's time includes its own launch
   overhead; the sum exceeds the plain wall by the lost overlap;
3. torch.profiler: device time by kernel, and the device busy share of
   the batch's wall time;
4. K1 per bounce: the rays entering each bounce of the batch
   (trace_bucketed's own compacted state, chip_smoke.bounce_rays), the K1
   kernel the wrapper picks for them, its device ms on them with L2
   emptied before each launch (fused epilogue on bounce 0, bare after, as
   the main path runs it), and its bound from a host re-walk of the
   ordered descent on a sample of them
   (`raytracing_c_tpu_torch/utils/bounds.py:k1_work`), with the share.

With --nee the batch renders with environment next-event estimation
under chip_smoke's 2048x1024 env map (chip_smoke.with_env_map): the
layers split the shadow rays' K1 launches ("shadow intersect (K1)") from
the primary ones and time the env-light sample and pdf evaluation as
layers of their own ("env sample", inside shade; "env eval", at the
misses), and step 4 lists each bounce's shadow launch beside its primary
one.

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
    from raytracing_c_tpu_torch.ops import env_light
    from raytracing_c_tpu_torch.ops import traverse_cuda as tc
    from raytracing_c_tpu_torch.render import camera, integrator, renderer
    from raytracing_c_tpu_torch.utils import bounds, rng

    if not torch.cuda.is_available():
        print("torch_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else "."
    nee = "--nee" in argv
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    scene = cs.procedural_scene(ps, np, torch, dev)
    if nee:
        scene = cs.with_env_map(ps, torch, scene, cs.make_env_map())
        env = env_light.scene_env_light(scene)
        print(json.dumps({"view": "env_table", "w": env.w, "h": env.h,
                          "host_build_s": env.seconds}))
    w, h, spp, bounces = cs.WIDTH, cs.HEIGHT, cs.SPP, cs.BOUNCES
    spp_px = cs.BATCH_RAYS // spp
    n_batches = math.ceil(w * h / spp_px)
    xs, ys, _ = renderer._pixel_tables(w, h, n_batches * spp_px - w * h)
    b = int(np.flatnonzero((xs == w // 2) & (ys == h // 2))[0]) // spp_px
    px = torch.from_numpy(xs[b * spp_px:(b + 1) * spp_px]).to(dev)
    py = torch.from_numpy(ys[b * spp_px:(b + 1) * spp_px]).to(dev)

    def batch():
        kb = rng.fold_in(rng.prng_key(0, dev), b)
        jitter = renderer._draw_uniforms(kb, cs.BATCH_RAYS, bounces, skip_mat=True)[0]
        return renderer._batch_core(
            scene, px, py, jitter, None, None, rng.fold_in(kb, 1), width=w, height=h, spp=spp,
            max_bounces=bounces, method="bvh", texture_mode="bilinear", compact=True, rr=False,
            nee=nee,
        )

    gpu = cs._gpu_line()
    batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rays = batch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"view": "plain", "gpu": gpu, "nee": nee, "batch": b,
                      "samples": cs.BATCH_RAYS,
                      "wall_s": wall, "rays": int(rays), "mrays_per_s": int(rays) / wall / 1e6}))

    # layers: wrap each stage with synchronize + host clock; a layer called
    # inside another (the env sample and the light's background lookup
    # inside shade, every layer inside bounce_step) is charged to itself
    # only, so bounce_step keeps the glue between its stages
    acc = defaultdict(float)
    inner = []

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            inner.append(0.0)
            r = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - s
            # bounce_step passes the primary rays' active mask positionally,
            # the shadow rays none
            key = "shadow " + name if name == "intersect (K1)" and len(a) == 3 else name
            acc[key] += dt - inner.pop()
            if inner:
                inner[-1] += dt
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
        (integrator, "bounce_step", "bounce glue (masks, throughput, origins)"),
        (renderer.color, "encode_u8", "encode"),
        (env_light, "sample", "env sample"),
        (env_light, "eval_pdf", "env eval"),
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
    layers = dict(acc)
    layers["compaction, scatter, spp mean"] = wall_layers - sum(acc.values())
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

    # K1 per bounce of the batch (with --nee each bounce's shadow launch
    # beside its primary one): rays, device ms, bound and share
    kb = rng.fold_in(rng.prng_key(0, dev), b)
    jitter = renderer._draw_uniforms(kb, cs.BATCH_RAYS, bounces, skip_mat=True)[0]
    o, d = camera.generate_rays(scene.camera, w, h, px.repeat_interleave(spp),
                                py.repeat_interleave(spp), jitter[0], jitter[1])
    _, _, states, shadows = cs.bounce_rays(integrator, scene, o, d, rng.fold_in(kb, 1), bounces,
                                           nee=nee)
    launches = [(i, "primary", bo, bd, i == 0) for i, (bo, bd) in enumerate(states)]
    launches += [(i, "shadow", so, sd, False) for i, (so, sd) in enumerate(shadows)]
    for i, kind, ro, rd, fuse in sorted(launches, key=lambda x: (x[0], x[1] == "shadow")):
        ms = cs.device_ms(torch, lambda: tc.bvh_traverse(  # noqa: B023
            ro, rd, scene.triangles, scene.bvh, fuse_attr=fuse), 10, "bvh_traverse")
        work = bounds.k1_work(scene, ro, rd, epilogue=fuse)
        bd_ = bounds.bound(work)
        print(json.dumps({"view": "k1_bounce", "gpu": gpu, "bounce": i, "rays_kind": kind,
                          "rays": ro.shape[0],
                          "kernel": "wide" if ro.shape[0] < tc.WIDE_BELOW else "thread",
                          "epilogue": fuse, "device_ms": ms, **work, **bd_,
                          "share": bd_["bound_ms"] / ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
