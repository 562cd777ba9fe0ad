#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (raytracing_c_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--save IMAGE.png]

Phases, one line each; any failure exits 1 and prints no result:

1. the card (nvidia-smi name and power limit) and the kernels' nvcc build;
2. K1 `bvh_traverse` against its plain version (the chunked brute-force
   oracle) at the main path's batch of 262,144 rays: camera rays and
   random rays on the procedural scene, random rays on a random soup of
   the same size. tri identical; t, u, v and the fused attribute planes
   within K_TOL (expected 0: both round alike, nvcc --fmad=false);
   dropped_min all +inf;
3. K2 `fetch_attrs` against its plain version on the same hits;
4. the main path: render() at 1920x1080, 16 spp, 8 bounces, method
   "auto", on a procedural stand-in for helmet.glb (15,490 triangles in a
   depth-4 BVH, 3 materials, 2048^2 albedo + normal + metal-roughness
   textures, constant sky). The launch counters are zeroed just before
   and read just after; both kernels must have run. Prints wall seconds,
   rays traced and Mrays/s, or the spp cut if the time budget forced one;
5. a 128x128, 4 spp render through the kernels against method="brute":
   PSNR >= 45 dB.

The second-to-last line is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Without CUDA, or outside the repository,
it exits 2 before printing anything but the reason.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 16, 8
BATCH_RAYS = 262_144  # the renderer's default ray arena (batch_pixels = 262144 // spp)
K_TOL = 1e-5
PSNR_MIN = 45.0
#: wall budget for the main-path render; beyond it spp is cut (and printed)
RENDER_BUDGET_S = 420.0


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Scenes (numpy, from a seed)
# ---------------------------------------------------------------------------


def _textures(rng, np):
    """Procedural 2048^2 albedo, 1024^2 normal map, 1024^2 metal-roughness."""
    n = 2048
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    check = ((np.floor(x * 32) + np.floor(y * 32)) % 2).astype(np.float32)
    noise = rng.uniform(0.0, 0.15, (n, n)).astype(np.float32)
    albedo = np.stack([0.55 + 0.35 * check * x, 0.45 + 0.3 * (1 - check) * y,
                       0.35 + 0.25 * check], -1) - noise[..., None]
    albedo = (np.clip(albedo, 0, 1) * 255).astype(np.uint8)

    m = 1024
    y, x = np.mgrid[0:m, 0:m].astype(np.float32) * (2 * np.pi * 24 / m)
    hx = np.cos(x) * np.sin(y)  # d/dx of sin(x) sin(y)
    hy = np.sin(x) * np.cos(y)
    nrm = np.stack([-0.4 * hx, -0.4 * hy, np.ones_like(hx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = ((nrm * 0.5 + 0.5) * 255).astype(np.uint8)

    y, x = np.mgrid[0:m, 0:m].astype(np.float32) / m
    mr = np.stack([np.zeros_like(x), 0.15 + 0.75 * (0.5 + 0.5 * np.sin(x * 40)),
                   ((np.floor(y * 16) % 2) * 255 / 255.0)], -1)
    mr = (mr * 255).astype(np.uint8)
    return [albedo, normal, mr]


def _displaced_sphere(np, n=88):
    """n x n quads of a displaced UV sphere (2 n^2 triangles), smooth
    per-vertex normals, outward winding, uv in [0, 2) x [0, 1]."""
    th = np.linspace(0.06, np.pi - 0.06, n + 1)
    ph = np.linspace(0.0, 2 * np.pi, n + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    R = 1.0 + 0.07 * np.sin(6 * P) * np.sin(5 * T)
    V = np.stack([R * np.sin(T) * np.cos(P), R * np.cos(T), R * np.sin(T) * np.sin(P)], -1)
    UV = np.stack([P / np.pi, T / np.pi], -1)
    a, b = V[:-1, :-1], V[1:, :-1]
    c, d = V[1:, 1:], V[:-1, 1:]
    ia, ib = (slice(None, -1), slice(None, -1)), (slice(1, None), slice(None, -1))
    ic, id_ = (slice(1, None), slice(1, None)), (slice(None, -1), slice(1, None))
    tris_v = [(a, b, c), (a, c, d)]
    tris_i = [(ia, ib, ic), (ia, ic, id_)]

    # smooth vertex normals: area-weighted sum of the adjacent face normals
    vn = np.zeros_like(V)
    for (p0, p1, p2), idx in zip(tris_v, tris_i):
        fn = np.cross(p1 - p0, p2 - p0)
        for s in idx:
            vn[s] += fn
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    vn *= np.sign((vn * V).sum(-1, keepdims=True))  # outward, like the winding below

    pos, nrm, uv = [], [], []
    for idx in tris_i:
        pos.append(np.stack([V[s] for s in idx], 2).reshape(-1, 3, 3))
        nrm.append(np.stack([vn[s] for s in idx], 2).reshape(-1, 3, 3))
        uv.append(np.stack([UV[s] for s in idx], 2).reshape(-1, 3, 2))
    pos, nrm, uv = (np.concatenate(x).astype(np.float32) for x in (pos, nrm, uv))
    # outward winding: the geometric normal must agree with the centroid
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    flip = (ng * pos.mean(1)).sum(-1) < 0
    for arr in (pos, nrm, uv):
        arr[flip, 1], arr[flip, 2] = arr[flip, 2].copy(), arr[flip, 1].copy()
    return pos, nrm, uv


def procedural_scene(ps, np, torch):
    """The helmet.glb stand-in: displaced sphere (15,488 triangles) on a
    floor quad, 3 materials, textured PBR."""
    rng = np.random.default_rng(0)
    pos, nrm, uv = _displaced_sphere(np)
    band = (np.abs(pos.mean(1)[:, 1]) < 0.25)
    mat = np.where(band, 1, 0).astype(np.int32)
    floor = np.array([[[-4, -1.1, -4], [-4, -1.1, 4], [4, -1.1, 4]],
                      [[-4, -1.1, -4], [4, -1.1, 4], [4, -1.1, -4]]], np.float32)
    fuv = (floor[:, :, [0, 2]] / 2).astype(np.float32)
    fn = np.zeros_like(floor)
    fn[..., 1] = 1.0
    mesh = ps.HostMesh(
        np.concatenate([pos, floor]), np.concatenate([nrm, fn]),
        np.concatenate([uv, fuv]), np.concatenate([mat, np.full(2, 2, np.int32)]),
    )
    f = lambda *v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    i = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    mats = ps.MaterialTable(
        base_color=Vec3(f(1.0, 1.0, 0.5), f(1.0, 0.78, 0.5), f(1.0, 0.34, 0.55)),
        emission=Vec3(f(0, 0, 0), f(0, 0, 0), f(0, 0, 0)),
        roughness=f(1.0, 0.3, 0.8), metalness=f(1.0, 1.0, 0.0),
        normal_strength=f(1.0, 0.0, 0.0), sheen=f(0.0, 0.0, 0.5),
        sheen_tint=f(0.0, 0.0, 0.5), anisotropic=f(0.0, 0.3, 0.0),
        tex_albedo=i(1, -1, -1), tex_normal=i(2, -1, -1), tex_mr=i(3, -1, -1),
        tex_emission=i(-1, -1, -1), shader_kind=i(0, 0, 0),
    ).with_rows()

    eye, target = np.array([0.0, 0.5, 3.3]), np.array([0.0, -0.15, 0.0])
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    view = np.eye(4, dtype=np.float32)
    view[:3, 0], view[:3, 1], view[:3, 2], view[:3, 3] = right, up, -fwd, eye
    return ps.build_scene(mesh, mats, ps.TextureAtlas.pack(_textures(rng, np)),
                          ps.Background.constant((0.6, 0.7, 0.9)),
                          ps.Camera.look(view, 45.0))


def soup_scene(ps, np, n=15452):
    """Random soup of helmet.glb's triangle count (tests/helpers.random_mesh)."""
    rng = np.random.default_rng(1)
    pos = (rng.uniform(-1, 1, (n, 1, 3)) + rng.normal(0, 0.12, (n, 3, 3))).astype(np.float32)
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    mesh = ps.HostMesh(pos, np.repeat(ng[:, None], 3, 1).astype(np.float32),
                       rng.uniform(0, 1, (n, 3, 2)).astype(np.float32), np.zeros(n, np.int32))
    return ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                          ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default())


def random_rays(n, seed, dev, np, torch, Vec3):
    """Rays from a 5-unit cube aimed into the unit cube (most hit)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return Vec3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])), Vec3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def psnr(np, a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return math.inf if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


def write_png(path: str, img) -> None:
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (len(data).to_bytes(4, "big") + tag + data
                + zlib.crc32(tag + data).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def compare_k1(torch, tc, label, scene, o, d, fuse):
    got = tc.bvh_traverse(o, d, scene.triangles, scene.bvh, fuse_attr=fuse)
    want = tc.bvh_traverse_plain(o, d, scene.triangles, fuse_attr=fuse)
    torch.cuda.synchronize()
    bad_tri = int((got["tri"] != want["tri"]).sum())
    hit = want["tri"] >= 0
    errs = [float((got[k] - want[k])[hit].abs().max()) if bool(hit.any()) else 0.0
            for k in ("t", "u", "v")]
    if fuse and bool(hit.any()):
        errs.append(float((got["attrs"] - want["attrs"])[:, hit].abs().max()))
    err = max(errs)
    miss_ok = bool(torch.isinf(got["t"][~hit]).all())
    dropped_inf = bool(torch.isinf(got["dropped_min"]).all())
    hit_rate = float(hit.float().mean())
    ok = bad_tri == 0 and err <= K_TOL and miss_ok and dropped_inf and hit_rate > 0.1
    ms = cuda_ms(torch, lambda: tc.bvh_traverse(o, d, scene.triangles, scene.bvh,
                                                fuse_attr=fuse), 20)
    plain_ms = cuda_ms(torch, lambda: tc.bvh_traverse_plain(o, d, scene.triangles,
                                                            fuse_attr=fuse), 1)
    print(f"phase2 K1 {label}: rays={o.shape[0]} hit={hit_rate:.4f} "
          f"fused={fuse} tri_mismatch={bad_tri} max_abs_err={err:.3g} "
          f"dropped_min_inf={dropped_inf} kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok, err, ms, plain_ms, got


def main(argv) -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        from raytracing_c_tpu_torch.models import scene as ps
        from raytracing_c_tpu_torch.ops import traverse_cuda as tc
        from raytracing_c_tpu_torch.render import camera, integrator, renderer
        from raytracing_c_tpu_torch.utils import rng
        from raytracing_c_tpu_torch.utils.vec3 import Vec3
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    save = argv[argv.index("--save") + 1] if "--save" in argv else None

    failures = []
    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    print(f"phase1 gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build = tc.build_library()
    tc._library()
    print(f"phase1 build: nvcc {build['seconds']:.1f} s -> {build['path']}", flush=True)

    t0 = time.perf_counter()
    scene = procedural_scene(ps, np, torch)
    soup = soup_scene(ps, np)
    print(f"phase1 scenes: procedural {scene.n_triangles} triangles depth "
          f"{scene.bvh.depth}; soup {soup.n_triangles} triangles depth {soup.bvh.depth}; "
          f"host build {time.perf_counter() - t0:.1f} s", flush=True)
    scene_d, soup_d = scene.to(dev), soup.to(dev)

    # --- phase 2: K1 against its plain version at the main path's batch ---
    # the render's batch that holds the image centre (its first tiles are sky)
    spp_px = BATCH_RAYS // SPP
    n_batches = math.ceil(WIDTH * HEIGHT / spp_px)
    xs, ys, _ = renderer._pixel_tables(WIDTH, HEIGHT, n_batches * spp_px - WIDTH * HEIGHT)
    b_mid = int(np.flatnonzero((xs == WIDTH // 2) & (ys == HEIGHT // 2))[0]) // spp_px
    kb = rng.fold_in(rng.prng_key(0, dev), b_mid)
    jitter, _ = renderer._draw_uniforms(kb, BATCH_RAYS, BOUNCES, skip_mat=True)
    sl = slice(b_mid * spp_px, (b_mid + 1) * spp_px)
    px = torch.from_numpy(xs[sl]).to(dev).repeat_interleave(SPP)
    py = torch.from_numpy(ys[sl]).to(dev).repeat_interleave(SPP)
    cam_o, cam_d = camera.generate_rays(scene_d.camera, WIDTH, HEIGHT, px, py,
                                        jitter[0], jitter[1])
    soup_o, soup_d_ = camera.generate_rays(soup_d.camera, WIDTH, HEIGHT, px, py,
                                           jitter[0], jitter[1])
    ro, rd = random_rays(BATCH_RAYS, 2, dev, np, torch, Vec3)
    k1_err = 0.0
    runs = {}
    for label, sc, o, d, fuse in (
        ("camera/procedural", scene_d, cam_o, cam_d, True),
        ("random/procedural", scene_d, ro, rd, False),
        ("camera/soup", soup_d, soup_o, soup_d_, True),
        ("random/soup", soup_d, ro, rd, True),
    ):
        ok, err, ms, plain_ms, got = compare_k1(torch, tc, label, sc, o, d, fuse)
        runs[label] = (ms, plain_ms, got)
        k1_err = max(k1_err, err)
        if not ok:
            failures.append(f"K1 {label}")
    k1_ms, k1_plain_ms, cam_hit = runs["camera/procedural"]

    # --- phase 3: K2 against its plain version on the camera hits ---
    attr_rows = scene_d.triangles.attr_rows
    args = (attr_rows, cam_hit["tri"], cam_hit["u"], cam_hit["v"])
    got2, want2 = tc.fetch_attrs(*args), tc.fetch_attrs_plain(*args)
    torch.cuda.synchronize()
    k2_err = float((got2 - want2).abs().max())
    k2_ms = cuda_ms(torch, lambda: tc.fetch_attrs(*args), 50)
    k2_plain_ms = cuda_ms(torch, lambda: tc.fetch_attrs_plain(*args), 10)
    k2_ok = k2_err <= K_TOL and bool(torch.isfinite(got2).all())
    print(f"phase3 K2 camera/procedural: rays={BATCH_RAYS} max_abs_err={k2_err:.3g} "
          f"kernel_ms={k2_ms:.4f} plain_ms={k2_plain_ms:.4f} {'ok' if k2_ok else 'FAIL'}",
          flush=True)
    if not k2_ok:
        failures.append("K2")

    # --- phase 4: the main path through render() ---
    rad, rays = integrator.trace_bucketed(scene_d, cam_o, cam_d, rng.fold_in(kb, 1), BOUNCES)
    finite = bool(torch.isfinite(rad.x).all() & torch.isfinite(rad.y).all()
                  & torch.isfinite(rad.z).all())
    print(f"phase4 one batch: {BATCH_RAYS} camera samples -> {int(rays)} rays, "
          f"radiance finite={finite}", flush=True)
    if not finite:
        failures.append("non-finite radiance")
    _, warm = renderer.render(scene_d, WIDTH, HEIGHT, spp=SPP, max_bounces=BOUNCES,
                              limit_batches=2)
    per_batch_s = warm.wall_ms / 1e3 / warm.batches
    spp = SPP
    if per_batch_s * n_batches > RENDER_BUDGET_S:
        spp = max(1, int(SPP * RENDER_BUDGET_S / (per_batch_s * n_batches)))
        print(f"phase4 cut: {per_batch_s:.2f} s/batch x {n_batches} batches exceeds "
              f"{RENDER_BUDGET_S:.0f} s; rendering {spp} spp instead of {SPP}", flush=True)
    tc.reset_launch_counts()
    img, st = renderer.render(scene_d, WIDTH, HEIGHT, spp=spp, max_bounces=BOUNCES,
                              seed=0, method="auto")
    launches = tc.launch_counts()
    distinct = len(np.unique(img.reshape(-1, 3), axis=0))
    main_ok = (launches["bvh_traverse"] > 0 and launches["fetch_attrs"] > 0
               and img.shape == (HEIGHT, WIDTH, 3) and float(img.std()) > 5.0
               and distinct > 1000)
    print(f"phase4 render {WIDTH}x{HEIGHT} spp={spp} bounces={BOUNCES}: "
          f"wall_s={st.wall_ms / 1e3:.3f} rays={st.rays_traced} "
          f"mrays_per_s={st.mrays_per_sec:.4f} batches={st.batches} "
          f"launches={launches} mean={float(img.mean()):.2f} std={float(img.std()):.2f} "
          f"distinct_colors={distinct} {'ok' if main_ok else 'FAIL'}", flush=True)
    if not main_ok:
        failures.append("main path")
    if save:
        write_png(save, img)

    # --- phase 5: kernel path against the brute-force oracle ---
    kw = dict(spp=4, max_bounces=BOUNCES, seed=3)
    img_k, st_k = renderer.render(scene_d, 128, 128, method="bvh", **kw)
    img_b, st_b = renderer.render(scene_d, 128, 128, method="brute", **kw)
    p = psnr(np, img_k, img_b)
    ok5 = p >= PSNR_MIN and img_k.std() > 5.0
    print(f"phase5 128x128 spp=4: kernel vs brute PSNR={p:.2f} dB "
          f"(identical={bool((img_k == img_b).all())}) rays {st_k.rays_traced} vs "
          f"{st_b.rays_traced} {'ok' if ok5 else 'FAIL'}", flush=True)
    if not ok5:
        failures.append("kernel vs brute image")

    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", flush=True)
        return 1
    src = "raytracing_c_tpu_torch/csrc/traverse.cu"
    kernels = [
        {"name": "bvh_traverse", "route": "cuda", "source": src,
         "replaces": "raytracing_c_tpu/ops/traverse_pallas.py:1391",
         "launches": launches["bvh_traverse"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fetch_attrs", "route": "cuda", "source": src,
         "replaces": "raytracing_c_tpu/ops/traverse_pallas.py:1646",
         "launches": launches["fetch_attrs"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
