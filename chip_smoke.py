#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (raytracing_c_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--save IMAGE.png]
    python3 chip_smoke.py --flagship-only SPP   (phase 4's render alone)

Phases, one line each or more; any failure exits 1 and prints no result:

1. the card (nvidia-smi name and power limit), the one nvcc build of
   every kernel (csrc/*.cu), the scenes and K1's node and triangle tables
   (built with each scene; their build time), and the env-light table of
   the stand-in under a 2048x1024 equirect env map (its host build time);
2. K1 `bvh_traverse` against its plain version (the chunked brute-force
   oracle) on five ray sets of the main path's batch size: camera rays
   and random rays on the procedural scene, camera and random rays on a
   random soup of the same size, and bounce1/procedural, the live rays
   entering bounce 1 of the image-centre batch (trace_bucketed's own
   compacted state), all run by its one-thread-per-ray kernel; and on the
   live rays entering bounces 2-7 of that batch (bounceN/procedural),
   fewer than WIDE_BELOW, run by its eight-lanes-per-ray kernel. With
   and without the fused epilogue: tri identical; t, u, v and the fused
   attribute planes within K_TOL
   (expected 0: both round alike, nvcc --fmad=false); dropped_min all
   +inf. Each set is timed as the main path runs it (fused epilogue on
   camera rays); the camera, bounce-1 and bounce-2 sets get their bounds
   from a host re-walk. Then the NEE shadow rays of bounces 0 and 1 of
   the same batch traced with nee under the env map (shadow0/procedural,
   shadow1/procedural, captured from trace_bucketed's own state), held to
   the oracle and timed on each kernel, each with its bound;
3. K2 `fetch_attrs` against its plain version on the same hits; then K4
   `shade_bounce` on the lanes entering each bounce of the image-centre
   batch (trace_bucketed's own compacted state and draws, as bounce_step
   hands them on), on the procedural scene without NEE and under the env
   map with NEE: K4's tail (the launch and, with NEE, the shadow test and
   `nee_add`) against the integrator's plain tail on the same lanes, every
   plane of the next state and the ray count bit-equal, one K4 launch a
   bounce and one `nee_add` with NEE; each launch timed with its bound
   (`bounds.k4_work`, bytes and operations), the plain tail timed on
   bounce 0 and `nee_add` on bounce 0's shaded lanes; then a 1920x1080
   frame and a 1024x1024 NEE frame at 16 spp with spans on, whose `shade`
   spans (`spans.shade_summary`) must count every lane through K4 and
   none through the plain tail;
4. the render path: render() at 1920x1080, 16 spp, 8 bounces, method
   "auto", on a procedural stand-in for helmet.glb (15,490 triangles in a
   depth-4 BVH, 3 materials, 2048^2 albedo + normal + metal-roughness
   textures, constant sky). The launch counters are zeroed just before
   and read just after; both K1 kernels and K2 must have run. Prints wall seconds,
   rays traced and Mrays/s, or the spp cut if the time budget forced one;
5. a 128x128, 4 spp render through the kernels against method="brute":
   PSNR >= 45 dB;
6. K3 `denoise_u8` against its plain version at 1920x1080 on a seeded
   image with planted fireflies and on the phase-4 frame: max abs
   difference <= K3_TOL u8 (expected 0), and K3 removes the fireflies;
7. the CLI path: in a temporary directory, the stand-in written as
   `standin.glb` (embedded PNG textures, a node hierarchy with a
   rotation/translation, a perspective camera node) and a 2048x1024
   equirect `background.png`, then cli.main() in-process at 1920x1080,
   16 spp (phase 4's cut, if any), 8 bounces, -D; the counters are zeroed
   just before and read just after: both K1 kernels, K2, K3 and K4 must have run
   (the NEE add must not), the output must decode to a textured frame whose sky carries the env map.
   Before it, the host's time to decode the GLB's 2048^2 albedo texture and
   background.png (PNGs filtered per row like a real encoder's); after it,
   `python -m raytracing_c_tpu_torch` at 64x64 with -D in a subprocess;
8. the NEE path: cli.main() in the same directory
   at 1920x1080, 16 spp (never cut), 8 bounces, --nee -D -V --save-scene;
   the counters are zeroed just before and read just after: every kernel
   must have run, and K1 more often than in phase 7 (the shadow rays).
   Prints the CLI's stages, rays, Mrays/s and the env table's build time.
   Then a 128x128, 4 spp render(nee=True) through the kernels against
   method="brute" (PSNR >= 45 dB), and --load-scene of the saved cache at
   256x256 against the model: identical images;
9. bake_lightmap of the stand-in at 512x512 texels, 16 samples, 8 bounces
   through K1 (wall, triangles rasterized, texel records, texels covered,
   Mrays/s), and a 64x64, 4-sample bake through
   K1 against the brute-force one (max abs difference <= LM_TOL); the
   native QOI codec on the phase-4 frame: byte-equal to the pure-Python
   encoder and decoded back (its build at first use, and both encoders,
   timed apart);
10. multi-device rendering, this slice's main path, one process per rank
   (raytracing_c_tpu_torch/parallel/): the stand-in goes to the ranks as a scene cache, and
   `launch.render_scene_cache` renders it through render(mesh=) on (a) one
   NCCL rank per card (torch.cuda.device_count()) and (b) two gloo ranks on
   card 0: the flagship frame at phase 4's spp, compacted (wall, rays,
   Mrays/s; each rank's launch counts, zeroed just before the render and
   read just after: K1's eight-lane kernel and K2 must have run on every
   rank, and its one-thread kernel too where a rank's camera launch holds
   WIDE_BELOW rays or more; the image mean within 2% of phase 4's, the
   bound of tests/test_sharding.py, since each rank keys its compacted
   draws apart), then (c) a 256x256 dense render and a 128x128 dense NEE
   render, each identical to the single-process render with equal ray
   counts; (d) the stand-in with the SAH splitter: K1 on the phase-2
   camera rays against the oracle, its device time beside the midpoint
   tree's, node visits and triangle tests per ray from the host re-walk;
11. the parity gate: the scene of PARITY_SCENE written anew (each file
   must hash to tests/goldens_torch16/manifest.json's sha256), then every
   case of PARITY_CASES (the CLI with an env map, -D, --nee, an OBJ with
   --rr --tonemap aces --nearest, --debug-normals; render(compact=False);
   bake_lightmap) at 16 spp through the port's own entry points on the
   card, seed 42, each against the JAX package's render of the same case
   (tools/make_torch_parity_refs.py, on the CPU): PSNR >= PSNR_MIN, printed
   beside the manifest's seed-42-vs-seed-43 floor and the share of
   byte-equal pixels. The lightmap case bakes the texel records the JAX
   package reads, those of the slots below n_triangles (`jax_read_bake`),
   and prints the texels that only the port's bake covers, from the
   triangles beyond slot n. glb_env and glb_nee are rendered twice and
   must be byte-identical. The counters are zeroed just before and read just
   after: both K1 kernels, K2 and K3 must have run;
12. the BVH inspector (raytracing_c_tpu_torch/tools/bvh_viz.py) on the
   stand-in built on the card: (a) its OBJ dump, byte-identical to the
   dump of the same mesh built on the CPU, with each level's box count
   that of the node rows' non-zero lanes; (b) overlay_levels at 512x512,
   which renders once through render() (spp 4, 3 bounces, seed 0: four
   batches of 262,144 camera rays, so both K1 kernels and K2 run; the
   counters are zeroed just before and read just after) and writes a
   PNG per level: each decodes through the port's codec, holds the
   level's colour on its wireframe pixels and equals a direct render()
   elsewhere, byte for byte; (c) the interactive view's 512x512
   snapshot, lit; (d) `python -m
   raytracing_c_tpu_torch.tools.bvh_viz standin.glb out.obj` in a
   subprocess on the card, which must exit 0 and print depth=4. Prints
   the phase's wall time;
13. render()'s batch loop (the JAX package's k_group and accumulate) on
   the stand-in at 1920x1080, phase 4's spp, 8 bounces: (a)
   render(limit_batches=8) with k_group 4 and 1, each with and without
   accumulate, the counters zeroed just before and read just after each:
   byte-equal images, equal rays and batches, equal K1 (both kernels), K2
   and K4 launches, each above 0; the same 8 batches through
   render_batches_grouped equal the frame's rows and rays; (b)
   render(limit_batches=5) with the defaults equals (a)'s image (the
   whole last group of 4 is drawn, as the JAX package draws it) and
   counts the rays of batches 0-4; (c) render_batch_indexed at batch 0
   and at the padded last batch (its index a tensor on the card) equals
   the rows of (a)'s and phase 4's frames, and render_batches_grouped
   from the last batch returns it 4 times; (d) render() at 256x256, 4
   spp under every JAX method name: the names mapped to K1 byte-equal to
   method="bvh", "brute" within PSNR_MIN, an unknown name a ValueError.
   Prints each case's wall time and the phase's;
14. K5's threefry draws (csrc/rng.cu) on the card: `bounce_uniforms` at
   the render batch's lanes entering bounces 0, 1, 2 and 7 (K5_LANES) at
   nu 3 and 7, and the batch draws (fold_in, split, the jitter's and the
   dense tracer's uniforms, a bounded uniform), each against the plain
   int64 version run on the same card (every word bit-equal), timed
   (`device_ms`) with its bound (`bounds.k5_*_work`) beside the plain
   version's wall; then a compacted render batch's draws summed.

After phase 4, `chip_smoke.py --flagship-only SPP` renders phase 4's frame
in a fresh process that has never started a profiler, then once more
after one profiler window; both walls are printed beside phase 4's.

Kernel times: `kernel_ms` is CUDA events around back-to-back calls of the
wrapper after a warm-up call (20 for K1, 50 for K2 and K3), with the
inputs warm in L2; it includes any gap where the host launches slower
than the card runs. `device_ms` is the profiler's device time per launch
of the kernel itself, each launch after a read of a buffer larger than
L2, so that it reads its inputs from device memory as its bytes bound
assumes. The kernels line reports `device_ms` as `ms`, beside its bound
(raytracing_c_tpu_torch/utils/bounds.py).

The kernels line lists K1 twice: bvh_traverse (one thread per ray) with
the camera batch's numbers and, beside them, bounce1_rays, bounce1_ms,
bounce1_bound_ms and bounce1_bound_by; bvh_traverse_wide (eight lanes per
ray) with bounce 2's, and later_ms: [set, rays, ms] for bounces 3-7. Each
has "shadow": the shadow sets on that kernel (set, rays, picked by the
wrapper's rule, ms, plain_ms, bound_ms, bound_by). shade_bounce (K4)
carries phase 3's bounce 0 without NEE as ms, plain_ms (the plain tail's
wall, its host dispatch included) and bound_ms, "nee" the same with NEE,
batch_ms and batch_ms_nee (the 8 launches' device ms summed) beside
their bounds, "per_bounce" each launch's lanes, shaded lanes, map taps,
ms and bound (bytes_ms, ops_ms), and "spans" the two frames' counters;
nee_add has bounce 0's NEE lanes, their ms and bound; rng_bounce_uniforms
(K5) has the 262,144-lane nu = 3 draw's, "draws" phase 14's rows (draw,
ms, plain_ms, bound_ms, bound_by, differing), "batch_ms" a batch's draws
and its other kernels' launches in phases 8 and 7. "launches" are phase
8's (the NEE path), "launches_without_nee" phase 7's, "launches_mesh_nccl"
and "launches_mesh_gloo" each rank's in phase 10's flagship renders (a)
and (b), "launches_parity" phase 11's, "launches_viz" phase 12's
overlay, "launches_batch_loop" phase 13a's first render; bvh_traverse
also has phase 10d's sah_ms, sah_midpoint_ms, sah_max_abs_err and
sah_bound_ms.
Before the card's name comes {"parity": {...}}: phase 11's cases (psnr_db,
floor_db, byte_equal, port_wall_s, jax_wall_s, ok, twice_identical) and
the fresh-process flagship beside phase 4's wall.
The second-to-last line is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Without CUDA, or outside the repository,
it exits 2 before printing anything but the reason.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 16, 8
BATCH_RAYS = 262_144  # the renderer's default ray arena (batch_pixels = 262144 // spp)
K_TOL = 1e-5
K3_TOL = 1  # u8
#: lightmap texels, K1 against the brute-force oracle (expected 0: same hits)
LM_TOL = 1e-5
PSNR_MIN = 45.0
#: wall budget for each full-size render; beyond it spp is cut (and printed)
RENDER_BUDGET_S = 300.0

#: bytes read between two timed launches, to empty the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# The helmet.glb stand-in (numpy, from a seed) and its files
# ---------------------------------------------------------------------------

#: the stand-in's 3 materials: textured PBR, an anisotropic metal band and
#: a sheen floor
STANDIN_MATERIALS = (
    dict(name="textured", base_color=(1.0, 1.0, 1.0), roughness=1.0, metalness=1.0,
         normal_strength=1.0, sheen=0.0, sheen_tint=0.0, anisotropic=0.0, textured=True),
    dict(name="band", base_color=(1.0, 0.78, 0.34), roughness=0.3, metalness=1.0,
         normal_strength=0.0, sheen=0.0, sheen_tint=0.0, anisotropic=0.3, textured=False),
    dict(name="floor", base_color=(0.5, 0.5, 0.55), roughness=0.8, metalness=0.0,
         normal_strength=0.0, sheen=0.5, sheen_tint=0.5, anisotropic=0.0, textured=False),
)
STANDIN_FOV_DEG = 45.0


def _textures(rng, np, n=2048, m=1024):
    """Procedural n^2 albedo, m^2 normal map, m^2 metal-roughness."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    check = ((np.floor(x * 32) + np.floor(y * 32)) % 2).astype(np.float32)
    noise = rng.uniform(0.0, 0.15, (n, n)).astype(np.float32)
    albedo = np.stack([0.55 + 0.35 * check * x, 0.45 + 0.3 * (1 - check) * y,
                       0.35 + 0.25 * check], -1) - noise[..., None]
    albedo = (np.clip(albedo, 0, 1) * 255).astype(np.uint8)

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


#: floor quad corners (x, z) at y = -1.1, and its two triangles
_FLOOR_XZ = ((-4.0, -4.0), (-4.0, 4.0), (4.0, 4.0), (4.0, -4.0))
_FLOOR_TRIS = ((0, 1, 2), (0, 2, 3))
_FLOOR_Y = -1.1


def standin_parts(np, n=88, tex=2048):
    """The helmet.glb stand-in as host arrays: a displaced sphere of n x n
    quads (2 n^2 triangles; material 1 on its equatorial band, else 0) on
    a floor quad (material 2), its textures (tex^2 albedo, (tex/2)^2
    normal and metal-roughness) and the camera-to-world view matrix.
    Returns (positions, normals, uvs, mat_id), textures, view."""
    rng = np.random.default_rng(0)
    pos, nrm, uv = _displaced_sphere(np, n)
    mat = np.where(np.abs(pos.mean(1)[:, 1]) < 0.25, 1, 0).astype(np.int32)
    corners = np.array([[x, _FLOOR_Y, z] for x, z in _FLOOR_XZ], np.float32)
    floor = corners[np.array(_FLOOR_TRIS)]
    fuv = (floor[:, :, [0, 2]] / 2).astype(np.float32)
    fn = np.zeros_like(floor)
    fn[..., 1] = 1.0
    arrays = (np.concatenate([pos, floor]), np.concatenate([nrm, fn]),
              np.concatenate([uv, fuv]), np.concatenate([mat, np.full(2, 2, np.int32)]))

    eye, target = np.array([0.0, 0.5, 3.3]), np.array([0.0, -0.15, 0.0])
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    view = np.eye(4, dtype=np.float32)
    view[:3, 0], view[:3, 1], view[:3, 2], view[:3, 3] = right, up, -fwd, eye
    return arrays, _textures(rng, np, tex, tex // 2), view


def procedural_scene(ps, np, torch, device, n=88, tex=2048, sah=None):
    """The helmet.glb stand-in as a port scene on `device`: displaced
    sphere (2 n^2 = 15,488 triangles) on a floor quad, 3 materials,
    textured PBR, constant sky; `sah` picks the BVH splitter
    (models/bvh.py:build_bvh)."""
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    (pos, nrm, uv, mat), textures, view = standin_parts(np, n, tex)
    mats = STANDIN_MATERIALS
    f = lambda k: torch.tensor([m[k] for m in mats], dtype=torch.float32)  # noqa: E731
    i = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    base = torch.tensor([m["base_color"] for m in mats], dtype=torch.float32)
    table = ps.MaterialTable(
        base_color=Vec3(base[:, 0].contiguous(), base[:, 1].contiguous(),
                        base[:, 2].contiguous()),
        emission=Vec3(*(torch.zeros(3) for _ in range(3))),
        roughness=f("roughness"), metalness=f("metalness"),
        normal_strength=f("normal_strength"), sheen=f("sheen"),
        sheen_tint=f("sheen_tint"), anisotropic=f("anisotropic"),
        tex_albedo=i(1, -1, -1), tex_normal=i(2, -1, -1), tex_mr=i(3, -1, -1),
        tex_emission=i(-1, -1, -1), shader_kind=i(0, 0, 0),
    ).with_rows()
    return ps.build_scene(ps.HostMesh(pos, nrm, uv, mat), table, ps.TextureAtlas.pack(textures),
                          ps.Background.constant((0.6, 0.7, 0.9)),
                          ps.Camera.look(view, STANDIN_FOV_DEG), device=device, sah=sah)


def soup_scene(ps, np, device, n=15452):
    """Random soup of helmet.glb's triangle count (tests/helpers.random_mesh)."""
    rng = np.random.default_rng(1)
    pos = (rng.uniform(-1, 1, (n, 1, 3)) + rng.normal(0, 0.12, (n, 3, 3))).astype(np.float32)
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    mesh = ps.HostMesh(pos, np.repeat(ng[:, None], 3, 1).astype(np.float32),
                       rng.uniform(0, 1, (n, 3, 2)).astype(np.float32), np.zeros(n, np.int32))
    return ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                          ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default(),
                          device=device)


def far_soup(ps, np, device, n=900, offset=1.0e4, inside=2e-4, rise=0.05):
    """A random soup of n triangles (soup_scene's shape) moved by `offset`
    along each axis, and rays that graze its leaf blocks' boxes: for each
    block, its least and greatest vertex in x and in y, a ray from `rise`
    below that vertex (in z) to the point of the vertex's triangle
    `inside` within that face. At 1e4 a box face lies on its extreme
    vertex (the EPSILON padding rounds away), so a slab test whose
    rounding grows with |o| (2^-24 |o| = 6e-4 here) loses some of these
    hits; one whose rounding grows with the distance from the origin to
    the box loses none. Returns (scene, origins, directions), the rays as
    (m, 3) float32 numpy."""
    from raytracing_c_tpu_torch.models.bvh import build_bvh

    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (n, 1, 3)) + rng.normal(0, 0.12, (n, 3, 3))
    pos = (pos + offset).astype(np.float32)
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    mesh = ps.HostMesh(pos, np.repeat(ng[:, None], 3, 1).astype(np.float32),
                       rng.uniform(0, 1, (n, 3, 2)).astype(np.float32), np.zeros(n, np.int32))
    _, slot_map, _ = build_bvh(mesh)
    origins, directions = [], []
    for block in slot_map.reshape(-1, 8):
        tris = pos[block[block >= 0]]
        for axis in (0, 1) if len(tris) else ():
            for pick in (np.argmin, np.argmax):
                tri, corner = divmod(int(pick(tris[:, :, axis])), 3)
                v = tris[tri, corner].astype(np.float64)
                c = tris[tri].astype(np.float64).mean(0)
                s = min(inside / max(abs(c[axis] - v[axis]), 1e-9), 0.5)
                o = tris[tri, corner].copy()
                o[2] = np.float32(v[2] - rise)
                d = v + s * (c - v) - o
                origins.append(o)
                directions.append(d / np.linalg.norm(d))
    scene = ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                           ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default(),
                           device=device)
    return scene, np.array(origins, np.float32), np.array(directions, np.float32)


#: the GLB mesh node's local transform (under a root node translated by
#: _GLB_ROOT_T): a rotation of 20 degrees about +y and a translation
_GLB_ROT_DEG = 20.0
_GLB_NODE_T = (0.05, 0.0, -0.05)
_GLB_ROOT_T = (0.0, 0.02, 0.0)


def write_glb(path: str, n: int = 88, tex: int = 2048) -> None:
    """Write the stand-in (standin_parts(n, tex)) as a binary glTF: three
    primitives (one per material: unindexed, u32-indexed, u16-indexed),
    PNG textures encoded by the port (two in bufferViews, one as a data
    URI), KHR_materials_sheen on the floor, the mesh node rotated and
    translated under a translated root node, and a perspective camera node
    holding the view matrix."""
    import base64
    import struct

    import numpy as np

    from raytracing_c_tpu_torch.io.image_io import encode_png

    (pos, nrm, uv, mat), textures, view = standin_parts(np, n, tex)
    blob = bytearray()
    views, accessors = [], []

    def add_view(data: bytes) -> int:
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def add_accessor(arr, ctype: int, kind: str) -> int:
        acc = {"bufferView": add_view(np.ascontiguousarray(arr).tobytes()),
               "componentType": ctype, "count": len(arr), "type": kind}
        if kind == "VEC3":
            acc["min"], acc["max"] = arr.min(0).tolist(), arr.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    # glTF stores the mesh in the node's local frame: undo the node's
    # world transform so the world-space stand-in is standin_parts'
    a = math.radians(_GLB_ROT_DEG)
    rot = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])
    shift = np.add(_GLB_NODE_T, _GLB_ROOT_T)
    local_pos = ((pos.reshape(-1, 3) - shift) @ rot).astype(np.float32)
    local_nrm = (nrm.reshape(-1, 3) @ rot).astype(np.float32)
    flat_uv = uv.reshape(-1, 2)
    prims = []
    for m in range(2):
        rows = np.flatnonzero(np.repeat(mat == m, 3))
        prim = {"attributes": {"POSITION": add_accessor(local_pos[rows], 5126, "VEC3"),
                               "NORMAL": add_accessor(local_nrm[rows], 5126, "VEC3"),
                               "TEXCOORD_0": add_accessor(flat_uv[rows], 5126, "VEC2")},
                "material": m}
        if m == 1:
            prim["indices"] = add_accessor(np.arange(len(rows), dtype=np.uint32), 5125, "SCALAR")
        prims.append(prim)
    corners = np.array([[x, _FLOOR_Y, z] for x, z in _FLOOR_XZ], np.float32)
    prims.append({"attributes": {
        "POSITION": add_accessor(((corners - shift) @ rot).astype(np.float32), 5126, "VEC3"),
        "NORMAL": add_accessor((np.tile([[0.0, 1.0, 0.0]], (4, 1)) @ rot).astype(np.float32),
                               5126, "VEC3"),
        "TEXCOORD_0": add_accessor((corners[:, [0, 2]] / 2).astype(np.float32), 5126, "VEC2")},
        "indices": add_accessor(np.array(_FLOOR_TRIS, np.uint16).reshape(-1), 5123, "SCALAR"),
        "material": 2})

    pngs = [encode_png(t) for t in textures]
    images = [{"bufferView": add_view(pngs[0]), "mimeType": "image/png"},
              {"bufferView": add_view(pngs[1]), "mimeType": "image/png"},
              {"uri": "data:image/png;base64," + base64.b64encode(pngs[2]).decode()}]
    materials = []
    for k, m in enumerate(STANDIN_MATERIALS):
        pbr = {"baseColorFactor": [*m["base_color"], 1.0], "metallicFactor": m["metalness"],
               "roughnessFactor": m["roughness"]}
        mat_doc = {"name": m["name"], "pbrMetallicRoughness": pbr}
        if m["textured"]:
            pbr["baseColorTexture"] = {"index": 0}
            pbr["metallicRoughnessTexture"] = {"index": 2}
            mat_doc["normalTexture"] = {"index": 1, "scale": m["normal_strength"]}
        if m["sheen"]:
            mat_doc["extensions"] = {"KHR_materials_sheen": {
                "sheenColorFactor": [m["sheen"]] * 3, "sheenRoughnessFactor": 0.5}}
        materials.append(mat_doc)

    half = a / 2
    doc = {
        "asset": {"version": "2.0", "generator": "chip_smoke.write_glb"},
        "extensionsUsed": ["KHR_materials_sheen"],
        "scene": 0,
        "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            {"name": "root", "translation": list(_GLB_ROOT_T), "children": [1]},
            {"name": "standin", "mesh": 0, "translation": list(_GLB_NODE_T),
             "rotation": [0.0, math.sin(half), 0.0, math.cos(half)]},
            {"name": "camera", "camera": 0,
             "matrix": view.astype(np.float64).T.reshape(-1).tolist()},
        ],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": math.radians(STANDIN_FOV_DEG), "aspectRatio": WIDTH / HEIGHT,
            "znear": 0.01}}],
        "meshes": [{"name": "standin", "primitives": prims}],
        "materials": materials,
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": images,
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob.extend(b"\0" * (-len(blob) % 4))
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))


def write_obj_mtl(directory: str, n: int = 88, tex: int = 2048) -> str:
    """Write the stand-in as standin.obj + standin.mtl + its PNG textures
    in `directory` (the floor as one quad face, fan-triangulated by the
    loaders; the band with negative indices; the PBR MTL keys Pr, Pm, Ps,
    aniso, norm, map_Kd, map_Pr). Returns the OBJ path."""
    import numpy as np

    from raytracing_c_tpu_torch.io.image_io import write_png

    (pos, nrm, uv, mat), textures, _view = standin_parts(np, n, tex)
    for name, img in zip(("albedo.png", "normal.png", "mr.png"), textures):
        write_png(os.path.join(directory, name), img)
    mtl = []
    for m in STANDIN_MATERIALS:
        mtl += [f"newmtl {m['name']}", "Kd {} {} {}".format(*m["base_color"]),
                "Ke 0 0 0", f"Pr {m['roughness']}", f"Pm {m['metalness']}"]
        if m["sheen"]:
            mtl.append(f"Ps {m['sheen']}")
        if m["anisotropic"]:
            mtl.append(f"aniso {m['anisotropic']}")
        if m["textured"]:
            mtl += ["norm normal.png", "map_Kd albedo.png", "map_Pr mr.png"]
    with open(os.path.join(directory, "standin.mtl"), "w") as f:
        f.write("\n".join(mtl) + "\n")

    lines = ["# chip_smoke.write_obj_mtl: the helmet.glb stand-in", "mtllib standin.mtl"]
    count = 0
    for m, name in ((0, "textured"), (1, "band")):
        sel = mat == m
        p, nn, t = pos[sel].reshape(-1, 3), nrm[sel].reshape(-1, 3), uv[sel].reshape(-1, 2)
        lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in p]
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in nn]
        lines += [f"vt {x:.9g} {y:.9g}" for x, y in t]
        lines.append(f"usemtl {name}")
        k = len(p)
        if m == 0:
            lines += [f"f {count + i + 1}/{count + i + 1}/{count + i + 1} "
                      f"{count + i + 2}/{count + i + 2}/{count + i + 2} "
                      f"{count + i + 3}/{count + i + 3}/{count + i + 3}" for i in range(0, k, 3)]
        else:  # relative indices
            lines += [f"f {i - k}/{i - k}/{i - k} {i + 1 - k}/{i + 1 - k}/{i + 1 - k} "
                      f"{i + 2 - k}/{i + 2 - k}/{i + 2 - k}" for i in range(0, k, 3)]
        count += k
    lines += [f"v {x} {_FLOOR_Y} {z}" for x, z in _FLOOR_XZ]
    lines += [f"vt {x / 2} {z / 2}" for x, z in _FLOOR_XZ]
    lines += ["usemtl floor", "f " + " ".join(f"{count + i}/{count + i}" for i in range(1, 5))]
    path = os.path.join(directory, "standin.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def make_env_map(width: int = 2048, height: int = 1024, seed: int = 0):
    """An equirect sky (u8 sRGB, (height, width, 3)): zenith-to-horizon
    gradient, a darker ground, a sun disk of 2 degrees radius at 40 degrees
    elevation, and seeded noise of 2 u8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    elev = (0.5 - v)[:, None] * np.pi  # +pi/2 at the top row
    azim = (u[None, :] - 0.5) * 2 * np.pi
    s = np.clip(np.sin(elev), 0.0, 1.0)[..., None] ** 0.5
    sky = (1 - s) * np.array([0.85, 0.9, 1.0]) + s * np.array([0.25, 0.45, 0.85])
    ground = np.array([0.35, 0.3, 0.25])
    img = np.where((elev > 0)[..., None], sky, ground) * np.ones((1, width, 1))
    sun_e, sun_a = math.radians(40.0), math.radians(-60.0)
    cos_d = (np.sin(elev) * math.sin(sun_e)
             + np.cos(elev) * math.cos(sun_e) * np.cos(azim - sun_a))
    img[cos_d > math.cos(math.radians(2.0))] = 1.0
    img = img * 255 + rng.normal(0.0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_env_map(path: str, width: int = 2048, height: int = 1024, seed: int = 0) -> None:
    from raytracing_c_tpu_torch.io.image_io import write_png

    write_png(path, make_env_map(width, height, seed))


# ---------------------------------------------------------------------------
# The 16-spp parity cases: the JAX package renders their references
# (tools/make_torch_parity_refs.py), phase 11 holds the port to them
# ---------------------------------------------------------------------------

#: the references: <case>.png (seed 42) and <case>_alt.png (seed 43; the
#: lightmap as .npy), and manifest.json
PARITY_DIR = os.path.join(HERE, "tests", "goldens_torch16")
PARITY_SEEDS = (42, 43)
#: the writers' parameters for the parity scene (write_parity_scene)
PARITY_SCENE = {"n": 88, "tex": 2048, "env_width": 512, "env_height": 256}
_PARITY_CLI = ["-W", "128", "-H", "128", "-S", "16"]
#: case -> its entry point and arguments: "cli" runs cli.main(argv + ["--seed",
#: seed, "-O", out]) in the scene's directory; "render" and "bake_lightmap"
#: load `model` without an env map (constant sky) and call the function with
#: `kwargs` and seed=seed
PARITY_CASES = {
    "glb_env": {"entry": "cli", "argv": [*_PARITY_CLI, "-B", "8", "--bg", "env.png",
                                         "standin.glb"]},
    "glb_env_D": {"entry": "cli", "argv": [*_PARITY_CLI, "-B", "8", "-D", "--bg", "env.png",
                                           "standin.glb"]},
    "glb_nee": {"entry": "cli", "argv": [*_PARITY_CLI, "-B", "8", "--nee", "--bg", "env.png",
                                         "standin.glb"]},
    "obj_rr_aces_nearest": {"entry": "cli", "argv": [
        *_PARITY_CLI, "-B", "8", "--rr", "--tonemap", "aces", "--nearest", "--bg", "env.png",
        "standin.obj"]},
    "glb_normals": {"entry": "cli", "argv": [*_PARITY_CLI, "-B", "1", "--debug-normals",
                                             "--no-bg", "standin.glb"]},
    "glb_dense": {"entry": "render", "model": "standin.glb", "kwargs": {
        "width": 128, "height": 128, "spp": 16, "max_bounces": 8, "compact": False}},
    "lightmap": {"entry": "bake_lightmap", "model": "standin.glb", "kwargs": {
        "width": 64, "height": 64, "samples": 16, "max_bounces": 4}},
}


def write_parity_scene(directory: str) -> dict:
    """Write the parity scene into `directory` with PARITY_SCENE's
    parameters: the stand-in as standin.glb and as standin.obj + .mtl + PNG
    textures, and a 512x256 equirect env.png. Returns {file: sha256}."""
    import hashlib

    p = PARITY_SCENE
    write_glb(os.path.join(directory, "standin.glb"), p["n"], p["tex"])
    write_obj_mtl(directory, p["n"], p["tex"])
    write_env_map(os.path.join(directory, "env.png"), p["env_width"], p["env_height"])
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def parity_file(case: str, seed: int) -> str:
    """The reference's file name for this case and seed."""
    ext = ".npy" if PARITY_CASES[case]["entry"] == "bake_lightmap" else ".png"
    return case + ("" if seed == PARITY_SEEDS[0] else "_alt") + ext


def parity_psnr(np, got, ref) -> float:
    """PSNR in dB: u8 images against a peak of 255, a float lightmap
    against the reference's maximum."""
    peak = 255.0 if ref.dtype == np.uint8 else float(ref.max())
    mse = np.mean((got.astype(np.float64) - ref.astype(np.float64)) ** 2)
    return math.inf if mse == 0 else 10.0 * math.log10(peak**2 / mse)


def firefly_image(np, h: int, w: int, seed: int = 6):
    """A smooth gradient with 2 u8 of noise and about one isolated white
    firefly per 2,000 pixels. Returns (image (h, w, 3) u8, firefly mask)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([60 + 80 * x / w, 70 + 60 * y / h, 90 + 40 * (x + y) / (w + h)], -1)
    img = np.clip(base + rng.normal(0.0, 2.0, base.shape), 0, 255).astype(np.uint8)
    k = max(1, h * w // 2000)
    mask = np.zeros((h, w), bool)
    mask[rng.integers(0, h, k), rng.integers(0, w, k)] = True
    img[mask] = 255
    return img, mask


def random_rays(n, seed, dev, np, torch, Vec3):
    """Rays from a 5-unit cube aimed into the unit cube (most hit)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return Vec3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])), Vec3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))


def bounce_rays(integrator, scene, origin, direction, key, bounces, nee=False):
    """integrator.trace_bucketed on camera rays, keeping the rays that
    enter each bounce: its own compacted state as bounce_step receives it,
    and with nee the shadow rays each bounce casts (its second scene
    intersection). Returns (radiance, rays traced, [(origin, direction) per
    bounce], [(origin, direction) of the shadow rays per bounce])."""
    states, shadows, casts = [], [], []
    step, cast = integrator.bounce_step, integrator.traverse.intersect_scene

    def keep_cast(scene_, o, d, *a, **k):
        casts.append((o, d))
        return cast(scene_, o, d, *a, **k)

    def keep(scene_, st, *a, **k):
        states.append((st["origin"], st["direction"]))
        casts.clear()
        out = step(scene_, st, *a, **k)
        shadows.extend(casts[1:])
        return out

    integrator.bounce_step, integrator.traverse.intersect_scene = keep, keep_cast
    try:
        rad, rays = integrator.trace_bucketed(scene, origin, direction, key, bounces, nee=nee)
    finally:
        integrator.bounce_step, integrator.traverse.intersect_scene = step, cast
    return rad, rays, states, shadows


def with_env_map(ps, torch, scene, img):
    """The scene with the (h, w, 3) u8 image appended to its atlas as its
    equirect background (no env-light table yet); the BVH, and so K1's
    cached tables, are shared."""
    import dataclasses

    a = scene.atlas
    dev = a.tex_r.device
    h, w, _ = img.shape
    flat = torch.from_numpy(img.reshape(-1, 3)).to(dev)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731
    atlas = ps.TextureAtlas(
        torch.cat([a.tex_r, flat[:, 0]]), torch.cat([a.tex_g, flat[:, 1]]),
        torch.cat([a.tex_b, flat[:, 2]]), torch.cat([a.offset, i32(a.tex_r.numel())]),
        torch.cat([a.width, i32(w)]), torch.cat([a.height, i32(h)]))
    return dataclasses.replace(scene, atlas=atlas, env_light=None,
                               background=ps.Background.equirect(a.offset.numel()).to(dev))


def k1_ray_sets(scene_d, soup_d, scene_env, dev):
    """Phase 2's K1 ray sets from the render's batch that holds the image
    centre (its first tiles are sky): (label, scene, origin, direction,
    fused as the main path runs it) for camera and random rays on the
    procedural scene and on the soup, each of the main path's batch size,
    then the live rays entering bounce 1 of that batch, then those entering
    bounces 2-7; and the NEE shadow rays of bounces 0 and 1 of the same
    batch traced with nee on scene_env (the stand-in under the env map).
    Returns (sets, shadow sets, (radiance, rays traced) of the batch's
    trace without nee)."""
    import numpy as np
    import torch

    from raytracing_c_tpu_torch.render import camera, integrator, renderer
    from raytracing_c_tpu_torch.utils import rng
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    spp_px = BATCH_RAYS // SPP
    n_batches = math.ceil(WIDTH * HEIGHT / spp_px)
    xs, ys, _ = renderer._pixel_tables(WIDTH, HEIGHT, n_batches * spp_px - WIDTH * HEIGHT)
    b_mid = int(np.flatnonzero((xs == WIDTH // 2) & (ys == HEIGHT // 2))[0]) // spp_px
    kb = rng.fold_in(rng.prng_key(0, dev), b_mid)
    jitter = renderer._draw_uniforms(kb, BATCH_RAYS, BOUNCES, skip_mat=True)[0]
    sl = slice(b_mid * spp_px, (b_mid + 1) * spp_px)
    px = torch.from_numpy(xs[sl]).to(dev).repeat_interleave(SPP)
    py = torch.from_numpy(ys[sl]).to(dev).repeat_interleave(SPP)
    cam_o, cam_d = camera.generate_rays(scene_d.camera, WIDTH, HEIGHT, px, py,
                                        jitter[0], jitter[1])
    soup_o, soup_dir = camera.generate_rays(soup_d.camera, WIDTH, HEIGHT, px, py,
                                            jitter[0], jitter[1])
    ro, rd = random_rays(BATCH_RAYS, 2, dev, np, torch, Vec3)
    rad, rays, states, _ = bounce_rays(integrator, scene_d, cam_o, cam_d, rng.fold_in(kb, 1),
                                       BOUNCES)
    later = [(f"bounce{b}/procedural", scene_d, *states[b], False)
             for b in range(1, len(states))]
    env_cam_o, env_cam_d = camera.generate_rays(scene_env.camera, WIDTH, HEIGHT, px, py,
                                                jitter[0], jitter[1])
    _, _, _, shadows = bounce_rays(integrator, scene_env, env_cam_o, env_cam_d,
                                   rng.fold_in(kb, 1), BOUNCES, nee=True)
    shadow_sets = [(f"shadow{b}/procedural", scene_env, *shadows[b], False) for b in (0, 1)]
    return [("camera/procedural", scene_d, cam_o, cam_d, True),
            ("random/procedural", scene_d, ro, rd, False),
            ("camera/soup", soup_d, soup_o, soup_dir, True),
            ("random/soup", soup_d, ro, rd, True), *later], shadow_sets, (rad, rays)


def k4_bounce_lanes(scene, nee: bool):
    """The lanes entering each bounce of the flagship frame's image-centre
    batch (render_batch at SPP and BOUNCES, seed 0, the compacted tracer's
    own state and draws), as bounce_step hands them to K4's tail:
    [(st, hit, rays, rand4, (method, texture_mode, rr, bounce_i, nee,
    rand2))], one per bounce."""
    import torch

    from raytracing_c_tpu_torch.render import integrator, renderer
    from raytracing_c_tpu_torch.utils import rng

    bp = BATCH_RAYS // SPP
    nb = math.ceil(WIDTH * HEIGHT / bp)
    xs, ys, _ = renderer._pixel_tables_device(WIDTH, HEIGHT, nb * bp - WIDTH * HEIGHT,
                                              scene.triangles.v0.x.device)
    b_mid = int(torch.nonzero((xs == WIDTH // 2) & (ys == HEIGHT // 2))[0]) // bp
    key = rng.fold_in(rng.prng_key(0, xs.device), b_mid)
    captured, tail = [], integrator._tail_k4

    def keep(scene_, st, hit, rays, rand4, *rest):
        captured.append((st, hit, rays, rand4, rest))
        return tail(scene_, st, hit, rays, rand4, *rest)

    integrator._tail_k4 = keep
    try:
        sl = slice(b_mid * bp, (b_mid + 1) * bp)
        renderer.render_batch(scene, xs[sl], ys[sl], key, width=WIDTH, height=HEIGHT, spp=SPP,
                              max_bounces=BOUNCES, compact=True, nee=nee)
    finally:
        integrator._tail_k4 = tail
    return captured


def k4_mismatch(torch, got: dict, want: dict):
    """K4's tail against the plain tail: the planes that differ in any bit
    and the largest absolute difference over the float planes (0.0 when
    every plane is bit-equal)."""
    bad, err = [], 0.0
    for name in ("origin", "direction", "throughput", "radiance", "active", "prev_pdf", "rays"):
        pairs = ([(f"{name}.{c}", getattr(got[name], c), getattr(want[name], c)) for c in "xyz"]
                 if name in ("origin", "direction", "throughput", "radiance")
                 else [(name, got[name], want[name])])
        for label, a, w in pairs:
            if a.dtype == torch.float32:
                same = a.view(torch.int32) == w.view(torch.int32)
                if a.numel():
                    diff = (a - w).abs().masked_fill(same, 0.0).nan_to_num(nan=math.inf)
                    err = max(err, float(diff.max()))
                ok = bool(same.all())
            else:
                ok = torch.equal(a, w)
            if not ok:
                bad.append(label)
    return bad, err


def phase3_k4(torch, scene_d, scene_env, failures, reps: int = 20) -> dict:
    """Phase 3's K4 part (module docstring): the flagship batch's lanes at
    each bounce through K4's tail and the plain tail, K4's and the NEE
    add's device ms and bounds, the shade spans' counters over two frames.
    Returns the kernels line's figures for shade_bounce and nee_add."""
    from raytracing_c_tpu_torch.ops import cuda_build, shade_cuda, traverse
    from raytracing_c_tpu_torch.render import integrator, renderer
    from raytracing_c_tpu_torch.utils import bounds, spans
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    res = {"err": 0.0, "per_bounce": []}
    for label, scene, nee in (("render", scene_d, False), ("nee", scene_env, True)):
        batch_ms = batch_bound_ms = 0.0
        for b, (st, hit, rays, rand4, rest) in enumerate(k4_bounce_lanes(scene, nee)):
            method, mode, rr, bounce_i, _, rand2 = rest
            before = cuda_build.launch_counts()
            got = integrator._tail_k4(scene, st, hit, rays, rand4, *rest)
            after = cuda_build.launch_counts()
            plain_hit = {**hit, "is_hit": st["active"] & torch.isfinite(hit["t"])}
            tail_plain = lambda: integrator._tail_plain(  # noqa: E731
                scene, st, plain_hit, rays, rand4, *rest)
            want = tail_plain()
            torch.cuda.synchronize()
            bad, err = k4_mismatch(torch, got, want)
            res["err"] = max(res["err"], err)
            launched = {k: after[k] - before[k] for k in ("shade_bounce", "nee_add")}

            attrs = integrator.k4_attr_planes(scene, st["origin"], st["direction"], hit, method)
            k4 = lambda: shade_cuda.shade_bounce(  # noqa: E731
                scene, st, hit["t"], attrs, rand4, rand2, texture_mode=mode, rr=rr,
                gamble=rr and bounce_i >= integrator.RR_START, nee=nee)
            out = k4()
            ms = device_ms(torch, k4, reps, "shade_bounce_kernel")
            work = bounds.k4_work(scene, st, hit["t"], attrs, out["shaded"], nee, mode, rr)
            bnd = bounds.bound(work)
            batch_ms += ms
            batch_bound_ms += bnd["bound_ms"]
            row = {"set": label, "bounce": b, "lanes": work["lanes"], "hits": work["hits"],
                   "shaded": work["shaded"], "map_taps": work["map_taps"], "ms": ms,
                   "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                   "bytes_ms": bnd["bytes_ms"], "ops_ms": bnd["ops_ms"]}
            extra = ""
            if b == 0:
                row["plain_ms"] = cuda_ms(torch, tail_plain, 5)
                extra = f" plain_tail_ms={row['plain_ms']:.4f}"
                res[label] = row
                if nee:
                    lanes = torch.nonzero(out["shaded"]).squeeze(1)
                    ray = out["shadow"][:, lanes]
                    shot_t = traverse.intersect_scene(
                        scene, Vec3(ray[0], ray[1], ray[2]), Vec3(ray[3], ray[4], ray[5]),
                        method=method)["t"]
                    add_ms = device_ms(torch, lambda: shade_cuda.nee_add(out, lanes, shot_t),
                                       reps, "nee_add_kernel")
                    add_b = bounds.bound(bounds.nee_add_work(lanes.numel()))
                    res["nee_add"] = {"lanes": int(lanes.numel()), "ms": add_ms,
                                      "bound_ms": add_b["bound_ms"],
                                      "bound_by": add_b["bound_by"]}
                    extra += (f"; nee_add lanes={lanes.numel()} device_ms={add_ms:.4f} "
                              f"bound_ms={add_b['bound_ms']:.5f} ({add_b['bound_by']}) share "
                              f"{add_b['bound_ms'] / add_ms:.3f}")
            res["per_bounce"].append(row)
            adds = int(nee and bool(out["shaded"].any()))  # none over no shaded lane
            ok = not bad and launched == {"shade_bounce": 1, "nee_add": adds}
            print(f"phase3 K4 {label}/bounce{b}: lanes={work['lanes']} hits={work['hits']} "
                  f"shaded={work['shaded']} map_taps={work['map_taps']} "
                  f"bit_equal_to_plain_tail={not bad} differing={bad} max_abs_err={err:.3g} "
                  f"launches={launched} device_ms={ms:.4f} bound_ms={bnd['bound_ms']:.5f} "
                  f"({bnd['bound_by']}; bytes {work['bytes']} {bnd['bytes_ms']:.5f} ms, "
                  f"operations {work['ops']:.4g} {bnd['ops_ms']:.5f} ms) share "
                  f"{bnd['bound_ms'] / ms:.3f}{extra} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"K4 {label} bounce {b}")
        res[f"batch_ms_{label}"] = batch_ms
        res[f"batch_bound_ms_{label}"] = batch_bound_ms
        print(f"phase3 K4 {label} batch: device_ms={batch_ms:.4f} over its launches, "
              f"bound_ms={batch_bound_ms:.5f}", flush=True)

    # the engagement counter: every shaded lane of a frame through K4
    for label, scene, size, kw in (("render", scene_d, (WIDTH, HEIGHT), {}),
                                   ("nee", scene_env, (1024, 1024), {"nee": True})):
        spans.enable()
        try:
            t0 = time.perf_counter()
            renderer.render(scene, *size, spp=SPP, max_bounces=BOUNCES, seed=2, **kw)
            wall = time.perf_counter() - t0
            summary = spans.shade_summary(spans.collect())
        finally:
            spans.disable()
        res[f"spans_{label}"] = summary
        ok = summary["plain_lanes"] == 0 and summary["k4_lanes"] > 0
        print(f"phase3 K4 spans {label} {size[0]}x{size[1]} spp={SPP}: wall_s={wall:.3f} "
              f"{summary} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"K4 spans {label}")
    return res


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


def device_ms(torch, fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds per launch of the CUDA kernel whose name
    holds `kernel`, from torch.profiler (CUPTI) over `reps` calls after one
    warm-up call: the kernel's own time, whatever the host's launch rate.
    Before each call a read of L2_FLUSH_BYTES evicts the previous call's
    inputs and outputs from L2. CUPTI may drop a few kernel records from a
    window: a window where the profiler saw fewer than all launches but one
    is measured again, up to twice. Then the mean is taken over the window
    that saw the most launches, if it saw at least half of them; with
    fewer it raises."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    best_us, best_n = 0.0, 0
    for _window in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total",
                                                                     0.0)
            if kernel in e.key and e.device_type.name == "CUDA" and t > 0:
                us += t
                n += e.count
        if n > reps:
            raise RuntimeError(f"profiler saw {n} launches of {kernel}, expected {reps}")
        if n >= reps - 1:
            return us / n / 1e3
        print(f"device_ms: profiler saw {n} of {reps} launches of {kernel}; measuring again",
              flush=True)
        if n > best_n:
            best_us, best_n = us, n
    if 2 * best_n < reps:
        raise RuntimeError(f"profiler saw at most {best_n} of {reps} launches of {kernel} "
                           f"in 3 windows")
    print(f"device_ms: mean over the {best_n} of {reps} launches of {kernel} that the "
          f"profiler saw", flush=True)
    return best_us / best_n / 1e3


def psnr(np, a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return math.inf if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def compare_k1(torch, tc, label, scene, o, d, fuse, need_hits=True, phase="phase2"):
    """K1 with its epilogue and without it against the oracle on these
    rays (tri, t, u, v, and the epilogue's attrs), then timed as the main
    path runs it: fused on camera rays, bare on secondary ones. With
    need_hits, a tenth of the rays must hit."""
    got = tc.bvh_traverse(o, d, scene.triangles, scene.bvh, fuse_attr=True)
    bare = tc.bvh_traverse(o, d, scene.triangles, scene.bvh, fuse_attr=False)
    want = tc.bvh_traverse_plain(o, d, scene.triangles, fuse_attr=True)
    torch.cuda.synchronize()
    bad_tri = int((got["tri"] != want["tri"]).sum() + (bare["tri"] != want["tri"]).sum())
    hit = want["tri"] >= 0
    errs = [float((g[k] - want[k])[hit].abs().max()) if bool(hit.any()) else 0.0
            for g in (got, bare) for k in ("t", "u", "v")]
    if bool(hit.any()):
        errs.append(float((got["attrs"] - want["attrs"])[:, hit].abs().max()))
    err = max(errs)
    miss_ok = bool(torch.isinf(got["t"][~hit]).all() & torch.isinf(bare["t"][~hit]).all())
    dropped_inf = bool(torch.isinf(got["dropped_min"]).all()
                       & torch.isinf(bare["dropped_min"]).all())
    hit_rate = float(hit.float().mean())
    ok = (bad_tri == 0 and err <= K_TOL and miss_ok and dropped_inf
          and (hit_rate > 0.1 or not need_hits))
    launch = lambda: tc.bvh_traverse(o, d, scene.triangles, scene.bvh,  # noqa: E731
                                     fuse_attr=fuse)
    ms = cuda_ms(torch, launch, 20)
    dev_ms = device_ms(torch, launch, 20, "bvh_traverse")
    plain_ms = cuda_ms(torch, lambda: tc.bvh_traverse_plain(o, d, scene.triangles,
                                                            fuse_attr=fuse), 1)
    print(f"{phase} K1 {label}: rays={o.shape[0]} hit={hit_rate:.4f} "
          f"fused={fuse} tri_mismatch={bad_tri} max_abs_err={err:.3g} "
          f"dropped_min_inf={dropped_inf} kernel_ms={ms:.4f} device_ms={dev_ms:.4f} "
          f"plain_ms={plain_ms:.2f} {'ok' if ok else 'FAIL'}", flush=True)
    return ok, err, dev_ms, plain_ms, got


#: the CLI's -V lines that chip_smoke reads: (key, pattern)
CLI_STAGES = (
    ("load_bvh_ms", r"Bvh generated in (\d+)ms"), ("render_ms", r"^(\d+)ms$"),
    ("mrays_per_s", r"([\d.]+) Mrays/second"), ("rays", r"\((\d+) rays traced\)"),
    ("denoise_ms", r"Denoising: (\d+)ms"), ("write_ms", r"Output file written in (\d+)ms"),
    ("env_table_ms", r"Env light table built in (\d+)ms"),
)


def num(pattern, text) -> float:
    """The first group of the pattern's first match in text, or nan."""
    m = re.search(pattern, text, re.M)
    return float(m.group(1)) if m else float("nan")


def run_cli(cli, argv, cwd, **kw):
    """cli.main(argv, **kw) in-process from `cwd`; returns (exit code,
    stdout)."""
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, **kw)
    finally:
        os.chdir(old)
    return rc, buf.getvalue()


def run_parity_case(case: str, scene_dir: str, seed: int, out_dir: str, device="cuda"):
    """Render a PARITY_CASES case through the port's own entry point on
    `device`: the CLI in `scene_dir` (its output decoded by the port's PNG
    codec), or render() / bake_lightmap() of the model loaded without an env
    map. Returns the u8 image or the float32 lightmap."""
    from raytracing_c_tpu_torch import cli
    from raytracing_c_tpu_torch.io import image_io
    from raytracing_c_tpu_torch.io.loader import load_scene
    from raytracing_c_tpu_torch.render import lightmap, renderer

    spec = PARITY_CASES[case]
    if spec["entry"] == "cli":
        out = os.path.join(out_dir, parity_file(case, seed))
        rc, text = run_cli(cli, [*spec["argv"], "--seed", str(seed), "-O", out], scene_dir,
                           device=device)
        if rc != 0:
            raise RuntimeError(f"parity case {case}: the CLI exited {rc}\n{text[-2000:]}")
        return image_io.load_image_rgb_u8(out)
    scene = load_scene(os.path.join(scene_dir, spec["model"]), background_path=None,
                       warn=lambda *a, **k: None, device=device)
    if spec["entry"] == "render":
        return renderer.render(scene, seed=seed, **spec["kwargs"])[0]
    return jax_read_bake(lightmap, scene, seed, **spec["kwargs"])


def jax_read_bake(lightmap, scene, seed, width, height, samples, max_bounces):
    """bake_lightmap's batches, keys and arithmetic on the texel records
    the JAX package reads: it rasterizes the first n_triangles slots
    (raytracing_c_tpu/render/lightmap.py:_rasterize_host), which on a
    padded tree are the port's records of the slots below n, in the same
    order. The port's own bake also covers the triangles beyond slot n,
    and so draws other batches: the parity gate holds the arithmetic, the
    records are held by tests/test_torch_lightmap.py. Returns the map."""
    import numpy as np

    from raytracing_c_tpu_torch.utils import rng

    texels = lightmap.rasterize(scene, width, height)
    read = texels.select(texels.slot < scene.n_triangles)
    out = np.zeros((height * width, 3), np.float32)
    batches = range(-(-len(read) // lightmap.BATCH_TEXELS))
    lightmap.bake_batches(scene, read, out, rng.prng_key(seed, scene.device), batches,
                          samples=samples, max_bounces=max_bounces,
                          batch_texels=lightmap.BATCH_TEXELS, method="auto")
    return out.reshape(height, width, 3)


def port_only_texels(scene_dir: str, spec: dict, device="cuda"):
    """The lightmap case's texels that only the port covers (written only
    by triangles beyond slot n_triangles, which the JAX package does not
    read) and all the texels the port covers."""
    from raytracing_c_tpu_torch.io.loader import load_scene
    from raytracing_c_tpu_torch.render import lightmap

    scene = load_scene(os.path.join(scene_dir, spec["model"]), background_path=None,
                       warn=lambda *a, **k: None, device=device)
    texels = lightmap.rasterize(scene, spec["kwargs"]["width"], spec["kwargs"]["height"])
    below = set(texels.index[texels.slot < scene.n_triangles].tolist())
    covered = set(texels.index.tolist())
    return len(covered - below), len(covered)


#: phase 10's parity renders (c): (width, height, spp, bounces, nee, batch
#: pixels before the mesh rounds them to a multiple of its world size)
PARITY_RENDERS = ((256, 256, 2, 3, False, 16384), (128, 128, 2, 3, True, 16384))


def phase10_mesh(np, torch, ps, tc, renderer, serialization, launch, bounds, scene_d, img4,
                 wall4_s, spp, cam, k1_mid_ms, failures):
    """Phase 10: multi-device rendering, one process per rank
    (raytracing_c_tpu_torch/parallel/). The scene goes to the ranks as a
    scene cache; `launch.render_scene_cache` renders it on (a) one NCCL rank
    per card and (b) two gloo ranks on card 0: the flagship frame
    (compacted), then the parity renders of PARITY_RENDERS, each against the
    single-process render here (dense: bit for bit). Then (d): the stand-in
    with the SAH splitter, K1 on the phase-2 camera rays against the oracle
    and timed beside the midpoint tree's. Returns the per-rank launch
    counts of each world's flagship render and the SAH numbers."""
    n_cards = torch.cuda.device_count()
    renders = [dict(width=WIDTH, height=HEIGHT, spp=spp, max_bounces=BOUNCES, compact=True)]
    renders += [dict(width=w, height=h, spp=sp, max_bounces=b, nee=nee, compact=False,
                     batch_pixels=bp) for w, h, sp, b, nee, bp in PARITY_RENDERS]
    refs = {}  # (render index, batch pixels) -> the single-process render here
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        path = os.path.join(tmp, "standin.npz")
        t0 = time.perf_counter()
        serialization.save_scene_cache(path, scene_d)
        print(f"phase10 scene cache for the ranks: {os.path.getsize(path)} B written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()  # the ranks share card 0 with this process
        launches, walls = {}, {}
        for label, world, backend, devices in (
                ("a", n_cards, "nccl", [f"cuda:{k}" for k in range(n_cards)]),
                ("b", 2, "gloo", ["cuda:0", "cuda:0"])):
            t0 = time.perf_counter()
            results = launch.run_ranks(launch.render_scene_cache, world, backend, devices,
                                       path, renders)
            call_s = time.perf_counter() - t0
            img, st, per_rank = results[0]
            launches[label] = per_rank
            walls[label] = st.wall_ms / 1e3
            # one thread per ray runs only launches of WIDE_BELOW rays or more
            need = ["bvh_traverse_wide", "fetch_attrs"]
            if BATCH_RAYS // world >= tc.WIDE_BELOW:
                need.append("bvh_traverse")
            rel = abs(float(img.mean()) - float(img4.mean())) / float(img4.mean())
            ok = (all(c[k] > 0 for c in per_rank for k in need) and img.shape == img4.shape
                  and rel <= 0.02)
            print(f"phase10{label} {backend} world={world} devices={','.join(devices)} "
                  f"render {WIDTH}x{HEIGHT} spp={spp} bounces={BOUNCES} compact: "
                  f"wall_s={st.wall_ms / 1e3:.3f} rays={st.rays_traced} "
                  f"mrays_per_s={st.mrays_per_sec:.4f} batches={st.batches} "
                  f"mean={float(img.mean()):.3f} (phase 4 {float(img4.mean()):.3f}, rel "
                  f"{rel:.5f}, bound 0.02) launches_per_rank={per_rank} needed={need} "
                  f"call_s={call_s:.1f} (start-up, load, replication and all renders) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"phase 10{label} flagship")
            for i, (w, h, sp, b, nee, bp) in enumerate(PARITY_RENDERS, start=1):
                bp_mesh = max(world, bp // world * world)
                if (i, bp_mesh) not in refs:
                    refs[i, bp_mesh] = renderer.render(scene_d, w, h, spp=sp, max_bounces=b,
                                                       nee=nee, compact=False,
                                                       batch_pixels=bp_mesh)
                ref, ref_st = refs[i, bp_mesh]
                got, got_st = results[i][:2]
                same = bool((got == ref).all()) and got_st.rays_traced == ref_st.rays_traced
                print(f"phase10c {backend} world={world} {w}x{h} spp={sp} bounces={b} "
                      f"nee={nee} dense, batch_pixels={bp_mesh}: mesh vs single process "
                      f"identical={bool((got == ref).all())} rays {got_st.rays_traced} vs "
                      f"{ref_st.rays_traced} {'ok' if same else 'FAIL'}", flush=True)
                if not same:
                    failures.append(f"phase 10c {backend} {w}x{h} nee={nee}")
        print(f"phase10 flagship walls: phase 4 (one process) {wall4_s:.3f} s, (a) "
              f"{walls['a']:.3f} s, (b) {walls['b']:.3f} s; (a)/(b) {walls['a'] / walls['b']:.3f}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the SAH splitter on the card
    t0 = time.perf_counter()
    scene_sah = procedural_scene(ps, np, torch, scene_d.device, sah=True)
    build_s = time.perf_counter() - t0
    cam_o, cam_d = cam
    ok, err, sah_ms, _, _ = compare_k1(torch, tc, "camera/procedural SAH tree", scene_sah,
                                       cam_o, cam_d, True, phase="phase10d")
    mid_ms = device_ms(torch, lambda: tc.bvh_traverse(cam_o, cam_d, scene_d.triangles,
                                                      scene_d.bvh, fuse_attr=True),
                       20, "bvh_traverse")
    walks = {k: bounds.k1_work(sc, cam_o, cam_d, epilogue=True)
             for k, sc in (("sah", scene_sah), ("midpoint", scene_d))}
    sah_bound = bounds.bound(walks["sah"])
    print(f"phase10d SAH tree of the stand-in (built in {build_s:.1f} s with its scene): K1 "
          f"camera/procedural device_ms={sah_ms:.4f} vs midpoint tree {mid_ms:.4f} (phase 2: "
          f"{k1_mid_ms:.4f}); node visits per ray {walks['sah']['node_visits_per_ray']:.3f} vs "
          f"{walks['midpoint']['node_visits_per_ray']:.3f}, triangle tests per ray "
          f"{walks['sah']['tri_tests_per_ray']:.3f} vs "
          f"{walks['midpoint']['tri_tests_per_ray']:.3f}; bound_ms={sah_bound['bound_ms']:.4f} "
          f"({sah_bound['bound_by']}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("phase 10d K1 on the SAH tree")
    return launches, {"sah_ms": sah_ms, "sah_midpoint_ms": mid_ms, "sah_max_abs_err": err,
                      "sah_bound_ms": sah_bound["bound_ms"]}


#: phase 11's cases rendered twice, which must give the same bytes
PARITY_TWICE = ("glb_env", "glb_nee")


def _db(x: float):
    return round(x, 4) if math.isfinite(x) else "inf"


def phase11_parity(np, reset_counts, counts, failures, device="cuda"):
    """Phase 11, the parity gate: every PARITY_CASES case rendered through
    the port's own entry point on `device` (seed 42) against the JAX
    package's reference (tests/goldens_torch16/, made by
    tools/make_torch_parity_refs.py): PSNR >= PSNR_MIN, with the seed-43
    floor and the share of byte-equal pixels beside it. The scene files
    are written anew and must hash to the manifest's sha256, and each case
    must be the manifest's; the PARITY_TWICE cases are rendered again and
    must be byte-identical. The launch counters are zeroed just before and
    read just after. Returns the {"parity": ...} record and the counts."""
    from raytracing_c_tpu_torch.io import image_io

    with open(os.path.join(PARITY_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    seed = PARITY_SEEDS[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parity_")
    try:
        scene_dir, out_dir = os.path.join(tmp, "scene"), os.path.join(tmp, "out")
        os.makedirs(scene_dir)
        os.makedirs(out_dir)
        sha = write_parity_scene(scene_dir)
        want = manifest["scene"]
        same_scene = sha == want["sha256"] and PARITY_SCENE == want["writers"]
        print(f"phase11 parity scene {PARITY_SCENE}: {len(sha)} files, sha256 as the "
              f"manifest's={same_scene} {'ok' if same_scene else 'FAIL'}", flush=True)
        if not same_scene:
            failures.append("phase 11 parity scene")
            return None, None
        cases = {}
        reset_counts()
        for case, spec in PARITY_CASES.items():
            ref_meta = manifest["cases"].get(case, {})
            defined = {k: ref_meta.get(k) for k in spec} == spec
            path = os.path.join(PARITY_DIR, parity_file(case, seed))
            ref = np.load(path) if path.endswith(".npy") else image_io.load_image_rgb_u8(path)
            t0 = time.perf_counter()
            got = run_parity_case(case, scene_dir, seed, out_dir, device)
            wall = time.perf_counter() - t0
            shaped = got.shape == ref.shape and got.dtype == ref.dtype
            p = parity_psnr(np, got, ref) if shaped else -math.inf
            equal = float((got == ref).all(-1).mean()) if shaped else 0.0
            ok = defined and shaped and p >= PSNR_MIN
            cases[case] = {"psnr_db": _db(p), "floor_db": ref_meta.get("floor_db"),
                           "byte_equal": round(equal, 6), "port_wall_s": round(wall, 3),
                           "jax_wall_s": ref_meta.get("jax_wall_s", [None])[0], "ok": ok}
            print(f"phase11 parity {case} ({spec['entry']}) {'x'.join(map(str, got.shape))}: "
                  f"PSNR={p:.2f} dB vs the JAX ref (bound {PSNR_MIN:g}; seed-43 floor "
                  f"{ref_meta.get('floor_db')} dB) byte_equal={equal:.4f} wall_s={wall:.2f} "
                  f"(JAX on the CPU {cases[case]['jax_wall_s']} s) case_as_manifest={defined} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"phase 11 parity {case}")
            if spec["entry"] == "bake_lightmap":
                only, covered = port_only_texels(scene_dir, spec, device)
                cases[case]["port_only_texels"] = only
                print(f"phase11 parity {case}: texels only the port's bake covers (triangles "
                      f"beyond slot n) {only} of {covered}", flush=True)
            if case in PARITY_TWICE:
                again = run_parity_case(case, scene_dir, seed, out_dir, device)
                same = again.shape == got.shape and bool((again == got).all())
                cases[case]["twice_identical"] = same
                print(f"phase11 parity {case} rendered twice: byte-identical={same} "
                      f"{'ok' if same else 'FAIL'}", flush=True)
                if not same:
                    failures.append(f"phase 11 determinism {case}")
        launches = counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ran = all(v > 0 for v in launches.values())
    print(f"phase11 launches={launches} every kernel ran={ran} {'ok' if ran else 'FAIL'}",
          flush=True)
    if not ran:
        failures.append("phase 11 launches")
    return {"bound_db": PSNR_MIN, "seed": seed, "cases": cases, "launches": launches}, launches


def phase12_bvh_viz(np, torch, ps, scene, reset_counts, counts, failures, n=88, size=512):
    """Phase 12, the BVH inspector (raytracing_c_tpu_torch/tools/bvh_viz.py)
    on `scene`, the stand-in of n x n quads on its device: (a) the OBJ dump
    byte-identical to the dump of the same mesh built on the CPU, its level
    counts those of the node rows' non-zero lanes; (b) overlay_levels at
    size x size, the counters zeroed just before and read just after (both
    K1 kernels and K2 must have run), each level PNG decoded by the port's
    codec and equal to a direct render() outside its wireframe pixels,
    which hold the level's colour; (c) the interactive view's snapshot; (d)
    `python -m raytracing_c_tpu_torch.tools.bvh_viz standin.glb out.obj` in
    a subprocess (on the GPU, as the module always runs). Returns the
    overlay's launch counts."""
    from raytracing_c_tpu_torch.io import image_io
    from raytracing_c_tpu_torch.render import renderer
    from raytracing_c_tpu_torch.tools import bvh_viz

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bvh_viz_")
    try:
        # (a) the dump, against the CPU build's and the node rows
        t0 = time.perf_counter()
        stats = bvh_viz.dump_bvh_obj(scene, os.path.join(tmp, "dev.obj"))
        dump_s = time.perf_counter() - t0
        bvh_viz.dump_bvh_obj(procedural_scene(ps, np, torch, "cpu", n=n, tex=64),
                             os.path.join(tmp, "cpu.obj"))
        with open(os.path.join(tmp, "dev.obj"), "rb") as f, \
                open(os.path.join(tmp, "cpu.obj"), "rb") as g:
            same = f.read() == g.read()
        lanes = (scene.bvh.nodes.cpu().numpy()[:, :48].reshape(-1, 6, 8) != 0).any(1)
        first = [(8 ** d - 1) // 7 for d in range(scene.bvh.depth + 1)]
        rows = {d: int(lanes[first[d]:first[d + 1]].sum()) for d in range(scene.bvh.depth)}
        ok_a = same and stats == rows
        print(f"phase12 dump: depth={scene.bvh.depth} boxes per level {stats} (node rows' "
              f"non-zero lanes {rows}) in {dump_s:.3f} s; byte-identical to the CPU build's "
              f"dump={same} {'ok' if ok_a else 'FAIL'}", flush=True)
        if not ok_a:
            failures.append("phase 12 dump")

        # (b) the overlay through the render path, against a direct render
        prefix = os.path.join(tmp, "ov")
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            bvh_viz.overlay_levels(scene, prefix, size)
        overlay_s = time.perf_counter() - t0
        launches = counts()
        ran = all(launches[k] > 0 for k in ("bvh_traverse", "bvh_traverse_wide", "fetch_attrs"))
        print(f"phase12 overlay {size}x{size}: wall_s={overlay_s:.3f} launches={launches} "
              f"K1 (both kernels) and K2 ran={ran} {'ok' if ran else 'FAIL'}", flush=True)
        if not ran:
            failures.append("phase 12 launches")
        ref = renderer.render(scene, size, size, spp=4, max_bounces=3, seed=0)[0]
        said = buf.getvalue().splitlines()
        ok_b = len(said) == scene.bvh.depth
        for d, (segs, n_boxes) in enumerate(bvh_viz._overlay_segments(scene, size)):
            path = f"{prefix}_level{d}.png"
            with open(path, "rb") as f:
                img = image_io.decode_png(f.read())
            mask = np.zeros((size, size), bool)
            mask[bvh_viz._line_pixels(segs, size, size)] = True
            color = bvh_viz.LEVEL_COLORS[d % len(bvh_viz.LEVEL_COLORS)]
            ok = (img.shape == ref.shape and bool((img[~mask] == ref[~mask]).all())
                  and bool((img[mask] == color).all())
                  and said[d:d + 1] == [f"{path}: {n_boxes} boxes"])
            ok_b &= ok
            print(f"phase12 overlay level {d}: {n_boxes} boxes, {int(mask.sum())} wireframe "
                  f"pixels of colour {color}; the other {int((~mask).sum())} equal a direct "
                  f"render() {'ok' if ok else 'FAIL'}", flush=True)
        if not ok_b:
            failures.append("phase 12 overlay")

        # (c) the interactive view's headless snapshot
        snap = os.path.join(tmp, "snap.png")
        with contextlib.redirect_stdout(io.StringIO()):
            bvh_viz.interactive(scene, snapshot=snap)
        with open(snap, "rb") as f:
            img = image_io.decode_png(f.read())
        lit = float((img > 0).mean())
        ok_c = img.shape == (512, 512, 3) and lit > 0.001
        print(f"phase12 snapshot: {'x'.join(map(str, img.shape))}, lit share {lit:.4f} "
              f"{'ok' if ok_c else 'FAIL'}", flush=True)
        if not ok_c:
            failures.append("phase 12 snapshot")

        # (d) the tool's own entry point, on the GPU
        write_glb(os.path.join(tmp, "standin.glb"), n=n, tex=64)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "raytracing_c_tpu_torch.tools.bvh_viz", "standin.glb",
             "out.obj"], cwd=tmp, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
            text=True, timeout=600)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        ok_d = proc.returncode == 0 and f"depth={scene.bvh.depth}," in line
        print(f"phase12 python -m raytracing_c_tpu_torch.tools.bvh_viz standin.glb out.obj: "
              f"exit={proc.returncode} wall_s={time.perf_counter() - t0:.1f} said {line!r} "
              f"{'ok' if ok_d else 'FAIL'}", flush=True)
        if not ok_d:
            print(proc.stderr[-4000:], flush=True)
            failures.append("phase 12 python -m")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase12 wall_s={time.perf_counter() - t_phase:.3f}", flush=True)
    return launches


#: phase 13's render() batch loops at limit_batches=8: (k_group, accumulate)
BATCH_LOOPS = ((4, True), (4, False), (1, True), (1, False))
#: the launch counters that render() moves (K3 runs only with -D)
RENDER_KERNELS = ("bvh_traverse", "bvh_traverse_wide", "fetch_attrs", "shade_bounce")
#: phase 13d's frame side: one batch of 262,144 rays at 4 spp
METHODS_SIZE = 256


def phase13_batch_api(np, torch, scene, img4, spp, reset_counts, counts, failures):
    """Phase 13, render()'s batch loop, the batch API and the JAX method
    names on `scene` at the flagship shape and phase 4's spp: (a)
    render(limit_batches=8) for each BATCH_LOOPS case, the counters zeroed
    just before and read just after each: byte-equal images, equal rays,
    batches and K1/K2/K4 launches, each kernel launched; the 8 batches through
    render_batches_grouped equal (a)'s frame and rays; (b) render(
    limit_batches=5) with the defaults (k_group 4, accumulate) equals (a)'s
    image, the whole last group drawn, and counts the rays of batches 0-4;
    (c) render_batch_indexed at b = 0 and at the padded last batch (a 0-d
    tensor on the card) equals the rows of (a)'s and phase 4's frames, and
    render_batches_grouped from the last batch gives it 4 times; (d)
    render() at 256x256, 4 spp with every JAX method name: each name
    mapped to K1 equal to method="bvh" byte for byte, "brute" within
    PSNR_MIN of it, an unknown name a ValueError. Returns (a)'s launches."""
    from raytracing_c_tpu_torch.ops import traverse
    from raytracing_c_tpu_torch.render import renderer
    from raytracing_c_tpu_torch.utils import rng

    t_phase = time.perf_counter()
    n_pixels = WIDTH * HEIGHT
    bp = BATCH_RAYS // spp  # render()'s default batch
    kw = dict(spp=spp, max_bounces=BOUNCES, seed=0, batch_pixels=bp)
    n_batches = -(-n_pixels // bp)
    xs, ys, perm = renderer._pixel_tables_device(WIDTH, HEIGHT, n_batches * bp - n_pixels,
                                                 scene.device)
    perm = perm.cpu().numpy()

    def rows(frame, b):  # batch b's pixels of an (H, W, 3) frame, in batch order
        return frame.reshape(-1, 3)[perm[b * bp:min((b + 1) * bp, n_pixels)]]

    def same_rows(frame, b, rgb):
        want = rows(frame, b)
        return bool((rgb[:len(want)].cpu().numpy() == want).all())

    runs = []
    for k, acc in BATCH_LOOPS:
        reset_counts()
        t0 = time.perf_counter()
        img, st = renderer.render(scene, WIDTH, HEIGHT, limit_batches=8, k_group=k,
                                  accumulate=acc, **kw)
        wall = time.perf_counter() - t0
        c = counts()
        c = {name: c[name] for name in RENDER_KERNELS}
        runs.append((img, st, c))
        print(f"phase13a render(limit_batches=8, k_group={k}, accumulate={acc}): "
              f"wall_s={wall:.3f} rays={st.rays_traced} batches={st.batches} launches={c}",
              flush=True)
    img8, st8, c8 = runs[0]
    ok = (all((img == img8).all() and (st.rays_traced, st.batches, c)
              == (st8.rays_traced, st8.batches, c8) for img, st, c in runs)
          and st8.batches == 8 and all(v > 0 for v in c8.values()) and img8.std() > 5.0)
    key = rng.prng_key(0, scene.device)
    bkw = dict(width=WIDTH, height=HEIGHT, spp=spp, max_bounces=BOUNCES, batch_px=bp,
               method="auto", compact=True)
    t0 = time.perf_counter()
    rgb8, rays8 = renderer.render_batches_grouped(scene, xs, ys, key, 0, k_group=8, **bkw)
    wall_g = time.perf_counter() - t0
    per_batch = [int(r) for r in rays8.cpu()]
    grouped_ok = (all(same_rows(img8, b, rgb8[b]) for b in range(8))
                  and sum(per_batch) == st8.rays_traced)
    print(f"phase13a byte_equal={all((img == img8).all() for img, _, _ in runs)} "
          f"render_batches_grouped(b0=0, k_group=8): wall_s={wall_g:.3f} rays per batch "
          f"{per_batch} equal to the frame={grouped_ok} {'ok' if ok and grouped_ok else 'FAIL'}",
          flush=True)
    if not (ok and grouped_ok):
        failures.append("phase 13a batch loops")

    t0 = time.perf_counter()
    img5, st5 = renderer.render(scene, WIDTH, HEIGHT, limit_batches=5, **kw)
    wall5 = time.perf_counter() - t0
    ok = (bool((img5 == img8).all()) and st5.rays_traced == sum(per_batch[:5])
          and st5.batches == 5)
    lit = [bool(rows(img5, b).any()) for b in range(8)]
    print(f"phase13b render(limit_batches=5): wall_s={wall5:.3f} equal to (a)'s 8-batch image="
          f"{bool((img5 == img8).all())} batches lit {lit} rays={st5.rays_traced} (batches 0-4 "
          f"{sum(per_batch[:5])}) batches={st5.batches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("phase 13b limit_batches")

    last = n_batches - 1
    t0 = time.perf_counter()
    rgb0, r0 = renderer.render_batch_indexed(scene, xs, ys, key, 0, **bkw)
    rgb_l, r_l = renderer.render_batch_indexed(
        scene, xs, ys, key, torch.tensor(last, device=scene.device), **bkw)
    rgb_g, r_g = renderer.render_batches_grouped(scene, xs, ys, key, last, k_group=4, **bkw)
    wall_c = time.perf_counter() - t0
    ok = (same_rows(img8, 0, rgb0) and int(r0) == per_batch[0] and same_rows(img4, last, rgb_l)
          and all(torch.equal(g, rgb_l) for g in rgb_g) and all(int(r) == int(r_l) for r in r_g))
    print(f"phase13c render_batch_indexed b=0 and b={last} (padded: {n_pixels - last * bp} "
          f"pixels of {bp}), render_batches_grouped(b0={last}, k_group=4): wall_s={wall_c:.3f} "
          f"equal to the frames' rows and to each other={ok} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failures.append("phase 13c render_batch_indexed")

    small = dict(spp=4, max_bounces=BOUNCES, seed=3)
    ref, st_ref = renderer.render(scene, METHODS_SIZE, METHODS_SIZE, method="bvh", **small)
    ok = True
    for name in ("auto", *traverse.JAX_METHODS):
        t0 = time.perf_counter()
        got, st = renderer.render(scene, METHODS_SIZE, METHODS_SIZE, method=name, **small)
        wall = time.perf_counter() - t0
        port = traverse.port_method(name, scene)
        if port == "bvh":
            good = bool((got == ref).all()) and st.rays_traced == st_ref.rays_traced
            said = f"byte_equal to bvh={good}"
        else:
            p = psnr(np, got, ref)
            good = p >= PSNR_MIN
            said = f"vs bvh PSNR={p:.2f} dB"
        ok &= good
        print(f"phase13d method={name} -> {port} {METHODS_SIZE}x{METHODS_SIZE} spp=4: "
              f"wall_s={wall:.3f} {said} {'ok' if good else 'FAIL'}", flush=True)
    try:
        renderer.render(scene, METHODS_SIZE, METHODS_SIZE, method="no_such_method", **small)
        raised = False
    except ValueError:
        raised = True
    print(f"phase13d method=no_such_method raises ValueError={raised} "
          f"{'ok' if raised else 'FAIL'}", flush=True)
    if not (ok and raised):
        failures.append("phase 13d method names")
    print(f"phase13 wall_s={time.perf_counter() - t_phase:.3f}", flush=True)
    return c8


#: phase 14's lane counts: the render batch's lanes entering bounces 0, 1, 2
#: and 7 (PERF.md section 5)
K5_LANES = (262_144, 203_896, 49_857, 1_871)


def phase14_k5(torch, failures, reps: int = 20) -> dict:
    """Phase 14 (module docstring): K5's draws at the main path's widths on
    the card, each against the plain int64 version run on the same card
    (every word bit-equal), timed with its bound (`bounds.k5_*_work`) and
    beside the plain version's wall. Returns the kernels line's figures."""
    from raytracing_c_tpu_torch.ops import rng_cuda
    from raytracing_c_tpu_torch.utils import bounds, rng

    dev = torch.device("cuda", 0)
    key = rng.fold_in(rng.prng_key(0, dev), 5)
    k1 = rng.fold_in(key, 1)
    order = torch.randperm(BATCH_RAYS, generator=torch.Generator().manual_seed(14))
    rows, err = [], 0

    def run(label, kernel, k5, plain, work):
        nonlocal err
        got, want = k5(), plain()
        torch.cuda.synchronize()
        a = got.view(torch.int32) if got.dtype == torch.float32 else got
        w = want.contiguous()
        w = w.view(torch.int32) if w.dtype == torch.float32 else w
        bad = int((a != w).sum()) if a.shape == w.shape else -1
        err = max(err, abs(bad))
        ms = device_ms(torch, k5, reps, kernel)
        plain_ms = cuda_ms(torch, plain, 3)
        b = bounds.bound(work)
        row = {"draw": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
               "bound_by": b["bound_by"], "differing": bad}
        rows.append(row)
        ok = bad == 0
        print(f"phase14 K5 {label}: bit_equal_to_plain={ok} differing={bad} "
              f"device_ms={ms:.5f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']}; bytes "
              f"{work['bytes']} {b['bytes_ms']:.5f} ms, operations {work['ops']:.4g} "
              f"{b['ops_ms']:.5f} ms) share {b['bound_ms'] / ms:.3f} plain_ms={plain_ms:.3f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"K5 {label}")
        return row

    for lanes in K5_LANES:
        slot = order[:lanes].sort().values.to(dev)  # compaction keeps the slots' order
        for nu in (3, 7):
            run(f"bounce_uniforms lanes={lanes} nu={nu}", "k5_bounce_uniforms_kernel",
                lambda: rng_cuda.bounce_uniforms(k1, slot, 2, nu),
                lambda: rng._bounce_uniforms_plain(k1, slot, 2, nu),
                bounds.k5_bounce_work(lanes, nu))
    # the batch draws (renderer.py: render_batch_indexed, _draw_uniforms, render_batch)
    run("fold_in(key, b)", "k5_fold_in_kernel", lambda: rng_cuda.fold_in(key, 57),
        lambda: rng._fold_in_plain(key, 57), bounds.k5_key_work(1))
    run("split(key)", "k5_split_kernel", lambda: rng_cuda.split(key),
        lambda: rng._split_plain(key, 2), bounds.k5_key_work(2))
    for shape in ((2, BATCH_RAYS), (BOUNCES, 4, BATCH_RAYS), (BOUNCES, 3, BATCH_RAYS)):
        run(f"uniform{shape}", "k5_bits_kernel", lambda: rng_cuda.uniform(key, shape),
            lambda: rng._uniform_plain(key, shape), bounds.k5_uniform_work(math.prod(shape)))
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    run(f"uniform(3, {BATCH_RAYS}) on normal's bounds", "k5_bits_kernel",
        lambda: rng_cuda.uniform(key, (3, BATCH_RAYS), lo, 1.0),
        lambda: rng._uniform_plain(key, (3, BATCH_RAYS), lo, 1.0),
        bounds.k5_uniform_work(3 * BATCH_RAYS))
    by = {r["draw"]: r for r in rows}
    batch = (2 * by["fold_in(key, b)"]["ms"] + by["split(key)"]["ms"]
             + by[f"uniform{(2, BATCH_RAYS)}"]["ms"]
             + sum(by[f"bounce_uniforms lanes={n} nu=3"]["ms"] for n in K5_LANES))
    print(f"phase14 K5 a compacted render batch's draws (4 a batch, the bounces at "
          f"{', '.join(map(str, K5_LANES))} lanes): device_ms={batch:.5f}", flush=True)
    return {"err": err, "rows": rows, "batch_ms": batch}


def fresh_flagship(spp: int) -> dict:
    """The flagship render() (phase 4's frame, warm-up and all) in a fresh
    Python process, first with no profiler ever started, then again after
    one profiler window like device_ms's: `chip_smoke.py --flagship-only
    SPP`. Returns its {"flagship": ...} record and the process's own
    wall."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--flagship-only",
                           str(spp)], cwd=HERE, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"--flagship-only exited {proc.returncode}\n{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])["flagship"]
    rec["process_s"] = round(time.perf_counter() - t0, 3)
    return rec


def flagship_only(np, torch, spp: int) -> int:
    """--flagship-only: phase 4's render in this process alone (scene
    build, a 2-batch warm-up, then the frame), then one torch.profiler
    window around a single launch, as device_ms opens, and the frame
    again; prints one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.render import renderer

    scene_d = procedural_scene(ps, np, torch, torch.device("cuda", 0))
    renderer.render(scene_d, WIDTH, HEIGHT, spp=spp, max_bounces=BOUNCES, limit_batches=2)
    frame = lambda: renderer.render(scene_d, WIDTH, HEIGHT, spp=spp,  # noqa: E731
                                    max_bounces=BOUNCES, seed=0, method="auto")
    img, st = frame()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1024, device="cuda").sum()
        torch.cuda.synchronize()
    _, after = frame()
    print(json.dumps({"flagship": {"wall_s": st.wall_ms / 1e3, "rays": st.rays_traced,
                                   "mrays_per_s": st.mrays_per_sec, "mean": float(img.mean()),
                                   "wall_after_profiler_s": after.wall_ms / 1e3}}))
    return 0


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
        from raytracing_c_tpu_torch import cli, native
        from raytracing_c_tpu_torch.io import image_io
        from raytracing_c_tpu_torch.io.gltf_loader import parse_glb
        from raytracing_c_tpu_torch.models import scene as ps
        from raytracing_c_tpu_torch.models import serialization
        from raytracing_c_tpu_torch.ops import cuda_build
        from raytracing_c_tpu_torch.ops import denoise as dn
        from raytracing_c_tpu_torch.ops import env_light
        from raytracing_c_tpu_torch.ops import traverse_cuda as tc
        from raytracing_c_tpu_torch.parallel import launch
        from raytracing_c_tpu_torch.render import lightmap, renderer
        from raytracing_c_tpu_torch.utils import bounds
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    if "--flagship-only" in argv:
        return flagship_only(np, torch, int(argv[argv.index("--flagship-only") + 1]))
    save = argv[argv.index("--save") + 1] if "--save" in argv else None

    t_start = time.perf_counter()
    failures = []
    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    print(f"phase1 gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build = cuda_build.build_libraries()
    tc._library()
    dn._library()
    print(f"phase1 build: one nvcc per source, {len(build['libraries'])} in parallel "
          f"({', '.join(sorted(build['libraries']))}) in {build['seconds']:.1f} s -> "
          f"{build['dir']}", flush=True)

    t0 = time.perf_counter()
    scene_d = procedural_scene(ps, np, torch, dev)
    soup_d = soup_scene(ps, np, dev)
    print(f"phase1 scenes: procedural {scene_d.n_triangles} triangles depth "
          f"{scene_d.bvh.depth}; soup {soup_d.n_triangles} triangles depth "
          f"{soup_d.bvh.depth}; build {time.perf_counter() - t0:.1f} s", flush=True)
    for label, sc in (("procedural", scene_d), ("soup", soup_d)):
        tab = tc.k1_tables(sc.bvh, sc.triangles)  # built by build_scene
        print(f"phase1 K1 tables {label}: nodes {tab.nodes.numel() * 4} B, triangles "
              f"{tab.tris.numel() * 4} B ({tab.tris.shape[0] // 3} occupied slots of "
              f"{sc.triangles.capacity}), built in {tab.seconds * 1e3:.2f} ms", flush=True)
    env_img = make_env_map()
    scene_env = with_env_map(ps, torch, scene_d, env_img)
    t0 = time.perf_counter()
    env = env_light.scene_env_light(scene_env)
    print(f"phase1 env-light table: {env.w}x{env.h} equirect map, alias table built on the "
          f"host in {env.seconds:.3f} s ({time.perf_counter() - t0:.3f} s with the upload)",
          flush=True)

    # --- phase 2: K1 against its plain version at the main path's batch ---
    spp_px = BATCH_RAYS // SPP
    n_batches = math.ceil(WIDTH * HEIGHT / spp_px)
    sets, shadow_sets, (rad, rays) = k1_ray_sets(scene_d, soup_d, scene_env, dev)
    cam_o, cam_d = sets[0][2:4]
    b1_o, b1_d = sets[4][2:4]
    b2_o, b2_d = sets[5][2:4]
    k1_err = {"bvh_traverse": 0.0, "bvh_traverse_wide": 0.0}
    runs = {}
    for n, (label, sc, o, d, fuse) in enumerate(sets):
        kernel = "bvh_traverse_wide" if o.shape[0] < tc.WIDE_BELOW else "bvh_traverse"
        ok, err, ms, plain_ms, got = compare_k1(torch, tc, label, sc, o, d, fuse,
                                                need_hits=n < 5)
        runs[label] = (ms, plain_ms, got, o.shape[0])
        k1_err[kernel] = max(k1_err[kernel], err)
        if not ok:
            failures.append(f"K1 {label}")
    if sets[4][2].shape[0] < tc.WIDE_BELOW or b2_o.shape[0] >= tc.WIDE_BELOW:
        failures.append("K1: bounce 1 not on one thread per ray, or bounce 2 not wide")
    k1_ms, k1_plain_ms, cam_hit, _ = runs["camera/procedural"]
    k1_bounds = {}
    for label, o, d, fuse in (("camera/procedural", cam_o, cam_d, True),
                              ("bounce1/procedural", b1_o, b1_d, False),
                              ("bounce2/procedural", b2_o, b2_d, False)):
        t0 = time.perf_counter()
        work = bounds.k1_work(scene_d, o, d, epilogue=fuse)
        k1_bounds[label] = b = bounds.bound(work)
        print(f"phase2 K1 bound {label}: host re-walk of {work['sample']} of {o.shape[0]} "
              f"rays ({time.perf_counter() - t0:.1f} s): {work['node_visits_per_ray']:.2f} "
              f"node visits, {work['box_tests_per_ray']:.2f} box tests, "
              f"{work['leaf_visits_per_ray']:.2f} leaf visits, {work['tri_tests_per_ray']:.2f} "
              f"triangle tests ({work['tri_ops_per_ray']:.1f} operations) per ray; "
              f"epilogue={fuse} bytes {work['bytes']:.4g} ops {work['ops']:.4g} -> bound_ms={b['bound_ms']:.4f} ({b['bound_by']}), share "
              f"{b['bound_ms'] / runs[label][0]:.3f}", flush=True)
    k1_bound = k1_bounds["camera/procedural"]

    # the NEE shadow rays of bounces 0 and 1, held and timed on each kernel
    shadow = {"bvh_traverse": [], "bvh_traverse_wide": []}
    wide_below = tc.WIDE_BELOW
    for label, sc, o, d, _ in shadow_sets:
        work = bounds.k1_work(sc, o, d, epilogue=False)
        b = bounds.bound(work)
        auto = "bvh_traverse_wide" if o.shape[0] < wide_below else "bvh_traverse"
        for kernel, limit in (("bvh_traverse", 0), ("bvh_traverse_wide", 2**31)):
            tc.WIDE_BELOW = limit
            try:
                ok, err, ms, plain_ms, got = compare_k1(torch, tc, f"{label} on {kernel}", sc,
                                                        o, d, False, need_hits=False)
            finally:
                tc.WIDE_BELOW = wide_below
            k1_err[kernel] = max(k1_err[kernel], err)
            occluded = float((got["tri"] >= 0).float().mean())
            shadow[kernel].append({"set": label, "rays": int(o.shape[0]), "picked": kernel == auto,
                                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                                   "bound_by": b["bound_by"]})
            print(f"phase2 K1 shadow {label} on {kernel}: rays={o.shape[0]} "
                  f"occluded={occluded:.4f} picked_by_wrapper={kernel == auto} device_ms={ms:.4f} "
                  f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']}; "
                  f"{work['node_visits_per_ray']:.2f} node visits, "
                  f"{work['tri_tests_per_ray']:.2f} triangle tests per ray) "
                  f"share {b['bound_ms'] / ms:.3f} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"K1 {label} on {kernel}")

    # --- phase 3: K2 against its plain version on the camera hits ---
    attr_rows = scene_d.triangles.attr_rows
    args = (attr_rows, cam_hit["tri"], cam_hit["u"], cam_hit["v"])
    got2, want2 = tc.fetch_attrs(*args), tc.fetch_attrs_plain(*args)
    torch.cuda.synchronize()
    k2_err = float((got2 - want2).abs().max())
    k2_event_ms = cuda_ms(torch, lambda: tc.fetch_attrs(*args), 50)
    k2_ms = device_ms(torch, lambda: tc.fetch_attrs(*args), 50, "fetch_attrs")
    k2_plain_ms = cuda_ms(torch, lambda: tc.fetch_attrs_plain(*args), 10)
    winners = int(torch.unique(cam_hit["tri"].clamp_min(0)).numel())
    k2_bound = bounds.bound(bounds.k2_work(BATCH_RAYS, winners))
    k2_ok = k2_err <= K_TOL and bool(torch.isfinite(got2).all())
    print(f"phase3 K2 camera/procedural: rays={BATCH_RAYS} max_abs_err={k2_err:.3g} "
          f"kernel_ms={k2_event_ms:.4f} device_ms={k2_ms:.4f} plain_ms={k2_plain_ms:.4f} "
          f"winners={winners} "
          f"bound_ms={k2_bound['bound_ms']:.4f} ({k2_bound['bound_by']}), share "
          f"{k2_bound['bound_ms'] / k2_ms:.3f} {'ok' if k2_ok else 'FAIL'}", flush=True)
    if not k2_ok:
        failures.append("K2")
    k4 = phase3_k4(torch, scene_d, scene_env, failures)

    # --- phase 4: the render path through render() ---
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
    cuda_build.reset_launch_counts()
    img, st = renderer.render(scene_d, WIDTH, HEIGHT, spp=spp, max_bounces=BOUNCES,
                              seed=0, method="auto")
    launches4 = cuda_build.launch_counts()
    distinct = len(np.unique(img.reshape(-1, 3), axis=0))
    main_ok = (launches4["bvh_traverse"] > 0 and launches4["bvh_traverse_wide"] > 0
               and launches4["fetch_attrs"] > 0 and launches4["shade_bounce"] > 0
               and img.shape == (HEIGHT, WIDTH, 3)
               and float(img.std()) > 5.0 and distinct > 1000)
    print(f"phase4 render {WIDTH}x{HEIGHT} spp={spp} bounces={BOUNCES}: "
          f"wall_s={st.wall_ms / 1e3:.3f} rays={st.rays_traced} "
          f"mrays_per_s={st.mrays_per_sec:.4f} batches={st.batches} "
          f"launches={launches4} mean={float(img.mean()):.2f} std={float(img.std()):.2f} "
          f"distinct_colors={distinct} {'ok' if main_ok else 'FAIL'}", flush=True)
    if not main_ok:
        failures.append("render path")
    if save:
        image_io.write_png(save, img)
    fresh = fresh_flagship(spp)
    rel = abs(fresh["mean"] - float(img.mean())) / float(img.mean())
    ok = fresh["rays"] > 0 and rel <= 0.02
    print(f"phase4 fresh process (chip_smoke.py --flagship-only {spp}, no profiler ever "
          f"started; scene build and warm-up as here): wall_s={fresh['wall_s']:.3f} "
          f"rays={fresh['rays']} mrays_per_s={fresh['mrays_per_s']:.4f} beside this process's "
          f"wall_s={st.wall_ms / 1e3:.3f} (after phases 2-3 profiled); ratio "
          f"{st.wall_ms / 1e3 / fresh['wall_s']:.3f}; the fresh process again after one "
          f"profiler window: wall_s={fresh['wall_after_profiler_s']:.3f}; mean rel {rel:.2g} "
          f"process_s={fresh['process_s']:.1f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("phase 4 fresh process")

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

    # --- phase 6: K3 against its plain version at the flagship frame size ---
    fire, fire_mask = firefly_image(np, HEIGHT, WIDTH)
    k3_err = 0
    for label, im in (("fireflies", fire), ("phase-4 frame", img)):
        x = torch.from_numpy(im).to(dev)
        got3, want3 = dn.denoise_u8(x), dn.denoise_u8_plain(x)
        torch.cuda.synchronize()
        err = int((got3.int() - want3.int()).abs().max())
        k3_err = max(k3_err, err)
        changed = (got3 != x).any(-1).cpu().numpy()
        line = (f"phase6 K3 {label} {WIDTH}x{HEIGHT}: max_abs_err={err} "
                f"identical={bool((got3 == want3).all())} changed_share={changed.mean():.5f}")
        ok6 = err <= K3_TOL
        if label == "fireflies":
            fixed = float(changed[fire_mask].mean())
            ok6 = ok6 and changed.mean() > 0 and fixed >= 0.9
            line += f" fireflies={int(fire_mask.sum())} fireflies_changed={fixed:.4f}"
            xf = x
        print(f"{line} {'ok' if ok6 else 'FAIL'}", flush=True)
        if not ok6:
            failures.append(f"K3 {label}")
    k3_event_ms = cuda_ms(torch, lambda: dn.denoise_u8(xf), 50)
    k3_ms = device_ms(torch, lambda: dn.denoise_u8(xf), 50, "denoise_u8_kernel")
    k3_plain_ms = cuda_ms(torch, lambda: dn.denoise_u8_plain(xf), 5)
    k3_bound = bounds.bound(bounds.k3_work(HEIGHT, WIDTH))
    print(f"phase6 K3 timing: kernel_ms={k3_event_ms:.4f} device_ms={k3_ms:.4f} "
          f"plain_ms={k3_plain_ms:.4f} "
          f"bound_ms={k3_bound['bound_ms']:.4f} ({k3_bound['bound_by']}; bytes "
          f"{k3_bound['bytes_ms']:.4f} ms, operations {k3_bound['ops_ms']:.4f} ms) "
          f"share {k3_bound['bound_ms'] / k3_ms:.3f}", flush=True)

    # --- phase 7: the CLI path on a GLB with an env map ---
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        write_glb(os.path.join(tmp, "standin.glb"))
        write_env_map(os.path.join(tmp, "background.png"))
        print(f"phase7 files: standin.glb {os.path.getsize(os.path.join(tmp, 'standin.glb'))} B, "
              f"background.png {os.path.getsize(os.path.join(tmp, 'background.png'))} B, "
              f"written in {time.perf_counter() - t0:.1f} s", flush=True)
        with open(os.path.join(tmp, "standin.glb"), "rb") as f:
            doc, blob = parse_glb(f.read())
        view = doc["bufferViews"][doc["images"][0]["bufferView"]]
        with open(os.path.join(tmp, "background.png"), "rb") as f:
            pngs = [("albedo 2048x2048", blob[view["byteOffset"]:][:view["byteLength"]]),
                    ("background.png 2048x1024", f.read())]
        for label, data in pngs:
            kinds = np.bincount(image_io.png_scanlines(data)[4], minlength=5).tolist()
            t0 = time.perf_counter()
            image_io.decode_png(data)
            print(f"phase7 png decode {label}: rows by filter (None, Sub, Up, Average, "
                  f"Paeth) {kinds}: {time.perf_counter() - t0:.3f} s", flush=True)
        out = os.path.join(tmp, "cli_out.png")
        argv7 = ["-W", str(WIDTH), "-H", str(HEIGHT), "-S", str(spp), "-B", str(BOUNCES),
                 "-D", "-V", "-O", out, "standin.glb"]
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        rc, text = run_cli(cli, argv7, tmp)
        cli_wall = time.perf_counter() - t0
        launches7 = cuda_build.launch_counts()

        img7 = image_io.load_image_rgb_u8(out) if rc == 0 else np.zeros((1, 1, 3), np.uint8)
        sky = len(np.unique(img7[:64].reshape(-1, 3), axis=0))
        ok7 = (rc == 0 and all(v > 0 for k, v in launches7.items() if k != "nee_add")
               and launches7["nee_add"] == 0
               and img7.shape == (HEIGHT, WIDTH, 3) and float(img7.std()) > 5.0 and sky > 1)
        said = {key: num(pattern, text) for key, pattern in CLI_STAGES}
        print(f"phase7 cli {' '.join(argv7)}: exit={rc} wall_s={cli_wall:.3f} "
              + " ".join(f"{k}={v:.12g}" for k, v in said.items())
              + f" launches={launches7} shape={img7.shape} std={float(img7.std()):.2f} "
              f"sky_colors={sky} {'ok' if ok7 else 'FAIL'}", flush=True)
        if not ok7:
            print(text[-4000:], flush=True)
            failures.append("CLI path")

        x_png = os.path.join(tmp, "x.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "raytracing_c_tpu_torch", "-W", "64", "-H", "64", "-S", "1",
             "-B", "2", "-D", "-O", x_png, "standin.glb"],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True,
            timeout=600)
        ok_m = proc.returncode == 0 and image_io.load_image_rgb_u8(x_png).shape == (64, 64, 3)
        print(f"phase7 python -m raytracing_c_tpu_torch 64x64 -D: exit={proc.returncode} "
              f"wall_s={time.perf_counter() - t0:.1f} {'ok' if ok_m else 'FAIL'}", flush=True)
        if not ok_m:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
            failures.append("python -m")

        # --- phase 8: the NEE path, the CLI with --nee at full width ---
        cache = os.path.join(tmp, "standin.npz")
        out8 = os.path.join(tmp, "nee_out.png")
        argv8 = ["-W", str(WIDTH), "-H", str(HEIGHT), "-S", str(SPP), "-B", str(BOUNCES),
                 "--nee", "-D", "-V", "--save-scene", cache, "-O", out8, "standin.glb"]
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        rc8, text8 = run_cli(cli, argv8, tmp)
        wall8 = time.perf_counter() - t0
        launches8 = cuda_build.launch_counts()
        said8 = {key: num(pattern, text8) for key, pattern in CLI_STAGES}
        img8 = image_io.load_image_rgb_u8(out8) if rc8 == 0 else np.zeros((1, 1, 3), np.uint8)
        sky8 = len(np.unique(img8[:64].reshape(-1, 3), axis=0))
        k1_of = lambda c: c["bvh_traverse"] + c["bvh_traverse_wide"]  # noqa: E731
        ok8 = (rc8 == 0 and all(v > 0 for v in launches8.values())
               and k1_of(launches8) > k1_of(launches7) and os.path.exists(cache)
               and img8.shape == (HEIGHT, WIDTH, 3) and float(img8.std()) > 5.0 and sky8 > 1)
        print(f"phase8 cli {' '.join(argv8)}: exit={rc8} wall_s={wall8:.3f} "
              + " ".join(f"{k}={v:.12g}" for k, v in said8.items())
              + f" launches={launches8} k1_launches={k1_of(launches8)} (without --nee, phase 7: "
              f"{k1_of(launches7)}) std={float(img8.std()):.2f} sky_colors={sky8} "
              f"{'ok' if ok8 else 'FAIL'}", flush=True)
        if not ok8:
            print(text8[-4000:], flush=True)
            failures.append("NEE CLI path")

        kw = dict(spp=4, max_bounces=BOUNCES, seed=3, nee=True)
        img_k, st_k = renderer.render(scene_env, 128, 128, method="bvh", **kw)
        img_b, st_b = renderer.render(scene_env, 128, 128, method="brute", **kw)
        p8 = psnr(np, img_k, img_b)
        ok = p8 >= PSNR_MIN and img_k.std() > 5.0 and st_k.rays_traced == st_b.rays_traced
        print(f"phase8 128x128 spp=4 nee: kernel vs brute PSNR={p8:.2f} dB "
              f"(identical={bool((img_k == img_b).all())}) rays {st_k.rays_traced} vs "
              f"{st_b.rays_traced} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append("NEE kernel vs brute image")

        # the scene cache: --load-scene of phase 8's cache against the model
        small = ["-W", "256", "-H", "256", "-S", "4", "-B", str(BOUNCES), "--nee", "-V"]
        rc_a, text_a = run_cli(cli, [*small, "-O", "direct.png", "standin.glb"], tmp)
        rc_b, text_b = run_cli(cli, [*small, "--load-scene", cache, "-O", "cached.png"], tmp)
        same = rc_a == 0 and rc_b == 0 and bool(
            (image_io.load_image_rgb_u8(os.path.join(tmp, "direct.png"))
             == image_io.load_image_rgb_u8(os.path.join(tmp, "cached.png"))).all())
        print(f"phase8 scene cache {os.path.getsize(cache) if os.path.exists(cache) else 0} B: "
              f"--load-scene 256x256 exit={rc_b} (model: {rc_a}) identical={same}; load_ms "
              f"cache={num(CLI_STAGES[0][1], text_b):g} model={num(CLI_STAGES[0][1], text_a):g} "
              f"{'ok' if same else 'FAIL'}", flush=True)
        if not same:
            failures.append("scene cache")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- phase 9: lightmap baking through K1, and the native QOI codec ---
    st9 = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm = lightmap.bake_lightmap(scene_d, 512, 512, samples=16, max_bounces=BOUNCES, stats=st9)
    lm_wall = time.perf_counter() - t0
    covered = int((lm != 0).any(-1).sum())
    ok = bool(np.isfinite(lm).all()) and covered > 512 * 512 // 4
    print(f"phase9 lightmap 512x512 samples=16 bounces={BOUNCES} (K1): wall_s={lm_wall:.3f} "
          f"triangles_rasterized={st9['triangles']} of {scene_d.n_triangles} "
          f"texel_records={st9['texels']} texels_covered={covered} rays={st9['rays']} "
          f"mrays_per_s={st9['rays'] / lm_wall / 1e6:.4f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("lightmap")
    kw = dict(samples=4, max_bounces=BOUNCES, seed=5)
    lm_k = lightmap.bake_lightmap(scene_d, 64, 64, method="bvh", **kw)
    lm_b = lightmap.bake_lightmap(scene_d, 64, 64, method="brute", **kw)
    lm_err = float(np.abs(lm_k - lm_b).max())
    ok = lm_err <= LM_TOL and float(lm_k.max()) > 0
    print(f"phase9 lightmap 64x64 samples=4: K1 vs brute max_abs_diff={lm_err:.3g} "
          f"(tolerance {LM_TOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("lightmap K1 vs brute")

    t0 = time.perf_counter()
    native.qoi_native()  # built with the system C compiler at first use
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_native = image_io.qoi_encode(img)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = image_io.qoi_decode(q_native)
    dec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_plain = image_io.qoi_encode_plain(img)
    enc_plain_s = time.perf_counter() - t0
    ok = q_native == q_plain and bool((back == img).all())
    print(f"phase9 qoi {WIDTH}x{HEIGHT} phase-4 frame: {len(q_native)} B, native build "
          f"(first use) {build_s:.3f} s, encode {enc_s:.4f} s, decode {dec_s:.4f} s; "
          f"pure-Python encode {enc_plain_s:.3f} s, "
          f"byte_equal={q_native == q_plain} round_trip={bool((back == img).all())} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("native QOI")

    # --- phase 10: multi-device rendering, one process per rank ---
    mesh_launches, sah = phase10_mesh(np, torch, ps, tc, renderer, serialization, launch,
                                      bounds, scene_d, img, st.wall_ms / 1e3, spp,
                                      (cam_o, cam_d), k1_ms,
                                      failures)

    # --- phase 11: the parity gate against the JAX package's references ---
    reset_counts, counts = cuda_build.reset_launch_counts, cuda_build.launch_counts
    parity, launches11 = phase11_parity(np, reset_counts, counts, failures)

    # --- phase 12: the BVH inspector, its overlay through the render path ---
    launches12 = phase12_bvh_viz(np, torch, ps, scene_d, reset_counts, counts, failures)

    # --- phase 13: render()'s batch loop, the batch API, the JAX method names ---
    launches13 = phase13_batch_api(np, torch, scene_d, img, spp, reset_counts, counts, failures)

    # --- phase 14: K5's threefry draws at the main path's widths ---
    k5 = phase14_k5(torch, failures)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", flush=True)
        return 1

    def entry(name, source, replaces, err, ms, plain_ms, b):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches8[name], "launches_without_nee": launches7[name],
                "launches_mesh_nccl": [c.get(name, 0) for c in mesh_launches["a"]],
                "launches_mesh_gloo": [c.get(name, 0) for c in mesh_launches["b"]],
                "launches_parity": launches11[name], "launches_viz": launches12[name],
                "launches_batch_loop": launches13.get(name, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": None}

    src = "raytracing_c_tpu_torch/csrc/traverse.cu"
    k4_src = "raytracing_c_tpu_torch/csrc/shade.cu"
    k4_replaces = ("none: XLA fuses the JAX package's bounce tail "
                   "(raytracing_c_tpu/render/integrator.py: bounce_step)")
    k1_pallas = "raytracing_c_tpu/ops/traverse_pallas.py:1391"
    b1 = k1_bounds["bounce1/procedural"]
    b2_ms, b2_plain_ms = runs["bounce2/procedural"][:2]
    kernels = [
        {**entry("bvh_traverse", src, k1_pallas, k1_err["bvh_traverse"], k1_ms, k1_plain_ms,
                 k1_bound),
         "bounce1_rays": int(b1_o.shape[0]), "bounce1_ms": runs["bounce1/procedural"][0],
         "bounce1_bound_ms": b1["bound_ms"], "bounce1_bound_by": b1["bound_by"],
         "shadow": shadow["bvh_traverse"], **sah},
        {**entry("bvh_traverse_wide", src, k1_pallas, k1_err["bvh_traverse_wide"], b2_ms,
                 b2_plain_ms, k1_bounds["bounce2/procedural"]),
         "rays": int(b2_o.shape[0]),
         "later_ms": [[label, runs[label][3], runs[label][0]] for label, *_ in sets[6:]],
         "shadow": shadow["bvh_traverse_wide"]},
        entry("fetch_attrs", src, "raytracing_c_tpu/ops/traverse_pallas.py:1646",
              k2_err, k2_ms, k2_plain_ms, k2_bound),
        entry("denoise_u8", "raytracing_c_tpu_torch/csrc/denoise.cu",
              "raytracing_c_tpu/ops/denoise_pallas.py:98", k3_err, k3_ms, k3_plain_ms,
              k3_bound),
        {**entry("shade_bounce", k4_src, k4_replaces, k4["err"], k4["render"]["ms"],
                 k4["render"]["plain_ms"], k4["render"]),
         "nee": k4["nee"], "batch_ms": k4["batch_ms_render"],
         "batch_bound_ms": k4["batch_bound_ms_render"], "batch_ms_nee": k4["batch_ms_nee"],
         "batch_bound_ms_nee": k4["batch_bound_ms_nee"], "per_bounce": k4["per_bounce"],
         "spans": {"render": k4["spans_render"], "nee": k4["spans_nee"]}},
        {**entry("nee_add", k4_src, k4_replaces, k4["err"], k4["nee_add"]["ms"], None,
                 k4["nee_add"]), "lanes": k4["nee_add"]["lanes"]},
        {**entry("rng_bounce_uniforms", "raytracing_c_tpu_torch/csrc/rng.cu",
                 "none: the JAX package draws through jax.random", k5["err"],
                 k5["rows"][0]["ms"], k5["rows"][0]["plain_ms"], k5["rows"][0]),
         "draws": k5["rows"], "batch_ms": k5["batch_ms"],
         **{f"launches_{n}": {"phase8": launches8[n], "phase7": launches7[n]}
            for n in ("rng_fold_in", "rng_split", "rng_bits")}},
    ]
    print(json.dumps({"parity": {"gpu": gpu, **parity,
                                 "flagship_fresh_process": fresh,
                                 "flagship_in_process_wall_s": st.wall_ms / 1e3}}))
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
