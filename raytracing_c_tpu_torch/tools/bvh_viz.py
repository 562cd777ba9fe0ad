"""BVH inspector (capability parity with bvh_visualizer.c).

Counterpart of the JAX package's `tools/bvh_viz.py`, with the same
functions, output files and printed lines. The reference is an interactive
raylib app drawing wireframe AABB cubes per tree level
(bvh_visualizer.c:22-58). Headless equivalent: dump every level's child
AABBs as wireframe line geometry into a Wavefront OBJ (one `o` object per
depth, so any viewer can toggle levels), skipping the zero ("empty lane")
boxes exactly like the reference (bvh_visualizer.c:44-49).

Usage (on the GPU; `main(argv, device="cpu")` runs it on the CPU):
    python -m raytracing_c_tpu_torch.tools.bvh_viz <model.(obj|glb|gltf|npz)> [out.obj]
    python -m raytracing_c_tpu_torch.tools.bvh_viz <model> --overlay <prefix> [size]
    python -m raytracing_c_tpu_torch.tools.bvh_viz <model> --interactive [--snapshot out.png]

--overlay renders the scene once through the port's renderer (the CUDA
kernels on a GPU) and writes <prefix>_level<d>.png per BVH level with the
level's AABB wireframes projected over the render. The lines are drawn by
`_line_pixels`, which gives PIL.ImageDraw.line's pixels (width 1).

--interactive is the direct counterpart of the reference's raylib app
(bvh_visualizer.c:60-107): an orbiting wireframe view of one BVH level at
a time, drawn in the terminal with ANSI half-blocks. Up/Down steps the
shown level (KEY_UP/KEY_DOWN parity), Left/Right orbits, w/s tilts,
+/- zooms, q quits. Level color follows the reference's HSV-by-depth
formula (bvh_visualizer.c:26). --snapshot renders one frame to a PNG
instead (headless self-test).

The BVH splitter follows RAYTPU_BVH_SAH (models/bvh.py).
"""

from __future__ import annotations

import sys

import numpy as np

# 12 box edges as pairs of corner indices (corners in zyx bit order)
_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def dump_bvh_obj(scene, out_path: str) -> dict:
    """Write wireframe AABBs per level; returns {depth: n_boxes}."""
    mins, maxs = scene.bvh.child_boxes_np()  # (n_internal, 8, 3) each
    depth = scene.bvh.depth

    lines = ["# BVH wireframe dump (one object per level)"]
    vert_count = 0
    stats = {}

    level_start = 0
    level_size = 1
    for d in range(depth):
        boxes = []
        for node in range(level_start, level_start + level_size):
            for j in range(8):
                lo = mins[node, j]
                hi = maxs[node, j]
                if (lo == 0).all() and (hi == 0).all():
                    continue  # empty lane (bvh_visualizer.c:44-49)
                boxes.append((lo, hi))
        stats[d] = len(boxes)
        lines.append(f"o level_{d}")
        for lo, hi in boxes:
            corners = [
                [hi[0] if i & 1 else lo[0],
                 hi[1] if i & 2 else lo[1],
                 hi[2] if i & 4 else lo[2]]
                for i in range(8)
            ]
            for c in corners:
                lines.append(f"v {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}")
            for a, b in _EDGES:
                lines.append(f"l {vert_count + a + 1} {vert_count + b + 1}")
            vert_count += 8
        level_start += level_size
        level_size *= 8

    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return stats


def _project(camera, pts, width, height):
    """World points (N, 3) -> (px, py, in_front) under the pinhole model of
    render/camera.generate_rays (raytracer.c:641-698), inverted."""
    m = camera.view_matrix.detach().cpu().numpy().astype(np.float64)
    rot = m[:3, :3]
    org = m[:3, 3]
    c = (pts - org) @ rot  # R^T (P - origin): camera space, -z forward
    in_front = c[:, 2] < -1e-9
    zi = np.where(in_front, -c[:, 2], 1.0)
    f = float(camera.focal_length)
    aspect = width / height
    u = c[:, 0] * f / zi / aspect
    v = -(c[:, 1] * f / zi)
    px = (u + 1.0) * width / 2.0 - 0.5
    py = (v + 1.0) * height / 2.0 - 0.5
    return px, py, in_front


def _line_pixels(segments, width: int, height: int):
    """Pixels (ys, xs) of the segments (n, 4) = (x0, y0, x1, y1), each drawn
    as PIL.ImageDraw.line draws a width-1 line: the endpoints truncated
    toward zero, then a Bresenham walk of max(|dx|, |dy|) + 1 points along
    the major axis (the minor coordinate steps when its error term reaches
    0), clipped to the image. Step i's minor offset has the closed form
    floor((2 |d_minor| i + |d_major|) / (2 |d_major|)), so only the steps
    whose major coordinate lies in the image are generated."""
    p = np.trunc(np.asarray(segments, np.float64).reshape(-1, 4)).astype(np.int64)
    x0, y0, x1, y1 = p.T
    dx, dy = x1 - x0, y1 - y0
    xmaj = np.abs(dx) > np.abs(dy)  # ties walk along y, as Pillow's
    m0, n0 = np.where(xmaj, x0, y0), np.where(xmaj, y0, x0)
    dm, dn = np.where(xmaj, dx, dy), np.where(xmaj, dy, dx)
    sm, sn = np.where(dm < 0, -1, 1), np.where(dn < 0, -1, 1)
    am, an = np.abs(dm), np.abs(dn)
    lim = np.where(xmaj, width, height)
    # steps i in [0, am] with 0 <= m0 + sm * i < lim
    lo = np.maximum(np.where(sm > 0, -m0, m0 - lim + 1), 0)
    hi = np.minimum(np.where(sm > 0, lim - 1 - m0, m0), am)
    cnt = np.maximum(hi - lo + 1, 0)
    seg = np.repeat(np.arange(len(p)), cnt)
    i = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt - lo, cnt)
    k = (2 * an[seg] * i + am[seg]) // np.maximum(2 * am[seg], 1)
    m = m0[seg] + sm[seg] * i
    n = n0[seg] + sn[seg] * k
    xs = np.where(xmaj[seg], m, n)
    ys = np.where(xmaj[seg], n, m)
    ok = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    return ys[ok], xs[ok]


LEVEL_COLORS = [(255, 80, 80), (80, 220, 80), (90, 140, 255), (255, 200, 60),
                (220, 90, 220)]


def _overlay_segments(scene, size: int):
    """Per level: (segments (n, 4) in pixels, n_boxes) of the nonempty child
    boxes' edges whose both corners lie in front of the camera, projected
    box by box as overlay_levels draws them."""
    levels = []
    for corners in _level_corner_sets(scene):
        segs = []
        for box in corners:
            px, py, ok = _project(scene.camera, box, size, size)
            segs += [(px[a], py[a], px[b], py[b]) for a, b in _EDGES if ok[a] and ok[b]]
        levels.append((np.array(segs, np.float64).reshape(-1, 4), len(corners)))
    return levels


def overlay_levels(scene, prefix: str, size: int = 512) -> None:
    """Render once, then write one PNG per level with that level's child
    AABBs drawn as projected wireframes."""
    from raytracing_c_tpu_torch.io.image_io import write_png
    from raytracing_c_tpu_torch.render.renderer import render

    img, _ = render(scene, size, size, spp=4, max_bounces=3, seed=0)
    for d, (segs, n) in enumerate(_overlay_segments(scene, size)):
        im = img.copy()
        im[_line_pixels(segs, size, size)] = LEVEL_COLORS[d % len(LEVEL_COLORS)]
        out = f"{prefix}_level{d}.png"
        write_png(out, im)
        print(f"{out}: {n} boxes")


def _level_corner_sets(scene):
    """Per level: (n_boxes, 8, 3) corner array of the nonempty child boxes
    (empty-lane skip rule = bvh_visualizer.c:44-49)."""
    mins, maxs = scene.bvh.child_boxes_np()
    levels = []
    level_start, level_size = 0, 1
    for _d in range(scene.bvh.depth):
        lo = mins[level_start : level_start + level_size].reshape(-1, 3)
        hi = maxs[level_start : level_start + level_size].reshape(-1, 3)
        keep = ~((lo == 0).all(1) & (hi == 0).all(1))
        lo, hi = lo[keep], hi[keep]
        # corner i takes hi on axis c iff bit c of i is set (same corner
        # order as dump_bvh_obj above)
        bits = ((np.arange(8)[:, None] >> np.arange(3)[None, :]) & 1) != 0
        corners = (
            np.where(bits[None], hi[:, None, :], lo[:, None, :])
            if len(lo)
            else np.zeros((0, 8, 3), np.float32)
        )
        levels.append(corners)
        level_start += level_size
        level_size *= 8
    return levels


def _hsv_level_color(depth_shown: int, tree_depth: int):
    """ColorFromHSV(-360*depth/bvh->depth, 0.7, 1) — bvh_visualizer.c:26."""
    import colorsys

    h = (-(depth_shown) / max(tree_depth, 1)) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.7, 1.0)
    return np.array([r * 255, g * 255, b * 255], np.float32)


def _raster_frame(level_corners, color, eye, target, width, height,
                  fovy_deg=45.0, cell_aspect=1.0):
    """Rasterize one level's box edges into an (H, W, 3) u8 buffer with a
    look-at pinhole camera (the raylib camera's perspective model).
    cell_aspect: pixel width/height ratio — 1.0 for square pixels (PNG
    snapshots); ~0.5 for terminal half-blocks (cells are ~2x tall)."""
    buf = np.zeros((height, width, 3), np.float32)
    corners = level_corners
    if len(corners) == 0:
        return buf.astype(np.uint8)
    fwd = target - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    upw = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, upw)
    right /= max(np.linalg.norm(right), 1e-9)
    up = np.cross(right, fwd)
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2)
    aspect = width / height * cell_aspect

    pts = corners.reshape(-1, 3) - eye
    cx = pts @ right
    cy = pts @ up
    cz = pts @ fwd
    ok = cz > 1e-6
    zi = np.where(ok, cz, 1.0)
    px = (cx * f / zi / aspect + 1.0) * width / 2.0
    py = (-cy * f / zi + 1.0) * height / 2.0
    px = px.reshape(-1, 8)
    py = py.reshape(-1, 8)
    ok = ok.reshape(-1, 8)

    S = 48  # samples per edge
    t = np.linspace(0.0, 1.0, S)[None, :]
    alpha = 0.35  # additive dim (the reference's ColorAlpha 0.125 analog)
    for a, b in _EDGES:
        good = ok[:, a] & ok[:, b]
        if not good.any():
            continue
        xs = px[good, a, None] * (1 - t) + px[good, b, None] * t
        ys = py[good, a, None] * (1 - t) + py[good, b, None] * t
        xi = np.round(xs).astype(np.int64).ravel()
        yi = np.round(ys).astype(np.int64).ravel()
        m = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        np.add.at(buf, (yi[m], xi[m]), color * alpha)
    return np.clip(buf, 0, 255).astype(np.uint8)


def _ansi_draw(buf):
    """(H, W, 3) u8 -> half-block ANSI string (two pixel rows per line)."""
    h, w, _ = buf.shape
    out = ["\x1b[H"]
    for y in range(0, h - 1, 2):
        row = []
        for x in range(w):
            tr, tg, tb = buf[y, x]
            br, bg_, bb = buf[y + 1, x]
            row.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
            )
        out.append("".join(row) + "\x1b[0m")
    return "\n".join(out)


def interactive(scene, snapshot: str | None = None):
    """Terminal port of the raylib viewer loop (bvh_visualizer.c:60-107)."""
    import shutil

    levels = _level_corner_sets(scene)
    depth = scene.bvh.depth
    all_pts = np.concatenate(
        [c.reshape(-1, 3) for c in levels if len(c)], axis=0
    )
    center = (all_pts.min(0) + all_pts.max(0)) / 2
    radius = float(np.linalg.norm(all_pts.max(0) - all_pts.min(0)))
    state = {"show": depth - 1, "az": 0.8, "el": 0.5, "r": 1.6 * radius}

    def frame(width, height, cell_aspect=1.0):
        eye = center + state["r"] * np.array([
            np.cos(state["el"]) * np.sin(state["az"]),
            np.sin(state["el"]),
            np.cos(state["el"]) * np.cos(state["az"]),
        ])
        show = int(np.clip(state["show"], 0, depth - 1))
        color = _hsv_level_color(show + 1, depth)
        return _raster_frame(levels[show], color, eye, center, width,
                             height, cell_aspect=cell_aspect), show

    if snapshot is not None:
        from raytracing_c_tpu_torch.io.image_io import write_png

        buf, show = frame(512, 512)
        write_png(snapshot, buf)
        print(f"{snapshot}: level {show} "
              f"({len(levels[show])} boxes) of depth {depth}")
        return

    import termios
    import tty

    if not sys.stdout.isatty():
        print("--interactive needs a TTY (use --snapshot headless)")
        return
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    sys.stdout.write("\x1b[2J\x1b[?25l")
    try:
        tty.setcbreak(fd)
        while True:
            cols, rows = shutil.get_terminal_size()
            w, h = cols, 2 * (rows - 1)
            buf, show = frame(w, h, cell_aspect=0.5)  # half-block cells
            sys.stdout.write(_ansi_draw(buf))
            sys.stdout.write(
                f"\n\x1b[0mlevel {show}/{depth - 1} "
                f"({len(levels[show])} boxes)  "
                "[Up/Down] level  [Left/Right,w/s] orbit  [+/-] zoom  [q]uit"
            )
            sys.stdout.flush()
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                seq = sys.stdin.read(2)
                if seq == "[A":
                    state["show"] = min(state["show"] + 1, depth - 1)
                elif seq == "[B":
                    state["show"] = max(state["show"] - 1, 0)
                elif seq == "[C":
                    state["az"] += 0.2
                elif seq == "[D":
                    state["az"] -= 0.2
            elif ch == "w":
                state["el"] = min(state["el"] + 0.15, 1.45)
            elif ch == "s":
                state["el"] = max(state["el"] - 0.15, -1.45)
            elif ch in "+=":
                state["r"] *= 0.85
            elif ch == "-":
                state["r"] /= 0.85
            elif ch == "q":
                break
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[?25h\x1b[0m\n")


def _load(path, device):
    if path.endswith(".npz"):
        from raytracing_c_tpu_torch.models.serialization import load_scene_cache

        return load_scene_cache(path, device=device)
    from raytracing_c_tpu_torch.io.loader import load_scene

    return load_scene(path, background_path=None, warn=lambda *a: None, device=device)


def main(argv, device="cuda"):
    """Run the inspector on `device` (the GPU unless a caller asks for the
    CPU; raises when CUDA is asked for and absent)."""
    path = argv[0]
    if len(argv) >= 2 and argv[1] == "--interactive":
        snap = None
        if "--snapshot" in argv:
            snap = argv[argv.index("--snapshot") + 1]
        interactive(_load(path, device), snapshot=snap)
        return
    if len(argv) >= 3 and argv[1] == "--overlay":
        size = int(argv[3]) if len(argv) > 3 else 512
        overlay_levels(_load(path, device), argv[2], size)
        return
    out = argv[1] if len(argv) > 1 else "bvh_wireframe.obj"
    scene = _load(path, device)
    stats = dump_bvh_obj(scene, out)
    total = sum(stats.values())
    print(f"wrote {out}: depth={scene.bvh.depth}, "
          + ", ".join(f"level {d}: {n} boxes" for d, n in stats.items())
          + f" ({total} total)")


if __name__ == "__main__":
    main(sys.argv[1:])
