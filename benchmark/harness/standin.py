"""The helmet.glb stand-in, its env map and its files, made from a seed.

Frozen copies of `chip_smoke.py`'s `STANDIN_MATERIALS`, `_textures`,
`_displaced_sphere`, `standin_parts`, `write_glb` and `make_env_map` at
commit f272015, with the seed of the textures' and the env map's noise
given by the caller, and PNGs written by the benchmark's own encoder
(`harness/png.py`). The shape never depends on the seed: a displaced UV
sphere of n x n quads (2 n^2 triangles) on a floor quad, 3 materials
(textured PBR with the helmet's four maps, albedo, normal, metal-roughness
and emissive, each tex^2, and emissiveFactor 1; an anisotropic metal band;
a sheen floor), a camera, and an equirect sky with a sun disk. Two changes
from the copied code: every map is tex^2 (chip_smoke.py makes the normal
and metal-roughness maps at (tex/2)^2), and the emissive map is added.
"""

from __future__ import annotations

import base64
import json
import math
import struct

import numpy as np

from harness import png

STANDIN_MATERIALS = (
    dict(name="textured", base_color=(1.0, 1.0, 1.0), emission=(1.0, 1.0, 1.0), roughness=1.0,
         metalness=1.0, normal_strength=1.0, sheen=0.0, sheen_tint=0.0, anisotropic=0.0,
         textured=True),
    dict(name="band", base_color=(1.0, 0.78, 0.34), emission=(0.0, 0.0, 0.0), roughness=0.3,
         metalness=1.0, normal_strength=0.0, sheen=0.0, sheen_tint=0.0, anisotropic=0.3,
         textured=False),
    dict(name="floor", base_color=(0.5, 0.5, 0.55), emission=(0.0, 0.0, 0.0), roughness=0.8,
         metalness=0.0, normal_strength=0.0, sheen=0.5, sheen_tint=0.5, anisotropic=0.0,
         textured=False),
)
FOV_DEG = 45.0
_FLOOR_XZ = ((-4.0, -4.0), (-4.0, 4.0), (4.0, 4.0), (4.0, -4.0))
_FLOOR_TRIS = ((0, 1, 2), (0, 2, 3))
_FLOOR_Y = -1.1
#: the GLB mesh node's local transform under a translated root node
GLB_ROT_DEG = 20.0
GLB_NODE_T = (0.05, 0.0, -0.05)
GLB_ROOT_T = (0.0, 0.02, 0.0)


#: the textured material's maps, in the order of the scene's texture ids
#: (texture k + 1 is map k) and of the GLB's images
MAPS = ("albedo", "normal", "mr", "emission")


def _emissive(rng, n):
    """The helmet's emissive map is black but for lit panels: here warm
    strips on one cell in eleven of a 16 x 16 grid, with seeded flicker."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    cell = (np.floor(x * 16) * 7 + np.floor(y * 16) * 3) % 11 == 0
    strip = np.abs(np.sin(y * np.pi * 128)) > 0.5
    glow = (cell & strip).astype(np.float32) * rng.uniform(0.6, 1.0, (n, n)).astype(np.float32)
    emissive = glow[..., None] * np.array([1.0, 0.55, 0.2], np.float32)
    return (emissive * 255).astype(np.uint8)


def _textures(rng, n):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    check = ((np.floor(x * 32) + np.floor(y * 32)) % 2).astype(np.float32)
    noise = rng.uniform(0.0, 0.15, (n, n)).astype(np.float32)
    albedo = np.stack([0.55 + 0.35 * check * x, 0.45 + 0.3 * (1 - check) * y,
                       0.35 + 0.25 * check], -1) - noise[..., None]
    albedo = (np.clip(albedo, 0, 1) * 255).astype(np.uint8)

    y, x = np.mgrid[0:n, 0:n].astype(np.float32) * (2 * np.pi * 24 / n)
    hx = np.cos(x) * np.sin(y)
    hy = np.sin(x) * np.cos(y)
    nrm = np.stack([-0.4 * hx, -0.4 * hy, np.ones_like(hx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = ((nrm * 0.5 + 0.5) * 255).astype(np.uint8)

    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    mr = np.stack([np.zeros_like(x), 0.15 + 0.75 * (0.5 + 0.5 * np.sin(x * 40)),
                   ((np.floor(y * 16) % 2) * 255 / 255.0)], -1)
    mr = (mr * 255).astype(np.uint8)
    return [albedo, normal, mr, _emissive(rng, n)]


def _displaced_sphere(n):
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
    vn = np.zeros_like(V)
    for (p0, p1, p2), idx in zip(tris_v, tris_i):
        fn = np.cross(p1 - p0, p2 - p0)
        for s in idx:
            vn[s] += fn
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    vn *= np.sign((vn * V).sum(-1, keepdims=True))
    pos, nrm, uv = [], [], []
    for idx in tris_i:
        pos.append(np.stack([V[s] for s in idx], 2).reshape(-1, 3, 3))
        nrm.append(np.stack([vn[s] for s in idx], 2).reshape(-1, 3, 3))
        uv.append(np.stack([UV[s] for s in idx], 2).reshape(-1, 3, 2))
    pos, nrm, uv = (np.concatenate(x).astype(np.float32) for x in (pos, nrm, uv))
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    flip = (ng * pos.mean(1)).sum(-1) < 0
    for arr in (pos, nrm, uv):
        arr[flip, 1], arr[flip, 2] = arr[flip, 2].copy(), arr[flip, 1].copy()
    return pos, nrm, uv


def standin_parts(seed: int, n: int = 88, tex: int = 2048):
    """Returns (positions, normals, uvs, mat_id), textures [albedo, normal,
    mr, emissive] (each tex^2), view (4, 4) float32 camera to world."""
    rng = np.random.default_rng(seed)
    pos, nrm, uv = _displaced_sphere(n)
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
    return arrays, _textures(rng, tex), view


def make_env_map(width: int, height: int, seed: int):
    """An equirect sky (u8 sRGB, (height, width, 3)): zenith-to-horizon
    gradient, a darker ground, a 2-degree sun disk at 40 degrees elevation,
    seeded noise of 2 u8."""
    rng = np.random.default_rng(seed)
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    elev = (0.5 - v)[:, None] * np.pi
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


def glb_document(parts, aspect: float) -> dict:
    """What `write_glb` puts in the file, before it is encoded: the
    primitives' local arrays (one per material: unindexed, u32-indexed,
    u16-indexed floor), the nodes (the mesh node rotated and translated
    under a translated root; a camera node holding the view matrix), the
    camera and the materials as glTF states them."""
    (pos, nrm, uv, mat), _textures_, view = parts
    a = math.radians(GLB_ROT_DEG)
    rot = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])
    shift = np.add(GLB_NODE_T, GLB_ROOT_T)
    local_pos = ((pos.reshape(-1, 3) - shift) @ rot).astype(np.float32)
    local_nrm = (nrm.reshape(-1, 3) @ rot).astype(np.float32)
    flat_uv = uv.reshape(-1, 2)
    prims = []
    for m in range(2):
        rows = np.flatnonzero(np.repeat(mat == m, 3))
        prims.append({"pos": local_pos[rows], "nrm": local_nrm[rows], "uv": flat_uv[rows],
                      "indices": np.arange(len(rows), dtype=np.uint32) if m == 1 else None,
                      "material": m})
    corners = np.array([[x, _FLOOR_Y, z] for x, z in _FLOOR_XZ], np.float32)
    prims.append({"pos": ((corners - shift) @ rot).astype(np.float32),
                  "nrm": (np.tile([[0.0, 1.0, 0.0]], (4, 1)) @ rot).astype(np.float32),
                  "uv": (corners[:, [0, 2]] / 2).astype(np.float32),
                  "indices": np.array(_FLOOR_TRIS, np.uint16).reshape(-1), "material": 2})
    materials = []
    for m in STANDIN_MATERIALS:
        pbr = {"baseColorFactor": [*m["base_color"], 1.0], "metallicFactor": m["metalness"],
               "roughnessFactor": m["roughness"]}
        doc = {"name": m["name"], "pbrMetallicRoughness": pbr}
        if any(m["emission"]):
            doc["emissiveFactor"] = list(m["emission"])
        if m["textured"]:
            pbr["baseColorTexture"] = {"index": MAPS.index("albedo")}
            pbr["metallicRoughnessTexture"] = {"index": MAPS.index("mr")}
            doc["normalTexture"] = {"index": MAPS.index("normal"), "scale": m["normal_strength"]}
            doc["emissiveTexture"] = {"index": MAPS.index("emission")}
        if m["sheen"]:
            doc["extensions"] = {"KHR_materials_sheen": {
                "sheenColorFactor": [m["sheen"]] * 3, "sheenRoughnessFactor": 0.5}}
        materials.append(doc)
    half = a / 2
    nodes = [
        {"name": "root", "translation": list(GLB_ROOT_T), "children": [1]},
        {"name": "standin", "mesh": 0, "translation": list(GLB_NODE_T),
         "rotation": [0.0, math.sin(half), 0.0, math.cos(half)]},
        {"name": "camera", "camera": 0, "matrix": view.astype(np.float64).T.reshape(-1).tolist()},
    ]
    camera = {"type": "perspective", "perspective": {
        "yfov": math.radians(FOV_DEG), "aspectRatio": aspect, "znear": 0.01}}
    return {"prims": prims, "nodes": nodes, "scene_nodes": [0, 2], "camera": camera,
            "materials": materials}


def write_glb(path: str, parts, aspect: float) -> dict:
    """Write the stand-in as a binary glTF (textures as PNG: the
    metal-roughness map as a data URI, the others in bufferViews;
    KHR_materials_sheen on the floor).
    Returns `glb_document(parts, aspect)`, what the file holds."""
    desc = glb_document(parts, aspect)
    textures = parts[1]
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

    prims = []
    for p in desc["prims"]:
        prim = {"attributes": {"POSITION": add_accessor(p["pos"], 5126, "VEC3"),
                               "NORMAL": add_accessor(p["nrm"], 5126, "VEC3"),
                               "TEXCOORD_0": add_accessor(p["uv"], 5126, "VEC2")},
                "material": p["material"]}
        if p["indices"] is not None:
            ctype = 5125 if p["indices"].dtype == np.uint32 else 5123
            prim["indices"] = add_accessor(p["indices"], ctype, "SCALAR")
        prims.append(prim)
    pngs = [png.encode(t) for t in textures]
    images = [{"uri": "data:image/png;base64," + base64.b64encode(data).decode()}
              if name == "mr" else {"bufferView": add_view(data), "mimeType": "image/png"}
              for name, data in zip(MAPS, pngs)]
    doc = {
        "asset": {"version": "2.0", "generator": "benchmark harness/standin.py"},
        "extensionsUsed": ["KHR_materials_sheen"],
        "scene": 0,
        "scenes": [{"nodes": desc["scene_nodes"]}],
        "nodes": desc["nodes"],
        "cameras": [desc["camera"]],
        "meshes": [{"name": "standin", "primitives": prims}],
        "materials": desc["materials"],
        "textures": [{"source": k} for k in range(len(images))],
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
    return desc


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png.encode(img))
