"""The plain reference's scene: triangles, materials, textures, background
and camera on a device, built from the benchmark's own host arrays.

The triangle store follows the program's layout only where it decides a
result: each triangle sits in the leaf slot that the benchmark's own tree
gives it (`roofline/bvh.py`), because the nearest hit breaks ties to the
lowest slot; v0/e1/e2 and the shading attributes are taken from the
float32 positions as `raytracing_c_tpu_torch/models/scene.py`'s
`pack_triangles` and `compute_tangents` take them (frozen at commit
f272015; the reference C renderer's triangles_insert, scene.c:105-155).
Only occupied slots are kept for intersection. Textures are packed as the
program's atlas is: slot 0 a 1x1 white texel, texture k + 1 the k-th image.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reference import shade
from reference.vec3 import Vec3
from roofline.bvh import build_bvh

ATTR_COLS = 25


@dataclass
class RefScene:
    ft: torch.dtype
    device: torch.device
    slots: torch.Tensor  # (n_occ,) int64 occupied slot ids, ascending
    v0: Vec3  # over the occupied slots
    e1: Vec3
    e2: Vec3
    attr: torch.Tensor  # (capacity, 25): n0, n1, n2, ng, tangent, bitangent, uv x 3, mat
    mat_rows: torch.Tensor  # (M, 16)
    tex_r: torch.Tensor
    tex_g: torch.Tensor
    tex_b: torch.Tensor
    tex_offset: torch.Tensor
    tex_width: torch.Tensor
    tex_height: torch.Tensor
    bg_tex: int
    bg_color: torch.Tensor
    view: torch.Tensor  # (4, 4) camera to world
    focal: torch.Tensor  # () 1 / tan(fov / 2)
    env: object = None  # shade.EnvTable, built for NEE


def compute_tangents(positions: np.ndarray, uvs: np.ndarray):
    p0, p1, p2 = positions[:, 0], positions[:, 1], positions[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    ng = np.cross(e1, e2)
    ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-30)
    duv1 = uvs[:, 1] - uvs[:, 0]
    duv2 = uvs[:, 2] - uvs[:, 0]
    d = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    small = np.abs(d) < 1e-4
    d = np.where(small, np.where(d < 0, -1e-4, 1e-4), d)
    inv_d = (1.0 / d)[:, None]
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_d
    bitangent = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv_d

    def _norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)

    return ng.astype(np.float32), _norm(tangent).astype(np.float32), \
        _norm(bitangent).astype(np.float32)


def build(mesh: dict, materials: list, textures: list, bg_tex: int, view: np.ndarray,
          focal: np.float32, device, ft=torch.float32) -> RefScene:
    """mesh: positions (n, 3, 3), normals (n, 3, 3), uvs (n, 3, 2) float32,
    mat_id (n,); materials: dicts of base_color, emission, roughness,
    metalness, normal_strength, sheen, sheen_tint, anisotropic and the
    texture ids tex_albedo, tex_normal, tex_mr, tex_emission (-1 for none);
    textures: (h, w, 3) u8 images, texture k + 1 being textures[k]; bg_tex:
    the equirect env map's texture id (-1 for a constant sky, which no
    configuration uses); view: (4, 4) float32 camera to world."""
    slot_map = build_bvh(mesh["positions"].astype(np.float32))["slot_map"]
    valid = slot_map >= 0
    idx = np.where(valid, slot_map, 0)

    def place(a):
        out = a[idx]
        out[~valid] = 0
        return out

    pos = place(mesh["positions"].astype(np.float32))
    nrm = place(mesh["normals"].astype(np.float32))
    uv = place(mesh["uvs"].astype(np.float32))
    ng, tan, btn = compute_tangents(pos, uv)
    ng[~valid] = 0.0
    tan[~valid] = 0.0
    btn[~valid] = 0.0
    mat = np.asarray(mesh["mat_id"], np.int32)[idx]
    mat[~valid] = -1
    capacity = len(slot_map)
    attr = np.zeros((capacity, ATTR_COLS), np.float32)
    attr[:, 0:3], attr[:, 3:6], attr[:, 6:9] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    attr[:, 9:12], attr[:, 12:15], attr[:, 15:18] = ng, tan, btn
    attr[:, 18:24] = uv.reshape(capacity, 6)
    attr[:, 24] = mat.astype(np.float32)

    occ = np.flatnonzero(valid)
    v0 = pos[occ, 0]
    e1 = pos[occ, 1] - v0
    e2 = pos[occ, 2] - v0
    dev = torch.device(device)

    def vec(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(ft)
        return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(), t[:, 2].contiguous())

    rows = np.zeros((len(materials), shade.MROW_COLS), np.float32)
    for k, m in enumerate(materials):
        rows[k, 0:3] = m["base_color"]
        rows[k, 3:6] = m.get("emission", (0.0, 0.0, 0.0))
        rows[k, 6:12] = [m["roughness"], m["metalness"], m["normal_strength"], m["sheen"],
                         m["sheen_tint"], m["anisotropic"]]
        rows[k, 12:16] = [m["tex_albedo"], m["tex_normal"], m["tex_mr"], m["tex_emission"]]

    planes = [np.full((1, 3), 255, np.uint8)]
    offs, ws, hs, total = [0], [1], [1], 1
    for img in textures:
        h, w, _ = img.shape
        offs.append(total)
        ws.append(w)
        hs.append(h)
        planes.append(np.asarray(img, np.uint8).reshape(-1, 3))
        total += w * h
    flat = np.concatenate(planes)
    u8 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return RefScene(
        ft=ft, device=dev, slots=torch.from_numpy(occ).to(dev), v0=vec(v0), e1=vec(e1),
        e2=vec(e2), attr=torch.from_numpy(attr).to(dev).to(ft),
        mat_rows=torch.from_numpy(rows).to(dev).to(ft),
        tex_r=u8(flat[:, 0]), tex_g=u8(flat[:, 1]), tex_b=u8(flat[:, 2]),
        tex_offset=i32(offs), tex_width=i32(ws), tex_height=i32(hs), bg_tex=int(bg_tex),
        bg_color=torch.zeros(3, dtype=ft, device=dev),
        view=torch.from_numpy(np.asarray(view, np.float32)).to(dev).to(ft),
        focal=torch.tensor(np.float32(focal)).to(dev).to(ft),
    )


def with_env(scene: RefScene, env_rgb: np.ndarray) -> RefScene:
    """The scene with its env map's alias table, as NEE needs it."""
    scene.env = shade.build_env_table(env_rgb, scene.device, scene.ft)
    return scene
