"""The reference's reading of the stand-in GLB: the scene that glTF 2.0's
rules make of what `harness/standin.py:write_glb` wrote.

No file is parsed: the reference takes the arrays and nodes the benchmark
wrote (`glb_document`) and applies the rules itself. Node transforms are
matrix or T * R * S, composed from the scene's roots; positions go through
the world matrix in float64 and normals through the inverse transpose of
its 3x3, renormalised, both then rounded to float32; the first perspective
camera node gives the view matrix and fov = yfov (focal 1 / tan(yfov / 2)).
Materials take glTF's defaults, the texture slots in image order (image k
is texture k + 1; the env map comes after them), and sheen as the
Rec.709 luminance of KHR_materials_sheen's sheenColorFactor (the reference
C renderer, driver.c:637); glTF states no sheen tint or anisotropy.
"""

from __future__ import annotations

import numpy as np

LUMA = (0.2126, 0.7152, 0.0722)


def _local(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def scene_inputs(desc: dict, n_images: int):
    """Returns (mesh dict, materials, view (4, 4) float32, focal float32)
    for `reference/scene.py:build`."""
    nodes = desc["nodes"]
    world = [None] * len(nodes)

    def visit(i, parent):
        world[i] = parent @ _local(nodes[i])
        for ch in nodes[i].get("children", []):
            visit(ch, world[i])

    for root in desc["scene_nodes"]:
        visit(root, np.eye(4))

    view, focal = None, None
    for i, node in enumerate(nodes):
        if "camera" in node and desc["camera"]["type"] == "perspective":
            yfov = float(desc["camera"]["perspective"]["yfov"])
            view = world[i].astype(np.float32)
            focal = np.float32(1.0 / np.tan(yfov * 0.5))
            break

    pos_all, nrm_all, uv_all, mat_all = [], [], [], []
    for i, node in enumerate(nodes):
        if "mesh" not in node:
            continue
        w = world[i]
        rot = w[:3, :3]
        nrm_mat = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
        for p in desc["prims"]:
            pos = p["pos"].astype(np.float64)
            idx = (np.arange(len(pos)) if p["indices"] is None
                   else p["indices"].astype(np.int64)).reshape(-1, 3)
            pos_w = pos @ rot.T + w[:3, 3]
            nrm_w = p["nrm"].astype(np.float64) @ nrm_mat.T
            nrm_w = nrm_w / np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-30)
            pos_all.append(pos_w[idx].astype(np.float32))
            nrm_all.append(nrm_w[idx].astype(np.float32))
            uv_all.append(p["uv"].astype(np.float32)[idx])
            mat_all.append(np.full(len(idx), p["material"], np.int32))
    mesh = {"positions": np.concatenate(pos_all), "normals": np.concatenate(nrm_all),
            "uvs": np.concatenate(uv_all), "mat_id": np.concatenate(mat_all)}

    def tex(slot):
        return -1 if slot is None else (slot["index"] + 1 if slot["index"] < n_images else -1)

    materials = []
    for m in desc["materials"]:
        pbr = m.get("pbrMetallicRoughness", {})
        sheen_c = m.get("extensions", {}).get("KHR_materials_sheen", {}).get(
            "sheenColorFactor", [0.0, 0.0, 0.0])
        nt = m.get("normalTexture")
        materials.append({
            "base_color": tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]),
            "emission": tuple(m.get("emissiveFactor", [0.0, 0.0, 0.0])),
            "roughness": float(pbr.get("roughnessFactor", 1.0)),
            "metalness": float(pbr.get("metallicFactor", 1.0)),
            "normal_strength": float(nt.get("scale", 1.0)) if nt else 0.0,
            "sheen": float(np.dot(LUMA, np.asarray(sheen_c[:3], np.float64))),
            "sheen_tint": 0.0, "anisotropic": 0.0,
            "tex_albedo": tex(pbr.get("baseColorTexture")), "tex_normal": tex(nt),
            "tex_mr": tex(pbr.get("metallicRoughnessTexture")),
            "tex_emission": tex(m.get("emissiveTexture")),
        })
    return mesh, materials, view, focal
