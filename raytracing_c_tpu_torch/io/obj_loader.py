"""Wavefront OBJ + MTL loader.

Counterpart of `raytracing_c_tpu/io/obj_loader.py`: the reference's codin
`obj_load` path (load_model_obj, driver.c:510-587):

- polygon faces are fan-triangulated; v / v/vt / v//vn / v/vt/vn index forms
  and negative (relative) indices are supported
- MTL PBR extension fields are consumed: Pr (roughness), Pm (metallic),
  Ps (sheen), aniso, norm + map_Kd/map_Ke/map_Pr/map_Pm textures; non-PBR
  materials keep Kd/Ke + the 0.5 default roughness and emit the reference's
  warning (driver.c:553, 565)
- textures are deduped by path (driver.c:518-527)
- a missing MTL file degrades to the default material (tower.obj references
  a tower.mtl that does not exist in the reference snapshot)
"""

from __future__ import annotations

import os

import numpy as np

from raytracing_c_tpu_torch.io.image_io import load_image_rgb_u8
from raytracing_c_tpu_torch.io.materials import AtlasBuilder, HostMaterial
from raytracing_c_tpu_torch.models.scene import HostMesh


def _parse_index(tok: str, n: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else n + i


def load_mtl(path: str, atlas: AtlasBuilder, warn=print) -> dict[str, HostMaterial]:
    """Parse an MTL file into HostMaterials (PBR extension aware)."""
    mats: dict[str, HostMaterial] = {}
    cur: HostMaterial | None = None
    base = os.path.dirname(path)

    def tex(p: str) -> int:
        full = os.path.join(base, p)
        try:
            img = load_image_rgb_u8(full)
        except (OSError, ValueError) as e:  # missing texture -> none (reference
            warn(f"Failed to load texture: '{full}': {e}")  # exits; we degrade)
            return -1
        return atlas.add(img, key=os.path.normpath(full))

    try:
        with open(path, "r", errors="replace") as f:
            lines = f.read().splitlines()
    except OSError:
        warn(f"Failed to load material library '{path}'")
        return mats

    for line in lines:
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        k = t[0]
        if k == "newmtl":
            name = t[1] if len(t) > 1 else ""
            cur = HostMaterial(name=name)
            mats[name] = cur
            continue
        if cur is None:
            continue
        if k == "Kd" and len(t) >= 4:
            cur.base_color = tuple(float(x) for x in t[1:4])
        elif k == "Ke" and len(t) >= 4:
            cur.emission = tuple(float(x) for x in t[1:4])
        elif k == "Pr":
            cur.roughness = float(t[1])
            cur.extra["is_pbr"] = True
        elif k == "Pm":
            cur.metalness = float(t[1])
            cur.extra["is_pbr"] = True
        elif k == "Ps":
            cur.sheen = float(t[1])
            cur.extra["is_pbr"] = True
        elif k == "aniso":
            cur.anisotropic = float(t[1])
            cur.extra["is_pbr"] = True
        elif k == "norm" or k == "map_bump" and cur.extra.get("is_pbr"):
            cur.tex_normal = tex(t[-1])
            cur.normal_strength = 1.0 if cur.tex_normal >= 0 else 0.0
            cur.extra["is_pbr"] = True
        elif k == "map_Kd":
            cur.tex_albedo = tex(t[-1])
        elif k == "map_Ke":
            cur.tex_emission = tex(t[-1])
        elif k in ("map_Pm", "map_Pr"):
            # the reference wires map_Pm into the metal-roughness slot
            # (driver.c:563); keep the first one found
            if cur.tex_mr < 0:
                cur.tex_mr = tex(t[-1])
            cur.extra["is_pbr"] = True

    return mats


def load_obj(path: str, atlas: AtlasBuilder | None = None, warn=print):
    """Load an OBJ file.

    Returns (HostMesh, materials: list[HostMaterial], atlas). Per-face
    material ids index the returned material list.
    """
    if atlas is None:
        atlas = AtlasBuilder()

    positions: list[list[float]] = []
    normals: list[list[float]] = []
    uvs: list[list[float]] = []

    mat_by_name: dict[str, HostMaterial] = {}
    mat_list: list[HostMaterial] = []
    mat_index: dict[str, int] = {}
    cur_mat = -1

    faces_v: list[tuple] = []
    faces_vt: list[tuple] = []
    faces_vn: list[tuple] = []
    faces_m: list[int] = []

    base = os.path.dirname(path)

    def get_mat_id(name: str) -> int:
        if name not in mat_index:
            m = mat_by_name.get(name)
            if m is None:
                if name:
                    warn(f"unknown material '{name}', using default")
                m = HostMaterial(name=name)
            if not m.extra.get("is_pbr"):
                # reference warning for non-PBR materials (driver.c:565)
                warn(f"material {len(mat_list)} is not a pbr material")
            mat_index[name] = len(mat_list)
            mat_list.append(m)
        return mat_index[name]

    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()
    for raw in lines:
        t = raw.split()
        if not t or t[0].startswith("#"):
            continue
        k = t[0]
        if k == "v":
            positions.append([float(x) for x in t[1:4]])
        elif k == "vn":
            normals.append([float(x) for x in t[1:4]])
        elif k == "vt":
            uvs.append([float(x) for x in t[1:3]])
        elif k == "mtllib":
            mtl_path = os.path.join(base, raw.split(None, 1)[1].strip())
            mat_by_name.update(load_mtl(mtl_path, atlas, warn))
        elif k == "usemtl":
            name = raw.split(None, 1)[1].strip() if len(t) > 1 else ""
            cur_mat = get_mat_id(name)
        elif k == "f":
            corners = []
            for tok in t[1:]:
                parts = tok.split("/")
                vi = _parse_index(parts[0], len(positions))
                ti = (
                    _parse_index(parts[1], len(uvs))
                    if len(parts) > 1 and parts[1]
                    else -1
                )
                ni = (
                    _parse_index(parts[2], len(normals))
                    if len(parts) > 2 and parts[2]
                    else -1
                )
                corners.append((vi, ti, ni))
            if cur_mat < 0:
                cur_mat = get_mat_id("")
            for i in range(1, len(corners) - 1):  # fan triangulation
                tri = (corners[0], corners[i], corners[i + 1])
                faces_v.append(tuple(c[0] for c in tri))
                faces_vt.append(tuple(c[1] for c in tri))
                faces_vn.append(tuple(c[2] for c in tri))
                faces_m.append(cur_mat)

    n = len(faces_v)
    pos_arr = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm_arr = (
        np.asarray(normals, np.float32).reshape(-1, 3)
        if normals
        else np.zeros((0, 3), np.float32)
    )
    uv_arr = (
        np.asarray(uvs, np.float32).reshape(-1, 2)
        if uvs
        else np.zeros((0, 2), np.float32)
    )

    fv = np.asarray(faces_v, np.int64).reshape(n, 3)
    p = pos_arr[fv]  # (n, 3, 3)

    # normals: indexed where present, else face normal
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    face_n = np.cross(e1, e2)
    face_n /= np.maximum(np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-30)
    nrm = np.repeat(face_n[:, None, :], 3, axis=1)
    if len(nrm_arr):
        fn = np.asarray(faces_vn, np.int64).reshape(n, 3)
        has = fn >= 0
        idx = np.where(has, fn, 0)
        indexed = nrm_arr[idx]
        nrm = np.where(has[..., None], indexed, nrm)

    uv = np.zeros((n, 3, 2), np.float32)
    if len(uv_arr):
        ft = np.asarray(faces_vt, np.int64).reshape(n, 3)
        has = ft >= 0
        idx = np.where(has, ft, 0)
        uv = np.where(has[..., None], uv_arr[idx], 0.0)

    mesh = HostMesh(
        positions=p.astype(np.float32),
        normals=nrm.astype(np.float32),
        uvs=uv.astype(np.float32),
        mat_id=np.asarray(faces_m, np.int32),
    )
    if not mat_list:
        mat_list = [HostMaterial()]
    return mesh, mat_list, atlas
