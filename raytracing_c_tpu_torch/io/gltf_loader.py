"""glTF 2.0 / GLB loader.

Counterpart of `raytracing_c_tpu/io/gltf_loader.py`: the reference's codin
glTF path (load_model_gltf, driver.c:589-683):

- GLB container and .gltf + external/data-URI buffers
- node hierarchy flattened: world transforms (matrix or TRS) applied to
  positions/normals (normals via inverse-transpose rotation)
- the FIRST perspective camera node wins: fov = yfov,
  focal = 1/tan(yfov/2), view matrix = the camera node's world matrix
  (driver.c:599-612); orthographic cameras are skipped
- materials: baseColorFactor/metallicFactor/roughnessFactor (glTF spec
  defaults 1.0), emissiveFactor, sheen = luminance(KHR_materials_sheen
  sheenColorFactor) (driver.c:637), normalTexture.scale ->
  normal_map_strength, and the 4 texture slots (base color, normal,
  metallic-roughness, emissive) (driver.c:640-658)
- images decoded from bufferViews or URIs (driver.c:620-626)
- a primitive's TEXCOORD_1, the lightmap UV set importers generate, into
  `HostMesh.lightmap_uvs` where any primitive has one (zero elsewhere: a
  bake skips triangles with no UV area)
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np
import torch

from raytracing_c_tpu_torch.io.image_io import decode_image_rgb_u8, load_image_rgb_u8
from raytracing_c_tpu_torch.io.materials import AtlasBuilder, HostMaterial
from raytracing_c_tpu_torch.models.scene import Camera, HostMesh
from raytracing_c_tpu_torch.utils.color import LUMA

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZES = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


def _load_buffers(doc: dict, blob: bytes | None, base_dir: str) -> list[bytes]:
    bufs = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if blob is None:
                raise ValueError("GLB BIN chunk missing")
            bufs.append(blob)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _read_accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n_comp = _TYPE_SIZES[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    item = np.dtype(dtype).itemsize * n_comp

    bv = doc["bufferViews"][acc["bufferView"]]
    data = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", item)

    if stride == item:
        arr = np.frombuffer(data, dtype, count * n_comp, start)
    else:
        rows = [
            np.frombuffer(data, dtype, n_comp, start + i * stride)
            for i in range(count)
        ]
        arr = np.concatenate(rows)
    arr = arr.reshape(count, n_comp) if n_comp > 1 else arr.reshape(count)
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return arr


def _trs_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF stores column-major
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def parse_glb(data: bytes):
    """Split a GLB container into (json_doc, bin_blob)."""
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    doc, blob = None, None
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off : off + clen]
        off += clen
        if ctype == 0x4E4F534A:  # 'JSON'
            doc = json.loads(chunk)
        elif ctype == 0x004E4942:  # 'BIN'
            blob = chunk
    if doc is None:
        raise ValueError("GLB without a JSON chunk")
    return doc, blob


def load_gltf(path: str, atlas: AtlasBuilder | None = None, warn=print):
    """Load a .glb/.gltf file.

    Returns (HostMesh, materials, atlas, camera | None).
    """
    if atlas is None:
        atlas = AtlasBuilder()
    base_dir = os.path.dirname(path)

    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == b"glTF":
        doc, blob = parse_glb(raw)
    else:
        doc, blob = json.loads(raw), None
    buffers = _load_buffers(doc, blob, base_dir)

    # ---- images -> atlas -------------------------------------------------
    image_tex_ids: list[int] = []
    for i, img in enumerate(doc.get("images", [])):
        try:
            if "bufferView" in img:
                bv = doc["bufferViews"][img["bufferView"]]
                data = buffers[bv["buffer"]]
                start = bv.get("byteOffset", 0)
                decoded = decode_image_rgb_u8(data[start : start + bv["byteLength"]],
                                              name=f"{path} image {i}")
            elif "uri" in img and img["uri"].startswith("data:"):
                decoded = decode_image_rgb_u8(
                    base64.b64decode(img["uri"].split(",", 1)[1]), name=f"{path} image {i}"
                )
            else:
                decoded = load_image_rgb_u8(os.path.join(base_dir, img["uri"]))
            image_tex_ids.append(atlas.add(decoded, key=("gltf", path, i)))
        except (OSError, ValueError) as e:
            warn(f"Failed to load image {i}: {e}")
            image_tex_ids.append(-1)

    def tex_image(tex_index: int) -> int:
        if tex_index is None or tex_index < 0:
            return -1
        src = doc["textures"][tex_index].get("source", -1)
        return image_tex_ids[src] if 0 <= src < len(image_tex_ids) else -1

    # ---- materials --------------------------------------------------------
    materials: list[HostMaterial] = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        bc = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        sheen_color = (
            m.get("extensions", {})
            .get("KHR_materials_sheen", {})
            .get("sheenColorFactor", [0.0, 0.0, 0.0])
        )
        sheen = float(np.dot(LUMA, np.asarray(sheen_color[:3], np.float64)))
        hm = HostMaterial(
            name=m.get("name", ""),
            base_color=tuple(bc[:3]),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metalness=float(pbr.get("metallicFactor", 1.0)),
            emission=tuple(m.get("emissiveFactor", [0.0, 0.0, 0.0])),
            sheen=sheen,
        )
        nt = m.get("normalTexture")
        if nt is not None:
            hm.tex_normal = tex_image(nt.get("index", -1))
            hm.normal_strength = float(nt.get("scale", 1.0))
        et = m.get("emissiveTexture")
        if et is not None:
            hm.tex_emission = tex_image(et.get("index", -1))
        bt = pbr.get("baseColorTexture")
        if bt is not None:
            hm.tex_albedo = tex_image(bt.get("index", -1))
        mrt = pbr.get("metallicRoughnessTexture")
        if mrt is not None:
            hm.tex_mr = tex_image(mrt.get("index", -1))
        materials.append(hm)
    if not materials:
        materials = [HostMaterial()]

    # ---- node hierarchy: world transforms ---------------------------------
    nodes = doc.get("nodes", [])
    world = [None] * len(nodes)

    def visit(ni: int, parent: np.ndarray):
        w = parent @ _trs_matrix(nodes[ni])
        world[ni] = w
        for ch in nodes[ni].get("children", []):
            visit(ch, w)

    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    roots = scenes[scene_idx]["nodes"] if scenes else range(len(nodes))
    for ri in roots:
        visit(ri, np.eye(4))
    for i in range(len(nodes)):  # orphan nodes (defensive)
        if world[i] is None:
            visit(i, np.eye(4))

    # ---- camera: first perspective camera node (driver.c:599-612) --------
    camera = None
    for ni, node in enumerate(nodes):
        ci = node.get("camera", -1)
        if ci < 0:
            continue
        cam = doc["cameras"][ci]
        if cam.get("type") != "perspective":
            continue
        yfov = float(cam["perspective"]["yfov"])
        camera = Camera(
            view_matrix=torch.from_numpy(world[ni].astype(np.float32)),
            fov=torch.tensor(np.float32(yfov)),
            focal_length=torch.tensor(np.float32(1.0 / np.tan(yfov * 0.5))),
        )
        break

    # ---- meshes -> triangle soup ------------------------------------------
    all_pos, all_nrm, all_uv, all_uv1, all_mat = [], [], [], [], []
    for ni, node in enumerate(nodes):
        mi = node.get("mesh", -1)
        if mi < 0:
            continue
        w = world[ni]
        rot = w[:3, :3]
        nrm_mat = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
        for prim in doc["meshes"][mi]["primitives"]:
            if prim.get("mode", 4) != 4:
                warn(f"skipping non-triangle primitive in mesh {mi}")
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float64)
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            idx = idx.reshape(-1, 3)

            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float64)
            else:
                nrm = None
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(
                    np.float32
                )
            else:
                uv = np.zeros((len(pos), 2), np.float32)
            uv1 = (_read_accessor(doc, buffers, attrs["TEXCOORD_1"]).astype(np.float32)[idx]
                   if "TEXCOORD_1" in attrs else None)

            pos_w = pos @ rot.T + w[:3, 3]
            tri_pos = pos_w[idx]  # (n, 3, 3)
            if nrm is not None:
                nrm_w = nrm @ nrm_mat.T
                ln = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
                nrm_w = nrm_w / np.maximum(ln, 1e-30)
                tri_nrm = nrm_w[idx]
            else:
                e1 = tri_pos[:, 1] - tri_pos[:, 0]
                e2 = tri_pos[:, 2] - tri_pos[:, 0]
                fn = np.cross(e1, e2)
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
                tri_nrm = np.repeat(fn[:, None, :], 3, axis=1)

            all_pos.append(tri_pos.astype(np.float32))
            all_nrm.append(tri_nrm.astype(np.float32))
            all_uv.append(uv[idx])
            all_uv1.append(uv1)
            all_mat.append(
                np.full(len(idx), prim.get("material", 0), np.int32)
            )

    if all_pos:
        mesh = HostMesh(
            positions=np.concatenate(all_pos),
            normals=np.concatenate(all_nrm),
            uvs=np.concatenate(all_uv),
            mat_id=np.concatenate(all_mat),
            lightmap_uvs=(np.concatenate([np.zeros_like(u) if u1 is None else u1
                                          for u, u1 in zip(all_uv, all_uv1)])
                          if any(u1 is not None for u1 in all_uv1) else None),
        )
    else:
        mesh = HostMesh(
            positions=np.zeros((0, 3, 3), np.float32),
            normals=np.zeros((0, 3, 3), np.float32),
            uvs=np.zeros((0, 3, 2), np.float32),
            mat_id=np.zeros(0, np.int32),
        )
    return mesh, materials, atlas, camera
