"""Host-side material + texture staging.

Counterpart of `raytracing_c_tpu/io/materials.py`. Loaders produce a list
of `HostMaterial` plus an `AtlasBuilder`; these pack into the scene's
`MaterialTable` / `TextureAtlas` (the reference's per-material
`PBR_Shader_Data` structs with raw image pointers, driver.c:191-198).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from raytracing_c_tpu_torch.models.scene import SHADER_DISNEY, MaterialTable, TextureAtlas
from raytracing_c_tpu_torch.utils.vec3 import Vec3


class AtlasBuilder:
    """Collects decoded u8 RGB images for `TextureAtlas.pack`.

    Texture id 0 is the atlas's 1x1 white dummy ("no texture"), so the
    first image added gets id 1.
    """

    def __init__(self) -> None:
        self._images: list[np.ndarray] = []
        self._dedup: dict = {}

    def add(self, img: np.ndarray, key=None) -> int:
        """Add an (H, W, 3) u8 image; returns its texture id. `key` enables
        dedup (the reference dedups OBJ textures by path hash map,
        driver.c:518-527)."""
        if key is not None and key in self._dedup:
            return self._dedup[key]
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise ValueError(f"AtlasBuilder.add: need (H, W, 3) u8, got {img.dtype} {img.shape}")
        self._images.append(np.ascontiguousarray(img))
        tid = len(self._images)
        if key is not None:
            self._dedup[key] = tid
        return tid

    def build(self) -> TextureAtlas:
        return TextureAtlas.pack(self._images)


@dataclass
class HostMaterial:
    """One material row (reference PBR_Shader_Data, driver.c:191-198)."""

    base_color: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5  # reference OBJ default, driver.c:553
    metalness: float = 0.0
    normal_strength: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    anisotropic: float = 0.0
    tex_albedo: int = -1
    tex_normal: int = -1
    tex_mr: int = -1
    tex_emission: int = -1
    shader_kind: int = SHADER_DISNEY
    name: str = ""
    extra: dict = field(default_factory=dict)


def build_material_table(mats: list[HostMaterial]) -> MaterialTable:
    if not mats:
        mats = [HostMaterial()]

    def col(name, dtype=np.float32):
        return torch.from_numpy(np.array([getattr(m, name) for m in mats], dtype))

    def vec(name):
        a = np.array([getattr(m, name) for m in mats], np.float32)
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, c])) for c in range(3)))

    return MaterialTable(
        base_color=vec("base_color"),
        emission=vec("emission"),
        roughness=col("roughness"),
        metalness=col("metalness"),
        normal_strength=col("normal_strength"),
        sheen=col("sheen"),
        sheen_tint=col("sheen_tint"),
        anisotropic=col("anisotropic"),
        tex_albedo=col("tex_albedo", np.int32),
        tex_normal=col("tex_normal", np.int32),
        tex_mr=col("tex_mr", np.int32),
        tex_emission=col("tex_emission", np.int32),
        shader_kind=col("shader_kind", np.int32),
    ).with_rows()
