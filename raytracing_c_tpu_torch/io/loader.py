"""Model file dispatch + scene assembly.

Counterpart of `raytracing_c_tpu/io/loader.py`. load_model_file
(driver.c:685-728): extension dispatch .obj/.glb/.gltf; the glTF camera
(if present) overrides the default camera; the environment map
`background.png` is loaded from the working directory (driver.c:759). A
missing or undecodable env map is a hard failure exactly like the
reference's load_texture ("Failed to load texture: '<path>'" then exit 1,
driver.c:106-116); callers that want no env light pass
background_path=None (the --no-bg extension) and get a neutral constant sky.
"""

from __future__ import annotations

import os

from raytracing_c_tpu_torch.io.gltf_loader import load_gltf
from raytracing_c_tpu_torch.io.image_io import load_image_rgb_u8
from raytracing_c_tpu_torch.io.materials import build_material_table
from raytracing_c_tpu_torch.io.obj_loader import load_obj
from raytracing_c_tpu_torch.models.scene import Background, Camera, build_scene, resolve_device

#: fallback sky when no env map is available (linear RGB)
DEFAULT_SKY = (0.5, 0.62, 0.78)


def load_model(path: str, warn=print):
    """Load a model file into host-side staging.

    Returns (mesh, materials, atlas builder, camera | None).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        mesh, mats, atlas = load_obj(path, warn=warn)
        return mesh, mats, atlas, None
    if ext in (".glb", ".gltf"):
        return load_gltf(path, warn=warn)
    raise ValueError(f"Unrecognized file type: '{path}'")


def load_scene(path: str, background_path: str | None = "background.png", warn=print,
               device="cuda"):
    """Full scene assembly mirroring main() (driver.c:730-788): default
    camera, env map, model load (camera override), BVH build; the scene
    lands on `device`, which is checked before the model is read."""
    resolve_device(device)
    mesh, mats, atlas, camera = load_model(path, warn=warn)

    background = Background.constant(DEFAULT_SKY)
    if background_path:
        try:
            img = load_image_rgb_u8(background_path)
        except (OSError, ValueError) as e:
            # reference load_texture parity (driver.c:106-116): any failure
            # to read/decode the env map is fatal, never a silent fallback
            raise FileNotFoundError(f"Failed to load texture: '{background_path}'") from e
        tid = atlas.add(img, key=os.path.normpath(background_path))
        background = Background.equirect(tid)

    if camera is None:
        camera = Camera.default()

    return build_scene(
        mesh,
        materials=build_material_table(mats),
        atlas=atlas.build(),
        background=background,
        camera=camera,
        device=device,
    )
