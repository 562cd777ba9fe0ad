"""raytracing_c_tpu_torch — the path tracer in PyTorch, with CUDA kernels.

The port of `raytracing_c_tpu` (JAX/Pallas) to PyTorch and hand-written
CUDA for NVIDIA Hopper. Subpackages and modules mirror the JAX package so
each function has a counterpart of the same name:

- `utils/`   Vec3 component planes, colour transfer, threefry RNG
- `models/`  scene dataclasses of tensors, host-side BVH build, scene cache
- `ops/`     intersection, texture, background, env-light sampling, Disney
             shading, traversal; `ops/traverse_cuda.py` + `csrc/traverse.cu`
             and `ops/denoise.py` + `csrc/denoise.cu` hold the kernels
- `render/`  camera, wavefront integrator, batched renderer, lightmap baker
- `io/`      model loaders, image codecs; `native/` the C QOI codec
- `tools/`   the BVH inspector (`python -m raytracing_c_tpu_torch.tools.bvh_viz`)

The package imports torch and numpy only. Functions run on the device of
the tensors they are given (`scene.to("cuda")`); a kernel wrapper takes its
plain PyTorch version only for CPU tensors.
"""

__version__ = "0.1.0"

EPSILON = 1.0e-4  # reference: common.h:8
BVH_WIDTH = 8     # reference: raytracer.h:6 (SIMD_WIDTH)
