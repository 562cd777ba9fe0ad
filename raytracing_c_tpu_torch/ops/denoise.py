"""Firefly median denoiser: the CUDA kernel K3, its plain version and wrapper.

Counterpart of both `raytracing_c_tpu/ops/denoise.py` (the plain image
pass) and `raytracing_c_tpu/ops/denoise_pallas.py` (the TPU kernel):

| kernel (csrc/denoise.cu) | wrapper      | replaces (Pallas)                          |
|--------------------------|--------------|--------------------------------------------|
| K3 `denoise_u8_kernel`   | `denoise_u8` | `denoise_u8_pallas` -> `_denoise_kernel`   |

The reference's 3x3 luminance-median filter (denoiser.c:9-127): the
edge-clamped neighbourhood sorted by Rec.709 luminance, the median sample,
the mean luminance without the minimum and maximum, and a blend of
luminance outliers in quiet neighbourhoods toward the median, on the 8-bit
image (u8 -> f32 / 255.999 -> u8).

`denoise_u8` given a CPU tensor runs `denoise_u8_plain`; given a CUDA
tensor it launches K3 through `cuda_build.launch`, which counts the
launches, or raises. K3 selects the median with the compare-exchange
network `MEDIAN9_NETWORK` on the keys (luminance key << 4 | index),
which picks the plain version's stable-sort median exactly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.utils import spans
from raytracing_c_tpu_torch.utils.color import LUMA

DENOISING_THRESHOLD = 0.0125  # denoiser.c:9
NEIGHBOURHOOD_WEIGHT = 5.0  # denoiser.c:10

#: K3's median-of-9 network (Devillard's opt_med9): 19 compare-exchanges,
#: (a, b) leaves the smaller key at a; position 4 ends as the median
MEDIAN9_NETWORK = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
                   (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
                   (4, 2), (6, 4), (4, 2))
#: K3's key of a luminance is max(float32 bits - KEY_BASE, 0): every
#: luminance of a u8 pixel is 0 or in [2**-13, 1), where the bits rise with
#: the value, so the key keeps the order in 27 bits
KEY_BASE = 0x39000000 - 1


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as a true division on every device (PyTorch's CUDA division by
    a Python scalar multiplies by its rounded reciprocal instead)."""
    return a / torch.tensor(c, dtype=a.dtype, device=a.device)


def denoise_u8_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (H, W, 3) u8 -> (H, W, 3) u8.

    The 9 luminances are summed in neighbourhood order (dy, dx row-major),
    the median comes from a stable sort, so that K3 agrees bit for bit."""
    f = img.to(torch.float32) * (1.0 / 255.999)
    h, w, _ = f.shape
    rows = torch.arange(h, device=f.device)
    cols = torch.arange(w, device=f.device)
    samples = []
    for dy in (-1, 0, 1):
        ys = torch.clamp(rows + dy, 0, h - 1)
        for dx in (-1, 0, 1):
            xs = torch.clamp(cols + dx, 0, w - 1)
            samples.append(f[ys][:, xs])
    lums = [(s[..., 0] * LUMA[0] + s[..., 1] * LUMA[1]) + s[..., 2] * LUMA[2] for s in samples]

    lum = torch.stack(lums, dim=-1)  # (H, W, 9)
    lum_sorted, order = torch.sort(lum, dim=-1, stable=True)
    stack = torch.stack(samples, dim=2)  # (H, W, 9, 3)
    median_rgb = torch.gather(stack, 2, order[..., 4:5, None].expand(h, w, 1, 3))[:, :, 0]
    median_lum = lum_sorted[..., 4]

    total = lums[0]
    for lv in lums[1:]:
        total = total + lv
    mean = _div(total - lum_sorted[..., 0] - lum_sorted[..., 8], 7.0)
    noisiness = torch.abs(median_lum - mean)

    diff = torch.abs(median_lum - lums[4]) - noisiness * NEIGHBOURHOOD_WEIGHT
    t = _div(torch.clamp(diff, 0.0, DENOISING_THRESHOLD), DENOISING_THRESHOLD)[..., None]
    out = samples[4] * (1.0 - t) + median_rgb * t
    return (out * 255.999).to(torch.uint8)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("denoise")
    lib.rt_denoise_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.rt_denoise_u8.restype = ctypes.c_int
    return lib


def denoise_u8(img: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: (H, W, 3) u8 -> (H, W, 3) u8 on the image's device,
    inside a `denoise` span."""
    with spans.span("denoise"):
        if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
            raise ValueError(f"denoise_u8: need an (H, W, 3) uint8 image, got {img.dtype} "
                             f"{tuple(img.shape)}")
        dev = img.device
        if dev.type == "cpu":
            return denoise_u8_plain(img)
        if dev.type != "cuda":
            raise ValueError(f"denoise_u8: unsupported device {dev}")
        img = img.contiguous()
        h, w, _ = img.shape
        out = torch.empty_like(img)
        if h == 0 or w == 0:
            return out
        cuda_build.launch("denoise_u8", _library().rt_denoise_u8, img.data_ptr(),
                          out.data_ptr(), h, w, device=dev)
        return out
