"""Colour management: sRGB transfer curves, luminance, tonemaps.

Counterpart of `raytracing_c_tpu/utils/color.py`, same reference quirks:
`srgb_to_linear` is the reference's pure power curve with no linear
segment (common.h:82-88); `linear_to_srgb` is the piecewise curve
(common.h:90-92).
"""

from __future__ import annotations

import torch

#: Rec.709 luma weights, reference driver.c:200-202 / denoiser.c:12-14.
LUMA = (0.2126, 0.7152, 0.0722)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Nonstandard pure-pow sRGB decode (reference common.h:82-88)."""
    return torch.pow(torch.clamp_min(c + 0.055, 0.0) / 1.055, 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Piecewise linear->sRGB encode (reference common.h:90-92)."""
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def aces(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic curve (reference raytracer.c:560-567; off by default)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (x * (a * x + b)) / (x * (c * x + d) + e)


def reinhard(x: torch.Tensor) -> torch.Tensor:
    """Extended Reinhard with L_white=4 (reference raytracer.c:569-572)."""
    l_white = 4.0
    return torch.clamp((x * (1.0 + x / (l_white * l_white))) / (1.0 + x), 0.0, 1.0)


def encode_u8(linear_rgb: torch.Tensor) -> torch.Tensor:
    """clamp -> linear_to_srgb -> *255.999 -> u8 (reference raytracer.c:700-716)."""
    c = linear_to_srgb(torch.clamp(linear_rgb, 0.0, 1.0))
    return (c * 255.999).to(torch.uint8)
