"""Conservative bfloat16 rounding of bounding boxes, on numpy bits.

Counterpart of `raytracing_c_tpu/utils/bf16.py` without ml_dtypes: a
bfloat16 is the top 16 bits of a float32, the conversion rounds to nearest
even, and the directed forms step one bf16 ulp where that rounding went
the wrong way, so minima round toward -inf and maxima toward +inf and a box
only grows. The port traverses float32 boxes; it writes these bits only
into the scene cache, whose format carries the JAX package's bf16 twin of
the node table (`models/serialization.py`).
"""

from __future__ import annotations

import numpy as np


def to_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), round to nearest even."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def to_float(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _step_ulp(bits: np.ndarray, toward_neg: bool) -> np.ndarray:
    """One bf16 ulp step in sign-magnitude space; crossing zero flips the
    sign, and the magnitude stops at infinity."""
    sign = (bits & 0x8000) != 0
    mag = (bits & 0x7FFF).astype(np.int32)
    delta = np.where(sign, 1, -1)
    if not toward_neg:
        delta = -delta
    new_mag = mag + delta
    crossed = new_mag < 0
    new_sign = np.where(crossed, ~sign, sign)
    new_mag = np.minimum(np.where(crossed, 1, new_mag), 0x7F80)
    return np.where(new_sign, 0x8000, 0).astype(np.uint16) | new_mag.astype(np.uint16)


def _round_directed(x: np.ndarray, toward_neg: bool) -> np.ndarray:
    x = np.asarray(x, np.float32)
    bits = to_bits(x)
    back = to_float(bits)
    need = (back > x) if toward_neg else (back < x)
    return np.where(need, _step_ulp(bits, toward_neg), bits)


def round_down(x: np.ndarray) -> np.ndarray:
    """bf16 bits of the greatest bf16 value <= x."""
    return _round_directed(x, True)


def round_up(x: np.ndarray) -> np.ndarray:
    """bf16 bits of the least bf16 value >= x."""
    return _round_directed(x, False)
