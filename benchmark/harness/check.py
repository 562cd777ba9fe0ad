"""The numbers the output check compares: the program's u8 pixels against
the plain reference's at the same pixels."""

from __future__ import annotations

import numpy as np


def compare(got: np.ndarray, ref: np.ndarray) -> dict:
    """got, ref: (n, 3) u8. mismatch_share: the share of channels that
    differ at all; max_abs_u8: the largest difference in u8 levels;
    mean_abs_u8: the mean difference in u8 levels; compared: the channels
    compared."""
    if got.shape != ref.shape or got.size == 0:
        raise ValueError(f"check: {got.shape} against {ref.shape}")
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return {"mismatch_share": float((diff > 0).mean()), "max_abs_u8": float(diff.max()),
            "mean_abs_u8": float(diff.mean()), "compared": float(diff.size)}
