"""The least time one H100 could take for a kernel's work.

Frozen copy of `raytracing_c_tpu_torch/utils/bounds.py`'s arithmetic at
commit f272015. A kernel's bound is the larger of the bytes its function
must move (each input read once, each output written once) over the
card's memory rate and its operations over the card's instruction rate.
Rates: one H100 SXM at its 700 W limit (NVIDIA's data sheet): 3.35 TB/s
of HBM3, and 67 TFLOP/s of float32 outside the tensor cores, a fused
multiply-add counting two, so 33.5 T instructions/s, one per lane per
clock. The counts below are the least instructions each test needs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2

#: K1, one slab test of an occupied child box: per axis the entry and exit
#: from the box's center and half-extent (3 fused multiply-adds) folded
#: into the running entry max and exit min (2), then entry < exit and
#: entry <= best t (2)
BOX_TEST_OPS = 17
#: K1, one Moller-Trumbore test of an occupied slot at the cost of the
#: step where it leaves: u outside [-EPSILON, 1 + EPSILON] after the cross
#: p (9), det (5), its reciprocal (1), o - v0 (3), u (5 + 1) and 2
#: compares; v or u + v outside after the cross q (9), v (5 + 1), u + v (1)
#: and 2 compares; else t (5 + 1) and 2 compares
TRI_U_FAIL_OPS = 26
TRI_V_FAIL_OPS = TRI_U_FAIL_OPS + 18
TRI_TEST_OPS = TRI_V_FAIL_OPS + 8
#: K1, per ray outside the walk: 3 reciprocals and -o * inv (3); the fused
#: attribute epilogue's interpolation (2 + 5 x 5)
RAY_SETUP_OPS = 6
EPILOGUE_OPS = 27
#: K3 per pixel: 3 conversions, 3 scalings, luminance (5) and its sort key
#: (3); the 9 neighbour indices (9), the 9-sum (8), min and max (8), the
#: mean (3), a 19-compare-exchange median-of-9 network (38), the blend
#: factor, the blend and the encode (25)
K3_OPS_PER_PIXEL = 14 + 9 + 8 + 8 + 3 + 19 * 2 + 25


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds: the larger of the memory and the instruction time."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_INSTR_PER_S)


def k3_work(height: int, width: int) -> tuple[float, float]:
    """K3's (bytes, operations) for one frame: 3 bytes in and 3 out per
    pixel."""
    n = height * width
    return 6.0 * n, float(n * K3_OPS_PER_PIXEL)
