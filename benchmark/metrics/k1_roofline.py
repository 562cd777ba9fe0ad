"""k1_roofline.render and .cli: the least time of both K1 kernels' work in
the profiled group (roofline/k1.py, on the benchmark's own tree; shadow rays
as an any-hit walk) over their profiled device time, in %, against one
H100's published rates (3.35 TB/s, 33.5 T instructions/s)."""
from metrics import _common


def read(run):
    return _common.k1_roofline(run)
