"""bvh_s.cli: seconds in the program's `bvh` (the BVH build and the
triangle packing) and `k1_tables` spans of the traced frame's load
(metrics/_spans.py)."""
from metrics import _spans


def read(run):
    return _spans.load_s(run, ("bvh", "k1_tables"))
