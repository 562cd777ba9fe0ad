"""load_s.cli: the CLI's "Bvh generated in" line (GLB read, images decoded,
env map read, BVH and K1's tables built), mean over the window's frames,
in s."""
from metrics import _common


def read(run):
    ms = _common.cli_sum(run, "load_ms")
    return None if ms is None else ms / 1e3 / len(run.frames)
