"""mrays_per_s.cli: the CLI's own "rays traced" over its printed render
wall, summed over the window's frames, in millions per second."""
from metrics import _common


def read(run):
    rays, ms = _common.cli_sum(run, "rays"), _common.cli_sum(run, "wall_ms")
    return None if rays is None or not ms else rays / ms / 1e3
