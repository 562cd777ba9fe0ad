"""rng_ms.render and .cli: host ms a batch in the program's `rng` spans (the
threefry draws: the batch's uniforms, its keys, each bounce's slot-keyed
draw) over the traced frame (metrics/_spans.py)."""
from metrics import _spans


def read(run):
    return _spans.frame_ms(run, ("rng",))
