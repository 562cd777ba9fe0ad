"""intersect_ms.render and .cli: host ms a batch in the program's
`intersect` (K1 and its input packing, the NEE shadow launch included) and
`attrs` (K2 or the unpacking of K1's epilogue) spans over the traced
frame (metrics/_spans.py)."""
from metrics import _spans


def read(run):
    return _spans.frame_ms(run, ("intersect", "attrs"))
