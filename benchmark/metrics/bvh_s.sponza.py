"""bvh_s.sponza: seconds in the program's `bvh` (the BVH build and the
triangle packing) and `k1_tables` spans of the scene rebuilt once under
spans after the window (`entries/sponza.py:extra_spans`); None without
them."""
from metrics import _spans


def read(run):
    recs = (run.state or {}).get("rebuild_spans")
    return None if not recs else _spans.span_s(recs, ("bvh", "k1_tables"))
