"""shadow_ms.sponza: host ms a batch in the program's `intersect` spans of
kind `shadow` (the NEE shadow rays' packing and K1's any-hit launch) over
the traced frame (metrics/_spans.py); None without such a span."""
from metrics import _spans


def read(run):
    p = _spans.traced(run)
    if p is None or not _spans.per_batch_ms(p["host"], ("batch",)):
        return None
    return _spans.by_attr_ms(p["host"], "intersect", "kind").get("shadow")
