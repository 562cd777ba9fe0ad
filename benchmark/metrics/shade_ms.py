"""shade_ms.render and .cli: host ms a batch in the program's `shade` spans
(Disney shade with its texture taps and NEE light sample, and the
emission it adds) over the traced frame (metrics/_spans.py)."""
from metrics import _spans


def read(run):
    return _spans.frame_ms(run, ("shade",))
