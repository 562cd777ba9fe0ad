"""sync_wait_ms.render and .cli: host ms a batch in the program's `sync`
spans, where the host blocks on the device to read its data (the
compaction and shadow-lane `nonzero`, the frame's ray count), over the
traced frame (metrics/_spans.py)."""
from metrics import _spans


def read(run):
    return _spans.frame_ms(run, ("sync",))
