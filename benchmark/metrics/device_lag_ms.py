"""device_lag_ms.render and .cli: the median over the leaf spans of the
traced frame's batches of how far the device's start of the span (a CUDA
event, put on the host's clock) trails the host's, in ms: near 0 the
device waits for the host; milliseconds, the device is behind. Read from
the pass with events on, which no other metric reads (metrics/_spans.py)."""
from metrics import _spans


def read(run):
    return _spans.lag_ms(run)
