"""launches_per_batch.render and .cli: CUDA kernel launches in the profiled
group (one group of k_group batches at the frame's centre rows) per batch."""
from metrics import _common


def read(run):
    return _common.launches_per_batch(run)
