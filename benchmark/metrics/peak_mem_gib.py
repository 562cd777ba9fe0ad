"""peak_mem_gib.render and .cli: torch.cuda.max_memory_allocated() over the
window, after reset_peak_memory_stats() at its start, in GiB."""
from metrics import _common


def read(run):
    return _common.peak_gib(run)
