"""device_idle_share.render and .cli: the share of the profiled group's
wall in which no kernel, copy or fill ran on the device, in %."""
from metrics import _common


def read(run):
    return _common.idle_share(run)
