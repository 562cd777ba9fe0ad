"""write_s.cli: the CLI's "Output file written in" line (the frame read
back and PNG-encoded), mean over the window's frames, in s."""
from metrics import _common


def read(run):
    ms = _common.cli_sum(run, "write_ms")
    return None if ms is None else ms / 1e3 / len(run.frames)
