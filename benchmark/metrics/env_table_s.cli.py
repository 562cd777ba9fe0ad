"""env_table_s.cli: the CLI's "Env light table built in" line (--nee), mean
over the window's frames, in s."""
from metrics import _common


def read(run):
    ms = _common.cli_sum(run, "env_table_ms")
    return None if ms is None else ms / 1e3 / len(run.frames)
