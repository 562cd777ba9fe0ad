"""decode_s.cli: seconds in the program's `decode` spans of the traced
frame's load (each image decoded, the env map included;
metrics/_spans.py)."""
from metrics import _spans


def read(run):
    return _spans.load_s(run, ("decode",))
