"""readback_ms.bake: host ms a batch in the program's `readback` spans of
the traced bake (the radiance to the host, the mean over a texel's samples
and the scatter into the map) over its `batch` spans; None without them."""

from metrics import _spans


def read(run):
    return _spans.frame_ms(run, ("readback",))
