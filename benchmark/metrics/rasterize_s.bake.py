"""rasterize_s.bake: host seconds in the program's `rasterize` span of the
traced bake (the store's readback, the UV-space arena and its inside
test, the records' positions and normals); None without it."""

from metrics import _spans


def read(run):
    return _spans.load_s(run, ("rasterize",))
