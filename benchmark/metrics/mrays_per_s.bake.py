"""mrays_per_s.bake: the rays of the window's bakes (bake_lightmap's
stats, the `bake` span's rays: every scene intersection of every texel's
hemisphere paths) over their wall, in millions per second; None without
them."""


def read(run):
    if not run.frames or "rays" not in run.frames[0]:
        return None
    return sum(f["rays"] for f in run.frames) / sum(f["wall_ms"] for f in run.frames) / 1e3
