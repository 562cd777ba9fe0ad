"""mrays_per_s.sponza: RenderStats.rays_traced over RenderStats.wall_ms,
summed over the window's render() frames, in millions per second (the
rays every scene intersection and NEE shadow ray)."""


def read(run):
    if not run.frames or "rays" not in run.frames[0]:
        return None
    return sum(f["rays"] for f in run.frames) / sum(f["wall_ms"] for f in run.frames) / 1e3
