"""mrays_per_s.render: RenderStats.rays_traced over RenderStats.wall_ms,
summed over the window's render() frames, in millions per second."""


def read(run):
    if run.config["entry"] != "render":
        return None
    return sum(f["rays"] for f in run.frames) / sum(f["wall_ms"] for f in run.frames) / 1e3
