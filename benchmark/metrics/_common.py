"""Readers shared by the metric files of this folder."""


def cli_sum(run, key):
    """The sum of a CLI stage line over the window's frames, or None."""
    vals = [f[key] for f in run.frames if key in f]
    return sum(vals) if vals and len(vals) == len(run.frames) else None


def group(run):
    """The profiled group's summary (harness/trace.py), or None."""
    return (run.profile or {}).get("group")


def launches_per_batch(run):
    g = group(run)
    return None if g is None else g["launches"] / run.config["k_group"]


def idle_share(run):
    g = group(run)
    if g is None or not g["window_s"]:
        return None
    return 100.0 * (1.0 - g["busy_s"] / g["window_s"])


def peak_gib(run):
    return None if run.window_peak_bytes is None else run.window_peak_bytes / 2**30


def k1_roofline(run):
    """Both K1 kernels' least time for their work on the benchmark's own
    tree (roofline/k1.py) over their profiled device time, in %."""
    from roofline import bounds
    from roofline.k1 import K1Tree, launch_work

    g = group(run)
    if g is None or not run.k1_launches:
        return None
    device_s = sum(v for k, v in g["by_name"].items() if "bvh_traverse" in k)
    if device_s <= 0:
        return None
    tree = K1Tree(run.entry.scene_positions(run))
    least = 0.0
    for la in run.k1_launches:
        nbytes, ops = launch_work(tree, la["rays"], la["o"], la["d"], la["shadow"],
                                  la["epilogue"])
        least += bounds.bound_s(nbytes, ops)
    return 100.0 * least / device_s
