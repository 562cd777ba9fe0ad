"""k3_roofline.cli: the least time of K3's work on the frame (roofline/
bounds.py:k3_work) over its mean profiled device time per launch on the
window's last frame, each launch cold (the L2 cache emptied before it), in
%."""
from roofline import bounds


def read(run):
    d = (run.profile or {}).get("denoise")
    if d is None:
        return None
    names = [k for k in d["by_name"] if "denoise" in k]
    launches = sum(d["count_by_name"][k] for k in names)
    if not launches:
        return None
    device_s = sum(d["by_name"][k] for k in names) / launches
    h, w = run.entry.frame_shape(run)
    return 100.0 * bounds.bound_s(*bounds.k3_work(h, w)) / device_s
