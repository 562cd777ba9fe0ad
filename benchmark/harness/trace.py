"""The traced part of a `--trace 1` run: one group of batches under
torch.profiler, read into device busy time, kernel launches, kernel times
and idle gaps; then the same group again, unprofiled, with the program's
K1 entry wrapped to record each launch's rays for K1's yardstick.

Spans are the benchmark's own (`record_function("bench.<name>")` around
each call it makes into the program); the device intervals are the
profiler's kernel, memcpy and memset records.
"""

from __future__ import annotations

import numpy as np
import torch

#: rays of each K1 launch walked on the host for its yardstick
K1_SAMPLE = 256


def _device_events(prof):
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        rec = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != DeviceType.CUDA:
            host.append(rec)
        elif not e.name.startswith("bench."):  # the spans' own marks on the device's timeline
            dev.append(rec)
    return dev, host


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gap_owners(gaps, host):
    """For each idle gap, the innermost host record that holds its middle
    (the benchmark's own spans left out); "python between ops" where none
    does."""
    mids = np.array([(s + e) / 2 for s, e in gaps])
    owner = np.full(len(gaps), "python between ops", dtype=object)
    if not len(mids):
        return owner
    order = np.argsort(mids)
    sm = mids[order]
    for s, e, name in sorted(host, key=lambda r: r[0] - r[1]):  # longest first
        if name.startswith("bench."):
            continue
        lo, hi = np.searchsorted(sm, s), np.searchsorted(sm, e, side="right")
        if hi > lo:
            owner[order[lo:hi]] = name
    return owner


def summarize(prof, span: str) -> dict:
    """Device work inside the host span `span`: busy seconds (union of
    device records), the span's seconds, kernel launches, seconds per
    kernel name and idle seconds by what the host was doing."""
    dev, host = _device_events(prof)
    win = [(s, e) for s, e, n in host if n == span]
    if not win:
        return None
    w0, w1 = win[0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    merged = _union([(s, e) for s, e, _ in inside])
    busy = sum(e - s for s, e in merged)
    by_name, count_by_name = {}, {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        count_by_name[n] = count_by_name.get(n, 0) + 1
    kernels = [r for r in inside if not r[2].startswith(("Memcpy", "Memset"))]
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = {}
    for (s, e), n in zip(gaps, _gap_owners(gaps, [r for r in host if r[1] > w0 and r[0] < w1])):
        idle[n] = idle.get(n, 0.0) + (e - s) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6, "launches": len(kernels),
            "by_name": by_name, "count_by_name": count_by_name, "device_ops": top(by_name),
            "idle_gaps": top(idle)}


def profile_group(run) -> dict:
    """Profile the entry's centre group (`entry.group`) and its extra
    spans (`entry.extra_spans`: (name, fn) pairs, such as the denoiser),
    each inside a span of its own and ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prep = run.entry.prepare_group(run)
    extra = run.entry.extra_spans(run)
    with profile(activities=acts) as prof:
        with record_function("bench.group"):
            run.entry.group(run, prep)
            run.sync()
        for name, fn in extra:
            with record_function(f"bench.{name}"):
                fn()
                run.sync()
    out = {"group": summarize(prof, "bench.group"),
           **{name: summarize(prof, f"bench.{name}") for name, _ in extra}}
    g = out["group"]
    if g is None:
        return None
    out.update(batches=prep["k"], busy_s=g["busy_s"], window_s=g["window_s"],
               breakdown={"device_ops": g["device_ops"], "idle_gaps": g["idle_gaps"]})
    return out


def record_k1(run) -> list:
    """The centre group again, unprofiled, with the program's K1 entry
    (`ops/traverse_cuda.py:bvh_traverse`) wrapped: per launch its live ray
    count, whether it is a shadow launch (no active mask: only whether
    something is hit counts) or carries the fused epilogue, and a seeded
    sample of its live rays. Returns one dict per launch, in order."""
    from raytracing_c_tpu_torch.ops import traverse_cuda

    original = traverse_cuda.bvh_traverse
    launches = []

    def wrapped(origin, direction, triangles, bvh, active=None, t_max=None,
                fuse_attr=False):
        live = (torch.arange(origin.shape[0], device=origin.x.device) if active is None
                else torch.nonzero(active).squeeze(1))
        n = int(live.numel())
        rnd = np.random.default_rng([run.seed, len(launches)])
        pick = np.sort(rnd.choice(n, min(K1_SAMPLE, n), replace=False)) if n else []
        idx = live[torch.as_tensor(pick, dtype=torch.int64, device=live.device)]
        o = torch.stack([origin.x[idx], origin.y[idx], origin.z[idx]], 1).cpu().numpy()
        d = torch.stack([direction.x[idx], direction.y[idx], direction.z[idx]], 1)
        launches.append({"rays": n, "shadow": active is None, "epilogue": bool(fuse_attr),
                         "o": o, "d": d.cpu().numpy()})
        return original(origin, direction, triangles, bvh, active, t_max, fuse_attr)

    # the wrapped function counts its launches on the module's name
    wrapped.launches = original.launches
    wrapped.wide_launches = original.wide_launches
    prep = run.entry.prepare_group(run)
    traverse_cuda.bvh_traverse = wrapped
    try:
        run.entry.group(run, prep)
        run.sync()
    finally:
        traverse_cuda.bvh_traverse = original
        original.launches = wrapped.launches
        original.wide_launches = wrapped.wide_launches
    return launches
