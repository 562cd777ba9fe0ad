"""Readers of the program's own spans (`raytracing_c_tpu_torch/utils/
spans.py`), shared by the metric files of this folder.

The traced pass runs once per `--trace 1` run, at the first metric that
asks for it (after the profiled group and K1's record), and is kept on the
run. It renders one more whole frame through the cell's entry
(`entry.frame`, the path the window times: in the CLI cell the load, the
env table, the render, the denoiser and the write), twice with the same
seed:

1. with spans on, host clock only: every metric but device_lag_ms reads
   these spans, the layers in ms a batch over the frame's `batch` spans,
   and in the CLI cell decode_s and bvh_s from the frame's load;
2. with spans and CUDA events on (CUDA only): device_lag_ms alone reads
   these, since recording the events adds host time inside each span.

Spans are off in the end, whatever happens. The two frames' walls, the
layers' ms a batch, what the leaf spans cover of the batch spans' wall,
the `sync` and `intersect` spans split by their counters, the lanes that
enter each bounce and the load go to stderr (PERF.md section 5 quotes
them). Where the program has no spans module (a checkout from before it
had one) the pass is None and so is every metric.
"""

from __future__ import annotations

import statistics
import sys
import time
from collections import defaultdict

from harness import runner

#: the layer leaves of a batch: every span inside `batch` that has no
#: child of its own (PERF.md section 3)
LEAVES = ("rng", "raygen", "intersect", "attrs", "shade", "background", "advance", "compact",
          "sync", "encode")
#: the load spans read into decode_s.cli and bvh_s.cli
LOAD = ("parse", "decode", "bvh", "upload", "k1_tables", "env_table")


def traced(run):
    """The traced pass of this run, {"host": spans, "device": spans or
    None, "walls": {"host": s, "device": s}}, or None without the
    program's spans module."""
    if not hasattr(run, "span_pass"):
        run.span_pass = _traced_pass(run)
    return run.span_pass


def _traced_pass(run):
    try:
        from raytracing_c_tpu_torch.utils import spans
    except ImportError:
        return None
    seed = runner.frame_seed(run.seed, len(run.frames))
    out = {"host": None, "device": None, "walls": {}}
    passes = ("host", "device") if run.device.type == "cuda" else ("host",)
    try:
        for name in passes:
            spans.enable(device=name == "device")
            t = time.perf_counter()
            run.entry.frame(run, seed)
            run.sync()
            out["walls"][name] = time.perf_counter() - t
            out[name] = spans.collect()
            spans.disable()
    finally:
        spans.disable()
    _report(out)
    return out


def _report(p) -> None:
    h = p["host"]
    say = lambda text: print("spans: " + text, file=sys.stderr)  # noqa: E731
    say("frame wall (s): " + ", ".join(f"{k} {v:.4f}" for k, v in p["walls"].items()))
    layers = {n: per_batch_ms(h, (n,)) for n in LEAVES}
    say("ms a batch: " + ", ".join(f"{n} {v:.3f}" for n, v in layers.items() if v is not None)
        + f"; batch {per_batch_ms(h, ('batch',))}; leaves cover {leaf_cover(h)}; "
        f"device lag {device_lag_ms(p['device'] or [])} ms")
    say("sync ms a batch by what: " + ", ".join(
        f"{k} {v:.3f}" for k, v in by_attr_ms(h, "sync", "what").items()))
    kernels = rays_by_kernel(h)
    say("intersect by kind: " + "; ".join(
        f"{k} {v:.3f} ms, " + ", ".join(f"{kern} {r:.0f} rays" for kern, r in
                                        kernels.get(k, {}).items())
        for k, v in by_attr_ms(h, "intersect", "kind").items()) + " (a batch)")
    say("lanes entering each bounce (mean): " + ", ".join(
        f"{i}: {v:.0f}" for i, v in lanes_by_bounce(h).items()))
    load = {n: span_s(h, (n,)) for n in ("load",) + LOAD}
    if load["load"] is not None:
        say("load (s): " + ", ".join(f"{n} {v:.4f}" for n, v in load.items() if v is not None))


def _ns(r) -> int:
    return r["end"] - r["start"]


def _batches(recs) -> int:
    return sum(r["name"] == "batch" for r in recs)


def span_s(recs, names) -> float | None:
    """Seconds in the spans named `names`, summed; None if there is none."""
    got = [_ns(r) for r in recs if r["name"] in names]
    return sum(got) / 1e9 if got else None


def per_batch_ms(recs, names) -> float | None:
    """ms a batch in the spans named `names`: summed over the frame and
    divided by its `batch` spans; None without a batch."""
    k = _batches(recs)
    if not k:
        return None
    return sum(_ns(r) for r in recs if r["name"] in names) / 1e6 / k


def by_attr_ms(recs, name, key) -> dict:
    """ms a batch in the spans named `name`, split by their counter `key`
    ("-" where a span has none)."""
    k = _batches(recs)
    out = defaultdict(float)
    for r in recs:
        if r["name"] == name:
            out[str(r["attrs"].get(key, "-"))] += _ns(r) / 1e6 / max(k, 1)
    return dict(out)


def rays_by_kernel(recs) -> dict:
    """{kind: {kernel: rays a batch}} over the `intersect` spans, from the
    kernel and rays that K1's wrapper notes ("-" where no launch ran)."""
    k = max(_batches(recs), 1)
    out = defaultdict(lambda: defaultdict(float))
    for r in recs:
        if r["name"] == "intersect":
            a = r["attrs"]
            out[a.get("kind", "-")][a.get("kernel", "-")] += a.get("rays", 0) / k
    return {kind: dict(v) for kind, v in out.items()}


def lanes_by_bounce(recs) -> dict:
    """{bounce index: the mean lanes that enter it} over the `bounce`
    spans."""
    got = defaultdict(list)
    for r in recs:
        if r["name"] == "bounce":
            got[r["attrs"]["index"]].append(r["attrs"]["lanes"])
    return {i: statistics.fmean(v) for i, v in sorted(got.items())}


def leaf_cover(recs) -> float | None:
    """The share of the `batch` spans' wall that their leaf spans cover."""
    batch = sum(_ns(r) for r in recs if r["name"] == "batch")
    if not batch:
        return None
    return sum(_ns(r) for r in recs if r["name"] in LEAVES and r["batch"] is not None) / batch


def device_lag_ms(recs) -> float | None:
    """The median, over the leaf spans inside a batch, of how far the
    device's start of the span trails the host's (dev_start - start), in
    ms: near 0 the device waits for the host; milliseconds, the host runs
    ahead."""
    lags = [r["dev_start"] - r["start"] for r in recs
            if r["name"] in LEAVES and r["batch"] is not None and "dev_start" in r]
    return statistics.median(lags) / 1e6 if lags else None


def frame_ms(run, names):
    """ms a batch in `names` over the host pass's frame, or None."""
    p = traced(run)
    return None if p is None else per_batch_ms(p["host"], names)


def load_s(run, names):
    """Seconds in `names` over the host pass's frame, or None."""
    p = traced(run)
    return None if p is None else span_s(p["host"], names)


def lag_ms(run):
    p = traced(run)
    return None if p is None or p["device"] is None else device_lag_ms(p["device"])
