"""One run of one cell: set-up, the measured window of whole frames, the
traced group, the output check, and the result line.

The window renders whole frames back to back through the cell's entry
(`entries/<entry>.py`); frame i takes the seed `frame_seed(seed, i)`. The
frame running when the window's seconds run out is finished and counted,
so no frame is cut. With trace on, one group of the entry's batches at the
frame's centre rows is profiled after the window (a profiled process stays
slower, so nothing end to end is read after it), then run again unprofiled
to record K1's launches for its yardstick. Last the program's state is
freed and a seeded sample of the window's batches is rendered again by the
plain reference (`reference/`) and compared.
"""

from __future__ import annotations

import gc
import hashlib
import io
import json
import random
import sys
import time

import torch

from harness import check, spec, trace


def frame_seed(seed: int, i: int) -> int:
    """The render seed of frame i of a run with `seed`, in [0, 2**32)."""
    h = hashlib.blake2b(f"{seed}:{i}".encode(), digest_size=4).digest()
    return int.from_bytes(h, "little")


class Run:
    """What one run knows; the entry module and the metric readers read
    and fill it."""

    def __init__(self, cell: str, seed: int, seconds: float, trace_on: bool, device: str,
                 t_start: float, bench: dict | None = None, overrides: dict | None = None):
        self.spec = spec.resolve(cell, bench)
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace_on = trace_on
        self.device = torch.device(device)
        self.t_start = t_start
        self.config = json.loads(json.dumps(self.spec["config"]))
        overrides = dict(overrides or {})
        self.traffic = overrides.pop("traffic", self.spec["traffic"])
        for k, v in overrides.items():
            if isinstance(v, dict):
                self.config.setdefault(k, {}).update(v)
            else:
                self.config[k] = v
        self.frames: list[dict] = []
        self.setup_s = self.window_s = None
        self.window_peak_bytes = None
        self.profile = None
        self.k1_launches = None
        self.state = None
        self.entry = spec.entry(self.config["entry"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(run: Run, hooks: dict | None = None) -> dict:
    """Drive one run; returns the result line's object. hooks (tests only):
    {"after_setup": fn(run)} to break the timed path underneath."""
    try:
        return _run_cell(run, hooks)
    finally:
        if run.state is not None:
            run.entry.cleanup(run)


def _run_cell(run: Run, hooks: dict | None) -> dict:
    entry = run.entry
    entry.setup(run)
    if hooks and "after_setup" in hooks:
        hooks["after_setup"](run)
    run.sync()
    setup_peak = None
    if run.device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    i, t = 0, t0
    while True:
        rec = entry.frame(run, frame_seed(run.seed, i))
        run.sync()
        rec["frame_s"], t = time.perf_counter() - t, time.perf_counter()
        run.frames.append(rec)
        i += 1
        if t - t0 >= run.seconds:
            break
    run.window_s = t - t0
    print(f"window {run.window_s:.3f} s, frames (s): "
          + " ".join(f"{f['frame_s']:.3f}" for f in run.frames), file=sys.stderr)
    if run.device.type == "cuda":
        run.window_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    memory_peak = None if setup_peak is None else max(setup_peak, run.window_peak_bytes)

    if run.trace_on:
        run.profile = trace.profile_group(run)
        run.k1_launches = trace.record_k1(run)

    metrics = {}
    wanted = run.spec["per_layer"] if run.trace_on else run.spec["end_to_end"]
    for m in wanted:
        value = spec.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    entry.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check_outputs(run)
    limits = run.spec["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(numbers[k] <= limits[k] for k in limits)

    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": len(run.frames),
           "failed": 0 if correct else 1, "metrics": metrics, "device": device}
    if run.trace_on and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = run.profile["breakdown"]
    out["checks"] = checks
    return out


def sample(run: Run):
    """The frame and batches the check compares, drawn from the seed: one
    batch among those whose rows hold the model (the middle half of the
    frame's batches) and one among all."""
    rnd = random.Random(f"check:{run.seed}")
    i = rnd.randrange(len(run.frames))
    nb = run.entry.n_batches(run)
    lo, hi = nb // 4, max(nb // 4 + 1, (3 * nb) // 4)
    first = rnd.randrange(lo, hi)
    rest = [b for b in range(nb) if b != first]
    picks = [first] + rnd.sample(rest, min(run.config["check_batches"] - 1, len(rest)))
    return i, sorted(picks)


def check_outputs(run: Run, in_place: torch.dtype | None = None) -> dict:
    """Render the sampled batches by the reference and compare them with
    the program's output. in_place puts the reference computed in that
    float type in the program's place: bfloat16 is the control, float64 a
    sound variant that rounds otherwise."""
    i, batches = sample(run)
    rec = run.frames[i]
    ref = run.entry.reference_pixels(run, rec, batches, torch.float32)
    got = (run.entry.reference_pixels(run, rec, batches, in_place)["rgb"] if in_place
           else run.entry.program_pixels(run, rec, ref))
    return check.compare(got, ref["rgb"])


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))


def capture_stdout(fn, *args, **kw):
    """fn's result and what it printed to stdout and stderr."""
    buf = io.StringIO()
    old_out, old_err = sys.stdout, sys.stderr
    sys.stdout = sys.stderr = buf
    try:
        return fn(*args, **kw), buf.getvalue()
    finally:
        sys.stdout, sys.stderr = old_out, old_err
