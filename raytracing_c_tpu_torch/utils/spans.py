"""Spans: named intervals at the boundaries of the program's layers, off by
default.

    from raytracing_c_tpu_torch.utils import spans
    spans.enable()              # or enable(device=True): CUDA events too
    try:
        img, stats = render(scene, 1920, 1080)
        records = spans.collect()
    finally:
        spans.disable()

The program opens `with spans.span("shade"):` around each layer (PERF.md
lists the names); a layer that learns a counter inside the span adds it
with `spans.note(...)`, and a coarse stage whose wall the program also
reports (a table's build seconds) is `spans.timed(name)`, one clock for
both. A span records its name, its host start and end
(`time.perf_counter_ns`), its parent's id, the ids of its frame and batch
(a `render` span opens a frame and a `batch` span a batch; every span
inside them takes their ids) and its attributes, the counters of that
boundary (given at the call or noted inside; PERF.md says which reader
reads each). A counter that lives on the device is `spans.tally(...)`ed
into the open `render` span: summed there without a sync and read once,
when that span closes, into its attributes. Records stay in memory until
`collect()`; `shade_summary` reads the `shade` spans' counters.

Off, `span` returns one shared no-op context after one check of a module
flag: no record_function, no allocation in this module, no sync.

On, under a recording `torch.profiler`, each span also opens a
`record_function` range of the same name, so the program's layers sit on
the profiler's timeline beside the kernels. With `enable(device=True)` on
CUDA, each span also records a pair of timing events on the current
stream, taken from a pool; `collect()` synchronizes once and puts them on
the host's `perf_counter` clock through one anchor event, as `dev_start`
and `dev_end`, with no profiler running.

The state is the process's own, as the profiler's is: a span call sits
deep inside library functions, and threading a recorder through each of
them would change every signature on the render path. One thread records.
"""

from __future__ import annotations

import time

import torch

#: the span names that open a new frame id and a new batch id
FRAME = "render"
BATCH = "batch"

_on = False
_device = None  # the CUDA device whose current stream takes the events, or None
_records: list[dict] = []
_open: list[dict] = []
_pool: list = []  # free timing events
_used: list = []  # events handed out since the last collect()
_ids = {FRAME: 0, BATCH: 0}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _event():
    ev = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    _used.append(ev)
    return ev


class _Span:
    __slots__ = ("name", "attrs", "rec", "rf", "ev")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.rf = self.ev = None

    def __enter__(self):
        parent = _open[-1] if _open else None
        frame, batch = (parent["frame"], parent["batch"]) if parent else (None, None)
        if self.name == FRAME:
            frame = _ids[FRAME] = _ids[FRAME] + 1
        elif self.name == BATCH:
            batch = _ids[BATCH] = _ids[BATCH] + 1
        rec = self.rec = {"name": self.name, "id": len(_records),
                          "parent": None if parent is None else parent["id"],
                          "frame": frame, "batch": batch, "start": None, "end": None,
                          "attrs": self.attrs}
        _records.append(rec)
        _open.append(rec)
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        rec["start"] = time.perf_counter_ns()
        if _device is not None:
            self.ev = (_event(), _event())
            self.ev[0].record(torch.cuda.current_stream(_device))
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.ev is not None:
            self.ev[1].record(torch.cuda.current_stream(_device))
            rec["_ev"] = self.ev
        rec["end"] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _open.pop()
        if "_tally" in rec:
            _read_tally(rec)
        return False


def _read_tally(rec) -> None:
    """A closed span's tallies into its attributes: the device's counters
    read together, with one sync."""
    tally = rec.pop("_tally")
    dev = {k: v for k, v in tally.items() if isinstance(v, torch.Tensor)}
    if dev:
        vals = torch.stack([v.to(torch.int64).reshape(()) for v in dev.values()]).tolist()
        tally.update(zip(dev, vals))
    rec["attrs"].update(tally)


def span(name: str, **attrs):
    """A context manager over one layer's interval, recorded while spans are
    on; attrs are its counters (python numbers or strings, read with no
    sync)."""
    if not _on:
        return _NOOP
    return _Span(name, attrs)


def note(**attrs) -> None:
    """Add counters to the innermost open span, from inside the layer that
    knows them (K1's wrapper notes the kernel it launched); nothing while
    off or outside every span."""
    if _on and _open:
        _open[-1]["attrs"].update(attrs)


def tally(**counts) -> None:
    """Add counters (python ints or 0-d integer tensors, on any device) to
    those of the innermost open `render` span, which reads them when it
    closes (`_read_tally`); nothing while off or outside a render span.
    The sums stay on their device until then."""
    if not _on:
        return
    for rec in reversed(_open):
        if rec["name"] == FRAME:
            t = rec.setdefault("_tally", {})
            for k, v in counts.items():
                t[k] = t[k] + v if k in t else v
            return


class timed:
    """A coarse stage's wall (a table build), measured on every call as
    `.seconds` and recorded, while spans are on, as the span `name` of the
    same two clock readings:

        with spans.timed("env_table") as t:
            ...
        seconds = t.seconds
    """

    __slots__ = ("name", "span", "start", "seconds")

    def __init__(self, name: str):
        self.name, self.span, self.seconds = name, None, 0.0

    def __enter__(self):
        if _on:
            self.span = _Span(self.name, {})
            self.start = self.span.__enter__()["start"]
        else:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.span is None:
            end = time.perf_counter_ns()
        else:
            self.span.__exit__(*exc)
            end = self.span.rec["end"]
        self.seconds = (end - self.start) / 1e9
        return False


def shade_summary(records) -> dict:
    """What the `shade` spans of `records` say of K4, from the kernel
    (`k4` or `plain`) and lanes each carries: K4's launches a batch (over
    the records' `batch` spans; None without one) and the lanes shaded
    through K4 and through the plain tail."""
    lanes = {"k4": 0, "plain": 0}
    launches = 0
    for r in records:
        if r["name"] == "shade":
            kernel = r["attrs"].get("kernel", "plain")
            lanes[kernel] += r["attrs"].get("lanes", 0)
            launches += kernel == "k4"
    batches = sum(r["name"] == BATCH for r in records)
    return {"k4_launches_per_batch": launches / batches if batches else None,
            "k4_lanes": lanes["k4"], "plain_lanes": lanes["plain"]}


def enabled() -> bool:
    return _on


def enable(device: bool = False) -> None:
    """Turn spans on, from no records. device=True also times each span on
    the current CUDA device's current stream (raises without CUDA)."""
    global _on, _device
    if device and not torch.cuda.is_available():
        raise RuntimeError("spans.enable(device=True) needs CUDA: "
                           "torch.cuda.is_available() is false")
    _drop()
    _device = torch.device("cuda", torch.cuda.current_device()) if device else None
    _on = True


def disable() -> None:
    """Turn spans off and drop what collect() has not taken."""
    global _on, _device
    _on = False
    _device = None
    _drop()


def _drop() -> None:
    _records.clear()
    _open.clear()
    _pool.extend(_used)
    _used.clear()


def collect() -> list[dict]:
    """The spans recorded since enable() or the last collect(), in the
    order they opened, each a dict: name, id, parent (id or None), frame,
    batch (ids or None), start, end (host ns), attrs; with device events
    also dev_start, dev_end (host ns, on the perf_counter clock) and
    dev_err_ns, the width of the anchor's host reading. Call it outside
    every span."""
    if _open:
        raise RuntimeError(f"spans.collect() inside the open span {_open[-1]['name']!r}")
    out = list(_records)
    timed = [r for r in out if "_ev" in r]
    if timed:
        torch.cuda.synchronize(_device)
        anchor = _event()
        t0 = time.perf_counter_ns()
        anchor.record(torch.cuda.current_stream(_device))
        t1 = time.perf_counter_ns()
        anchor.synchronize()
        for r in timed:
            ev0, ev1 = r.pop("_ev")
            r["dev_start"] = t1 - round(ev0.elapsed_time(anchor) * 1e6)
            r["dev_end"] = t1 - round(ev1.elapsed_time(anchor) * 1e6)
            r["dev_err_ns"] = t1 - t0
    _records.clear()
    _pool.extend(_used)
    _used.clear()
    return out
