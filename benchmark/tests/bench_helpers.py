"""Shared set-up of the benchmark's tests: the benchmark's folders on the
path, and each cell at a size a CPU test can hold."""

from __future__ import annotations

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import runner  # noqa: E402

CELLS = ("helmet_1080p.render_dense", "helmet_cli_1024.nee_denoise")
#: every cell's scene and frame cut to a CPU test's size
SMALL = {
    "render": {"width": 32, "height": 32, "spp": 2, "max_bounces": 3},
    "cli_defaults": {"width": 32, "height": 32, "spp": 2, "max_bounces": 3},
    "scene": {"sphere_quads": 10, "texture": 32, "env_width": 64, "env_height": 32},
}
SMALL_ARGV = ["-W", "32", "-H", "32", "-S", "2", "-B", "3"]


def small_run(cell: str, seed: int, trace: bool = False, **traffic) -> runner.Run:
    """A run of `cell` on the CPU at SMALL's sizes (the CLI's argv given
    SMALL's -W -H -S -B), its traffic changed by `traffic`."""
    probe = runner.Run(cell, seed, 0.0, trace, "cpu", time.perf_counter())
    t = dict(probe.traffic, **traffic)
    if "argv" in t:
        t["argv"] = SMALL_ARGV + list(t["argv"])
    return runner.Run(cell, seed, 0.0, trace, "cpu", time.perf_counter(),
                      overrides=dict(SMALL, traffic=t))
