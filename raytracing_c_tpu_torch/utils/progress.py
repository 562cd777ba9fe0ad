"""Progress reporting (reference: 20-char bar at 500ms cadence,
driver.c:809-819). Counterpart of `raytracing_c_tpu/utils/progress.py`."""

from __future__ import annotations

import sys
import time

BAR = "=" * 20


class ProgressBar:
    def __init__(self, interval_s: float = 0.5, stream=None):
        self.interval_s = interval_s
        self.stream = stream if stream is not None else sys.stdout
        self._last = 0.0

    def __call__(self, done: int, total: int) -> None:
        now = time.monotonic()
        if now - self._last < self.interval_s and done < total:
            return
        self._last = now
        p = min(done / max(total, 1), 1.0)
        fill = BAR[: int(p * len(BAR))]
        self.stream.write(f"\r[{fill:<20}] {int(p * 100)}%")
        self.stream.flush()

    def finish(self) -> None:
        self.stream.write(f"\r[{BAR}] 100%\n")
        self.stream.flush()
