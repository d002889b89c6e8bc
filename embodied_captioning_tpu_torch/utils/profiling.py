"""Named wall-clock ranges.

`RangeTimer` times nested named ranges as a context manager and keeps
each range's durations; `PROFILER` is the process-wide instance the
trainers time their rollout, policy-input and update phases with. A range
reads the host clock only: on the card it measures what the host waited
for, so a caller that wants device time synchronises inside the range.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class RangeTimer:
    """Seconds of each call of each named range, in `stats`."""

    def __init__(self) -> None:
        self.stats: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def range(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats[name].append(time.perf_counter() - t0)

    def reset(self) -> None:
        self.stats.clear()


PROFILER = RangeTimer()  # process-wide default
