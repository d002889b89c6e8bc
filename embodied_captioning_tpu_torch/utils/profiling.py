"""Named wall-clock ranges, a profiler trace and a fenced timer.

`RangeTimer` times nested named ranges as a context manager and keeps
each range's durations; `PROFILER` is the process-wide instance the
trainers time their rollout, policy-input and update phases with. A range
reads the host clock only: on the card it measures what the host waited
for, so a caller that wants device time synchronises inside the range.
`trace` records a block with `torch.profiler` into a Chrome trace file;
`device_timer` times calls between two synchronisations of the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` (the host's operators, and
    the card's kernels where there is a card) and write it under `logdir`
    as a Chrome trace (`trace_<pid>_<ns>.json`, viewable in Perfetto or
    chrome://tracing), also if the block raises. Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _input_device(args, kwargs) -> Optional[torch.device]:
    """The device of the first tensor among the arguments (lists, tuples
    and dicts searched), or None where there is none."""
    todo: List[Any] = list(args) + list(kwargs.values())
    while todo:
        x = todo.pop(0)
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return None


def device_timer(fn: Callable, *args, iters: int = 1, **kwargs):
    """(result, seconds per call) of `fn(*args, **kwargs)`: one warm call,
    then `iters` calls between two synchronisations of the card. The card
    is the one the first tensor argument lies on; with no tensor argument,
    the current card. Only CPU inputs are timed without a card, on the
    host clock: a missing card raises, as `torch.cuda.synchronize` does."""
    dev = _input_device(args, kwargs)
    on_card = dev is None or dev.type == "cuda"

    def fence():
        if on_card:
            torch.cuda.synchronize(dev)

    out = fn(*args, **kwargs)
    fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    fence()
    return out, (time.perf_counter() - t0) / max(iters, 1)
