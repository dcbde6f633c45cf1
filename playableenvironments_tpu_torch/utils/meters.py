"""Running-average and timing meters.

Port of playableenvironments_tpu/utils/meters.py: `AverageMeter` (keyed
running means, popped once a logging interval) and `TimeMeter` (named
wall-clock sections). `profiler_trace` is a torch.profiler context that
writes a chrome trace of the region; it synchronizes the card before the
trace stops, so the region's device work is in it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class AverageMeter:
    """Keyed running means, poppable per logging interval."""

    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def add(self, values: Dict[str, float]):
        for key, value in values.items():
            self._sums[key] += float(value)
            self._counts[key] += 1

    def mean(self, key: str) -> float:
        return self._sums[key] / max(self._counts[key], 1)

    def pop_all(self) -> Dict[str, float]:
        out = {k: self.mean(k) for k in self._sums}
        self._sums.clear()
        self._counts.clear()
        return out


class TimeMeter:
    """Named wall-clock section timing with mean/sum summaries."""

    def __init__(self, mode: str = "mean", enabled: bool = True):
        self.mode = mode
        self.enabled = enabled
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._starts: Dict[str, float] = {}

    def start(self, name: str):
        if self.enabled:
            self._starts[name] = time.perf_counter()

    def end(self, name: str):
        if self.enabled and name in self._starts:
            self.add(name, time.perf_counter() - self._starts.pop(name))

    def add(self, name: str, seconds: float):
        """Count one section of `name` that took `seconds`, measured by the
        caller."""
        if self.enabled:
            self._totals[name] += seconds
            self._counts[name] += 1

    @contextlib.contextmanager
    def section(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.end(name)

    def summary(self) -> Dict[str, float]:
        if self.mode == "sum":
            return dict(self._totals)
        return {k: v / max(self._counts[k], 1) for k, v in self._totals.items()}

    def print_summary(self):
        for name, value in sorted(self.summary().items()):
            print(f"[time] {name}: {value * 1000:.1f} ms")


def start_profiler():
    """A started torch.profiler.profile of the CPU and, where there is one,
    the card; `stop_profiler` ends it and writes its trace."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler, log_dir: str) -> str:
    """Synchronize the card, stop `profiler` and write its chrome trace into
    `log_dir`. :return: the trace's path."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    profiler.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1000)}.json")
    profiler.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A torch.profiler trace around a region, written under `log_dir`
    (nothing without one)."""
    if not log_dir:
        yield
        return
    profiler = start_profiler()
    try:
        yield
    finally:
        stop_profiler(profiler, log_dir)
