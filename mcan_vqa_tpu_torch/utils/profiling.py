"""Profiling hooks: a ``torch.profiler`` trace and step timing
(mcan_vqa_tpu/utils/profiling.py).

The reference has no profiling beyond wall-clock per epoch (reference:
core/exec.py:153, 210-211).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, CPU activity and (with a
    CUDA device) the card's, exported as a Chrome trace
    ``trace_<pid>_<time>.json`` into ``profile_dir``, also when the block
    raises; nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            profile_dir,
            f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))


class StepTimer:
    """EMA of step wall time; call .tick() once per step."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else \
                self.alpha * dt + (1 - self.alpha) * self.ema
        self._last = now
        return self.ema
