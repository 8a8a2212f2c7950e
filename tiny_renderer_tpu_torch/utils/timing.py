"""Timing and observability (``tiny_renderer_tpu.utils.timing``).

The reference's only instrumentation is an FPS counter printed once per
second (src/app.rs:230-242); FpsCounter reproduces it.  StageTimer adds
named wall-time stages that wait for the device, and `profile_trace`
wraps torch.profiler for a Chrome trace of host and device activity.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class FpsCounter:
    """Prints `FPS --- N` once per second, like src/app.rs:230-242."""

    def __init__(self, enabled: bool = True, out=print):
        self.enabled = enabled
        self._out = out
        self._begin = time.monotonic()
        self._frames = 0

    def tick(self):
        if not self.enabled:
            return
        self._frames += 1
        now = time.monotonic()
        if now - self._begin > 1.0:
            self._out(f"FPS --- {self._frames}")
            self._begin = now
            self._frames = 0


class StageTimer:
    """Accumulates named stage wall times.  `sync`: a tensor whose CUDA
    device is synchronized before the stage's clock stops (nothing extra on
    the CPU, where torch ops finish before they return)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name}: {1e3 * total / n:.3f} ms/iter over {n} iters")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Optional torch.profiler trace around a block (--profile): CPU
    activity, and CUDA activity when a GPU is present, exported as a Chrome
    trace to <log_dir>/trace.json."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
