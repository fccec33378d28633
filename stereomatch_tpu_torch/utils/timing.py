"""Per-stage wall-clock timing + run statistics (port of
`stereomatch_tpu/utils/timing.py`).

Replaces the reference's timer family (startTimer/getTimer
src/Stereo3DMST.cpp:15-26, StartTimer/GetTimer + cudaEvent timers
src/PatchMatchStereoGPU.cu:9479-9535) and its mean/stddev helper
`timingStat` (.cu:9493-9517). Device work is made observable by
synchronizing the CUDA devices a stage's result lives on, and
`torch.profiler` can wrap any stage for traces.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

__all__ = ["StageTimer", "timing_stat", "profile_trace"]


@contextmanager
def profile_trace(log_dir: str):
    """Wrap a region in a torch.profiler trace (CPU events, and the card's
    where CUDA is present) and write it into `log_dir` as a Chrome trace
    (view in chrome://tracing or Perfetto). Usage:
    `with profile_trace("/tmp/trace"): run_pipeline()`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def timing_stat(samples) -> tuple[float, float]:
    """(mean, stddev) over timing samples in ms (ref: timingStat,
    src/PatchMatchStereoGPU.cu:9493-9517)."""
    n = len(samples)
    if n == 0:
        return 0.0, 0.0
    mean = sum(samples) / n
    var = sum((s - mean) ** 2 for s in samples) / n
    return mean, var**0.5


def _synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of `result` (a tensor,
    or a tuple, list or dict of them, nested)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(result)
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class StageTimer:
    """Accumulates per-stage wall times; waits for the card where a
    stage's result lives on it, so the numbers mean what the reference's
    per-stage prints meant."""

    verbose: bool = False
    stages: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            _synchronize(result)
        dt = (time.perf_counter() - t0) * 1e3
        self.stages.setdefault(name, []).append(dt)
        if self.verbose:
            print(f"{name}: {dt:.1f} ms")

    def time(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(out)
        dt = (time.perf_counter() - t0) * 1e3
        self.stages.setdefault(name, []).append(dt)
        if self.verbose:
            print(f"{name}: {dt:.1f} ms")
        return out

    def report(self) -> str:
        lines = []
        for name, samples in self.stages.items():
            mean, std = timing_stat(samples)
            lines.append(f"{name}: {mean:.1f} ± {std:.1f} ms (n={len(samples)})")
        return "\n".join(lines)
