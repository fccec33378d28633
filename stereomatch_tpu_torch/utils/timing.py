"""Per-stage wall-clock timing + run statistics (port of
`stereomatch_tpu/utils/timing.py`).

Replaces the reference's timer family (startTimer/getTimer
src/Stereo3DMST.cpp:15-26, StartTimer/GetTimer + cudaEvent timers
src/PatchMatchStereoGPU.cu:9479-9535) and its mean/stddev helper
`timingStat` (.cu:9493-9517). Device work is made observable by
synchronizing the CUDA devices a stage's result lives on, and
`torch.profiler` can wrap any stage for traces.

`span(name)` marks a layer of the program in such a trace: a profiler
CPU event on the clock of the trace's device events, so that each launch,
host sync and idle gap of the device can be put down to the innermost
span around it. Span names are `sm.<layer>[.<part>]`, from `SPANS` (or
`sm.app.<stage>` from `StageTimer`), and carry no ids, so they aggregate;
a frame's spans are those inside its `sm.server.submit` and
`sm.server.collect`. With no profiler running a span is one shared no-op.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch

__all__ = ["SPANS", "StageTimer", "span", "timing_stat", "profile_trace"]

# every span the program opens, with the layer it marks (the second
# component of the name); StageTimer adds sm.app.<stage>
SPANS = frozenset({
    "sm.server.submit",  # a served frame's submit_pair: key, upload, enqueue
    "sm.server.collect",  # a served frame's outputs to the host, LR stat, failure replay
    "sm.server.scene_cut",  # the video server's keyframe replay of a scene cut
    "sm.server.temporal",  # a video temporal frame's enqueue, inside sm.server.submit
    "sm.volume",  # a served frame's cost volumes
    "sm.volume.guided",  # the guided filter of both views' volumes (builtin_cost_volumes)
    "sm.sgbm",  # the SGBM seed of a 3DMST frame; the whole of sgbm_pipeline
    "sm.sgbm.gray",  # sgbm_pipeline: one view to gray on the host, then uploaded
    "sm.sgbm.speckle",  # sgbm_pipeline: the speckle filter
    "sm.sgbm.to_host",  # sgbm_pipeline: the map to the host
    "sm.sgbm.band_up",  # banded SGBM: one band's cost and upward K1c launch
    "sm.sgbm.band",  # banded SGBM: one band's cost, K1c launch and selection
    "sm.forest",  # one view's prefilter, edge weights, device forest, capacity check
    "sm.forest.round",  # one round of a forest loop that ends in a host check
    "sm.refine",  # one view's refine on a built forest
    "sm.refine.iter",  # one iteration of mst_pms_optimize
    "sm.rng",  # one threefry draw: PRNGKey, split, fold_in, uniform
})

_NO_SPAN = nullcontext()


def span(name: str):
    """A context manager that marks `name` (one of `SPANS`) in a running
    `torch.profiler` trace, or the shared no-op when none runs. The span
    is a function-scope record (`RecordFunctionFast`), not a user
    annotation, so the card's trace gets no device event for it."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


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
        """Time the block, inside the span `sm.app.<name>`."""
        t0 = time.perf_counter()
        with span("sm.app." + name):
            yield
            if result is not None:
                _synchronize(result)
        dt = (time.perf_counter() - t0) * 1e3
        self.stages.setdefault(name, []).append(dt)
        if self.verbose:
            print(f"{name}: {dt:.1f} ms")

    def time(self, name: str, fn, *args, **kwargs):
        with self.stage(name):
            out = fn(*args, **kwargs)
            _synchronize(out)
        return out

    def report(self) -> str:
        lines = []
        for name, samples in self.stages.items():
            mean, std = timing_stat(samples)
            lines.append(f"{name}: {mean:.1f} ± {std:.1f} ms (n={len(samples)})")
        return "\n".join(lines)
