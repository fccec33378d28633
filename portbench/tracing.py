"""The traced segment of a `--trace 1` run: a few frames served under
`torch.profiler` (CPU and CUDA activity) with the CUDA sync debug mode set
to warn, so that every host sync the program makes is counted. From the
profile: every device event (kernels, copies, fills), the CPU ops, the
union of the device's busy intervals and the longest idle gaps labelled by
the innermost CPU op the host was in.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict
from dataclasses import dataclass, field

from .yardstick import busy_s, idle_gaps

TOP = 10
_NOT_KERNELS = ("Memcpy", "Memset")
_PROFILER_OWN = ("Activity Buffer Request",)  # the profiler's bookkeeping, not the program's


@dataclass
class Trace:
    frames: int
    keys: int  # keyframes among them (every frame of a stateless mix)
    window_s: float
    kernels: list = field(default_factory=list)  # (name, start_us, end_us)
    copies: list = field(default_factory=list)  # memcpy and memset events
    cpu_ops: list = field(default_factory=list)  # (name, start_us, end_us)
    syncs: int = 0
    t0_us: float = 0.0
    t1_us: float = 0.0

    @property
    def busy_s(self) -> float:
        return busy_s((s, e) for _, s, e in self.kernels + self.copies) / 1e6

    def kernel_time_s(self, match) -> tuple[int, float]:
        """(launches, summed device seconds) of the kernels whose name
        `match` accepts."""
        hits = [(s, e) for n, s, e in self.kernels if match(n)]
        return len(hits), sum(e - s for s, e in hits) / 1e6

    def breakdown(self) -> dict:
        per = defaultdict(float)
        for n, s, e in self.kernels + self.copies:
            per[n] += (e - s) / 1e6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
        events = [(s, e) for _, s, e in self.kernels + self.copies]
        gaps = sorted(idle_gaps(events, self.t0_us, self.t1_us), key=lambda g: g[0] - g[1])[:TOP]
        labelled = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [(e - s, n) for n, s, e in self.cpu_ops if s <= mid <= e]
            labelled.append([min(inner)[1] if inner else "host outside any op", (b - a) / 1e6])
        return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": labelled}


def traced(serve, frames: int, keys_of) -> Trace:
    """Run `serve()` (which serves `frames` frames and returns their
    records) under the profiler and the sync counter."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                recs = serve()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    tr = Trace(frames=frames, keys=keys_of(recs), window_s=window_s, syncs=syncs)
    starts, ends = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            (tr.copies if e.name.startswith(_NOT_KERNELS) else tr.kernels).append(row)
        elif e.name not in _PROFILER_OWN:
            tr.cpu_ops.append(row)
            starts.append(row[1])
            ends.append(row[2])
    if starts:
        tr.t0_us, tr.t1_us = min(starts), max(ends)
    return tr
