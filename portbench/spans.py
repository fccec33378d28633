"""The program's own spans in a traced run, and what each layer of the
program is charged with.

The program marks its layers with profiler CPU events named
`sm.<layer>[.<part>]` (`stereomatch_tpu_torch/utils/timing.py::span`), on
the clock of the trace's device events. From a `Trace` (`tracing.py`):

- program spans: the CPU ops whose name starts with `sm.`;
- the innermost span at an instant: the shortest program span that holds
  it (start <= t < end); a span's layer is its name's second component;
- launches: the runtime calls in `LAUNCHES`, each charged at its start;
- syncs: the runtime calls in `SYNCS`, each charged at its start;
- idle: the gaps between the device events (`yardstick.idle_gaps`), each
  split piece by piece over the innermost spans it overlaps.

What lies in no span is unattributed (the name `None`). Each layer's sum
plus the unattributed part is the trace's total, for launches, syncs and
idle alike. A trace without program spans (a program that opens none)
gives no attribution, and every reader of it returns None.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from .yardstick import idle_gaps, median

PREFIX = "sm."
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx"})
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"})


def layer(name: str | None) -> str | None:
    """`sm.forest.round` -> `forest`; None (unattributed) stays None."""
    return None if name is None else name.split(".")[1]


def innermost_segments(spans) -> list[tuple[float, float, str]]:
    """The timeline of (start, end, name) spans cut into disjoint pieces,
    each with the name of the shortest span that holds it (adjacent pieces
    of one name merged); pieces no span holds are left out. Sorted by
    start."""
    events = []
    for i, (s, e, _) in enumerate(spans):
        if e > s:
            events += [(s, 1, i), (e, 0, i)]
    events.sort()  # at one instant, ends before starts
    out, active, prev = [], set(), None
    for t, starts, i in events:
        if active and t > prev:
            j = min(active, key=lambda k: (spans[k][1] - spans[k][0], k))
            if out and out[-1][1] == prev and out[-1][2] == spans[j][2]:
                out[-1] = (out[-1][0], t, spans[j][2])  # one piece, not two
            else:
                out.append((prev, t, spans[j][2]))
        prev = t
        (active.add if starts else active.discard)(i)
    return out


@dataclass
class Attribution:
    """What the traced frames charged to each innermost span name (None:
    unattributed): launches, syncs and idle microseconds; the spans
    themselves as (start, end, name)."""

    frames: int
    spans: list
    launches: Counter = field(default_factory=Counter)
    syncs: Counter = field(default_factory=Counter)
    idle_us: dict = field(default_factory=lambda: defaultdict(float))
    rng_launches_in_refine: int = 0

    def has(self, name: str) -> bool:
        return any(n == name for _, _, n in self.spans)

    def count(self, name: str) -> int:
        return sum(n == name for _, _, n in self.spans)

    def durations_ms(self, name: str) -> list[float]:
        return [(e - s) / 1e3 for s, e, n in self.spans if n == name]

    def by_layer(self, charges) -> dict:
        """A charge table (launches, syncs or idle_us) summed by layer."""
        out = defaultdict(float)
        for name, v in charges.items():
            out[layer(name)] += v
        return out

    def per_frame(self, charges, lay: str) -> float:
        return self.by_layer(charges).get(lay, 0.0) / self.frames


def _holder(segments):
    starts = [s for s, _, _ in segments]

    def at(t: float):
        k = bisect_right(starts, t) - 1
        if k >= 0 and t < segments[k][1]:
            return segments[k][2]
        return None

    return at


def split_interval(segments, starts, a: float, b: float):
    """[(name, length)] of the interval [a, b] over the segments, None for
    the pieces no segment covers; the lengths sum to b - a."""
    out, t = [], a
    k = max(bisect_right(starts, a) - 1, 0)
    while t < b and k < len(segments):
        s, e, name = segments[k]
        if e <= t:
            k += 1
            continue
        if s >= b:
            break
        if s > t:
            out.append((None, s - t))
            t = s
        stop = min(e, b)
        out.append((name, stop - t))
        t = stop
        k += 1
    if t < b:
        out.append((None, b - t))
    return out


def attribute(trace) -> Attribution | None:
    """The attribution of a `Trace`, or None without frames or program
    spans."""
    if trace is None or not trace.frames:
        return None
    spans = sorted((s, e, n) for n, s, e in trace.cpu_ops if n.startswith(PREFIX))
    if not spans:
        return None
    segments = innermost_segments(spans)
    at = _holder(segments)
    refine = _holder(innermost_segments([x for x in spans if x[2] == "sm.refine"]))
    att = Attribution(frames=trace.frames, spans=spans)
    for n, s, _ in trace.cpu_ops:
        if n in LAUNCHES:
            inner = at(s)
            att.launches[inner] += 1
            if inner == "sm.rng" and refine(s) is not None:
                att.rng_launches_in_refine += 1
        elif n in SYNCS:
            att.syncs[at(s)] += 1
    starts = [s for s, _, _ in segments]
    events = [(s, e) for _, s, e in trace.kernels + trace.copies]
    for a, b in idle_gaps(events, trace.t0_us, trace.t1_us):
        for name, length in split_interval(segments, starts, a, b):
            att.idle_us[name] += length
    return att


_last: tuple = (None, None)  # (trace, its attribution): the readers of one run share it


def of(run) -> Attribution | None:
    """The attribution of a run's trace, computed once for all readers."""
    global _last
    if _last[0] is not run.trace:
        _last = (run.trace, attribute(run.trace))
    return _last[1]


def launches_per_frame(run, lay: str, span: str) -> float | None:
    """Launches a frame charged to `lay`, where the trace has `span`."""
    att = of(run)
    if att is None or not att.has(span):
        return None
    return att.per_frame(att.launches, lay)


def idle_ms_per_frame(run, lay: str, span: str) -> float | None:
    """Device idle ms a frame charged to `lay`, where the trace has `span`."""
    att = of(run)
    if att is None or not att.has(span):
        return None
    return att.per_frame(att.idle_us, lay) / 1e3


def median_span_ms(run, span: str) -> float | None:
    """Median host ms of the spans named `span`."""
    att = of(run)
    if att is None or not att.has(span):
        return None
    return median(att.durations_ms(span))
