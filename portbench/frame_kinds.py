"""What a traced run's frames were charged by kind: the part of the forest
layer's charges (`portbench/spans.py`) that fell inside the video server's
temporal frames, the program spans `sm.server.temporal` that it opens
around a temporal frame's enqueue in submit_pair (none around a keyframe).

A sync is the forest's when the innermost program span at its start is of
the forest layer, and a temporal frame's when a temporal span holds that
start; an idle piece is split the same way, over the innermost spans and
then over the temporal spans. Charges are given a traced temporal frame:
over the number of temporal spans. A trace without a temporal span (a
keyframe-only mix, or a program that opens none) reads None.
"""

from __future__ import annotations

from .spans import SYNCS, _holder, innermost_segments, layer, of, split_interval
from .yardstick import idle_gaps

TEMPORAL = "sm.server.temporal"


def temporal_forest(run) -> dict | None:
    """{"frames", "syncs", "idle_us"}: the traced temporal frames, and the
    syncs and idle microseconds charged to the forest layer inside them, or
    None."""
    att = of(run)
    if att is None or not att.has(TEMPORAL):
        return None
    trace = run.trace
    segments = innermost_segments(att.spans)
    starts = [s for s, _, _ in segments]
    temporal = innermost_segments([x for x in att.spans if x[2] == TEMPORAL])
    inner, in_temporal = _holder(segments), _holder(temporal)
    syncs = sum(1 for n, s, _ in trace.cpu_ops
                if n in SYNCS and in_temporal(s) is not None and layer(inner(s)) == "forest")
    idle = 0.0
    events = [(s, e) for _, s, e in trace.kernels + trace.copies]
    for a, b in idle_gaps(events, trace.t0_us, trace.t1_us):
        for ts, te, _ in temporal:
            lo, hi = max(a, ts), min(b, te)
            if hi > lo:
                idle += sum(length for name, length in split_interval(segments, starts, lo, hi)
                            if layer(name) == "forest")
    return {"frames": att.count(TEMPORAL), "syncs": syncs, "idle_us": idle}
