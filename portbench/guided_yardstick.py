"""The guided filter's yardstick: the bytes its work has to move, and the
device time of the kernels the program launched inside `sm.volume.guided`.

Bytes: a view's guided filter reads its (rows, cols, D) float32 cost volume
and its (rows, cols) float32 guide once and writes the filtered volume
once, (2 D + 1) rows cols 4 bytes; a pair frame filters two views. They
are the bytes of the work, not of one implementation, so a fused kernel is
read by the same yardstick as the eager box filters.

Device time: a `Trace` keeps kernels and launch calls without correlation
ids. The program enqueues on one stream, so the k-th launch call
(`spans.LAUNCHES`) by host start is the k-th kernel by device start. The
kernels whose launch call lies innermost in `sm.volume.guided` are the
filter's. Where the counts of launch calls and kernels differ (a launch API
the trace does not name, a kernel of another stream), nothing is matched.
"""

from __future__ import annotations

from .spans import LAUNCHES, PREFIX, _holder, innermost_segments
from .yardstick import bound_s

SPAN = "sm.volume.guided"


def guided_bytes(rows: int, cols: int, max_disp: int, views: int = 2) -> int:
    """Bytes of one frame's guided filters: each view's float32 volume and
    guide read once and its filtered volume written once."""
    return views * (2 * max_disp + 1) * rows * cols * 4


def span_kernel_s(trace, span: str = SPAN) -> float | None:
    """Summed device seconds of the kernels whose launch call's innermost
    program span is `span`; None where launch calls and kernels do not pair
    one to one, or where no launch lies in `span`."""
    if trace is None:
        return None
    launches = sorted(s for n, s, _ in trace.cpu_ops if n in LAUNCHES)
    kernels = sorted((s, e) for _, s, e in trace.kernels)
    if len(launches) != len(kernels):
        return None
    spans = sorted((s, e, n) for n, s, e in trace.cpu_ops if n.startswith(PREFIX))
    at = _holder(innermost_segments(spans))
    hits = [kernels[k] for k, s in enumerate(launches) if at(s) == span]
    if not hits:
        return None
    return sum(e - s for s, e in hits) / 1e6


def roofline_pct(run) -> float | None:
    """The guided filter's least time over the device time of its kernels
    in the traced frames, as a %."""
    tr, spec = run.trace, run.spec
    if tr is None or not tr.frames or "guided" not in spec:
        return None
    t = span_kernel_s(tr)
    if t is None or t <= 0:
        return None
    least = bound_s(tr.frames * guided_bytes(spec["rows"], spec["cols"], spec["max_disp"]))
    return 100.0 * least / t
