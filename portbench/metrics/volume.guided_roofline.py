"""volume.guided_roofline: the guided filter's share (%) of its roofline in
the traced frames: the least time to read each view's float32 volume and
guide once and write the filtered volume once, two views a frame, over the
device time of the kernels launched inside `sm.volume.guided`, matched to
their launch calls by rank (`portbench/guided_yardstick.py`). Left out
where launch calls and kernels do not pair one to one, or where the trace
lacks the span."""

from portbench.guided_yardstick import roofline_pct


def read(run):
    return roofline_pct(run)
