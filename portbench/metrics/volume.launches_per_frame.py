"""volume.launches_per_frame: kernel launches a traced frame whose
innermost program span is `sm.volume` (the cost volumes of both views)."""

from portbench.spans import launches_per_frame


def read(run):
    return launches_per_frame(run, "volume", "sm.volume")
