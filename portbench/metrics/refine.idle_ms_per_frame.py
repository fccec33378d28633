"""refine.idle_ms_per_frame: device idle ms a traced frame while the
host's innermost program span is `sm.refine` or `sm.refine.iter`."""

from portbench.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, "refine", "sm.refine")
