"""forest.launches_per_frame: kernel launches a traced frame whose
innermost program span is `sm.forest` or `sm.forest.round` (both views'
prefilter, edge weights, device forest and capacity check)."""

from portbench.spans import launches_per_frame


def read(run):
    return launches_per_frame(run, "forest", "sm.forest")
