"""forest.rounds_per_frame: `sm.forest.round` spans a traced frame, one for
each round of a forest loop that ends in a host check (segmentation,
pointer jumping, component MST, list ranking, ancestor doubling)."""

from portbench.spans import of


def read(run):
    att = of(run)
    if att is None or not att.has("sm.forest"):
        return None
    return att.count("sm.forest.round") / att.frames
