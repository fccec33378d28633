"""forest.syncs_per_frame: the runtime's synchronize calls a traced frame
whose innermost program span is `sm.forest` or `sm.forest.round`: the
host checks of the forest loops and the capacity check."""

from portbench.spans import of


def read(run):
    att = of(run)
    if att is None or not att.has("sm.forest"):
        return None
    return att.per_frame(att.syncs, "forest")
