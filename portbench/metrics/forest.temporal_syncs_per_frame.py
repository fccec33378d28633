"""forest.temporal_syncs_per_frame: the runtime's synchronize calls a traced
temporal frame whose innermost program span is `sm.forest` or
`sm.forest.round` and which start inside an `sm.server.temporal` span: the
host checks of the forest loops that a temporal frame pays when it builds
both forests (none with `reuse_forest`)."""

from portbench.frame_kinds import temporal_forest


def read(run):
    got = temporal_forest(run)
    return None if got is None else got["syncs"] / got["frames"]
