"""forest.temporal_idle_ms_per_frame: device idle ms a traced temporal frame
while the host's innermost program span is `sm.forest` or
`sm.forest.round`, inside an `sm.server.temporal` span."""

from portbench.frame_kinds import temporal_forest


def read(run):
    got = temporal_forest(run)
    return None if got is None else got["idle_us"] / got["frames"] / 1e3
