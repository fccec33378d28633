"""volume.guided_idle_ms_per_frame: device idle ms a traced frame while the
host's innermost program span is `sm.volume.guided`."""

from portbench.spans import of


def read(run):
    att = of(run)
    if att is None or not att.has("sm.volume.guided"):
        return None
    return att.idle_us.get("sm.volume.guided", 0.0) / att.frames / 1e3
