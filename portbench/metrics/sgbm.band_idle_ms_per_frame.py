"""sgbm.band_idle_ms_per_frame: device idle ms a traced call while the
host's innermost program span is a band of the band-streamed SGBM
(`sm.sgbm.band` or `sm.sgbm.band_up`: a band's cost, its K1c launch and,
going down, its selection)."""

from portbench.spans import of


def read(run):
    att = of(run)
    if att is None or not att.has("sm.sgbm.band"):
        return None
    idle = att.idle_us.get("sm.sgbm.band", 0.0) + att.idle_us.get("sm.sgbm.band_up", 0.0)
    return idle / 1e3 / att.frames
