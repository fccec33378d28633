"""device.idle_unattributed_pct: share (%) of the traced device idle time
during which the host was in no program span (`sm.*`): what the spans
leave unexplained."""

from portbench.spans import of


def read(run):
    att = of(run)
    total = 0.0 if att is None else sum(att.idle_us.values())
    if total <= 0:
        return None
    return 100.0 * att.idle_us.get(None, 0.0) / total
