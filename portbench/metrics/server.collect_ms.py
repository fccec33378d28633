"""server.collect_ms: median host ms of a traced frame's `sm.server.collect`
span: its outputs copied to the host (where the host waits for the
device), the video server's LR statistic and any replay."""

from portbench.spans import median_span_ms


def read(run):
    return median_span_ms(run, "sm.server.collect")
