"""server.temporal_submit_ms: median host ms of a traced temporal frame's
`sm.server.temporal` span, the enqueue of its volumes, forests and refine
inside submit_pair: how long the host is held by a temporal frame, the
forest's waits included."""

from portbench.spans import median_span_ms


def read(run):
    return median_span_ms(run, "sm.server.temporal")
