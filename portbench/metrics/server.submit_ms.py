"""server.submit_ms: median host ms of a traced frame's `sm.server.submit`
span, the whole of the server's submit_pair: the frame's key, the upload of
its inputs and the enqueue of its work, with every host wait of the
forest build inside it."""

from portbench.spans import median_span_ms


def read(run):
    return median_span_ms(run, "sm.server.submit")
