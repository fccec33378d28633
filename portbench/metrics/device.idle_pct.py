"""device.idle_pct: share (%) of the traced window in which no operation
ran on the device (the union of the device events' intervals)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
