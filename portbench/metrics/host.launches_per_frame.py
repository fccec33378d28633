"""host.launches_per_frame: device kernels (copies and fills left out) in
the traced frames, over those frames."""


def read(run):
    tr = run.trace
    if tr is None or not tr.frames or not tr.kernels:
        return None
    return len(tr.kernels) / tr.frames
