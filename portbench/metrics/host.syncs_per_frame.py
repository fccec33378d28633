"""host.syncs_per_frame: the host's waits on the device in the traced
frames (warnings of `torch.cuda.set_sync_debug_mode("warn")`, each
counted), over those frames."""


def read(run):
    tr = run.trace
    if tr is None or not tr.frames or not tr.kernels:
        return None
    return tr.syncs / tr.frames
