"""sgbm.launches_per_frame: kernel launches a traced frame whose
innermost program span is `sm.sgbm` or one of its parts (the 3DMST
frame's SGBM seed; the whole of an sgbm_pipeline call)."""

from portbench.spans import launches_per_frame


def read(run):
    return launches_per_frame(run, "sgbm", "sm.sgbm")
