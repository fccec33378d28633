"""refine.rng_launches_per_frame: kernel launches a traced frame whose
innermost program span is `sm.rng` (a threefry draw) inside an `sm.refine`
span: the candidate draws of both views' refine."""

from portbench.spans import of


def read(run):
    att = of(run)
    if att is None or not att.has("sm.refine"):
        return None
    return att.rng_launches_in_refine / att.frames
