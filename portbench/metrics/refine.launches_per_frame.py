"""refine.launches_per_frame: kernel launches a traced frame whose
innermost program span is `sm.refine` or `sm.refine.iter` (both views'
seed labels and refine iterations). The RNG's draws inside the refine are
counted apart, by refine.rng_launches_per_frame."""

from portbench.spans import launches_per_frame


def read(run):
    return launches_per_frame(run, "refine", "sm.refine")
