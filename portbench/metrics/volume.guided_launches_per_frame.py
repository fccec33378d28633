"""volume.guided_launches_per_frame: kernel launches a traced frame whose
innermost program span is `sm.volume.guided` (the guided filter of both
views' cost volumes)."""

from portbench.spans import of


def read(run):
    att = of(run)
    if att is None or not att.has("sm.volume.guided"):
        return None
    return att.launches["sm.volume.guided"] / att.frames
