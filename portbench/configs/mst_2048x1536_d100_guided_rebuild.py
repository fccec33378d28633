"""The video server as it ships at 2048x1536 with 100 disparities: the
guided-filtered adgrad volume (radius 9, eps (0.01*255)^2, 16 slices a
slab), and without `reuse_forest`, so the temporal frames build both
forests from their own images every frame, as the keyframes do.

Everything but the reference is the guided configuration's module
(`mst_2048x1536_d100_guided.py`, loaded by path): its `System` holds the
guided constants to the program's and builds `compile_mst_video_server(...,
volume_guided=True, reuse_forest=False)` for the stateful mix, and `score`,
`check_sample`, `compare` and `limits` are shared. This module's `System`
first refuses a configuration that states `reuse_forest` or a mix that is
not stateful; the reference is `portbench/reference/video_rebuild.py`.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path


def _guided_module():
    path = Path(__file__).resolve().with_name("mst_2048x1536_d100_guided.py")
    spec = importlib.util.spec_from_file_location("portbench_config_mst_guided", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_guided = _guided_module()
score, check_sample, compare, limits = (
    _guided.score, _guided.check_sample, _guided.compare, _guided.limits)


class System(_guided.System):
    def __init__(self, spec: dict, mix: dict, device):
        if spec["server"]["reuse_forest"] or not mix["stateful"]:
            raise ValueError("this configuration is the video server that rebuilds both forests "
                             "every frame: it needs reuse_forest false and a stateful mix")
        super().__init__(spec, mix, device)


def reference(sample: list, traffic, spec: dict, device, lower: bool = False) -> list:
    """The reference's maps of the sampled keyframe group (`lower`: the
    control)."""
    from portbench.reference.video_rebuild import mst_video_rebuild_group

    scenes = [traffic.scene(f["i"]) for f in sample]
    return mst_video_rebuild_group([(s.left, s.right) for s in scenes],
                                   [f["key_seed"] for f in sample], [f["maps"] for f in sample],
                                   spec, spec["server"]["scene_cut_ratio"], lower=lower,
                                   device=device)
