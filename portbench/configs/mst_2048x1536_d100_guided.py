"""The SGBM-seeded 3DMST frame at 2048x1536 with 100 disparities on the pair
server's default volume: the adgrad volume of each view guided-filtered with
its gray image as guide (radius 9, eps (0.01*255)^2, 16 slices a slab).

Everything but the reference is the raw configuration's module
(`mst_2048x1536_d100_raw.py`, loaded by path): its `System` builds
`compile_sgbm_mst_server(..., volume_guided=True)` for `"volume":
"adgrad_guided"`, and `score`, `check_sample`, `compare` and `limits` are
shared. This module's `System` first holds the configuration's guided
constants to the program's (`GuidedFilterConfig()`); the reference is
`portbench/reference/guided.py`, of pair-server frames (a stateless mix).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path


def _raw_module():
    path = Path(__file__).resolve().with_name("mst_2048x1536_d100_raw.py")
    spec = importlib.util.spec_from_file_location("portbench_config_mst_raw", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_raw = _raw_module()
score, check_sample, compare, limits = _raw.score, _raw.check_sample, _raw.compare, _raw.limits


class System(_raw.System):
    def __init__(self, spec: dict, mix: dict, device):
        from stereomatch_tpu_torch.config import GuidedFilterConfig

        g, want = spec["guided"], GuidedFilterConfig()
        stated = (spec["volume"], int(g["radius"]), float(g["eps"]), int(g["slab"]))
        if stated != ("adgrad_guided", want.radius, want.eps, want.slab):
            raise ValueError(f"the configuration states the guided volume {stated}; the program "
                             f"filters with radius {want.radius}, eps {want.eps}, slab {want.slab}")
        super().__init__(spec, mix, device)


def reference(sample: list, traffic, spec: dict, device, lower: bool = False) -> list:
    """The reference's maps of the sampled frames (`lower`: the control)."""
    from portbench.reference.guided import mst_pair_guided

    scenes = [traffic.scene(f["i"]) for f in sample]
    return [mst_pair_guided(s.left, s.right, f["key_seed"], spec, lower=lower, device=device)
            for s, f in zip(scenes, sample)]
