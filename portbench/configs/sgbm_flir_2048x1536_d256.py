"""OpenCV-surface SGBM (MODE_HH, 8 paths) with speckle filtering at the FLIR
rig's 2048x1536 and 256 disparities, through the program's
`pipelines.sgbm_pipeline`, one call a pair. Its float32 aggregated volume
(3.2 GB) is above the program's band threshold, so every call streams the
rows in bands of 128 through K1c.
"""

from __future__ import annotations

import numpy as np


class System:
    """submit(frame index, left, right, key seed) runs one call; collect
    hands its left map back."""

    def __init__(self, spec: dict, mix: dict, device):
        from stereomatch_tpu_torch import pipelines
        from stereomatch_tpu_torch.config import SGBMConfig

        self.spec = spec
        self.cfg = SGBMConfig(**spec["sgbm"])
        self.depth = 1  # one call at a time
        if "band_threshold_bytes" in spec:  # a rehearsal's small frame takes the band path
            pipelines.SGBM_BAND_THRESHOLD_BYTES = int(spec["band_threshold_bytes"])
        self.device = device
        self.pipelines = pipelines
        self.is_key: dict[int, bool] = {}  # every call stands alone
        self._done: dict[int, tuple] = {}
        self._next = 0

    def submit(self, i: int, left: np.ndarray, right: np.ndarray, key_seed: int) -> int:
        # the scenes are BGR, the pipeline takes RGB
        disp = self.pipelines.sgbm_pipeline(left[..., ::-1], right[..., ::-1], self.cfg,
                                            speckle=True, device=self.device)
        t = self._next
        self._next += 1
        self._done[t] = (disp,)
        return t

    def collect(self, ticket: int):
        return self._done.pop(ticket)

    def reset(self) -> None:
        pass

    def failures(self) -> int:
        return 0  # a failed call raises

    def counters(self) -> dict:
        return {}


def score(maps, scene, spec: dict, eval_mask, threshold: float = 2.0) -> tuple[int, int]:
    """(bad, scored) pixels of one frame's left map (invalid: min_disp - 1)."""
    from portbench.yardstick import bad_counts

    (disp,) = maps
    return bad_counts(disp, disp != spec["sgbm"]["min_disp"] - 1, scene.disp_left, eval_mask, threshold)


def check_sample(frames: list, traffic) -> list:
    return traffic.sample(frames, int(traffic.mix["check_frames"]))


def reference(sample: list, traffic, spec: dict, device, lower: bool = False) -> list:
    """The reference's left maps of the sampled calls (`lower`: the control)."""
    from portbench.reference.frames import SGBM_BAND_THRESHOLD_BYTES, sgbm_flir

    thr = spec.get("band_threshold_bytes", SGBM_BAND_THRESHOLD_BYTES)
    out = []
    for f in sample:
        sc = traffic.scene(f["i"])
        out.append((sgbm_flir(sc.left[..., ::-1], sc.right[..., ::-1], spec, lower=lower,
                              device=device, band_threshold_bytes=thr),))
    return out


def compare(got: list, want: list, spec: dict) -> dict:
    """The share of pixels where two left maps differ at all, worst call.
    SGBM's costs and path sums are integers in float32, so the program's
    kernels and the reference agree exactly."""
    worst = 0.0
    for (g,), (w,) in zip(got, want, strict=True):
        if g.shape != w.shape:
            return {"diff_share": 1.0}
        worst = max(worst, float(np.mean(g != w)))
    return {"diff_share": worst}


def limits(spec: dict) -> dict:
    return {"diff_share": float(spec["check"]["diff_share_limit"])}
