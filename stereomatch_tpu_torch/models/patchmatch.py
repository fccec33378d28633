"""PatchMatch stereo pipeline: slanted-plane propagation and post-process
(port of `stereomatch_tpu/models/patchmatch.py`).

The reference's PatchMatchStereoGPU entry (src/PatchMatchStereoGPU.cu:
2602-3023) with the CPU pm::PatchMatch post-processing chain (the GPU one
is compiled out at .cu:2839-2858): the LR check within 1 px
(pm.cpp:536-546), the plane-extended fill of the occluded pixels, then the
colour-weighted median over them (pm.cpp:396-435 / .cu:2436-2600).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PatchMatchConfig, WeightedMedianConfig
from ..ops.patchmatch import patchmatch_stereo, plane_fill_occluded
from ..ops.postprocess import lr_occlusion_mask, weighted_median

__all__ = ["patchmatch_pipeline", "PatchMatchOutput"]


class PatchMatchOutput(NamedTuple):
    left_disp: torch.Tensor
    right_disp: torch.Tensor
    left_raw: torch.Tensor
    right_raw: torch.Tensor


def patchmatch_pipeline(
    key: torch.Tensor,
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    cfg: PatchMatchConfig = PatchMatchConfig(),
    median_cfg: WeightedMedianConfig = WeightedMedianConfig(),
    postprocess: bool = True,
) -> PatchMatchOutput:
    """PatchMatch on a BGR pair in [0, 255] on the key's device; with
    `postprocess`, the LR masks, the plane fill, then the weighted median
    (gamma 0.1: images in [0, 255], .cu:2474) on the occluded pixels."""
    left_bgr = left_bgr.float()
    right_bgr = right_bgr.float()
    left, right, _, _ = patchmatch_stereo(key, left_bgr, right_bgr, cfg)
    dl_raw, dr_raw = left.d, right.d
    dl, dr = dl_raw, dr_raw
    if postprocess:
        occ_l = lr_occlusion_mask(dl, dr, -1, cfg.max_disp, cfg.min_disp)
        occ_r = lr_occlusion_mask(dr, dl, +1, cfg.max_disp, cfg.min_disp)
        dl = plane_fill_occluded(left, ~occ_l)
        dr = plane_fill_occluded(right, ~occ_r)
        dl = weighted_median(dl, left_bgr, occ_l, median_cfg, normalized_intensity=False)
        dr = weighted_median(dr, right_bgr, occ_r, median_cfg, normalized_intensity=False)
    return PatchMatchOutput(dl, dr, dl_raw, dr_raw)
