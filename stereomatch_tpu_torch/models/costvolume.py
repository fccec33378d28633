"""Cost-volume stereo with guided-filter aggregation and variational
denoise (port of `stereomatch_tpu/models/costvolume.py`).

The reference's production GPU pipeline
`costVolumeStereoPlusVariationalDenoise` (src/PatchMatchStereoGPU.cu:
8776-9410), in the JAX module's stage order:

  1. pixelwise truncated AD + gray-gradient BGR cost volumes, both views
     (.cu:8983-8984);
  2. gray-guided guided-filter smoothing of each volume, eps=(0.01*255)^2,
     radius 9 (.cu:9000-9001), streamed in disparity slabs;
  3. WTA + parabola subpixel (.cu:9212-9213);
  4. weighted-Huber primal-dual denoise, lambda=0.5 (.cu:9226-9227);
  5. with `lr_check`, the LR check and occlusion fill of both views (the
     reference compiles its own out, #if 0 at .cu:9232-9239).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CostVolumePipelineConfig
from ..ops.cost import adgrad_bgr_volumes, bgr_to_gray
from ..ops.filters import guided_filter_volume
from ..ops.postprocess import lr_check_fill_pair
from ..ops.select import wta_disparity
from ..ops.variational import variational_disparity_denoise

__all__ = ["cost_volume_stereo", "CostVolumeOutput"]


class CostVolumeOutput(NamedTuple):
    left_disp: torch.Tensor
    right_disp: torch.Tensor
    left_raw: torch.Tensor  # WTA before denoise
    right_raw: torch.Tensor


def cost_volume_stereo(
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
    denoise: bool = True,
    lr_check: bool = False,
) -> CostVolumeOutput:
    """The full cost-volume pipeline on a rectified BGR pair in [0, 255],
    on the images' device. Returns float32 disparities of both views
    (left: matches at x - d, right: matches at x + d)."""
    v = cfg.volume
    left_bgr = left_bgr.float()
    right_bgr = right_bgr.float()
    gray_l = bgr_to_gray(left_bgr)
    gray_r = bgr_to_gray(right_bgr)

    lvol, rvol = adgrad_bgr_volumes(left_bgr, right_bgr, v)
    g = cfg.guided
    lvol = guided_filter_volume(gray_l, lvol, g.radius, g.eps, slab=g.slab)
    rvol = guided_filter_volume(gray_r, rvol, g.radius, g.eps, slab=g.slab)
    left_raw = wta_disparity(lvol, v.min_disp)
    right_raw = wta_disparity(rvol, v.min_disp)
    del lvol, rvol

    left, right = left_raw, right_raw
    if denoise:
        left = variational_disparity_denoise(left, gray_l, v.min_disp, v.max_disp, cfg.denoise)
        right = variational_disparity_denoise(right, gray_r, v.min_disp, v.max_disp, cfg.denoise)
    if lr_check:
        left, right = lr_check_fill_pair(left, right, float(v.max_disp), float(v.min_disp))
    return CostVolumeOutput(left, right, left_raw, right_raw)
