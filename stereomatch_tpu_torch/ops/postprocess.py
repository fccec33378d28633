"""Post-processing: nearest-valid fill, the left-right consistency checks
and the occlusion fill of both views (port of
`stereomatch_tpu/ops/postprocess.py`; its `weighted_median` is not ported
yet, ROADMAP.md). Disparities round half to even in both packages
(`torch.round`, `jnp.round`)."""

from __future__ import annotations

import torch

__all__ = ["lr_occlusion_mask", "nearest_valid_fill", "lr_check_fill_pair", "lr_consistency"]


def lr_check_fill_pair(disp_l, disp_r, max_disp: float, min_disp: float):
    """LR-check both views against each other and fill the occluded pixels
    (the cost-volume pipeline's lr_check step). Returns (left, right)
    filled maps."""
    occ_l = lr_occlusion_mask(disp_l, disp_r, -1, max_disp, min_disp)
    occ_r = lr_occlusion_mask(disp_r, disp_l, +1, max_disp, min_disp)
    zero = disp_l.new_zeros(())
    left = nearest_valid_fill(torch.where(occ_l, zero, disp_l), ~occ_l)
    right = nearest_valid_fill(torch.where(occ_r, zero, disp_r), ~occ_r)
    return left, right


def lr_occlusion_mask(
    disp_ref: torch.Tensor,
    disp_other: torch.Tensor,
    sign: int,
    max_disp: float,
    min_disp: float = 0.0,
    max_diff: float = 1.0,
) -> torch.Tensor:
    """Occlusion mask for one view (True = inconsistent or occluded), as
    the GPU leftRightCheck (src/PatchMatchStereoGPU.cu:2115-2153). sign -1
    for a left-view map (match at x - d), +1 for a right-view map (match at
    x + d): invalid when d <= 0, d > max_disp, d < min_disp, the match
    column is out of bounds, or |d - other(x + sign*round(d))| > max_diff."""
    w = disp_ref.shape[1]
    xs = torch.arange(w, device=disp_ref.device)[None, :]
    match_x = xs + sign * torch.round(disp_ref).long()
    in_bounds = (match_x >= 0) & (match_x < w)
    other = torch.gather(disp_other, 1, match_x.clamp(0, w - 1))
    consistent = torch.abs(disp_ref - other) <= max_diff
    valid = (
        (disp_ref > 0.0)
        & (disp_ref <= max_disp)
        & (disp_ref >= min_disp)
        & in_bounds
        & consistent
    )
    return ~valid


def nearest_valid_fill(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill invalid pixels from row neighbours (reference rule,
    src/Stereo3DMST.cpp:676-708): the nearest valid value to the left,
    replaced by the nearest valid value to the right when that is smaller
    (or when there is no left one); 0 when the row has none."""
    h, w = disp.shape
    xs = torch.arange(w, device=disp.device).expand(h, w)
    left_idx = torch.cummax(torch.where(valid, xs, -1), dim=1).values
    right_idx = torch.cummin(torch.where(valid, xs, w).flip(1), dim=1).values.flip(1)
    has_l = left_idx >= 0
    has_r = right_idx < w
    fl = torch.gather(disp, 1, left_idx.clamp(0, w - 1))
    fr = torch.gather(disp, 1, right_idx.clamp(0, w - 1))
    zero = disp.new_zeros(())
    fill = torch.where(
        has_l & has_r,
        torch.minimum(fl, fr),
        torch.where(has_l, fl, torch.where(has_r, fr, zero)),
    )
    return torch.where(valid, disp, fill)


def lr_consistency(
    left_disp: torch.Tensor,
    right_disp: torch.Tensor,
    max_disp: float,
    max_diff: float = 1.0,
    fill: bool = True,
):
    """Left-view LR check: d = round(left(x)) (half to even) is valid iff
    x - d >= 0, 0 <= d < max_disp and |left(x) - right(x - d)| <= max_diff.
    Invalid pixels are zeroed and, if `fill`, nearest-valid filled.
    Returns (disp, valid)."""
    w = left_disp.shape[1]
    xs = torch.arange(w, device=left_disp.device)[None, :]
    d_round = torch.round(left_disp).long()
    match_x = xs - d_round
    in_range = (match_x >= 0) & (d_round >= 0) & (d_round < max_disp)
    right_at = torch.gather(right_disp, 1, match_x.clamp(0, w - 1))
    valid = in_range & (torch.abs(left_disp - right_at) <= max_diff)
    disp = torch.where(valid, left_disp, left_disp.new_zeros(()))
    if fill:
        disp = nearest_valid_fill(disp, valid)
    return disp, valid
