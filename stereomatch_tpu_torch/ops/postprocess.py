"""Post-processing: nearest-valid fill, the left-right consistency checks,
the occlusion fill of both views and the colour-weighted median (port of
`stereomatch_tpu/ops/postprocess.py`). Disparities round half to even in
both packages (`torch.round`, `jnp.round`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import WeightedMedianConfig
from .segmentation import channel_l1

__all__ = ["lr_occlusion_mask", "nearest_valid_columns", "nearest_valid_fill", "lr_check_fill_pair",
           "lr_consistency", "weighted_median"]


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


def nearest_valid_columns(valid: torch.Tensor):
    """(xs, left, right) for an (H, W) mask: each pixel's column, the nearest
    valid column at or left of it (-1 if none) and at or right of it (W if
    none), as JAX's cummax and reverse cummin."""
    h, w = valid.shape
    xs = torch.arange(w, device=valid.device).expand(h, w)
    left = torch.cummax(torch.where(valid, xs, -1), dim=1).values
    right = torch.cummin(torch.where(valid, xs, w).flip(1), dim=1).values.flip(1)
    return xs, left, right


def nearest_valid_fill(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill invalid pixels from row neighbours (reference rule,
    src/Stereo3DMST.cpp:676-708): the nearest valid value to the left,
    replaced by the nearest valid value to the right when that is smaller
    (or when there is no left one); 0 when the row has none."""
    w = disp.shape[1]
    _, left_idx, right_idx = nearest_valid_columns(valid)
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


def weighted_median(
    disp: torch.Tensor,
    bgr: torch.Tensor,
    occluded: torch.Tensor,
    cfg: WeightedMedianConfig = WeightedMedianConfig(),
    normalized_intensity: bool = True,
) -> torch.Tensor:
    """Colour-weighted median of the occluded pixels (ref:
    weightedMedianFilter, src/PatchMatchStereoGPU.cu:2436-2600).

    Over the window (taps on a `cfg.tap_stride` grid, dy outer, dx inner),
    each tap weighs exp(-sqrt(L1_bgr(center, tap)) * gamma), gamma 25.5 for
    [0, 1] images and 0.1 for [0, 255] ones (.cu:2474); out-of-bounds taps
    weigh 0 (disparity and colour are zero-padded). The median is the
    smallest tap disparity whose cumulative weight reaches half the total:
    a range pass, `cfg.bisect_iters` bisections of S(m) = sum_j w_j [d_j <=
    m], then the exact snap to the smallest tap value in the final bracket;
    where no tap lies in it, the pixel keeps `disp`. Fixed pass counts, no
    host sync. Only pixels with `occluded` True are replaced."""
    win_r = cfg.window_size // 2
    gamma = 25.5 if normalized_intensity else 0.1
    h, w = disp.shape
    offs = range(-win_r, win_r + 1, cfg.tap_stride)
    taps = [(dy, dx) for dy in offs for dx in offs]
    pad_d = F.pad(disp, (win_r, win_r, win_r, win_r))
    pad_c = F.pad(bgr, (0, 0, win_r, win_r, win_r, win_r))
    in_y = torch.arange(h, device=disp.device)[:, None]
    in_x = torch.arange(w, device=disp.device)[None, :]

    # each pass reads every tap's (disparity, weight); they are computed
    # once here, as each of JAX's passes computes them alike
    d_taps, w_taps = [], []
    for dy, dx in taps:
        rows = slice(dy + win_r, dy + win_r + h)
        cols = slice(dx + win_r, dx + win_r + w)
        d_taps.append(pad_d[rows, cols])
        cdiff = torch.sqrt(channel_l1(pad_c[rows, cols] - bgr))
        inb = (in_y + dy >= 0) & (in_y + dy < h) & (in_x + dx >= 0) & (in_x + dx < w)
        w_taps.append(torch.where(inb, torch.exp(-cdiff * gamma), 0.0))

    wsum = torch.zeros_like(disp)
    dmin = torch.full_like(disp, float("inf"))
    dmax = torch.full_like(disp, -float("inf"))
    for d_t, wgt in zip(d_taps, w_taps):
        live = wgt > 0.0
        dmin = torch.minimum(dmin, torch.where(live, d_t, float("inf")))
        dmax = torch.maximum(dmax, torch.where(live, d_t, -float("inf")))
        wsum = wsum + wgt
    half = 0.5 * wsum

    # bisection, invariant S(lo) < half <= S(hi)
    lo, hi = dmin - 1.0, dmax
    for _ in range(cfg.bisect_iters):
        mid = 0.5 * (lo + hi)
        s = torch.zeros_like(disp)
        for d_t, wgt in zip(d_taps, w_taps):
            s = s + torch.where(d_t <= mid, wgt, 0.0)
        upper = s >= half
        lo, hi = torch.where(upper, lo, mid), torch.where(upper, mid, hi)

    med = torch.full_like(disp, float("inf"))
    for d_t, wgt in zip(d_taps, w_taps):
        inside = (wgt > 0.0) & (d_t > lo) & (d_t <= hi)
        med = torch.minimum(med, torch.where(inside, d_t, float("inf")))
    med = torch.where(torch.isfinite(med), med, disp)
    return torch.where(occluded, med, disp)
