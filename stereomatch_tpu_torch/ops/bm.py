"""Block matching (StereoBM) with the OpenCV parameter surface (port of
`stereomatch_tpu/ops/bm.py`).

cv::StereoBM as the reference's legacy CLI configures it (preFilterCap 31,
blockSize 9, textureThreshold 10, uniquenessRatio 15, speckle 100/32,
disp12MaxDiff 1; src/stereo_opencv (copy).cpp:258-268), as one pass over
an (H, W, D) SAD volume:

  - prefilter: clipped horizontal Sobel (SGBM's `xsobel_clipped`);
  - cost: window SAD of the prefiltered pair via cumsum box sums;
  - texture: a window sum of |prefiltered - cap| below textureThreshold
    invalidates;
  - WTA with OpenCV's reversed-index tie-break (ties go to the LARGER
    disparity), uniqueness thresh = minSAD + floor(minSAD*ratio/100),
    OpenCV-BM subpixel (p - n) / (p + n - 2*minSAD + |p - n|);
  - disp12 cross-check by min-cost projection, floor/ceil tolerant like
    cv::validateDisparity;
  - border/ROI invalidation matching cv::getValidDisparityROI.

The SAD of integer-valued images is an integer below 2^24, so every box
sum is exact and the result equals the JAX module's bit for bit. Speckle
filtering is ops/speckle.py, applied by the pipeline. Output is float32
disparity; invalid = min_disp - 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import BMConfig
from .cost import shifted_stack
from .sgbm import _block_sum, xsobel_clipped

__all__ = ["bm_disparity", "BMOutput", "valid_disparity_roi"]

_BIG = 1e9  # the JAX module's np.float32(1e9)
_NO_DISP = -(2**20)


class BMOutput(NamedTuple):
    disparity: torch.Tensor  # float32, invalid = min_disp - 1
    valid: torch.Tensor  # bool


def valid_disparity_roi(
    roi1: tuple[int, int, int, int],
    roi2: tuple[int, int, int, int],
    min_disp: int,
    num_disp: int,
    block_size: int,
) -> tuple[int, int, int, int]:
    """cv::getValidDisparityROI: the two rectification valid-pixel ROIs
    intersected with the disparity search band and the block border.
    Returns (x, y, w, h), all zeros when empty."""
    sw2 = block_size // 2
    min_d, max_d = min_disp, min_disp + num_disp - 1
    xmin = max(roi1[0], roi2[0] + max_d) + sw2
    xmax = min(roi1[0] + roi1[2], roi2[0] + roi2[2] + min_d) - sw2
    ymin = max(roi1[1], roi2[1]) + sw2
    ymax = min(roi1[1] + roi1[3], roi2[1] + roi2[3]) - sw2
    if xmax - xmin > 0 and ymax - ymin > 0:
        return (xmin, ymin, xmax - xmin, ymax - ymin)
    return (0, 0, 0, 0)


def bm_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    cfg: BMConfig = BMConfig(),
) -> BMOutput:
    """StereoBM left-view disparity on the images' device (no speckle pass:
    see pipelines)."""
    h, w = left_gray.shape
    nd = cfg.num_disp
    r = cfg.block_size // 2
    cap = float(cfg.prefilter_cap)
    dev = left_gray.device

    pl = xsobel_clipped(left_gray.float(), cfg.prefilter_cap)
    pr = xsobel_clipped(right_gray.float(), cfg.prefilter_cap)
    rstack, _ = shifted_stack(pr, nd, -1, cfg.min_disp)
    # window sums edge-replicated at the borders, which the ROI mask drops
    sad = _block_sum(torch.abs(pl[:, :, None] - rstack), cfg.block_size)
    del rstack
    tsum = _block_sum(torch.abs(pl - cap), cfg.block_size)

    # StereoBM scans disparities in reversed index order: ties go to the
    # larger disparity
    best = nd - 1 - torch.argmin(sad.flip(-1), dim=-1)
    min_s = sad.amin(-1)
    b3 = best[..., None]
    big = sad.new_full((), _BIG)
    pre = torch.where(best == 0, big, sad.gather(-1, (b3 - 1).clamp(min=0))[..., 0])
    nxt = torch.where(best == nd - 1, big, sad.gather(-1, (b3 + 1).clamp(max=nd - 1))[..., 0])
    # sad[-1] := sad[1], sad[nd] := sad[nd-2] (OpenCV's mirror) makes the
    # subpixel offset exactly 0 at the ends
    pre = torch.where(best == 0, nxt, pre)
    nxt = torch.where(best == nd - 1, pre, nxt)

    # uniqueness: thresh = minSAD + floor(minSAD*ratio/100); any d with
    # |d - best| > 1 and SAD <= thresh invalidates
    if cfg.uniqueness_ratio > 0:
        ds = torch.arange(nd, device=dev)[None, None, :]
        thresh = min_s + torch.floor(min_s * (cfg.uniqueness_ratio / 100.0))
        bad = (sad <= thresh[..., None]) & (torch.abs(ds - b3) > 1)
        unique_ok = ~torch.any(bad, dim=-1)
        del bad
    else:
        unique_ok = torch.ones((h, w), dtype=torch.bool, device=dev)
    del sad

    texture_ok = tsum >= float(cfg.texture_threshold)

    # OpenCV BM subpixel: offset = (p - n) / (p + n - 2*minSAD + |p - n|)
    p, n = pre, nxt
    denom = p + n - 2.0 * min_s + torch.abs(p - n)
    offset = torch.where(denom > 0, (p - n) / denom, p.new_zeros(()))
    disp = best + cfg.min_disp + offset

    # valid ROI (cv::getValidDisparityROI): the left margin where some d
    # would read out of the right image, plus the block-radius border
    xs = torch.arange(w, device=dev)[None, :]
    ys = torch.arange(h, device=dev)[:, None]
    roi_ok = (xs >= cfg.min_disp + nd - 1 + r) & (xs < w - r) & (ys >= r) & (ys < h - r)
    if cfg.roi1 is not None and cfg.roi2 is not None:
        rx, ry, rw, rh = valid_disparity_roi(cfg.roi1, cfg.roi2, cfg.min_disp, nd, cfg.block_size)
        roi_ok = roi_ok & (xs >= rx) & (xs < rx + rw) & (ys >= ry) & (ys < ry + rh)

    # disp12 cross-check (cv::validateDisparity semantics): right disparity
    # by min-cost projection of surviving left pixels, then a floor/ceil-
    # tolerant comparison
    if cfg.disp12_max_diff >= 0:
        bestd = best + cfg.min_disp
        xr = xs - bestd
        proj_ok = unique_ok & texture_ok & roi_ok & (xr >= 0)
        xrc = xr.clamp(0, w - 1)
        cost_scatter = torch.full((h, w), _BIG, device=dev).scatter_reduce(
            1, xrc, torch.where(proj_ok, min_s, big), "amin"
        )
        is_winner = proj_ok & (min_s <= cost_scatter.gather(1, xrc))
        no_disp = torch.full_like(bestd, _NO_DISP)
        disp2 = no_disp.scatter_reduce(1, xrc, torch.where(is_winner, bestd, no_disp), "amax")

        def _fails(dd):
            xr1 = xs - dd
            d2_at = disp2.gather(1, xr1.clamp(0, w - 1))
            has = (d2_at > _NO_DISP) & (xr1 >= 0) & (xr1 < w)
            return has & (torch.abs(d2_at - dd) > cfg.disp12_max_diff)

        lr_ok = ~(_fails(torch.floor(disp).long()) & _fails(torch.ceil(disp).long()))
    else:
        lr_ok = torch.ones((h, w), dtype=torch.bool, device=dev)

    valid = unique_ok & texture_ok & roi_ok & lr_ok
    out = torch.where(valid, disp, disp.new_full((), float(cfg.min_disp - 1))).float()
    return BMOutput(out, valid)
