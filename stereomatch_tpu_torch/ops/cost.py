"""Matching-cost construction (port of the AD+gradient part of
`stereomatch_tpu/ops/cost.py`).

Volumes are disparity-last, (H, W, D), as in the JAX package:
  right volume: rvol[y, x, d] = cost(right(y, x), left(y, x + d))
  left  volume: lvol[y, x, d] = cost(left(y, x),  right(y, x - d))
"""

from __future__ import annotations

import torch

from ..config import CostVolumeConfig

__all__ = ["shifted_stack", "bgr_to_gray", "adgrad_bgr_volumes"]


def shifted_stack(img: torch.Tensor, num_disp: int, sign: int, min_disp: int = 0):
    """out[y, x, k] = img[y, x + sign*(min_disp+k)] with edge-clamped
    columns; returns (stack, valid) where valid (W, K) marks in-bounds
    source columns. img is (H, W) or (H, W, C); K is inserted after W."""
    w = img.shape[1]
    dev = img.device
    idx = torch.arange(w, device=dev)[:, None] + sign * (
        min_disp + torch.arange(num_disp, device=dev)
    )[None, :]
    valid = (idx >= 0) & (idx < w)
    return img[:, idx.clamp(0, w - 1)], valid


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BT.601 gray from BGR channel order (0.114 B + 0.587 G + 0.299 R)."""
    return 0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]


def adgrad_bgr_volumes(
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    cfg: CostVolumeConfig = CostVolumeConfig(),
):
    """Truncated-AD + gray-forward-gradient BGR cost volumes:
    cost = 0.11 min(L1_bgr / 3, 7) + 0.89 min(|g_ref - g_match|, 2),
    bad_cost where the match (or its forward-gradient neighbour) leaves
    the image. Images (H, W, 3) float in [0, 255]; returns (lvol, rvol)
    float32 (H, W, D)."""
    num_disp = cfg.num_disp
    w = left_bgr.shape[1]
    dev = left_bgr.device

    def grad_x(gray):
        return torch.diff(gray, dim=1, append=gray[:, -1:])

    gl = grad_x(bgr_to_gray(left_bgr))
    gr = grad_x(bgr_to_gray(right_bgr))

    def volume(ref_bgr, ref_grad, match_bgr, match_grad, sign):
        match_stack, _ = shifted_stack(match_bgr, num_disp, sign, cfg.min_disp)
        grad_stack, _ = shifted_stack(match_grad, num_disp, sign, cfg.min_disp)
        color_l1 = torch.sum(torch.abs(ref_bgr[:, :, None, :] - match_stack), dim=-1)
        del match_stack
        grad_l1 = torch.abs(ref_grad[:, :, None] - grad_stack)
        return cfg.color_weight * torch.clamp(
            color_l1 * (1.0 / 3.0), max=cfg.color_truncation
        ) + cfg.gradient_weight * torch.clamp(grad_l1, max=cfg.gradient_truncation)

    xs = torch.arange(w, device=dev)[:, None]
    ds = cfg.min_disp + torch.arange(num_disp, device=dev)[None, :]
    bad = torch.full((), cfg.bad_cost, dtype=torch.float32, device=dev)

    rvol = volume(right_bgr, gr, left_bgr, gl, +1)
    rvol = torch.where((xs + ds + 1 < w)[None], rvol, bad)
    lvol = volume(left_bgr, gl, right_bgr, gr, -1)
    lvol = torch.where(((xs - ds >= 0) & (xs + 1 < w))[None], lvol, bad)
    return lvol.float(), rvol.float()
