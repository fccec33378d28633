"""Disparity selection: WTA with parabola subpixel refinement (port of
`stereomatch_tpu/ops/select.py`).

The reference's selectDisparity (src/PatchMatchStereoGPU.cu:1688-1737):
per-pixel argmin over the disparity axis (the first minimum wins ties, as
`torch.argmin` and `jnp.argmin` both give), then a one-shot parabola fit
through (pre, cur, next). At the volume's d-boundaries the missing
neighbour cost is 0.0 (.cu:1722-1725), and the update is subtracted only
where |update| < 1 (.cu:1731-1732).
"""

from __future__ import annotations

import torch

__all__ = ["wta_disparity", "wta_argmin", "wta_coupled"]


def wta_argmin(volume: torch.Tensor) -> torch.Tensor:
    """Plain argmin over the last (disparity) axis, first-minimum ties."""
    return torch.argmin(volume, dim=-1)


def wta_coupled(
    volume: torch.Tensor,
    u: torch.Tensor,
    lagr: torch.Tensor,
    lambda_d: float,
    theta_inv: float,
    min_disp: int = 0,
    subpixel: bool = True,
) -> torch.Tensor:
    """WTA over the augmented-Lagrangian-coupled cost
        lambda_d * C(d) + L * (u - d) + (u - d)^2 / (2 theta)
    (ref: MCCNN_ALTV_CostVolumeWTA, src/PatchMatchStereoGPU.cu:4748-4803)."""
    nd = volume.shape[-1]
    ds = torch.arange(nd, dtype=torch.float32, device=volume.device) + float(min_disp)
    diff = u[..., None] - ds
    coupled = lambda_d * volume + lagr[..., None] * diff + 0.5 * theta_inv * diff * diff
    return wta_disparity(coupled, min_disp, subpixel)


def wta_disparity(
    volume: torch.Tensor, min_disp: int = 0, subpixel: bool = True
) -> torch.Tensor:
    """WTA disparity (float32) from an (H, W, D) cost volume: best_d +
    min_disp - parabola_update. A zero curvature gives inf or nan, which
    the |update| < 1 gate rejects, as the reference's unguarded float
    math does."""
    num_disp = volume.shape[-1]
    best = torch.argmin(volume, dim=-1)
    disp = (best + min_disp).float()
    if not subpixel:
        return disp

    b = best[..., None]
    cur = volume.gather(-1, b)[..., 0]
    pre = volume.gather(-1, (b - 1).clamp(min=0))[..., 0]
    nxt = volume.gather(-1, (b + 1).clamp(max=num_disp - 1))[..., 0]
    zero = volume.new_zeros(())
    pre = torch.where(best == 0, zero, pre)
    nxt = torch.where(best == num_disp - 1, zero, nxt)

    update = (nxt - pre) * 0.5 / (nxt - 2.0 * cur + pre)
    return torch.where(torch.abs(update) < 1.0, disp - update, disp)
