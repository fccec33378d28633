"""Bilinear remap on torch tensors: the per-frame half of rectification
(port of `stereomatch_tpu/geometry/remap.py`).

Equivalent of cv::remap(..., INTER_LINEAR, BORDER_CONSTANT) as the
reference uses it (src/stereo_opencv.cpp:128-129, src/stereo_Yin.cpp:146-147):
four gathers on the image's device, with taps outside the source image
contributing `border_value`.
"""

from __future__ import annotations

import torch

__all__ = ["remap_bilinear"]


def remap_bilinear(src: torch.Tensor, mapx: torch.Tensor, mapy: torch.Tensor,
                   border_value: float = 0.0) -> torch.Tensor:
    """Sample `src` (H, W) or (H, W, C) at float coords (mapx, mapy) with
    bilinear interpolation and constant border, on src's device. The four
    taps blend in the JAX function's order."""
    h, w = src.shape[0], src.shape[1]
    squeeze = src.dim() == 2
    img = src[..., None] if squeeze else src
    mapx = torch.as_tensor(mapx, device=img.device)
    mapy = torch.as_tensor(mapy, device=img.device)

    x0f = torch.floor(mapx)
    y0f = torch.floor(mapy)
    fx = (mapx - x0f).to(img.dtype)
    fy = (mapy - y0f).to(img.dtype)
    x0 = x0f.long()
    y0 = y0f.long()
    border = torch.tensor(border_value, dtype=img.dtype, device=img.device)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]  # (H', W', C)
        return torch.where(valid[..., None], vals, border)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)

    wx = fx[..., None]
    wy = fy[..., None]
    out = (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )
    return out[..., 0] if squeeze else out
