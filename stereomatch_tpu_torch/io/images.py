"""Host-side image I/O and color conversion (port of
`stereomatch_tpu/io/images.py`).

Replaces the reference's lodepng path (`loadPNG`/`savePNG`/`imgCharToFloat`,
src/PatchMatchStereoGPU.cu:9414-9477, include/lodepng.h) and cv::imread /
imwrite usage with PIL-backed loading, as the JAX package does. Images are
float32 numpy arrays in [0, 255], channel-last RGB. The savers take numpy
arrays or tensors on any device; the color helpers work on either.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

__all__ = [
    "load_image",
    "save_image",
    "save_disparity_png",
    "to_gray",
    "to_planar",
    "normalize01",
]

# OpenCV BGR2GRAY weights; the reference computes gray as
# 0.114*B + 0.587*G + 0.299*R (src/PatchMatchStereoGPU.cu:1531-1539).
_GRAY_R, _GRAY_G, _GRAY_B = 0.299, 0.587, 0.114


def to_numpy(x, dtype=None) -> np.ndarray:
    """A host numpy array of `x`: a tensor on any device (copied to the
    host; bfloat16 as float32), or anything np.asarray takes."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x, dtype=dtype)


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32. RGB (H, W, 3) in [0,255], or (H, W) gray."""
    img = Image.open(path)
    if gray:
        img = img.convert("L")
        return np.asarray(img, dtype=np.float32)
    img = img.convert("RGB")
    return np.asarray(img, dtype=np.float32)


def save_image(path: str, img) -> None:
    arr = np.clip(np.round(to_numpy(img)), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def save_disparity_png(path: str, disp, max_disp: float | None = None) -> None:
    """Save a disparity map as 8-bit PNG, scaled by 255/max_disp (the
    reference writes 8-bit disparity PNGs: build/left_disparity.png)."""
    d = to_numpy(disp, np.float32)
    if max_disp is None:
        max_disp = float(d.max()) or 1.0
    save_image(path, d * (255.0 / max_disp))


def to_gray(rgb):
    """Luma conversion with OpenCV weights, on numpy arrays or tensors:
    (..., H, W, 3) -> (..., H, W)."""
    return _GRAY_R * rgb[..., 0] + _GRAY_G * rgb[..., 1] + _GRAY_B * rgb[..., 2]


def to_planar(rgb):
    """(H, W, C) -> (C, H, W) planar float, numpy or tensor (ref:
    imgCharToFloat, src/PatchMatchStereoGPU.cu:9456-9477)."""
    if isinstance(rgb, torch.Tensor):
        return rgb.movedim(-1, 0).contiguous()
    return np.ascontiguousarray(np.moveaxis(rgb, -1, 0))


def normalize01(img):
    return img * (1.0 / 255.0)
