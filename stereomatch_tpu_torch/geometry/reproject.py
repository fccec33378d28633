"""Disparity -> 3D reprojection with the Q matrix (port of
`stereomatch_tpu/geometry/reproject.py`).

Equivalent of cv::reprojectImageTo3D (call sites src/stereo_opencv.cpp:177,
src/stereo_Yin.cpp:223): [X Y Z W]^T = Q @ [x y d 1]^T, output XYZ/W.
Q-matrix scaling for resized pairs mirrors
StereoMatching::scaleStereoPairQMatrix (src/StereoMatching.cpp:195-209).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["reproject_image_to_3d", "scale_q"]


def reproject_image_to_3d(
    disparity: torch.Tensor,
    Q: np.ndarray,
    handle_missing: bool = False,
    missing_z: float = 10000.0,
) -> torch.Tensor:
    """(H, W) disparity -> (H, W, 3) XYZ in float32 on the disparity's
    device. With handle_missing=True, pixels with disparity <= 0 get Z =
    missing_z (OpenCV marks missing points with a large Z)."""
    h, w = disparity.shape
    dev = disparity.device
    q = torch.as_tensor(np.asarray(Q), dtype=torch.float32).to(dev)
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    d = disparity.float()
    X = q[0, 0] * x + q[0, 1] * y + q[0, 2] * d + q[0, 3]
    Y = q[1, 0] * x + q[1, 1] * y + q[1, 2] * d + q[1, 3]
    Z = q[2, 0] * x + q[2, 1] * y + q[2, 2] * d + q[2, 3]
    Wc = q[3, 0] * x + q[3, 1] * y + q[3, 2] * d + q[3, 3]
    w_inv = torch.where(Wc != 0, 1.0 / Wc, Wc.new_zeros(()))
    xyz = torch.stack([X * w_inv, Y * w_inv, Z * w_inv], dim=-1)
    if handle_missing:
        bad = (d <= 0)[..., None]
        xyz = torch.where(bad, torch.tensor([0.0, 0.0, missing_z], device=dev), xyz)
    return xyz


def scale_q(Q: np.ndarray, scale: float) -> np.ndarray:
    """Scale Q for images resized by `scale` (rows 0..2, last column)."""
    q = np.asarray(Q, dtype=np.float64).copy()
    q[:3, 3] *= scale
    return q
