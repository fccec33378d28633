"""Disparity error metrics on torch tensors and the golden-file loaders
(port of `stereomatch_tpu/eval.py`).

Each metric takes an estimate, a ground truth and an optional bool mask of
pixels to score (default: finite, positive ground truth) on any device,
and returns a Python float. Differences are taken in float32, as in the
JAX package, and averaged in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .io.images import to_numpy

__all__ = [
    "bad_pixel_rate",
    "d1_all",
    "epe",
    "disparity_metrics",
    "load_golden_png",
    "load_kitti_disparity",
    "load_middlebury_pfm",
    "save_middlebury_pfm",
]


def _abs_err(est, gt, valid):
    est = torch.as_tensor(est).float()
    gt = torch.as_tensor(gt, device=est.device).float()
    if valid is None:
        valid = torch.isfinite(gt) & (gt > 0)
    valid = torch.as_tensor(valid, device=est.device).bool()
    g = gt[valid]
    return (est[valid] - g).abs(), g


def _mean(x: torch.Tensor) -> float:
    return float(x.double().mean()) if x.numel() else 0.0


def bad_pixel_rate(est, gt, threshold: float = 1.0, valid=None) -> float:
    """Fraction of scored pixels with |est - gt| > threshold."""
    err, _ = _abs_err(est, gt, valid)
    return _mean(err > threshold)


def d1_all(est, gt, valid=None) -> float:
    """KITTI D1-all: error > 3 px and > 5% of the ground truth."""
    err, g = _abs_err(est, gt, valid)
    return _mean((err > 3.0) & (err > 0.05 * g.abs()))


def epe(est, gt, valid=None) -> float:
    """Mean end-point error over scored pixels."""
    err, _ = _abs_err(est, gt, valid)
    return _mean(err)


def disparity_metrics(est, gt, valid=None) -> dict:
    return {
        "epe": epe(est, gt, valid),
        "bad1": bad_pixel_rate(est, gt, 1.0, valid),
        "bad2": bad_pixel_rate(est, gt, 2.0, valid),
        "bad3": bad_pixel_rate(est, gt, 3.0, valid),
        "d1_all": d1_all(est, gt, valid),
    }


# The loaders read host files into numpy arrays, as the JAX package's do;
# the metrics above take them as they take tensors.


def load_golden_png(path: str, scale: float = 1.0) -> np.ndarray:
    """8-bit golden disparity PNG (the reference's build artifacts,
    written by src/stereo_opencv.cpp:167-168). Values are raw 8-bit
    disparities times an unknown display scale; pass `scale` to undo it."""
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32) * scale


def load_kitti_disparity(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI disp_occ/disp_noc format: uint16 PNG, disparity = value/256,
    0 = invalid. Returns (disparity, valid_mask)."""
    from PIL import Image

    raw = np.asarray(Image.open(path)).astype(np.float32)
    valid = raw > 0
    return raw / 256.0, valid


def load_middlebury_pfm(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Middlebury ground-truth disparity (.pfm, grayscale float): header
    'Pf', 'W H', scale (sign = endianness), rows bottom-to-top. Invalid
    pixels are inf. Returns (disparity, valid_mask)."""
    with open(path, "rb") as f:
        if f.readline().strip() not in (b"Pf",):
            raise ValueError(f"{path}: not a grayscale PFM")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(4 * w * h), dtype=dtype).reshape(h, w)
    disp = np.flipud(data).astype(np.float32)  # PFM rows are bottom-up
    valid = np.isfinite(disp) & (disp > 0)
    return disp, valid


def save_middlebury_pfm(path: str, disp) -> None:
    """Write a grayscale little-endian PFM (inf = invalid) from a numpy
    array or a tensor on any device."""
    disp = to_numpy(disp, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{disp.shape[1]} {disp.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(disp).astype("<f4").tobytes())
