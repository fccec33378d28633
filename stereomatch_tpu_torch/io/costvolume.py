"""mc-cnn raw cost-volume file ingestion (port of
`stereomatch_tpu/io/costvolume.py`).

The reference consumes external CNN matching costs as raw little-endian
float32 files of shape (D, H, W) written by mc-cnn ("left.bin"/"right.bin"),
mmap'd at src/Stereo3DMST.cpp:769-775. NaNs are replaced with 0.5 and values
clamped to <= 0.5 for the accurate network (Stereo3DMST.cpp:785-803); the
fast network's scores in (-1, 1) are rescaled to (c+1)/2 first (the
commented alternative there, and RemoveNanFromCostVolume,
src/PatchMatchStereoGPU.cu:4713-4745, which uses NaN->1.0 and also derives
an ambiguity map = mean cost < 0.8).

This module reads that format into (H, W, D) numpy arrays, disparity last
as every cost volume of the port; the savers take tensors too.
"""

from __future__ import annotations

import numpy as np
import torch

from .images import to_numpy

__all__ = [
    "load_mccnn_volume",
    "save_mccnn_volume",
    "clean_mccnn",
    "ambiguity_map",
]


def load_mccnn_volume(path: str, height: int, width: int, max_disp: int) -> np.ndarray:
    """Read a raw (D, H, W) float32 cost volume and return it as (H, W, D)."""
    vol = np.fromfile(path, dtype=np.float32, count=max_disp * height * width)
    if vol.size != max_disp * height * width:
        raise ValueError(
            f"{path}: expected {max_disp * height * width} floats, got {vol.size}"
        )
    return np.ascontiguousarray(vol.reshape(max_disp, height, width).transpose(1, 2, 0))


def save_mccnn_volume(path: str, vol_hwd) -> None:
    """Write an (H, W, D) volume in the reference's (D, H, W) raw layout."""
    np.ascontiguousarray(to_numpy(vol_hwd, np.float32).transpose(2, 0, 1)).tofile(path)


def clean_mccnn(vol, arch: str = "acrt", nan_value: float = 0.5, clamp: float = 0.5):
    """NaN-clean + normalize an mc-cnn volume, numpy or tensor.

    arch="acrt": scores already in (0,1); NaN->0.5, clamp to <= 0.5
      (ref: Stereo3DMST.cpp:785-803).
    arch="fast": scores in (-1,1); rescale (c+1)/2 then same
      (ref commented line Stereo3DMST.cpp:792; .cu:4713-4745).
    """
    if arch == "fast":
        vol = (vol + 1.0) * 0.5
    if isinstance(vol, np.ndarray):
        return np.minimum(np.where(np.isnan(vol), nan_value, vol), clamp)
    vol = torch.as_tensor(vol)
    vol = torch.where(torch.isnan(vol), torch.tensor(nan_value, dtype=vol.dtype, device=vol.device),
                      vol)
    return torch.clamp(vol, max=clamp)


def ambiguity_map(vol, threshold: float = 0.8):
    """Ambiguity mask = mean cost over disparities < threshold
    (ref: RemoveNanFromCostVolume, src/PatchMatchStereoGPU.cu:4713-4745);
    numpy or tensor."""
    return vol.mean(axis=-1) < threshold
