"""Debug inspectors (port of `stereomatch_tpu/utils/debug.py`): file-output
equivalents of the reference's mouse-callback viewers (ShowSlice
.cu:4679-4711, ShowWeights :5447-5524, ShowAlpha1 :5111-5176; SURVEY.md
non-goals turn interactive UIs into artifacts). They take tensors on any
device or numpy arrays."""

from __future__ import annotations

import numpy as np

from ..io.images import to_numpy

__all__ = ["save_cost_slice", "save_tree_weights", "save_support_weights"]


def _to_png(path: str, img) -> None:
    from PIL import Image

    img = to_numpy(img, np.float32)
    lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
    scaled = (img - lo) / (hi - lo + 1e-12)
    Image.fromarray((scaled * 255).astype(np.uint8)).save(path)


def save_cost_slice(path: str, volume, d: int) -> None:
    """One disparity slice of an (H, W, D) cost volume as a normalized PNG
    (the reference's ShowSlice click inspector)."""
    _to_png(path, volume[..., d])


def save_tree_weights(path: str, forest_arrays, height: int, width: int) -> None:
    """Per-pixel edge weight to the parent (exp(-gamma*w)) as a PNG — the
    ShowWeights inspector's information, whole-image at once."""
    f = forest_arrays
    img = np.zeros(height * width, np.float32)
    img[to_numpy(f.pixel_of_node)] = to_numpy(f.w_exp)
    _to_png(path, img.reshape(height, width))


def save_support_weights(path: str, alpha1, k: int = 0) -> None:
    """One neighbor plane of NL2TGV support weights (ShowAlpha1)."""
    _to_png(path, alpha1[..., k])
