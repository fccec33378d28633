"""Speckle filtering: parallel connected components on the disparity image
(port of `stereomatch_tpu/ops/speckle.py`).

cv2.filterSpeckles as the reference's SGBM and BM configure it
(speckleWindowSize=100, speckleRange=32, src/StereoMatching.cpp:156-173;
StereoSGBM::compute passes DISP_SCALE*speckleRange on its 1/16 fixed-point
map, i.e. 32 whole disparities on a float map): 4-connected regions of
pixels whose neighbouring disparities differ by <= max_diff are measured,
and regions of <= max_size pixels are reset to `invalid`.

OpenCV's sequential flood fill becomes label propagation with pointer
jumping: each round takes the min label over connected neighbours, then
compresses twice through label = label[label]. The round count is fixed
(16 by default, as in the JAX module): no round waits on the host.
Labels are int64 flat indices, so they index directly.
"""

from __future__ import annotations

import torch

__all__ = ["connected_components", "component_sizes", "filter_speckles"]

_NO_LINK = 2**30


def connected_components(
    connect_right: torch.Tensor,
    connect_down: torch.Tensor,
    iters: int = 16,
) -> torch.Tensor:
    """Label 4-connected components. connect_right[y, x] joins (y,x)-(y,x+1)
    (shape (H, W-1), or (H, W) with the last column ignored); connect_down
    joins (y,x)-(y+1,x). Returns int64 labels: after enough rounds, the min
    flat index in each component.

    Each round reads exactly the states the JAX round reads: both
    horizontal updates see the labels before either of them, both vertical
    updates the labels after the horizontal ones. The updates build new
    tensors, so no read sees a view that a later write has changed."""
    h, w = connect_right.shape[0], connect_down.shape[1]
    cr = connect_right[:, : w - 1]
    cd = connect_down[: h - 1, :]
    dev = connect_right.device
    lab = torch.arange(h * w, device=dev).reshape(h, w)
    big = torch.full((), _NO_LINK, dtype=lab.dtype, device=dev)
    for _ in range(iters):
        from_right = torch.where(cr, lab[:, 1:], big)
        from_left = torch.where(cr, lab[:, :-1], big)
        lab = torch.cat([torch.minimum(lab[:, :-1], from_right), lab[:, -1:]], 1)
        lab = torch.cat([lab[:, :1], torch.minimum(lab[:, 1:], from_left)], 1)
        from_down = torch.where(cd, lab[1:, :], big)
        from_up = torch.where(cd, lab[:-1, :], big)
        lab = torch.cat([torch.minimum(lab[:-1, :], from_down), lab[-1:, :]], 0)
        lab = torch.cat([lab[:1, :], torch.minimum(lab[1:, :], from_up)], 0)
        flat = lab.reshape(-1)
        flat = flat[flat]  # pointer jump x2: hop doubling
        flat = flat[flat]
        lab = flat.reshape(h, w)
    return lab


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel size of the pixel's component (a histogram of labels, by
    index_add_: unlike bincount on CUDA, it makes no host sync)."""
    flat = labels.reshape(-1)
    counts = torch.zeros_like(flat).index_add_(0, flat, torch.ones_like(flat))
    return counts[flat].reshape(labels.shape)


def filter_speckles(
    disp: torch.Tensor,
    invalid: float,
    max_size: int,
    max_diff: float,
    iters: int = 16,
) -> torch.Tensor:
    """cv2.filterSpeckles semantics: connect 4-neighbours whose disparities
    differ by <= max_diff (both pixels valid, i.e. != invalid); components
    of <= max_size pixels are set to `invalid`."""
    valid = disp != invalid
    dr = torch.abs(disp[:, 1:] - disp[:, :-1])
    dd = torch.abs(disp[1:, :] - disp[:-1, :])
    cr = (dr <= max_diff) & valid[:, 1:] & valid[:, :-1]
    cd = (dd <= max_diff) & valid[1:, :] & valid[:-1, :]
    labels = connected_components(cr, cd, iters)
    keep = valid & (component_sizes(labels) > max_size)
    return torch.where(keep, disp, disp.new_full((), invalid))
