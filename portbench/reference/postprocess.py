# Frozen copy of the part of stereomatch_tpu_torch/ops/postprocess.py that the reference reaches, taken
# when the benchmark was defined, for the benchmark's reference: imports rewritten to this folder,
# every kernel call replaced by its plain PyTorch twin. Do not edit.
"""Post-processing: nearest-valid fill and the left-right consistency check (port of
`stereomatch_tpu/ops/postprocess.py`). Disparities round half to even in
both packages (`torch.round`, `jnp.round`)."""

from __future__ import annotations

import torch

__all__ = ['nearest_valid_columns', 'nearest_valid_fill', 'lr_consistency']


def nearest_valid_columns(valid: torch.Tensor):
    """(xs, left, right) for an (H, W) mask: each pixel's column, the nearest
    valid column at or left of it (-1 if none) and at or right of it (W if
    none), as JAX's cummax and reverse cummin."""
    h, w = valid.shape
    xs = torch.arange(w, device=valid.device).expand(h, w)
    left = torch.cummax(torch.where(valid, xs, -1), dim=1).values
    right = torch.cummin(torch.where(valid, xs, w).flip(1), dim=1).values.flip(1)
    return xs, left, right


def nearest_valid_fill(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill invalid pixels from row neighbours (reference rule,
    src/Stereo3DMST.cpp:676-708): the nearest valid value to the left,
    replaced by the nearest valid value to the right when that is smaller
    (or when there is no left one); 0 when the row has none."""
    w = disp.shape[1]
    _, left_idx, right_idx = nearest_valid_columns(valid)
    has_l = left_idx >= 0
    has_r = right_idx < w
    fl = torch.gather(disp, 1, left_idx.clamp(0, w - 1))
    fr = torch.gather(disp, 1, right_idx.clamp(0, w - 1))
    zero = disp.new_zeros(())
    fill = torch.where(
        has_l & has_r,
        torch.minimum(fl, fr),
        torch.where(has_l, fl, torch.where(has_r, fr, zero)),
    )
    return torch.where(valid, disp, fill)


def lr_consistency(
    left_disp: torch.Tensor,
    right_disp: torch.Tensor,
    max_disp: float,
    max_diff: float = 1.0,
    fill: bool = True,
):
    """Left-view LR check: d = round(left(x)) (half to even) is valid iff
    x - d >= 0, 0 <= d < max_disp and |left(x) - right(x - d)| <= max_diff.
    Invalid pixels are zeroed and, if `fill`, nearest-valid filled.
    Returns (disp, valid)."""
    w = left_disp.shape[1]
    xs = torch.arange(w, device=left_disp.device)[None, :]
    d_round = torch.round(left_disp).long()
    match_x = xs - d_round
    in_range = (match_x >= 0) & (d_round >= 0) & (d_round < max_disp)
    right_at = torch.gather(right_disp, 1, match_x.clamp(0, w - 1))
    valid = in_range & (torch.abs(left_disp - right_at) <= max_diff)
    disp = torch.where(valid, left_disp, left_disp.new_zeros(()))
    if fill:
        disp = nearest_valid_fill(disp, valid)
    return disp, valid


