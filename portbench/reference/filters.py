# Frozen copy of the part of stereomatch_tpu_torch/ops/filters.py that the reference reaches, taken
# when the benchmark was defined, for the benchmark's reference: imports rewritten to this folder,
# every kernel call replaced by its plain PyTorch twin. Do not edit.
"""Separable box filters and the 3x3 median (port of
`stereomatch_tpu/ops/filters.py`).

Same border semantics as the JAX module: `mode="zero"` pads with zeros and
normalizes by a fixed 1/(2r+1); `mode="reflect"` is BORDER_REFLECT_101
(`jnp.pad(mode="reflect")`). Window sums are cumsum differences, like the
JAX version, so results agree to float32 rounding of the cumsum order.
"""

from __future__ import annotations

import torch

__all__ = ['box_filter_sum', 'box_filter', 'median3x3']


def _zero_pad(x: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    parts = []
    for n in (before, after):
        shape = list(x.shape)
        shape[axis] = n
        parts.append(x.new_zeros(shape))
    return torch.cat([parts[0], x, parts[1]], dim=axis)


def _reflect101(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    dev = x.device  # built there: a host-to-device copy would sync
    idx = torch.cat([
        torch.arange(radius, 0, -1, device=dev),
        torch.arange(n, device=dev),
        torch.arange(n - 2, n - 2 - radius, -1, device=dev),
    ])
    return x.index_select(axis, idx)


def box_filter_sum(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Windowed sum over a (2*radius+1) window along `axis`, zero padding."""
    if radius == 0:
        return x
    n = x.shape[axis]
    c = torch.cumsum(_zero_pad(x, axis, radius + 1, radius), dim=axis)
    return c.narrow(axis, 2 * radius + 1, n) - c.narrow(axis, 0, n)


def box_filter(
    x: torch.Tensor,
    radius: int,
    axes: tuple[int, ...] = (0, 1),
    mode: str = "zero",
) -> torch.Tensor:
    """Separable box *mean* filter along `axes` ("zero" or "reflect")."""
    scale = 1.0 / (2 * radius + 1)
    out = x
    if mode == "zero":
        for ax in axes:
            out = box_filter_sum(out, radius, ax) * scale
        return out
    if mode == "reflect":
        for ax in axes:
            n = out.shape[ax]
            c = torch.cumsum(_reflect101(out, radius, ax), dim=ax)
            c = _zero_pad(c, ax, 1, 0)
            out = (c.narrow(ax, 2 * radius + 1, n) - c.narrow(ax, 0, n)) * scale
        return out
    raise ValueError(f"unknown box filter mode {mode!r}")



# optimal 9-element median network (19 compare-exchanges), as in the JAX op
_MEDIAN9 = (
    (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4),
    (6, 7), (0, 3), (3, 6), (1, 4), (4, 7), (2, 5), (5, 8), (1, 3),
    (5, 7), (2, 6), (4, 6), (2, 4), (2, 3), (4, 5),
)


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median with replicated borders (cv::medianBlur ksize=3) on an
    (H, W) or (H, W, C) tensor."""
    h, w = x.shape[0], x.shape[1]
    ys = torch.clamp(torch.arange(-1, h + 1, device=x.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-1, w + 1, device=x.device), 0, w - 1)
    xp = x.index_select(0, ys).index_select(1, xs)
    taps = [xp[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    for i, j in _MEDIAN9:
        taps[i], taps[j] = torch.minimum(taps[i], taps[j]), torch.maximum(taps[i], taps[j])
    return taps[4]
