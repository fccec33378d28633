"""Separable box filters, guided filter and the 3x3 median (port of
`stereomatch_tpu/ops/filters.py`).

Same border semantics as the JAX module: `mode="zero"` pads with zeros and
normalizes by a fixed 1/(2r+1); `mode="reflect"` is BORDER_REFLECT_101
(`jnp.pad(mode="reflect")`). Window sums are cumsum differences, like the
JAX version, so results agree to float32 rounding of the cumsum order.
On a CUDA device `guided_filter_volume` is kernel K4
(csrc/guided_filter.cu), whose plain twin is `guided_filter_volume_twin`.
"""

from __future__ import annotations

import torch

__all__ = [
    "box_filter_sum",
    "box_filter",
    "guided_filter_gray",
    "guided_filter_volume",
    "guided_filter_volume_twin",
    "guided_filter_color",
    "median3x3",
]


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


def guided_filter_gray(
    guide: torch.Tensor,
    src: torch.Tensor,
    radius: int,
    eps: float,
    mode: str = "zero",
) -> torch.Tensor:
    """He et al. guided filter with a single-channel (H, W) guide; src is
    (H, W) or (H, W, K), filtered per channel with shared guide stats."""
    g = guide
    squeeze = src.ndim == 2
    p = src[..., None] if squeeze else src
    mean_g = box_filter(g, radius, (0, 1), mode)
    var_g = box_filter(g * g, radius, (0, 1), mode) - mean_g * mean_g
    mean_p = box_filter(p, radius, (0, 1), mode)
    corr_gp = box_filter(g[..., None] * p, radius, (0, 1), mode)
    a = (corr_gp - mean_g[..., None] * mean_p) / (var_g[..., None] + eps)
    b = mean_p - a * mean_g[..., None]
    out = box_filter(a, radius, (0, 1), mode) * g[..., None] + box_filter(
        b, radius, (0, 1), mode
    )
    return out[..., 0] if squeeze else out


def guided_filter_volume(
    guide: torch.Tensor,
    volume: torch.Tensor,
    radius: int,
    eps: float,
    slab: int = 16,
    mode: str = "zero",
) -> torch.Tensor:
    """Guided-filter an (H, W, D) float32 volume, every disparity slice with
    the (H, W) guide, zero padding.

    A CPU tensor runs the plain twin, `guided_filter_volume_twin`, `slab`
    slices at a time. A CUDA tensor launches kernel K4 once
    (csrc/guided_filter.cu: the whole volume, no temporaries but the
    output, so `slab` is not read) or raises: K4 takes float32 contiguous
    operands on one device, 0 <= radius <= 9 and mode "zero" only.
    `guided_filter_volume.launches` counts K4 launches. K4 sums its windows
    directly and by short slides where the twin takes cumsum differences,
    so the two agree to float32 rounding of the window sums."""
    if volume.device.type == "cpu":
        return guided_filter_volume_twin(guide, volume, radius, eps, slab, mode)
    if not volume.is_cuda:
        raise ValueError(f"K4 takes CUDA (or CPU) tensors, got one on {volume.device}")
    if mode != "zero":
        raise ValueError(f"K4 filters with zero padding only, got mode {mode!r}")
    if volume.ndim != 3 or guide.shape != volume.shape[:2]:
        raise ValueError(f"volume must be (H, W, D) and guide (H, W), got "
                         f"{tuple(volume.shape)} and {tuple(guide.shape)}")
    if volume.dtype != torch.float32 or guide.dtype != torch.float32:
        raise TypeError(f"K4 takes float32, got {volume.dtype} and {guide.dtype}")
    if guide.device != volume.device:
        raise ValueError(f"guide on {guide.device}, volume on {volume.device}")
    if not (volume.is_contiguous() and guide.is_contiguous()):
        raise ValueError("volume and guide must be contiguous")
    if not 0 <= int(radius) <= 9:
        raise ValueError(f"K4 takes 0 <= radius <= 9, got {radius}")
    out = torch.empty_like(volume)
    if out.numel() == 0:
        return out
    from .._build import load_kernels

    load_kernels().guided_filter(guide, volume, out, int(radius), float(eps))
    guided_filter_volume.launches += 1
    return out


guided_filter_volume.launches = 0


def guided_filter_volume_twin(
    guide: torch.Tensor,
    volume: torch.Tensor,
    radius: int,
    eps: float,
    slab: int = 16,
    mode: str = "zero",
) -> torch.Tensor:
    """K4's plain twin: guided-filter an (H, W, D) volume `slab` disparity
    slices at a time (guide statistics computed once), bounding peak memory
    to ~2 slabs of temporaries on top of the input and output volumes."""
    h, w, d = volume.shape
    g = guide
    mean_g = box_filter(g, radius, (0, 1), mode)
    var_g = box_filter(g * g, radius, (0, 1), mode) - mean_g * mean_g
    denom = (var_g + eps)[..., None]
    mg = mean_g[..., None]
    g3 = g[..., None]
    out = torch.empty_like(volume)
    for s0 in range(0, d, slab):
        # a ragged last slab filters exactly like a zero-padded one: every
        # op is per slice along D
        p = volume[:, :, s0 : s0 + slab]
        mean_p = box_filter(p, radius, (0, 1), mode)
        corr_gp = box_filter(g3 * p, radius, (0, 1), mode)
        a = (corr_gp - mg * mean_p) / denom
        b = mean_p - a * mg
        out[:, :, s0 : s0 + slab] = box_filter(a, radius, (0, 1), mode) * g3 + box_filter(
            b, radius, (0, 1), mode
        )
    return out


def guided_filter_color(
    guide_rgb: torch.Tensor,
    src: torch.Tensor,
    radius: int,
    eps: float,
    mode: str = "zero",
) -> torch.Tensor:
    """Guided filter with a 3-channel guide: per-pixel 3x3 covariance with
    its explicit inverse (ref: colorGuidedFilterHelper0-5 and the d_inv_* /
    d_cov_det globals, src/PatchMatchStereoGPU.cu:8173-8537, :112-139).
    guide_rgb: (H, W, 3); src: (H, W) or (H, W, K)."""
    squeeze = src.ndim == 2
    p = src[..., None] if squeeze else src
    g = guide_rgb
    mean_g = box_filter(g, radius, (0, 1), mode)  # (H, W, 3)

    def cov(i, j):
        return (
            box_filter(g[..., i] * g[..., j], radius, (0, 1), mode)
            - mean_g[..., i] * mean_g[..., j]
            + (eps if i == j else 0.0)
        )

    c00, c01, c02 = cov(0, 0), cov(0, 1), cov(0, 2)
    c11, c12, c22 = cov(1, 1), cov(1, 2), cov(2, 2)

    # explicit inverse via the adjugate
    i00 = c11 * c22 - c12 * c12
    i01 = c02 * c12 - c01 * c22
    i02 = c01 * c12 - c02 * c11
    i11 = c00 * c22 - c02 * c02
    i12 = c01 * c02 - c00 * c12
    i22 = c00 * c11 - c01 * c01
    inv_det = (1.0 / (c00 * i00 + c01 * i01 + c02 * i02))[..., None]

    mean_p = box_filter(p, radius, (0, 1), mode)  # (H, W, K)
    cov_gp = [
        box_filter(g[..., i : i + 1] * p, radius, (0, 1), mode)
        - mean_g[..., i : i + 1] * mean_p
        for i in range(3)
    ]

    def row(a, b, c):
        return (a[..., None] * cov_gp[0] + b[..., None] * cov_gp[1]
                + c[..., None] * cov_gp[2]) * inv_det

    a0, a1, a2 = row(i00, i01, i02), row(i01, i11, i12), row(i02, i12, i22)
    b = mean_p - a0 * mean_g[..., 0:1] - a1 * mean_g[..., 1:2] - a2 * mean_g[..., 2:3]
    out = (
        box_filter(a0, radius, (0, 1), mode) * g[..., 0:1]
        + box_filter(a1, radius, (0, 1), mode) * g[..., 1:2]
        + box_filter(a2, radius, (0, 1), mode) * g[..., 2:3]
        + box_filter(b, radius, (0, 1), mode)
    )
    return out[..., 0] if squeeze else out


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
