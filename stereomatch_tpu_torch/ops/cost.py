"""Matching-cost construction: census, AD+gradient BGR, ZNCC/AD/AGD
volumes (port of `stereomatch_tpu/ops/cost.py`).

Volumes are disparity-last, (H, W, D), as in the JAX package:
  right volume: rvol[y, x, d] = cost(right(y, x), left(y, x + d))
  left  volume: lvol[y, x, d] = cost(left(y, x),  right(y, x - d))

The census Hamming cost packs the ternary codes into bitplanes, as the JAX
module does, but in int64 words of 63 taps (the sign bit stays clear, so
`>>` shifts in zeros) and counts bits with a masked SWAR popcount, since
torch has no popcount. The volume is accumulated word by word into one
int32 (H, W, D) tensor: the JAX module's (H, W, D, words) shifted stacks
are never built.
"""

from __future__ import annotations

import torch

from ..config import CensusConfig, CostVolumeConfig, ZNCCConfig
from .filters import box_filter

__all__ = [
    "shifted_stack",
    "local_contrast",
    "bgr_to_gray",
    "ternary_census_planes",
    "census_cost_volumes",
    "census_stereo",
    "adgrad_bgr_volumes",
    "windowed_volumes",
]

_WORD_TAPS = 63  # census taps per int64 word; bit 63 stays 0


def shifted_stack(img: torch.Tensor, num_disp: int, sign: int, min_disp: int = 0):
    """out[y, x, k] = img[y, x + sign*(min_disp+k)] with edge-clamped
    columns; returns (stack, valid) where valid (W, K) marks in-bounds
    source columns. img is (H, W) or (H, W, C); K is inserted after W."""
    w = img.shape[1]
    dev = img.device
    idx = torch.arange(w, device=dev)[:, None] + sign * (
        min_disp + torch.arange(num_disp, device=dev)
    )[None, :]
    valid = (idx >= 0) & (idx < w)
    return img[:, idx.clamp(0, w - 1)], valid


def local_contrast(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Subtract the local box mean (ref: the zero-mean pre-pass of the cost
    pipeline, src/PatchMatchStereoGPU.cu:8936-8961)."""
    return img - box_filter(img, radius, (0, 1), mode="zero")


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BT.601 gray from BGR channel order (0.114 B + 0.587 G + 0.299 R)."""
    return 0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]


# ---------------------------------------------------------------------------
# Ternary census
# ---------------------------------------------------------------------------


def _census_offsets(win_rw: int, win_rh: int):
    return [
        (dy, dx)
        for dy in range(-win_rh, win_rh + 1)
        for dx in range(-win_rw, win_rw + 1)
        if not (dy == 0 and dx == 0)
    ]


def ternary_census_planes(
    img: torch.Tensor, win_rw: int = 4, win_rh: int = 8, epsilon: float = 0.0045
):
    """Ternary census transform packed into two bitplanes.

    For each window offset o the code is +1 / 0 / -1 as I(p+o) - I(p)
    compares against ±epsilon (ref: src/StereoMatching.cpp:76-93, on
    intensities in [0, 1]); each window is centred on its own pixel, as in
    the JAX module. Plane `pos` packs (code == +1), `neg` packs
    (code == -1), so two codes differ iff (pos_a ^ pos_b) | (neg_a ^ neg_b)
    has the tap's bit set. Border taps use edge padding.

    Returns (pos, neg): each (H, W, n_words) int64 with
    n_words = ceil(n_offsets / 63).
    """
    offsets = _census_offsets(win_rw, win_rh)
    h, w = img.shape[:2]
    dev = img.device
    ys = torch.arange(-win_rh, h + win_rh, device=dev).clamp(0, h - 1)
    xs = torch.arange(-win_rw, w + win_rw, device=dev).clamp(0, w - 1)
    padded = img.index_select(0, ys).index_select(1, xs)
    n_words = -(-len(offsets) // _WORD_TAPS)
    pos = torch.zeros((h, w, n_words), dtype=torch.int64, device=dev)
    neg = torch.zeros((h, w, n_words), dtype=torch.int64, device=dev)
    for bit, (dy, dx) in enumerate(offsets):
        diff = padded[dy + win_rh : dy + win_rh + h, dx + win_rw : dx + win_rw + w] - img
        word, shift = divmod(bit, _WORD_TAPS)
        pos[..., word] |= (diff > epsilon).long() << shift
        neg[..., word] |= (diff < -epsilon).long() << shift
    return pos, neg


def _popcount63(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 words (SWAR); returns int32."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).int()


def _hamming_volume(ref_planes, match_planes, sign: int, num_disp: int, n_taps: int):
    """cost[y, x, d] = Hamming distance between ref's code at x and match's
    code at x + sign*d (edge-clamped), n_taps where that column leaves the
    image. Accumulated word by word into one int32 (H, W, D) volume."""
    pos_a, neg_a = ref_planes
    pos_b, neg_b = match_planes
    h, w, n_words = pos_a.shape
    cost = torch.zeros((h, w, num_disp), dtype=torch.int32, device=pos_a.device)
    valid = None
    for k in range(n_words):
        pb, valid = shifted_stack(pos_b[..., k], num_disp, sign)
        diff = pb ^ pos_a[..., k, None]
        del pb
        nb, _ = shifted_stack(neg_b[..., k], num_disp, sign)
        diff |= nb ^ neg_a[..., k, None]
        del nb
        cost += _popcount63(diff)
        del diff
    return torch.where(valid[None], cost, torch.full_like(cost, n_taps))


def census_cost_volumes(
    left: torch.Tensor, right: torch.Tensor, cfg: CensusConfig = CensusConfig()
):
    """Ternary-census Hamming cost volumes for both views.

    left/right: (H, W) gray in [0, 1]. Returns (lvol, rvol), each (H, W, D)
    int32 with D = d_max + 1; out-of-range disparities get the max cost
    (the number of window taps)."""
    n_taps = (2 * cfg.win_rw + 1) * (2 * cfg.win_rh + 1) - 1
    pl = ternary_census_planes(left, cfg.win_rw, cfg.win_rh, cfg.epsilon)
    pr = ternary_census_planes(right, cfg.win_rw, cfg.win_rh, cfg.epsilon)
    num_disp = cfg.d_max + 1
    # right reference matches left at x + d; left reference matches right at x - d
    rvol = _hamming_volume(pr, pl, +1, num_disp, n_taps)
    lvol = _hamming_volume(pl, pr, -1, num_disp, n_taps)
    return lvol, rvol


def census_stereo(
    left: torch.Tensor, right: torch.Tensor, cfg: CensusConfig = CensusConfig()
) -> torch.Tensor:
    """Right-image integer WTA disparity (int32) from the ternary census
    cost, with the reference's valid interior (rows win_rh..H-win_rh-1,
    cols win_rw..W-win_rw-d_max-1; everything else 0,
    src/StereoMatching.cpp:52-59), first-minimum ties. Only the right
    volume is built: the left one is not read."""
    n_taps = (2 * cfg.win_rw + 1) * (2 * cfg.win_rh + 1) - 1
    pl = ternary_census_planes(left, cfg.win_rw, cfg.win_rh, cfg.epsilon)
    pr = ternary_census_planes(right, cfg.win_rw, cfg.win_rh, cfg.epsilon)
    rvol = _hamming_volume(pr, pl, +1, cfg.d_max + 1, n_taps)
    del pl, pr
    disp = torch.argmin(rvol, dim=-1).int()
    h, w = left.shape[:2]
    ys = torch.arange(h, device=left.device)[:, None]
    xs = torch.arange(w, device=left.device)[None, :]
    interior = (
        (ys >= cfg.win_rh)
        & (ys < h - cfg.win_rh)
        & (xs >= cfg.win_rw)
        & (xs < w - cfg.win_rw - cfg.d_max)
    )
    return torch.where(interior, disp, torch.zeros_like(disp))


# ---------------------------------------------------------------------------
# Pixelwise truncated AD + gradient BGR cost (the production volume cost)
# ---------------------------------------------------------------------------


def _grad_x(gray: torch.Tensor) -> torch.Tensor:
    """Forward x-difference, 0 at the last column."""
    return torch.diff(gray, dim=1, append=gray[:, -1:])


def adgrad_bgr_volumes(
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    cfg: CostVolumeConfig = CostVolumeConfig(),
):
    """Truncated-AD + gray-forward-gradient BGR cost volumes:
    cost = 0.11 min(L1_bgr / 3, 7) + 0.89 min(|g_ref - g_match|, 2),
    bad_cost where the match (or its forward-gradient neighbour) leaves
    the image. Images (H, W, 3) float in [0, 255]; returns (lvol, rvol)
    float32 (H, W, D)."""
    num_disp = cfg.num_disp
    w = left_bgr.shape[1]
    dev = left_bgr.device
    gl = _grad_x(bgr_to_gray(left_bgr))
    gr = _grad_x(bgr_to_gray(right_bgr))

    def volume(ref_bgr, ref_grad, match_bgr, match_grad, sign):
        match_stack, _ = shifted_stack(match_bgr, num_disp, sign, cfg.min_disp)
        grad_stack, _ = shifted_stack(match_grad, num_disp, sign, cfg.min_disp)
        color_l1 = torch.sum(torch.abs(ref_bgr[:, :, None, :] - match_stack), dim=-1)
        del match_stack
        grad_l1 = torch.abs(ref_grad[:, :, None] - grad_stack)
        return cfg.color_weight * torch.clamp(
            color_l1 * (1.0 / 3.0), max=cfg.color_truncation
        ) + cfg.gradient_weight * torch.clamp(grad_l1, max=cfg.gradient_truncation)

    xs = torch.arange(w, device=dev)[:, None]
    ds = cfg.min_disp + torch.arange(num_disp, device=dev)[None, :]
    bad = torch.full((), cfg.bad_cost, dtype=torch.float32, device=dev)

    rvol = volume(right_bgr, gr, left_bgr, gl, +1)
    rvol = torch.where((xs + ds + 1 < w)[None], rvol, bad)
    lvol = volume(left_bgr, gl, right_bgr, gr, -1)
    lvol = torch.where(((xs - ds >= 0) & (xs + 1 < w))[None], lvol, bad)
    return lvol.float(), rvol.float()


# ---------------------------------------------------------------------------
# Windowed gray costs: ZNCC / truncated AD / AD+gradient
# ---------------------------------------------------------------------------


def windowed_volumes(
    left_gray: torch.Tensor, right_gray: torch.Tensor, cfg: ZNCCConfig = ZNCCConfig()
):
    """Windowed gray cost volumes over a (2r+1)^2 box
    (ref: buildCostVolumeSharedMemory, src/PatchMatchStereoGPU.cu:1298-1479).

    metric="zncc": cost = -sum(ref*match) / (N * rms(ref) * rms(match))
      over the window (the reference's un-centred "ZNCC").
    metric="ad":   sum of min(|ref - match|, 7) over the window.
    metric="agd":  sum of 0.1*min(|ref-match|,7) + 0.9*min(|grad diff|,2).

    Window sums are cumsum box filters; out-of-range entries get
    N*bad_cost (.cu:1410, :1420). Returns (lvol, rvol) float32."""
    r = cfg.win_radius
    n = float((2 * r + 1) ** 2)
    num_disp = cfg.max_disp - cfg.min_disp + 1
    w = left_gray.shape[1]
    dev = left_gray.device

    def win_sum(x):
        return box_filter(x, r, (0, 1), mode="zero") * n if r else x

    def volume(ref, match, sign):
        match_stack, _ = shifted_stack(match, num_disp, sign, cfg.min_disp)
        if cfg.metric == "zncc":
            prod = win_sum(ref[:, :, None] * match_stack)
            ref_ss = win_sum(ref * ref)[:, :, None]
            match_ss = win_sum(match_stack * match_stack)
            denom = n * torch.sqrt(ref_ss / n) * torch.sqrt(match_ss / n)
            return -prod / torch.clamp(denom, min=1e-20)
        if cfg.metric == "ad":
            return win_sum(torch.clamp(torch.abs(ref[:, :, None] - match_stack), max=7.0))
        if cfg.metric == "agd":
            gref = _grad_x(ref)
            gstack, _ = shifted_stack(_grad_x(match), num_disp, sign, cfg.min_disp)
            return win_sum(
                0.1 * torch.clamp(torch.abs(ref[:, :, None] - match_stack), max=7.0)
                + 0.9 * torch.clamp(torch.abs(gref[:, :, None] - gstack), max=2.0)
            )
        raise ValueError(f"unknown windowed metric {cfg.metric!r}")

    xs = torch.arange(w, device=dev)[:, None]
    ds = cfg.min_disp + torch.arange(num_disp, device=dev)[None, :]
    sentinel = torch.full((), n * cfg.bad_cost, dtype=torch.float32, device=dev)

    rvol = volume(right_gray, left_gray, +1)
    rvol = torch.where((xs + ds + r + 1 < w)[None], rvol, sentinel)
    lvol = volume(left_gray, right_gray, -1)
    lvol = torch.where((xs - ds - r >= 0)[None], lvol, sentinel)
    return lvol.float(), rvol.float()
