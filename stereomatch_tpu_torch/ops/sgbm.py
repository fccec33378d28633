"""Semi-global matching (port of `stereomatch_tpu/ops/sgbm.py`).

Cost: Birchfield-Tomasi on the clipped x-Sobel image plus a quarter-weight
BT on intensity, block-summed (OpenCV's calcPixelCostBT blend). Aggregation:
the 8-path DP
    Lr(p,d) = C(p,d) + min(Lr(q,d), Lr(q,d±1)+P1, minLr(q)+P2) - minLr(q)
with q = p - r and zero state where q leaves the image. `aggregate_8path`
below is the plain PyTorch twin of the CUDA kernel K1
(`ops/sgbm_cuda.py`, `csrc/sgbm_aggregate.cu`): one pass per direction,
S accumulated in float32 in the same per-pixel order as the kernel, so
the two agree bit for bit. `aggregate_paths` is the same with carries in
and out, the twin of K1's carry entry K1c. `sgbm_disparity` aggregates
through the K1 wrapper, `sgbm_disparity_banded` streams 128-row bands
through K1c's; each wrapper launches its kernel for CUDA tensors and runs
the twin for CPU tensors.

Then WTA, uniqueness ratio, quadratic subpixel and the disp12 cross-check
with its free right-view map (OpenCV's disp2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SGBMConfig
from .cost import shifted_stack
from .filters import box_filter_sum

__all__ = [
    "xsobel_clipped",
    "bt_cost_volume",
    "sgbm_cost_volume",
    "SGBM_DIRECTIONS",
    "aggregate_paths",
    "aggregate_8path",
    "sgbm_disparity",
    "sgbm_disparity_banded",
    "SGBMOutput",
]

_BIG = 1e9  # the JAX module's out-of-range neighbour cost (np.float32(1e9))

# Path directions as (dy, dx) = pixel - predecessor, in the order S is
# accumulated (the order of the JAX Pallas kernels: the downward row pass
# {vertical, from-left, from-right}, the upward row pass, then E and W).
SGBM_DIRECTIONS = {
    8: ((1, 0), (1, 1), (1, -1), (-1, 0), (-1, 1), (-1, -1), (0, 1), (0, -1)),
    5: ((1, 0), (1, 1), (1, -1), (0, 1), (0, -1)),  # MODE_SGBM set
    4: ((1, 0), (-1, 0), (0, 1), (0, -1)),
}


def xsobel_clipped(img: torch.Tensor, cap: int = 63) -> torch.Tensor:
    """OpenCV SGBM prefilter: horizontal Sobel clipped to [-cap, cap] and
    shifted by +cap; border columns neutral (= cap), border rows replicate."""
    img = img.float()
    up = torch.cat([img[:1], img[:-1]], 0)
    dn = torch.cat([img[1:], img[-1:]], 0)

    def lft(a):
        return torch.cat([a.new_zeros(a.shape[0], 1), a[:, :-1]], 1)

    def rgt(a):
        return torch.cat([a[:, 1:], a.new_zeros(a.shape[0], 1)], 1)

    sob = (rgt(img) - lft(img)) * 2.0 + (rgt(up) - lft(up)) + (rgt(dn) - lft(dn))
    out = torch.clamp(sob, -cap, cap) + cap
    w = img.shape[1]
    xs = torch.arange(w, device=img.device)[None, :]
    border = (xs == 0) | (xs == w - 1)
    return torch.where(border, torch.full_like(out, float(cap)), out)


def _bt_terms(row_img: torch.Tensor):
    """Per-pixel (min, max) over {I, floor((I+I_left)/2), floor((I+I_right)/2)}."""
    left_half = torch.floor(0.5 * (row_img + torch.cat([row_img[:, :1], row_img[:, :-1]], 1)))
    right_half = torch.floor(0.5 * (row_img + torch.cat([row_img[:, 1:], row_img[:, -1:]], 1)))
    vmin = torch.minimum(torch.minimum(row_img, left_half), right_half)
    vmax = torch.maximum(torch.maximum(row_img, left_half), right_half)
    return vmin, vmax


def bt_cost_volume(left, right, min_disp: int, num_disp: int) -> torch.Tensor:
    """Symmetric Birchfield-Tomasi cost, left reference:
    cost[y, x, d] = BT(left(x), right(x - d)), edge-clamped columns."""
    lmin, lmax = _bt_terms(left)
    rmin, rmax = _bt_terms(right)
    r, _ = shifted_stack(right, num_disp, -1, min_disp)
    r_min, _ = shifted_stack(rmin, num_disp, -1, min_disp)
    r_max, _ = shifted_stack(rmax, num_disp, -1, min_disp)
    lv = left[:, :, None]
    c0 = torch.clamp(torch.maximum(lv - r_max, r_min - lv), min=0.0)
    del r_min, r_max
    c1 = torch.clamp(torch.maximum(r - lmax[:, :, None], lmin[:, :, None] - r), min=0.0)
    return torch.minimum(c0, c1)


def _pixel_cost(left_gray, right_gray, cfg: SGBMConfig) -> torch.Tensor:
    sl = xsobel_clipped(left_gray, cfg.prefilter_cap)
    sr = xsobel_clipped(right_gray, cfg.prefilter_cap)
    c = bt_cost_volume(sl, sr, cfg.min_disp, cfg.num_disp)
    return c + torch.floor(
        bt_cost_volume(left_gray, right_gray, cfg.min_disp, cfg.num_disp) * 0.25
    )


def _block_sum(c: torch.Tensor, block_size: int) -> torch.Tensor:
    """Block sum with edge-replicated cost at the borders (OpenCV)."""
    r = block_size // 2
    if r == 0:
        return c
    h, w = c.shape[0], c.shape[1]
    ys = torch.clamp(torch.arange(-r, h + r, device=c.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-r, w + r, device=c.device), 0, w - 1)
    pad = c.index_select(0, ys).index_select(1, xs)
    s = box_filter_sum(box_filter_sum(pad, r, 0), r, 1)
    return s[r:-r, r:-r]


def sgbm_cost_volume(left_gray, right_gray, cfg: SGBMConfig) -> torch.Tensor:
    """OpenCV-style SGBM matching cost (H, W, D) in cfg.cost_dtype."""
    c = _block_sum(_pixel_cost(left_gray.float(), right_gray.float(), cfg), cfg.block_size)
    if cfg.cost_dtype != "float32":
        c = c.to(getattr(torch, cfg.cost_dtype))
    return c


def _dp_step(c: torch.Tensor, lp: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """One DP update on (..., D) rows, as the JAX Pallas `_dp_step`."""
    mp = lp.amin(-1, keepdim=True)
    big = lp.new_full(lp.shape[:-1] + (1,), _BIG)
    up = torch.cat([big, lp[..., :-1]], -1)
    dn = torch.cat([lp[..., 1:], big], -1)
    cand = torch.minimum(torch.minimum(lp, up + p1), torch.minimum(dn + p1, mp + p2))
    return (c + cand) - mp


def _direction_pass(c, s, dy: int, dx: int, p1: float, p2: float, lp=None):
    """S += Lr for one direction (in place; s None skips it). c, s: (H, W, D)
    float32. A vertical or diagonal pass starts from `lp`, the (W, D) state
    of the row before its first (zero if None; the predecessor column x -
    dx is read, zero where it leaves the image) and returns its state on
    its last row; a horizontal pass returns None."""
    h, w, d = c.shape
    if dy != 0:
        lp = c.new_zeros(w, d) if lp is None else lp.float()
        zero = c.new_zeros(1, d)
        for y in (range(h) if dy > 0 else range(h - 1, -1, -1)):
            if dx == 1:  # predecessor one column left; zero state at x = 0
                lp = torch.cat([zero, lp[:-1]], 0)
            elif dx == -1:
                lp = torch.cat([lp[1:], zero], 0)
            lp = _dp_step(c[y], lp, p1, p2)
            if s is not None:
                s[y] += lp
        return lp
    lp = c.new_zeros(h, d)
    for x in (range(w) if dx > 0 else range(w - 1, -1, -1)):
        lp = _dp_step(c[:, x], lp, p1, p2)
        s[:, x] += lp
    return None


def aggregate_paths(cost: torch.Tensor, p1: float, p2: float, directions, carry_in=None,
                    carry_out=None, with_s: bool = True) -> torch.Tensor | None:
    """Plain PyTorch twin of K1 and of its carry entry K1c: S = sum over
    `directions` ((dy, dx) pairs, in this order) of Lr, float32 state and
    sum for f32 or bf16 costs; cost (H, W, D) -> S (H, W, D) float32, or
    None without S (with_s=False, an upward sweep that only records its
    carry). carry_in / carry_out: None or (c, W, D) float32, c the number of
    directions with dy != 0, slice j the j-th of them: the state on the row
    before the band's first (in the sweep's order) and the state on its
    last row, written into carry_out."""
    c = cost.float()
    s = torch.zeros_like(c) if with_s else None
    j = 0
    for dy, dx in directions:
        last = _direction_pass(c, s, dy, dx, float(p1), float(p2),
                               None if carry_in is None or dy == 0 else carry_in[j])
        if dy != 0:
            if carry_out is not None:
                carry_out[j].copy_(last)
            j += 1
    return s


def aggregate_8path(cost: torch.Tensor, p1: float, p2: float, num_paths: int = 8) -> torch.Tensor:
    """Plain PyTorch twin of K1: S = sum over `num_paths` (8, 5 or 4)
    directions of Lr, float32 state and sum for f32 or bf16 costs.
    cost (H, W, D) -> S (H, W, D) float32."""
    if num_paths not in SGBM_DIRECTIONS:
        raise ValueError(f"num_paths must be 4, 5 or 8, got {num_paths}")
    return aggregate_paths(cost, p1, p2, SGBM_DIRECTIONS[num_paths])


class SGBMOutput(NamedTuple):
    disparity: torch.Tensor  # float32, invalid = min_disp - 1
    valid: torch.Tensor  # bool
    aggregated: torch.Tensor  # (H, W', D) summed path costs, or empty
    # RIGHT-view disparity by min-cost projection (OpenCV's disp2),
    # integer-valued, invalid = min_disp - 1; None when disp12 is off
    right_disparity: torch.Tensor | None = None


def sgbm_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    cfg: SGBMConfig = SGBMConfig(),
    keep_volume: bool = False,
) -> SGBMOutput:
    """Full SGBM disparity for the LEFT view on the images' device: cost ->
    8-path aggregation (K1 on CUDA, its twin on CPU) -> WTA -> uniqueness
    -> subpixel -> disp12."""
    from .sgbm_cuda import aggregate_8path_cuda

    p1, p2 = cfg.resolved_p1p2()
    c = sgbm_cost_volume(left_gray, right_gray, cfg)
    h, w_full, nd = c.shape
    # OpenCV never evaluates the leftmost min_disp + num_disp columns, so
    # no path carries state in from that margin
    margin = min(cfg.min_disp + nd, w_full)
    s = aggregate_8path_cuda(c[:, margin:].contiguous(), float(p1), float(p2), cfg.num_paths)
    out, valid, rdisp = _select_from_aggregated(s, cfg, margin, w_full)
    agg = s if keep_volume else s.new_zeros((0,))
    return SGBMOutput(out, valid, agg, rdisp)


def _select_from_aggregated(s: torch.Tensor, cfg: SGBMConfig, margin: int, w_full: int):
    """WTA + uniqueness + subpixel + disp12 from an aggregated (H, W', D)
    float32 volume; returns (disparity, valid) padded back to w_full
    columns and the (H, w_full) right-view map."""
    h, w, nd = s.shape
    dev = s.device
    ds = torch.arange(nd, device=dev)[None, None, :]
    min_s = s.amin(-1)
    best = torch.argmin(s, dim=-1)  # first minimum, as jnp.argmin
    b3 = best[..., None]
    zero = s.new_zeros(())
    pre = torch.where(best == 0, zero, s.gather(-1, (b3 - 1).clamp(min=0))[..., 0])
    nxt = torch.where(best == nd - 1, zero, s.gather(-1, (b3 + 1).clamp(max=nd - 1))[..., 0])

    if cfg.uniqueness_ratio > 0:
        bad = (s * (100.0 - cfg.uniqueness_ratio) < min_s[..., None] * 100.0) & (
            torch.abs(ds - b3) > 1
        )
        unique_ok = ~torch.any(bad, dim=-1)
        del bad
    else:
        unique_ok = torch.ones((h, w), dtype=torch.bool, device=dev)

    denom = torch.clamp(pre + nxt - 2.0 * min_s, min=1.0)
    offset = (pre - nxt) * 0.5 / denom
    interior = (best > 0) & (best < nd - 1)
    disp = (best + cfg.min_disp).float() + torch.where(interior, offset, zero)

    if cfg.disp12_max_diff >= 0:
        neg = -(2**20)
        xg = torch.arange(w, device=dev)[None, :] + margin  # global column
        bestd = best + cfg.min_disp
        xr = xg - bestd
        proj_ok = unique_ok & (xr >= 0) & (xr < w_full)
        xr_c = xr.clamp(0, w_full - 1)
        cost_scatter = torch.full((h, w_full), _BIG, device=dev).scatter_reduce(
            1, xr_c, torch.where(proj_ok, min_s, s.new_full((), _BIG)), "amin"
        )
        hit_cost = cost_scatter.gather(1, xr_c)
        is_winner = proj_ok & (min_s <= hit_cost)
        disp2 = torch.full((h, w_full), neg, dtype=torch.int64, device=dev).scatter_reduce(
            1, xr_c, torch.where(is_winner, bestd, torch.full_like(bestd, neg)), "amax"
        )

        def _disp12_fails(dd):
            xr1 = xg - dd
            d2_at = disp2.gather(1, xr1.clamp(0, w_full - 1))
            has = (d2_at > neg) & (xr1 >= 0) & (xr1 < w_full)
            return has & (torch.abs(d2_at - dd) > cfg.disp12_max_diff)

        # OpenCV checks both integer roundings of the subpixel disparity
        lr_ok = ~(
            _disp12_fails(torch.floor(disp).long()) & _disp12_fails(torch.ceil(disp).long())
        )
        rdisp = torch.where(
            disp2 > neg, disp2.float(), s.new_full((), float(cfg.min_disp - 1))
        )
    else:
        lr_ok = torch.ones((h, w), dtype=torch.bool, device=dev)
        rdisp = None

    valid = unique_ok & lr_ok
    invalid_val = float(cfg.min_disp - 1)
    out = torch.where(valid, disp, s.new_full((), invalid_val))
    out = torch.cat([out.new_full((h, margin), invalid_val), out], 1)
    valid = torch.cat([valid.new_zeros((h, margin)), valid], 1)
    return out, valid, rdisp


def _band_cost(lp: torch.Tensor, rp: torch.Tensor, b: int, band_rows: int, h: int, margin: int,
               cfg: SGBMConfig, ctx: int = 3) -> torch.Tensor:
    """Band b's (band_rows, W', D) cost from the edge-padded images' strip
    of band_rows + 2 ctx rows (Sobel 1 + block radius 2): context rows
    outside the image take the edge row's PIXEL cost (the whole image's
    block sum replicates cost rows, not image rows), and rows past h cost
    zero, so the padded last band is transparent to the DP (a zero state
    through zero-cost rows stays zero). Contiguous, in cfg.cost_dtype."""
    dev = lp.device
    n = band_rows + 2 * ctx
    start = b * band_rows
    cpix = _pixel_cost(lp[start:start + n], rp[start:start + n], cfg)
    src = torch.clamp(torch.arange(start - ctx, start - ctx + n, device=dev), 0, h - 1)
    cpix = cpix.index_select(0, torch.clamp(src - (start - ctx), 0, n - 1))
    c = _block_sum(cpix, cfg.block_size)
    del cpix
    if cfg.cost_dtype != "float32":
        c = c.to(getattr(torch, cfg.cost_dtype))
    c = c[ctx:ctx + band_rows, margin:]
    inside = torch.arange(start, start + band_rows, device=dev) < h
    return torch.where(inside[:, None, None], c, c.new_zeros(()))


def sgbm_disparity_banded(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    cfg: SGBMConfig = SGBMConfig(),
    band_rows: int = 128,
    device: torch.device | str = "cuda",
) -> SGBMOutput:
    """sgbm_disparity in bands of `band_rows` rows on `device`, never
    holding the whole (H, W', D) cost or aggregated volume: meant for
    2048x1536x256-scale frames, with memory of a few band volumes. Each
    band's cost is recomputed from an image strip (`_band_cost`), so the
    block sums' float32 prefixes can differ from the whole frame's by 1 ulp
    on a non-integer cost, and a near tie may then resolve differently.

    Two sweeps of K1c (`aggregate_paths_cuda`; its twin on the CPU). The
    upward sweep, from the bottom band, records the {N, NE, NW} carry
    entering each band from below (none for the 5-path set, one direction
    for 4 paths; the top band's outgoing carry is never read, so its up
    launch is skipped). The downward sweep finishes each band in one
    launch (the downward directions from the running carry, the upward
    ones from the recorded carry, E and W inside the band) and reduces it
    at once with `_select_from_aggregated`. Launches: 2 nbands - 1, or
    nbands without upward paths."""
    from .sgbm_cuda import aggregate_paths_cuda

    if cfg.num_paths not in SGBM_DIRECTIONS:
        raise ValueError(f"num_paths must be 4, 5 or 8, got {cfg.num_paths}")
    p1, p2 = (float(p) for p in cfg.resolved_p1p2())
    dirs = SGBM_DIRECTIONS[cfg.num_paths]
    ndir = 3 if cfg.num_paths in (8, 5) else 1
    use_up = cfg.num_paths != 5  # MODE_SGBM has no upward paths
    carried = 2 * ndir if use_up else ndir
    left_gray = torch.as_tensor(left_gray).to(device).float()
    right_gray = torch.as_tensor(right_gray).to(device).float()
    h, w_full = left_gray.shape
    nd = cfg.num_disp
    margin = min(cfg.min_disp + nd, w_full)
    w = w_full - margin
    nbands = -(-h // band_rows)
    ctx = 3
    rows = torch.clamp(torch.arange(-ctx, nbands * band_rows + ctx, device=left_gray.device),
                       0, h - 1)
    lp, rp = left_gray.index_select(0, rows), right_gray.index_select(0, rows)

    def cost(b):
        return _band_cost(lp, rp, b, band_rows, h, margin, cfg, ctx)

    zero = torch.zeros((ndir, w, nd), dtype=torch.float32, device=left_gray.device)
    up_in = [zero] * nbands  # up_in[b]: the upward carry entering band b from below
    if use_up:
        for b in range(nbands - 1, 0, -1):
            up_in[b - 1] = torch.empty_like(zero)
            aggregate_paths_cuda(cost(b), p1, p2, dirs[ndir:2 * ndir], up_in[b], up_in[b - 1],
                                 with_s=False)

    down = zero
    outs, valids, rdisps = [], [], []
    for b in range(nbands):
        carry_in = torch.cat([down, up_in[b]]) if use_up else down
        carry_out = carry_in.new_empty((carried, w, nd))
        s = aggregate_paths_cuda(cost(b), p1, p2, dirs, carry_in, carry_out)
        down = carry_out[:ndir]
        up_in[b] = None  # read once
        out_b, valid_b, rdisp_b = _select_from_aggregated(s, cfg, margin, w_full)
        del s
        outs.append(out_b)
        valids.append(valid_b)
        rdisps.append(rdisp_b)
    out = torch.cat(outs)[:h]
    valid = torch.cat(valids)[:h]
    rdisp = None if rdisps[0] is None else torch.cat(rdisps)[:h]
    return SGBMOutput(out, valid, out.new_zeros((0,)), rdisp)
