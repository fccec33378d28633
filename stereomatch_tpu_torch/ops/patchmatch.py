"""Slanted-plane PatchMatch stereo as iterated parallel propagation (port of
`stereomatch_tpu/ops/patchmatch.py`).

The reference's two PatchMatch engines (the GPU kernel family,
src/PatchMatchStereoGPU.cu:861-998 evaluateCost, :1740-2010
stereoMatching; the CPU pm::PatchMatch, src/pm.cpp) sweep the image in
raster order. Here every pixel tests, each round, its 4 neighbours' planes
and 4 jump-flooding planes (shifted plane maps of the round's start:
Jacobi, not Gauss-Seidel), the other view's plane at its match column, and
annealed random refinements. The window cost runs on a subsampled tap grid
(cfg.tap_stride) as a loop over taps, one (H, W) map an op, never the
rows*cols*35*35 weight tensor of pm.cpp:447-487.

Every loop count is fixed by the config: no host sync, no early exit. The
random draws are `stereomatch_tpu_torch.random`'s, bit-exact with
jax.random, so one key draws the JAX package's candidates. XLA's CPU
backend contracts some multiply-adds into FMAs and torch does not, so
costs differ from the JAX package's in their last bits (tests hold them
within a stated tolerance).

Planes are stored as (nx, ny, d): unit-normal xy components plus the
disparity at the pixel; nz = sqrt(1 - nx^2 - ny^2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import random as trandom
from ..config import PatchMatchConfig
from .postprocess import nearest_valid_columns
from .segmentation import channel_l1

__all__ = [
    "PlaneState",
    "plane_cost",
    "patchmatch_stereo",
    "planes_to_disparity",
    "plane_fill_occluded",
    "plane_fill_occluded_best_cost",
]

_FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PlaneState(NamedTuple):
    nx: torch.Tensor  # (H, W)
    ny: torch.Tensor
    d: torch.Tensor  # disparity at the pixel (positive, own-view convention)


def _nz(nx, ny):
    return torch.sqrt(torch.clamp(1.0 - nx * nx - ny * ny, min=1e-8))


def planes_to_disparity(p: PlaneState) -> torch.Tensor:
    return p.d


def _where_planes(mask, a: PlaneState, b: PlaneState) -> PlaneState:
    return PlaneState(*(torch.where(mask, x, y) for x, y in zip(a, b)))


def _sample_x(img, xf):
    """Linear interpolation of img (H, W) along x at float columns xf
    (H, W), rows fixed (the reference reads linear-filtered textures)."""
    w = img.shape[1]
    x0 = torch.floor(xf)
    frac = xf - x0
    x0i = torch.clamp(x0.long(), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    return torch.gather(img, 1, x0i) * (1.0 - frac) + torch.gather(img, 1, x1i) * frac


def _pad_edge(a: torch.Tensor, r: int) -> torch.Tensor:
    """Edge padding of the first two axes by r (`jnp.pad(mode="edge")`)."""
    h, w = a.shape[:2]
    iy = torch.clamp(torch.arange(-r, h + r, device=a.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-r, w + r, device=a.device), 0, w - 1)
    return a[iy[:, None], ix[None, :]]


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(|a - b|, -1) in float32: the difference in the storage dtype, the
    channel sum accumulated in float32 and rounded once to the storage
    dtype (as XLA reduces a bf16 sum)."""
    return channel_l1((a - b).float()).to(a.dtype).float()


def _plane_coeffs(p: PlaneState):
    """(af, bf, cf) of d(x, y) = af*x + bf*y + cf through each pixel's plane."""
    h, w = p.d.shape
    nz = _nz(p.nx, p.ny)
    xs = torch.arange(w, dtype=torch.float32, device=p.d.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=p.d.device)[:, None]
    return -p.nx / nz, -p.ny / nz, (p.nx * xs + p.ny * ys + nz * p.d) / nz, xs, ys


def plane_cost(
    base_bgr: torch.Tensor,  # (H, W, 3) in [0, 255]
    base_gray: torch.Tensor,  # (H, W)
    match_gray: torch.Tensor,  # (H, W)
    planes: PlaneState,
    cfg: PatchMatchConfig,
    sign: int,  # -1 left base (match at x - d), +1 right base
    match_bgr: torch.Tensor | None = None,  # needed for metric="adgrad"
    base_grad: torch.Tensor | None = None,  # (H, W, 2) gray gradients
    match_grad: torch.Tensor | None = None,
) -> torch.Tensor:
    """Window cost of a plane map, (H, W).

    metric="grad_sign" (GPU evaluateCost, src/PatchMatchStereoGPU.cu:861-998):
    per tap, adaptive weight exp(-L1_bgr(center, tap)/gamma) and penalty 0.1
    where the base and match gray increments disagree in sign; out-of-range
    taps add 10.0 with weight 1.

    metric="adgrad" (CPU pm::PatchMatch, src/pm.cpp:97-160): the same
    weights, penalty (1-alpha)*min(L1_bgr, tau_c) + alpha*min(L1_grad,
    tau_g) from one 5-channel match feature (colour and gradient) read by
    one gather pair a tap; out-of-range taps cost plane_penalty.

    Taps go dy outer, dx inner, summed in that order; every map is
    edge-padded by the window radius."""
    h, w = base_gray.shape
    r = cfg.window_size // 2
    stride = cfg.tap_stride
    taps = [(dy, dx) for dy in range(-r, r + 1, stride) for dx in range(-r, r + 1, stride)]

    af, bf, cf, xs, ys = _plane_coeffs(planes)
    d_center = af * xs + bf * ys + cf
    match_center_x = xs + sign * d_center
    center_ok = (
        (d_center >= cfg.min_disp)
        & (d_center <= cfg.max_disp)
        & (match_center_x >= 0)
        & (match_center_x < w)
    )
    g_match_c = _sample_x(match_gray, torch.clamp(match_center_x, 0, w - 1))

    # the padded maps are re-read once per tap and candidate; bf16 storage
    # halves those bytes, and the arithmetic returns to float32 after each load
    fdt = _FEATURE_DTYPES[cfg.feature_dtype]
    gray_p = _pad_edge(base_gray, r).to(fdt)
    bgr_p = _pad_edge(base_bgr, r).to(fdt)
    adgrad = cfg.metric == "adgrad"
    if adgrad:
        bgrad_p = _pad_edge(base_grad, r).to(fdt)
        mfeat_p = _pad_edge(torch.cat([match_bgr, match_grad], -1), r).to(fdt)
    else:
        match_p = _pad_edge(match_gray, r).to(fdt)
    base_bgr_f = base_bgr.to(fdt)
    oob_cost = cfg.plane_penalty if adgrad else 10.0

    cost = torch.zeros((h, w), device=base_gray.device)
    wsum = torch.zeros((h, w), device=base_gray.device)
    for dy, dx in taps:
        rows = slice(dy + r, dy + r + h)
        cols = slice(dx + r, dx + r + w)
        base_tap_c = bgr_p[rows, cols]
        d_tap = af * (xs + dx) + bf * (ys + dy) + cf
        mxs = xs + sign * d_tap
        ok = center_ok & (d_tap >= cfg.min_disp) & (d_tap <= cfg.max_disp) & (mxs >= 0) & (mxs < w)
        weight = torch.exp(-_l1(base_bgr_f, base_tap_c) / cfg.gamma)
        mx = torch.clamp(xs + dx + sign * d_tap, 0, w - 1)
        if adgrad:
            feat = mfeat_p[rows, r:r + w]
            x0 = torch.floor(mx)
            frac = (mx - x0)[..., None]
            x0i = torch.clamp(x0.long(), 0, w - 1)[..., None]
            x1i = torch.clamp(x0i + 1, 0, w - 1)
            v0 = torch.gather(feat, 1, x0i.expand(h, w, 5)).float()
            v1 = torch.gather(feat, 1, x1i.expand(h, w, 5)).float()
            m_feat = v0 * (1.0 - frac) + v1 * frac
            c_l1 = channel_l1(base_tap_c.float() - m_feat[..., :3])
            g_l1 = channel_l1(bgrad_p[rows, cols].float() - m_feat[..., 3:])
            penalty = ((1.0 - cfg.alpha) * torch.clamp(c_l1, max=cfg.tau_c)
                       + cfg.alpha * torch.clamp(g_l1, max=cfg.tau_g))
        else:
            match_tap = _sample_x(match_p[rows, r:r + w].float(), mx)
            base_tap_g = gray_p[rows, cols].float()
            disagree = (base_gray - base_tap_g) * (g_match_c - match_tap) < 0.0
            penalty = torch.where(disagree, 0.1, 0.0)
        cost = cost + torch.where(ok, weight * penalty, oob_cost)
        wsum = wsum + torch.where(ok, weight, 1.0)
    return cost / wsum


def plane_fill_occluded(planes: PlaneState, valid: torch.Tensor) -> torch.Tensor:
    """Occlusion fill with planes: each invalid pixel takes the nearest valid
    pixel's plane on its row from the left and the right, extends both to
    its own (x, y) and keeps the lower disparity (background wins), as the
    reference's fill (pm.cpp:367-392). Returns the disparity map."""
    nx, ny, d = planes
    h, w = d.shape
    xs, left_idx, right_idx = nearest_valid_columns(valid)
    ys = torch.arange(h, device=d.device)[:, None].expand(h, w)

    def extend(src_idx):
        sx = torch.clamp(src_idx, 0, w - 1)
        snx, sny, sd = (torch.gather(a, 1, sx) for a in (nx, ny, d))
        nz = _nz(snx, sny)
        af, bf = -snx / nz, -sny / nz
        cf = (snx * sx + sny * ys + nz * sd) / nz
        return af * xs + bf * ys + cf

    d_l = extend(left_idx)
    d_r = extend(right_idx)
    has_l, has_r = left_idx >= 0, right_idx < w
    fill = torch.where(
        has_l & has_r,
        torch.minimum(d_l, d_r),
        torch.where(has_l, d_l, torch.where(has_r, d_r, 0.0)),
    )
    return torch.where(valid, d, fill)


def plane_fill_occluded_best_cost(
    planes: PlaneState,
    valid: torch.Tensor,
    base_bgr: torch.Tensor,
    base_gray: torch.Tensor,
    match_gray: torch.Tensor,
    cfg: PatchMatchConfig,
    sign: int,
    k: int = 4,
    match_bgr: torch.Tensor | None = None,
    base_grad: torch.Tensor | None = None,
    match_grad: torch.Tensor | None = None,
) -> torch.Tensor:
    """GPU-style occlusion fill (ref fillInOccluded,
    src/PatchMatchStereoGPU.cu:2190-2224): each occluded pixel takes the
    valid donor whose plane has the lowest window cost at this pixel; the
    donor's own disparity is used, not plane-extended. The donors are the
    k nearest valid pixels on each side of the row (the j-th found by
    re-reading the first-nearest scan one column past the (j-1)-th), within
    +-W/4 as in the reference; a pixel with no donor in range gets 0.
    Returns the filled disparity map."""
    nx, ny, d = planes
    h, w = d.shape
    xs, l1, r1 = nearest_valid_columns(valid)
    max_reach = w // 4

    donor_idx = []
    lj, rj = l1, r1
    for _ in range(k):
        donor_idx += [lj, rj]
        lj = torch.where(lj > 0, torch.gather(l1, 1, torch.clamp(lj - 1, 0, w - 1)), -1)
        rj = torch.where(rj < w - 1, torch.gather(r1, 1, torch.clamp(rj + 1, 0, w - 1)), w)

    best_cost = torch.full((h, w), 1e10, device=d.device)
    best_disp = torch.zeros((h, w), device=d.device)
    for idx in donor_idx:
        in_range = (idx >= 0) & (idx < w) & (torch.abs(idx - xs) <= max_reach)
        sx = torch.clamp(idx, 0, w - 1)
        cand = PlaneState(*(torch.gather(a, 1, sx) for a in (nx, ny, d)))
        c = plane_cost(base_bgr, base_gray, match_gray, cand, cfg, sign,
                       match_bgr=match_bgr, base_grad=base_grad, match_grad=match_grad)
        c = torch.where(in_range, c, 1e10)
        better = c < best_cost
        best_cost = torch.where(better, c, best_cost)
        best_disp = torch.where(better, cand.d, best_disp)
    return torch.where(valid, d, best_disp)


def _view_transform(other: PlaneState, sign: int, w: int) -> PlaneState:
    """Plane candidates from the other view: each pixel takes the other
    view's plane at x + sign*round(d_other(x)), the other view's disparity
    read at the same column (ref view propagation, .cu:1799-1827, :1802)."""
    xs = torch.arange(w, device=other.d.device)[None, :]
    mx = torch.clamp(xs + sign * torch.round(other.d).long(), 0, w - 1)
    return PlaneState(*(torch.gather(a, 1, mx) for a in other))


def _gray(bgr: torch.Tensor) -> torch.Tensor:
    return 0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]


def _grad2(g: torch.Tensor) -> torch.Tensor:
    """Central-difference gray gradients, one-sided at the borders
    (`jnp.gradient`; the role of pm.cpp's Sobel/8, pm.cpp:70-88), (H, W, 2)."""
    gy, gx = torch.gradient(g)
    return torch.stack([gx, gy], dim=-1)


def _rand_init(key: torch.Tensor, h: int, w: int, cfg: PatchMatchConfig) -> PlaneState:
    """Random planes: d uniform in [min_disp, max_disp), the normal from a
    uniform point of the unit disc lifted to the hemisphere (ref
    .cu:2782-2799)."""
    k1, k2, k3 = trandom.split(key, 3)
    d = trandom.uniform(k1, (h, w), minval=cfg.min_disp, maxval=cfg.max_disp)
    rr = torch.sqrt(trandom.uniform(k2, (h, w)))
    th = trandom.uniform(k3, (h, w)) * (2 * math.pi)
    x1, x2 = rr * torch.cos(th), rr * torch.sin(th)
    s = torch.sqrt(torch.clamp(1.0 - x1 * x1 - x2 * x2, min=0.0))
    return PlaneState(2.0 * x1 * s, 2.0 * x2 * s, d)


def _refine_ladder(max_disp: float):
    """(disparity delta, normal delta) per refinement level: halving from
    (max_disp/2, 1) while the disparity delta is >= 0.1 (the GPU kernels'
    bound, .cu:1835; `ops/mst.py::refine_deltas` stops at > 0.1)."""
    out = []
    md, mn = 0.5 * max_disp, 1.0
    while md >= 0.1:
        out.append((md, mn))
        md, mn = md * 0.5, mn * 0.5
    return out


def _jump_schedule(h: int, w: int, iters: int) -> list[int]:
    """Jump-flooding distances: max(H, W)/4 halving down to 2, cycled when
    the rounds outnumber the levels."""
    m = max(h, w) // 4
    levels = [max(2, m >> k) for k in range(max(1, m.bit_length() - 1))]
    return [levels[k % len(levels)] for k in range(iters)]


class _Views:
    """The pair's images and gray maps (and gradients for adgrad): the cost
    of a plane map for either view."""

    def __init__(self, left_bgr, right_bgr, cfg: PatchMatchConfig):
        self.bgr = (left_bgr, right_bgr)
        self.gray = (_gray(left_bgr), _gray(right_bgr))
        self.grad = ((_grad2(self.gray[0]), _grad2(self.gray[1])) if cfg.metric == "adgrad"
                     else (None, None))
        self.cfg = cfg

    def cost(self, planes: PlaneState, base: int) -> torch.Tensor:
        """Cost of `planes` with view `base` (0 left, sign -1; 1 right, +1)."""
        other = 1 - base
        return plane_cost(self.bgr[base], self.gray[base], self.gray[other], planes, self.cfg,
                          -1 if base == 0 else 1, match_bgr=self.bgr[other],
                          base_grad=self.grad[base], match_grad=self.grad[other])


def _init_state(key: torch.Tensor, views: _Views, cfg: PatchMatchConfig):
    """(left, right, cost_l, cost_r, kloop) from the key: random planes per
    view and their costs."""
    h, w = views.gray[0].shape
    kl, kr, kloop = trandom.split(key, 3)
    left = _rand_init(kl, h, w, cfg)
    right = _rand_init(kr, h, w, cfg)
    return left, right, views.cost(left, 0), views.cost(right, 1), kloop


def _update_view(key_i, jump: int, planes: PlaneState, cost, other: PlaneState, base: int,
                 views: _Views, ladder):
    """One view's share of a round: 4 neighbour and 4 jump planes (shifts of
    the round-start `planes`, each extended to this pixel), the other view's
    plane, then the annealed refinements; a candidate replaces the current
    plane where its cost is lower."""
    cfg = views.cfg
    sign = -1 if base == 0 else 1
    h, w = planes.d.shape
    state = (planes, cost)

    def try_candidate(st, cand: PlaneState):
        pl, c = st
        c_new = views.cost(cand, base)
        better = c_new < c
        return _where_planes(better, cand, pl), torch.where(better, c_new, c)

    xs = torch.arange(w, dtype=torch.float32, device=planes.d.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=planes.d.device)[:, None]
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1),
                   (jump, 0), (-jump, 0), (0, jump), (0, -jump)):
        nb = PlaneState(*(torch.roll(a, (dy, dx), dims=(0, 1)) for a in planes))
        nz = _nz(nb.nx, nb.ny)
        # the plane through the neighbour's (x - dx, y - dy), extended to (x, y)
        af, bf = -nb.nx / nz, -nb.ny / nz
        cf = (nb.nx * (xs - dx) + nb.ny * (ys - dy) + nz * nb.d) / nz
        state = try_candidate(state, PlaneState(nb.nx, nb.ny, af * xs + bf * ys + cf))

    state = try_candidate(state, _view_transform(other, sign, w))

    for j, (dd, dn) in enumerate(ladder):
        pl, _ = state
        u = trandom.uniform(trandom.fold_in(key_i, j), (4, h, w), minval=-1.0, maxval=1.0)
        nd = pl.d + u[0] * dd
        nx = pl.nx + u[1] * dn
        ny = pl.ny + u[2] * dn
        nz0 = _nz(pl.nx, pl.ny) + u[3] * dn
        norm = torch.sqrt(nx * nx + ny * ny + nz0 * nz0)
        nx, ny = nx / norm, ny / norm
        ok = (nd >= cfg.min_disp) & (nd <= cfg.max_disp) & (nx * nx + ny * ny < 1.0)
        state = try_candidate(state, _where_planes(ok, PlaneState(nx, ny, nd), pl))
    return state


def _round(key_i, jump: int, left, right, cost_l, cost_r, views: _Views, ladder):
    """One round: the left view first, then the right view, whose view
    propagation reads the new left planes."""
    k1, k2 = trandom.split(key_i)
    left, cost_l = _update_view(k1, jump, left, cost_l, right, 0, views, ladder)
    right, cost_r = _update_view(k2, jump, right, cost_r, left, 1, views, ladder)
    return left, right, cost_l, cost_r


def patchmatch_stereo(
    key: torch.Tensor,
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    cfg: PatchMatchConfig = PatchMatchConfig(),
    iterations: int | None = None,
):
    """Run PatchMatch on a rectified BGR pair in [0, 255] (float32 tensors on
    the key's device). Returns (left: PlaneState, right: PlaneState,
    left_cost, right_cost). The rounds follow the reference loop
    (.cu:2810-2826) with Jacobi propagation instead of in-place sweeps;
    refinement deltas anneal by halving within each round (.cu:1831-1884)."""
    iters = cfg.iterations if iterations is None else iterations
    h, w = left_bgr.shape[:2]
    views = _Views(left_bgr, right_bgr, cfg)
    left, right, cost_l, cost_r, kloop = _init_state(key, views, cfg)
    ladder = _refine_ladder(cfg.max_disp)
    keys = trandom.split(kloop, iters)
    for i, jump in enumerate(_jump_schedule(h, w, iters)):
        left, right, cost_l, cost_r = _round(keys[i], jump, left, right, cost_l, cost_r, views,
                                             ladder)
    return left, right, cost_l, cost_r
