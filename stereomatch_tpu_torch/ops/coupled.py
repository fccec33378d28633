"""Coupled PatchMatch <-> variational data-step ops (port of
`stereomatch_tpu/ops/coupled.py`):

  - `hybrid_plane_cost`: evaluateCost_huber's live branch
    (src/PatchMatchStereoGPU.cu:3033-3271), an adaptive-weight window
    (subsampled stride 5, :3126-3128) whose per-tap data term is a cost
    volume lookup linearly interpolated in d and clamped at 0.5
    (:3189-3203); weights exp(-L1_bgr/5) on [0, 255] colours (:3047);
    out-of-range taps add cost 1.0 with weight 0.7 (:3253-3254);
  - `coupled_plane_cost`: the above plus the coupling
    0.5*(theta_d*(d/Dmax - v)^2 + theta_n*||n - vn||^2)
    (stereoMatching_huber, :3328-3330);
  - `huber_rof_field_step`: one dual and primal Huber-ROF step on the
    (d, nx, ny) fields (:3903-4056), edge weight gp, Huber eps 0.001,
    steps 1/sqrt(8), primal extrapolation 2x_new - x_old.

The alternation itself lives in `models/coupled.py`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import CoupledConfig
from .patchmatch import PlaneState, _l1, _pad_edge, _plane_coeffs
from .variational import _div_bwd, _grad_fwd

__all__ = [
    "hybrid_plane_cost",
    "coupled_plane_cost",
    "HuberFields",
    "init_fields",
    "huber_rof_field_step",
]


def hybrid_plane_cost(
    base_bgr: torch.Tensor,  # (H, W, 3) in [0, 255]
    base_vol: torch.Tensor,  # (H, W, D) matching cost, lower = better
    planes: PlaneState,
    cfg: CoupledConfig,
    sign: int,  # -1 left base (match at x - d), +1 right base
) -> torch.Tensor:
    """Window cost of a plane map against a cost volume, (H, W).

    Per tap (dy, dx) on the subsampled grid (dy outer, dx inner): d_tap from
    the plane; valid iff d_tap in [0, max_disp], the matched column is in
    range and the tap pixel is inside the image; then
        cost += exp(-L1_bgr(center, tap)/gamma) * min(lerp_d(vol[tap]), clamp)
    else cost += oob_cost with weight oob_weight. Slice k is disparity k, so
    the lerp is between floor(d) and floor(d) + 1. The volume is edge-padded
    once a call; each tap gathers its two lerp slices from a view of it."""
    h, w, nd = base_vol.shape
    r = cfg.window_size // 2
    offs = range(-r, r + 1, cfg.tap_stride)
    af, bf, cf, xs, ys = _plane_coeffs(planes)
    bgr_p = _pad_edge(base_bgr, r)
    vol_p = _pad_edge(base_vol, r)

    cost = torch.zeros((h, w), device=base_vol.device)
    wsum = torch.zeros((h, w), device=base_vol.device)
    for dy in offs:
        for dx in offs:
            rows = slice(dy + r, dy + r + h)
            cols = slice(dx + r, dx + r + w)
            d_tap = af * (xs + dx) + bf * (ys + dy) + cf
            mxs = xs + sign * d_tap
            ok = (
                (d_tap >= 0.0)
                & (d_tap <= cfg.max_disp)
                & (mxs >= 0)
                & (mxs < w)
                & (xs + dx >= 0)
                & (xs + dx < w)
                & (ys + dy >= 0)
                & (ys + dy < h)
            )
            weight = torch.exp(-_l1(base_bgr, bgr_p[rows, cols]) / cfg.gamma_pmsh)
            lo = torch.clamp(torch.floor(d_tap).long(), 0, nd - 1)
            hi = torch.clamp(lo + 1, 0, nd - 1)
            frac = torch.clamp(d_tap - lo.float(), 0.0, 1.0)
            tap_vol = vol_p[rows, cols]
            c_lo = torch.gather(tap_vol, 2, lo[..., None])[..., 0]
            c_hi = torch.gather(tap_vol, 2, hi[..., None])[..., 0]
            data = torch.clamp((1.0 - frac) * c_lo + frac * c_hi, max=cfg.clamp)
            cost = cost + torch.where(ok, weight * data, cfg.oob_cost)
            wsum = wsum + torch.where(ok, weight, cfg.oob_weight)
    return cost / wsum


def coupled_plane_cost(
    base_bgr, base_vol, planes: PlaneState, fields, cfg: CoupledConfig,
    sign: int, theta_d, theta_n,
) -> torch.Tensor:
    """lambda * hybrid cost + 0.5*(theta_d*(d/Dmax - v)^2 + theta_n*||n-vn||^2)
    (stereoMatching_huber, .cu:3323-3330). theta_d and theta_n are floats
    or 0-dim float32 tensors."""
    c = cfg.lambda_data * hybrid_plane_cost(base_bgr, base_vol, planes, cfg, sign)
    dn = planes.d / float(cfg.max_disp)
    return c + 0.5 * (
        theta_d * (dn - fields.vd) ** 2
        + theta_n * ((planes.nx - fields.vnx) ** 2 + (planes.ny - fields.vny) ** 2)
    )


class HuberFields(NamedTuple):
    """Smoothed fields and their dual variables (they persist across outer
    rounds, like the reference's device buffers)."""

    vd: torch.Tensor  # (H, W) smoothed disparity in [0, 1]
    vnx: torch.Tensor  # smoothed normal x
    vny: torch.Tensor
    pd: torch.Tensor  # (H, W, 2) disparity dual
    pn: torch.Tensor  # (H, W, 4) normal dual (x/y dirs of nx, then of ny)


def init_fields(d_norm: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor) -> HuberFields:
    z2 = d_norm.new_zeros(d_norm.shape + (2,))
    z4 = d_norm.new_zeros(d_norm.shape + (4,))
    return HuberFields(d_norm, nx, ny, z2, z4)


def huber_rof_field_step(
    st: HuberFields,
    d_data: torch.Tensor,  # (H, W) data disparity in [0, 1]
    nx_data: torch.Tensor,
    ny_data: torch.Tensor,
    weight: torch.Tensor,  # per-pixel edge weight gp
    theta_d,
    theta_n,
    eps: float = 0.001,
    step: float = 1.0 / math.sqrt(8.0),
) -> HuberFields:
    """One dual and primal Huber-ROF step on (vd, vnx, vny) toward the data
    fields (kernels .cu:3903-4056; eps .cu:3938, steps 1/sqrt(8)
    .cu:3940-3941/4046-4047, extrapolation .cu:4053-4056). theta_d and
    theta_n are floats or 0-dim float32 tensors."""
    gp = weight
    gp_inv = 1.0 / gp

    def dual_pair(p2, f):
        dx, dy = _grad_fwd(f)
        t0 = (p2[..., 0] + step * gp * dx) / (1.0 + step * eps * gp_inv)
        t1 = (p2[..., 1] + step * gp * dy) / (1.0 + step * eps * gp_inv)
        norm = torch.clamp(torch.sqrt(t0 * t0 + t1 * t1), min=1.0)
        return torch.stack([t0 / norm, t1 / norm], dim=-1)

    pd = dual_pair(st.pd, st.vd)
    pn = torch.cat([dual_pair(st.pn[..., 0:2], st.vnx), dual_pair(st.pn[..., 2:4], st.vny)], -1)

    def primal(v, p2, data, theta):
        div = _div_bwd(p2[..., 0], p2[..., 1])
        v_t = (v + step * (theta * data + gp * div)) / (1.0 + step * theta)
        return 2.0 * v_t - v

    vd = primal(st.vd, pd, d_data, theta_d)
    vnx = primal(st.vnx, pn[..., 0:2], nx_data, theta_n)
    vny = primal(st.vny, pn[..., 2:4], ny_data, theta_n)
    return HuberFields(vd, vnx, vny, pd, pn)
