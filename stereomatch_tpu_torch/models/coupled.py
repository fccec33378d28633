"""Coupled data <-> variational alternating engines (port of
`stereomatch_tpu/models/coupled.py`).

The reference scaffolds both alternations inside `PatchMatchStereoNL2TGV`
but never reaches them (goto FREE_RESOURCE at src/PatchMatchStereoGPU.cu:7328
skips :7331-7727):

  1. `coupled_patchmatch_stereo`: each outer round runs `smooth_iters`
     Huber-ROF primal-dual steps smoothing the (d, nx, ny) fields toward
     the current planes (huberROFSmooth, .cu:3903-4073), then one Jacobi
     PatchMatch round over the hybrid cost-volume window cost with the
     coupling to those fields (stereoMatching_huber, .cu:3273-3581). theta
     ramps up so the data and the smoothed fields converge together.
  2. `coupled_wta_stereo`, the non-window branch (.cu:7473-7476): TGV-2
     smoothing of u with the augmented-Lagrangian coupling (AL_TGV_*,
     .cu:4491-4663), then the coupled WTA over the volume, lambda_d C(d) +
     L (u - d) + (u - d)^2 / (2 theta) (MCCNN_ALTV_CostVolumeWTA,
     .cu:4748-4803), the multiplier update L += (u - a) theta_inv / 2
     (.cu:4643-4655) and theta_inv growing by 1 / (1 - beta i) a round
     (.cu:7532).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import random as trandom
from ..config import CoupledConfig
from ..ops.coupled import coupled_plane_cost, huber_rof_field_step, init_fields
from ..ops.patchmatch import PlaneState, _gray, _nz, _refine_ladder, _where_planes
from ..ops.select import wta_coupled, wta_disparity
from ..ops.tgv import TGVParams, diffusion_tensor, tgv_dual_primal_step
from ..ops.variational import edge_weight

__all__ = ["coupled_patchmatch_stereo", "coupled_wta_stereo", "CoupledOutput"]


class CoupledOutput(NamedTuple):
    disparity: torch.Tensor  # (H, W) in [0, max_disp]
    smoothed: torch.Tensor  # the variational field v (same units)
    planes: PlaneState | None


def _coupled_update(key_i, planes, fields, bgr, vol, cfg, sign, theta_d, theta_n):
    """One Jacobi data-step round (stereoMatching_huber, .cu:3273-3581): the
    current label re-scored from scratch (the coupling target moves every
    round, and min_cost restarts at 1e10, .cu:3306), its 8 neighbours'
    planes at face value (the neighbour's d used at this pixel, no plane
    extension, .cu:3316-3325), then annealed refinement on PatchMatch's
    ladder (.cu:3383-3443), whose draw assigns u as (d, nz, nx, ny).
    Returns (planes, cost)."""
    h, w = planes.d.shape

    def cost_of(p):
        return coupled_plane_cost(bgr, vol, p, fields, cfg, sign, theta_d, theta_n)

    def try_candidate(state, cand):
        pl, c = state
        c_new = cost_of(cand)
        better = c_new < c
        return _where_planes(better, cand, pl), torch.where(better, c_new, c)

    state = (planes, cost_of(planes))
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)):
        cand = PlaneState(*(torch.roll(a, (dy, dx), dims=(0, 1)) for a in planes))
        state = try_candidate(state, cand)

    for j, (dd, s) in enumerate(_refine_ladder(cfg.max_disp)):
        pl, _ = state
        u = trandom.uniform(trandom.fold_in(key_i, j), (4, h, w), minval=-1.0, maxval=1.0)
        nd = pl.d + u[0] * dd
        nz0 = _nz(pl.nx, pl.ny) + u[1] * s
        nx = pl.nx + u[2] * s
        ny = pl.ny + u[3] * s
        norm = torch.sqrt(nx * nx + ny * ny + nz0 * nz0)
        nx, ny = nx / norm, ny / norm
        ok = (nd >= 0.0) & (nd <= cfg.max_disp) & (nx * nx + ny * ny < 1.0)
        state = try_candidate(state, _where_planes(ok, PlaneState(nx, ny, nd), pl))
    return state


def _theta_schedule(start: float, end: float, n: int) -> list[float]:
    """start + (end - start) * it / max(n - 1, 1) for it < n, in float32 as
    XLA computes the JAX package's `start + (end - start) * (it / k)`: it
    folds the two constants into (end - start) / k, so the default ramp is
    5, 10, ..., 50 exactly (the literal order gives 30.000002 at it = 5)."""
    f32 = np.float32
    coef = f32(end - start) / f32(max(n - 1, 1))
    return [float(f32(start) + f32(it) * coef) for it in range(n)]


def coupled_patchmatch_stereo(
    key: torch.Tensor,
    base_bgr: torch.Tensor,  # (H, W, 3) [0, 255]
    base_vol: torch.Tensor,  # (H, W, D) matching cost
    cfg: CoupledConfig = CoupledConfig(),
    sign: int = -1,
) -> CoupledOutput:
    """Single-view coupled PatchMatch <-> Huber-ROF alternation, on the
    key's device. Returns disparities in [0, max_disp]; `smoothed` is the
    variational field (what the reference's unreached loop would output,
    .cu:7320)."""
    h, w = base_vol.shape[:2]
    dev = base_vol.device
    _, kloop = trandom.split(key)

    # fronto-parallel planes at the volume's WTA (the reference warm-starts
    # with uncoupled PMS rounds, .cu:7334-7371)
    d0 = torch.clamp(wta_disparity(base_vol, 0), 0.0, float(cfg.max_disp))
    zero = torch.zeros((h, w), device=dev)
    planes = PlaneState(zero, zero, d0)
    gp = edge_weight(_gray(base_bgr))
    fields = init_fields(d0 / float(cfg.max_disp), planes.nx, planes.ny)

    n = cfg.outer_iterations
    # 0-dim float32 tensors filled on the card (a host copy would sync)
    full = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    thetas = zip(_theta_schedule(cfg.theta_d_start, cfg.theta_d_end, n),
                 _theta_schedule(cfg.theta_n_start, cfg.theta_n_end, n))
    for it, (td, tn) in enumerate(thetas):
        theta_d, theta_n = full(td), full(tn)
        d_data = planes.d / float(cfg.max_disp)
        for _ in range(cfg.smooth_iters):
            fields = huber_rof_field_step(fields, d_data, planes.nx, planes.ny, gp, theta_d,
                                          theta_n, cfg.huber_eps)
        planes, _ = _coupled_update(trandom.fold_in(kloop, it), planes, fields, base_bgr,
                                    base_vol, cfg, sign, theta_d, theta_n)
    return CoupledOutput(planes.d, torch.clamp(fields.vd, 0.0, 1.0) * float(cfg.max_disp),
                         planes)


def _theta_inv_schedule(theta_inv0: float, beta: float, n: int) -> list[float]:
    """theta_inv of each of n rounds, in float32 as XLA computes the JAX
    package's carried `theta_inv / max(1 - beta * i, 0.05)`: it contracts
    1 - beta * i into one fused multiply-add (the product of a float32 and
    a small integer and its difference from 1 are exact in float64, so
    rounding that once to float32 is the FMA's result), then divides
    correctly rounded."""
    f32 = np.float32
    out, th = [], f32(theta_inv0)
    with np.errstate(over="ignore"):  # a long schedule overflows to inf, as in float32
        for i in range(n):
            out.append(float(th))
            den = max(f32(1.0 - float(f32(beta)) * i), f32(0.05))
            th = f32(th / den)
    return out


def coupled_wta_stereo(
    base_vol: torch.Tensor,  # (H, W, D)
    guide_gray: torch.Tensor,  # (H, W) [0, 255]
    cfg: CoupledConfig = CoupledConfig(),
    tgv_params: TGVParams = TGVParams(),
    tgv: bool = True,
    device: torch.device | str = "cuda",
) -> CoupledOutput:
    """AL-TGV <-> coupled-WTA alternation (the reference loop's live
    non-window branch, .cu:7405-7534) on `device`: from the volume's WTA,
    cfg.outer_iterations rounds of cfg.smooth_iters TGV steps of u, the
    coupled WTA re-selection of a, the multiplier update and theta's
    annealing. All fields live in [0, 1] (the reference normalises by Dmax,
    .cu:6941-6952); returns (a, u) in pixels, no planes."""
    base_vol = torch.as_tensor(base_vol).to(device)
    guide_gray = torch.as_tensor(guide_gray).to(device)
    max_d = float(base_vol.shape[-1] - 1)
    g = diffusion_tensor(guide_gray * (1.0 / 255.0), None, tgv_params.tensor_a,
                         tgv_params.tensor_b)
    g00, g01, g11 = g[..., 0], g[..., 1], g[..., 3]
    planes = (g00, g01, g01, g11)  # the JAX engine uses g01 for both off-diagonals

    a = wta_disparity(base_vol, 0) / max_d
    z = torch.zeros_like(a)
    u, lagr, v, p, q = a, z, (z, z), (z, z), (z, z, z, z)
    # 0-dim float32 tensors filled on the card (a host copy would sync)
    full = lambda x: torch.full((), x, dtype=torch.float32, device=device)  # noqa: E731
    for th in _theta_inv_schedule(cfg.theta_inv0, cfg.beta_anneal, cfg.outer_iterations):
        theta_inv = full(th)
        for _ in range(cfg.smooth_iters):
            u, v, p, q = tgv_dual_primal_step(u, v, p, q, lagr, a, planes, theta_inv,
                                              tgv_params, tgv)
        # u and L live in [0, 1] units while wta_coupled's d axis is in
        # pixels: L scales by 1/max_d and theta_inv by 1/max_d^2
        a = wta_coupled(base_vol, u * max_d, lagr / max_d, cfg.lambda_d,
                        theta_inv / (max_d * max_d), 0) / max_d
        a = torch.clamp(a, 0.0, 1.0)
        lagr = lagr + (u - a) * 0.5 * theta_inv
    return CoupledOutput(a * max_d, u * max_d, None)
