"""Coupled PatchMatch <-> Huber-ROF alternating engine (port of
`stereomatch_tpu/models/coupled.py::coupled_patchmatch_stereo`; its
`coupled_wta_stereo` needs `ops/tgv.py` and is not ported yet, ROADMAP.md).

The reference scaffolds this alternation inside `PatchMatchStereoNL2TGV`
but never reaches it (goto FREE_RESOURCE at src/PatchMatchStereoGPU.cu:7328
skips :7331-7727). Each outer round runs `smooth_iters` Huber-ROF
primal-dual steps smoothing the (d, nx, ny) fields toward the current
planes (huberROFSmooth, .cu:3903-4073), then one Jacobi PatchMatch round
over the hybrid cost-volume window cost with the coupling to those fields
(stereoMatching_huber, .cu:3273-3581). theta ramps up so the data and the
smoothed fields converge together.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import random as trandom
from ..config import CoupledConfig
from ..ops.coupled import coupled_plane_cost, huber_rof_field_step, init_fields
from ..ops.patchmatch import PlaneState, _gray, _nz, _refine_ladder, _where_planes
from ..ops.select import wta_disparity
from ..ops.variational import edge_weight

__all__ = ["coupled_patchmatch_stereo", "CoupledOutput"]


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
