"""Non-local second-order TGV (NL2TGV) refinement (port of
`stereomatch_tpu/ops/nltgv.py`).

The reference's NL2TGV kernel family (src/PatchMatchStereoGPU.cu):
InitNL2TGV (:4805-4826), InitAlpha1 (:4829-4871), NL2TGV_primalUpdate
(:4874-4955), NL2TGV_dualUpdate (:4958-5103), with the kernels' diagonal
preconditioning (sigma_p = sigma_q = 1/2, tau_u = 1/(2 n), tau_w = 1/(4 n)).

Support: the causal half of a (2r+1)^2 neighbourhood, n = 2r(r+1) offsets
(n = 12 at r = 2). Each pixel i holds a scalar dual p(i, j) and a 2-vector
dual q(i, j) toward each half-neighbour j, as (H, W, n) and (H, W, n, 2)
planes; the mirrored contributions make the full neighbourhood's
divergence. Support weights alpha1(i, j) = exp(-||c_i - c_j|| w_ci -
dist(i, j) w_pi) (ref :4865). The reference's loop is dead code (.cu:7328);
`nl2tgv_refine` is its live equivalent, a standalone refiner of a [0, 1]
field, a fixed Python loop with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["NL2TGVParams", "nl2tgv_refine", "support_weights"]


class NL2TGVParams(NamedTuple):
    support_radius: int = 2
    lambda_s: float = 0.2
    lambda_a: float = 8.0
    w_ci: float = 25.5  # color similarity (images scaled to [0,1])
    w_pi: float = 0.5  # proximity = 1/support_radius by default
    theta_inv: float = 2.0
    iterations: int = 100
    tgv: bool = True
    lagrangian: bool = False


def _offsets(r: int) -> list[tuple[int, int]]:
    """The causal half-neighbourhood (dy, dx): dy in [0, r], dx in [-r, r],
    without (0, dx <= 0)."""
    offs = [(h, w) for h in range(r + 1) for w in range(-r, r + 1)]
    return offs[r + 1:]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = x[y + dy, x + dx], zero out of bounds; x is (H, W, ...)."""
    h, w = x.shape[0], x.shape[1]
    pad = [0, 0] * (x.ndim - 2) + [max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)]
    xp = F.pad(x, pad)
    y0, x0 = dy + max(0, -dy), dx + max(0, -dx)
    return xp[y0:y0 + h, x0:x0 + w]


def _in_bounds(h: int, w: int, offs, device) -> torch.Tensor:
    """(H, W, n) bool: the half-neighbour (y + dy, x + dx) lies in the image."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return torch.stack([(ys + dy < h) & (xs + dx >= 0) & (xs + dx < w) for dy, dx in offs], -1)


def support_weights(bgr01: torch.Tensor, params: NL2TGVParams) -> torch.Tensor:
    """alpha1 (H, W, n): exp(-||dc||_2 w_ci - dist w_pi), 0 where the
    neighbour leaves the image (InitAlpha1, .cu:4829-4871)."""
    h, w = bgr01.shape[:2]
    offs = _offsets(params.support_radius)
    inb = _in_bounds(h, w, offs, bgr01.device)
    planes = []
    for k, (dy, dx) in enumerate(offs):
        cdiff = torch.sqrt(torch.sum((bgr01 - _shift(bgr01, dy, dx)) ** 2, -1))
        dist = (dy * dy + dx * dx) ** 0.5
        a = torch.exp(-cdiff * params.w_ci - dist * params.w_pi)
        planes.append(torch.where(inb[..., k], a, 0.0))
    return torch.stack(planes, -1)


def nl2tgv_refine(u0: torch.Tensor, bgr: torch.Tensor,
                  params: NL2TGVParams = NL2TGVParams()) -> torch.Tensor:
    """NL2TGV refinement of a [0, 1] field u0 guided by a BGR image in
    [0, 255], on u0's device. Returns the refined field. The data field of
    the coupling is u0 itself."""
    h, w = u0.shape
    offs = _offsets(params.support_radius)
    n = len(offs)
    alpha1 = support_weights(torch.as_tensor(bgr, device=u0.device).float() / 255.0, params)
    a_field = u0
    sigma_p = sigma_q = 0.5
    tau_u = 1.0 / (2.0 * n)
    tau_w = 1.0 / (4.0 * n)
    inb = _in_bounds(h, w, offs, u0.device)
    bound_p = alpha1 * params.lambda_s
    bound_q = (params.lambda_a * bound_p)[..., None]

    z = torch.zeros_like(u0)
    u, wx, wy, lagr = u0, z, z, z
    p = u0.new_zeros((h, w, n))
    q = u0.new_zeros((h, w, n, 2))
    for _ in range(params.iterations):
        # ---- dual update, one half-neighbour j a plane ----
        new_p, new_q = [], []
        for k, (dy, dx) in enumerate(offs):
            pk = p[..., k] + sigma_p * (_shift(u, dy, dx) - u - dx * wx - dy * wy)
            new_p.append(torch.where(inb[..., k], pk, 0.0))
            if params.tgv:
                qx = q[..., k, 0] + sigma_q * (_shift(wx, dy, dx) - wx)
                qy = q[..., k, 1] + sigma_q * (_shift(wy, dy, dx) - wy)
                new_q.append(torch.stack([torch.where(inb[..., k], qx, 0.0),
                                          torch.where(inb[..., k], qy, 0.0)], -1))
        p_new = torch.stack(new_p, -1)
        norm_p = torch.sqrt(torch.sum(p_new * p_new, -1, keepdim=True))
        p_new = p_new / torch.clamp(norm_p / torch.clamp(bound_p, min=1e-20), min=1.0)
        p_new = torch.where(bound_p > 0, p_new, 0.0)
        if params.tgv:
            q_new = torch.stack(new_q, -2)  # (H, W, n, 2)
            norm_q = torch.sqrt(torch.sum(q_new * q_new, (-2, -1), keepdim=True))
            q_new = q_new / torch.clamp(norm_q / torch.clamp(bound_q, min=1e-20), min=1.0)
            q_new = torch.where(bound_q > 0, q_new, 0.0)
        else:
            q_new = q

        # ---- primal update: the non-local divergence ----
        div_p, div_qx, div_qy = z, z, z
        for k, (dy, dx) in enumerate(offs):
            pk = p_new[..., k]
            div_p = div_p + pk - _shift(pk, -dy, -dx)
            if params.tgv:
                div_qx = div_qx + q_new[..., k, 0] + dx * pk - _shift(q_new[..., k, 0], -dy, -dx)
                div_qy = div_qy + q_new[..., k, 1] + dy * pk - _shift(q_new[..., k, 1], -dy, -dx)

        u_t = (u + tau_u * div_p - tau_u * lagr + tau_u * params.theta_inv * a_field) / (
            1.0 + tau_u * params.theta_inv)
        u_new = 2.0 * torch.clamp(u_t, 0.0, 1.0) - u
        if params.tgv:
            wx_t = wx + tau_w * div_qx
            wy_t = wy + tau_w * div_qy
            wx, wy = 2.0 * wx_t - wx, 2.0 * wy_t - wy
        if params.lagrangian:
            lagr = lagr + (u_new - a_field) * 0.5 * params.theta_inv
        u, p, q = u_new, p_new, q_new
    return u
