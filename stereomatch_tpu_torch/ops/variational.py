"""Variational refinement: weighted-Huber primal-dual disparity denoise
(port of `stereomatch_tpu/ops/variational.py`).

The reference's variationalDisparityDenoise (src/PatchMatchStereoGPU.cu:
7809-7940, kernels :1001-1126): a Newcombe-style weighted Huber-ROF on the
[0,1]-normalized disparity,
    min_u  sum w|∇u|_delta + lambda |u - f|_gamma,
with per-pixel edge weight w = exp(-alpha |∇I/255|^beta). Each iteration
is a 4-neighbour stencil of elementwise ops; the loop runs its fixed count
with no host sync and no convergence test, as the JAX `fori_loop` does.
"""

from __future__ import annotations

import torch

from ..config import DenoiseConfig

__all__ = ["edge_weight", "huber_denoise", "variational_disparity_denoise"]


def _grad_fwd(u: torch.Tensor):
    """Forward differences, zero at the last column/row (ref: .cu:1012-1013,
    :1054-1055)."""
    zc = u.new_zeros(u.shape[0], 1)
    zr = u.new_zeros(1, u.shape[1])
    dx = torch.cat([u[:, 1:] - u[:, :-1], zc], 1)
    dy = torch.cat([u[1:, :] - u[:-1, :], zr], 0)
    return dx, dy


def _div_bwd(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence with the reference's boundary rule
    (.cu:1110-1117): first col/row keep p, last col/row take -p[prev]."""
    h, w = px.shape
    div_x = torch.cat(
        [px[:, :1], px[:, 1 : w - 1] - px[:, : w - 2], -px[:, w - 2 : w - 1]], 1
    )
    div_y = torch.cat(
        [py[:1, :], py[1 : h - 1, :] - py[: h - 2, :], -py[h - 2 : h - 1, :]], 0
    )
    return div_x + div_y


def edge_weight(gray: torch.Tensor, alpha: float = 10.0, beta: float = 1.0) -> torch.Tensor:
    """Per-pixel weight exp(-alpha*|∇(I/255)|^beta) (ref:
    perPixelWeightPlusNormalizeImg, .cu:1001-1023). gray in [0, 255]."""
    dx, dy = _grad_fwd(gray * (1.0 / 255.0))
    mag = torch.sqrt(dx * dx + dy * dy)
    return torch.exp(-alpha * torch.abs(mag) ** beta)


def huber_denoise(
    f: torch.Tensor, weight: torch.Tensor, cfg: DenoiseConfig = DenoiseConfig()
) -> torch.Tensor:
    """Primal-dual weighted-Huber denoise of a [0,1] field `f`, dual then
    primal each iteration (.cu:7873-7879):
      q  <- prox( (q + sigma (u - f)) / (1 + sigma gamma), |.| <= lambda )
      p  <- prox( (p + sigma ∇u) / (1 + sigma delta), |.| <= w isotropic )
      u  <- u + 2 tau (div p - lambda q)
    """
    u = f
    q = torch.zeros_like(f)
    px = torch.zeros_like(f)
    py = torch.zeros_like(f)
    one = f.new_ones(())
    for _ in range(cfg.iterations):
        dx, dy = _grad_fwd(u)
        q = (q + cfg.sigma * (u - f)) / (1.0 + cfg.sigma * cfg.gamma)
        q = q / torch.maximum(one, torch.abs(q) / cfg.lam)
        px = (px + cfg.sigma * dx) / (1.0 + cfg.sigma * cfg.delta)
        py = (py + cfg.sigma * dy) / (1.0 + cfg.sigma * cfg.delta)
        norm = torch.maximum(one, torch.sqrt(px * px + py * py) / weight)
        px, py = px / norm, py / norm
        u = u + 2.0 * cfg.tau * (_div_bwd(px, py) - cfg.lam * q)
    return u


def variational_disparity_denoise(
    disp: torch.Tensor,
    gray: torch.Tensor,
    min_disp: int,
    max_disp: int,
    cfg: DenoiseConfig = DenoiseConfig(),
) -> torch.Tensor:
    """The reference host function (.cu:7809-7940): normalize the disparity
    to [0,1] over [min_disp, max_disp] (.cu:1019), run `cfg.iterations`
    primal-dual steps, scale back (.cu:1033-1037). `gray` is the guide
    image in [0, 255]."""
    span = float(max_disp - min_disp)
    f = (disp - float(min_disp)) / span
    w = edge_weight(gray, cfg.alpha, cfg.beta)
    u = huber_denoise(f, w, cfg)
    return u * span + float(min_disp)
