"""Second-order TGV refinement with an anisotropic diffusion tensor (port
of `stereomatch_tpu/ops/tgv.py`).

The reference's AL-TGV kernel family (src/PatchMatchStereoGPU.cu):
anisotropicDiffusionTensorG (:4412-4487), AL_TGV_dualUpdate (:4491-4552),
AL_TGV_computeGp (:4554-4566), AL_TGV_primalUpdate (:4568-4641),
AL_TGV_augmentedLagranianUpdate (:4643-4655), Init2TGV (:4657-4663), with
the production steps tau_p = tau_q = 1/2, tau_u = 1/4, tau_v = 1/8
(.cu:6807-6810). The reference's loop is dead code (after the goto at
.cu:7328); `tgv2_refine` is its live equivalent, a standalone denoiser of a
[0, 1] disparity field coupled to its input. The LSD line mask
(cv::createLineSegmentDetector, .cu:6368-6400) has a gradient-magnitude
stand-in, `line_response`; `lsd_line_mask` is the exact one, on the host
with cv2.

Every step is a 4-neighbour stencil of elementwise ops on (H, W) maps; the
iterations are a fixed Python loop with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["diffusion_tensor", "line_response", "lsd_line_mask", "tgv2_refine", "TGVParams"]


class TGVParams(NamedTuple):
    lambda_s: float = 0.2  # first-order dual bound (edge term)
    lambda_a: float = 0.8  # second-order dual bound
    tau_p: float = 0.5
    tau_q: float = 0.5
    tau_u: float = 0.25
    tau_v: float = 0.125
    theta_inv: float = 2.0  # data-coupling strength 1/theta
    tensor_a: float = 5.0  # diffusion tensor exp(-a*|grad|^b)
    tensor_b: float = 0.5
    iterations: int = 100
    # the AL multiplier update (.cu:4643-4655) would drive a standalone
    # refinement back to its noisy input, so it is off unless the caller
    # runs the full alternating scheme
    lagrangian: bool = False


def _central_grad(img: torch.Tensor):
    """Central differences with one-sided borders (.cu:4428-4436)."""
    dx = torch.cat([img[:, 1:2] - img[:, 0:1], (img[:, 2:] - img[:, :-2]) * 0.5,
                    img[:, -1:] - img[:, -2:-1]], 1)
    dy = torch.cat([img[1:2] - img[0:1], (img[2:] - img[:-2]) * 0.5, img[-1:] - img[-2:-1]], 0)
    return dx, dy


def line_response(gray: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """Gradient magnitude thresholded to a soft [0, 1] mask: the cheap
    stand-in for the reference's LSD mask."""
    dx, dy = _central_grad(gray)
    return torch.clamp(torch.sqrt(dx * dx + dy * dy) / threshold, 0.0, 1.0)


def lsd_line_mask(gray, sigma: float = 1.0):
    """The reference's exact LSD line-segment mask, on the host (needs cv2):
    cv::createLineSegmentDetector(LSD_REFINE_ADV) segments drawn 1 px wide
    into a zeroed mask, scaled to [0, 1] and Gaussian-blurred with sigma 1
    (src/PatchMatchStereoGPU.cu:6368-6396). `gray` is a numpy array or a
    tensor; returns an (H, W) float32 numpy mask."""
    import cv2
    import numpy as np

    if isinstance(gray, torch.Tensor):
        gray = gray.cpu().numpy()
    g8 = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    lines = cv2.createLineSegmentDetector(cv2.LSD_REFINE_ADV).detect(g8)[0]
    mask = np.zeros(g8.shape, np.uint8)
    if lines is not None:
        for seg in np.asarray(lines).reshape(-1, 4):
            cv2.line(mask, (int(round(float(seg[0]))), int(round(float(seg[1])))),
                     (int(round(float(seg[2]))), int(round(float(seg[3])))), 255, 1)
    return cv2.GaussianBlur(mask.astype(np.float32) / 255.0, (0, 0), float(sigma))


def diffusion_tensor(gray_gauss: torch.Tensor, ls_mask: torch.Tensor | None = None,
                     a: float = 5.0, b: float = 0.5) -> torch.Tensor:
    """Anisotropic diffusion tensor G (H, W, 4) = [[g00 g01], [g10 g11]]
    (anisotropicDiffusionTensorG, .cu:4412-4487): with n the normalised
    image gradient and s = exp(-a |grad|^b), G = s n n^T + (I - n n^T),
    diffusion suppressed across edges and free along them. Where the line
    mask is active, G comes from the mask's gradient instead."""
    zero = 1e-4

    def tensor_from(img):
        dx, dy = _central_grad(img)
        mag2 = dx * dx + dy * dy
        s = torch.exp(-a * torch.pow(torch.clamp(mag2, min=0.0), b * 0.5))
        norm = torch.sqrt(mag2)
        ok = norm > zero
        safe = torch.clamp(norm, min=zero)
        nx = torch.where(ok, dx / safe, 0.0)
        ny = torch.where(ok, dy / safe, 0.0)
        g00 = torch.where(ok, s * nx * nx + ny * ny, 1.0)
        g01 = torch.where(ok, (s - 1.0) * nx * ny, 0.0)
        g11 = torch.where(ok, s * ny * ny + nx * nx, 1.0)
        return torch.stack([g00, g01, g01, g11], -1)

    g = tensor_from(gray_gauss)
    if ls_mask is not None:
        g = torch.where((ls_mask >= zero)[..., None], tensor_from(ls_mask), g)
    return g


def _fwd_diff(f: torch.Tensor):
    """Forward differences, zero at the last column / row (.cu:4504-4505)."""
    return F.pad(f[:, 1:] - f[:, :-1], (0, 1)), F.pad(f[1:] - f[:-1], (0, 0, 0, 1))


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence with the reference's borders
    (.cu:4580-4588): the first column / row keep p, the last take -p[prev]."""
    w, h = px.shape[1], py.shape[0]
    div_x = torch.cat([px[:, :1], px[:, 1:w - 1] - px[:, :w - 2], -px[:, w - 2:w - 1]], 1)
    div_y = torch.cat([py[:1], py[1:h - 1] - py[:h - 2], -py[h - 2:h - 1]], 0)
    return div_x + div_y


def tgv_dual_primal_step(u, v, p, q, lagr, a_field, g, theta_inv, params: TGVParams, tgv: bool):
    """One TGV-2 (or TV) iteration, shared by `tgv2_refine` and the coupled
    WTA engine: u the field, v = (vx, vy), p = (px, py), q = (qxx, qxy,
    qyx, qyy), g = (g00, g01, g10, g11) tensor planes, `theta_inv` a float
    or a 0-dim tensor.
      p += tau_p G (grad u - v); project |p| <= lambda_s
      q += tau_q grad v;         project |q| <= lambda_a
      u  = clip01((u + tau_u (div Gp - L + theta_inv a)) / (1 + tau_u theta_inv)),
           over-relaxed (.cu:4597-4601)
      v += tau_v (p + div q), over-relaxed
    Returns (u, v, p, q)."""
    g00, g01, g10, g11 = g
    vx, vy = v
    px, py = p
    du_dx, du_dy = _fwd_diff(u)
    ex, ey = du_dx - vx, du_dy - vy
    px_n = px + params.tau_p * (g00 * ex + g01 * ey)
    py_n = py + params.tau_p * (g10 * ex + g11 * ey)
    scale = torch.clamp(torch.sqrt(px_n * px_n + py_n * py_n) / params.lambda_s, min=1.0)
    px_n, py_n = px_n / scale, py_n / scale
    if tgv:
        dvx_dx, dvx_dy = _fwd_diff(vx)
        dvy_dx, dvy_dy = _fwd_diff(vy)
        qxx, qxy, qyx, qyy = q
        qxx_n = qxx + params.tau_q * dvx_dx
        qxy_n = qxy + params.tau_q * dvx_dy
        qyx_n = qyx + params.tau_q * dvy_dx
        qyy_n = qyy + params.tau_q * dvy_dy
        qn = torch.sqrt(qxx_n ** 2 + qxy_n ** 2 + qyx_n ** 2 + qyy_n ** 2)
        qs = torch.clamp(qn / params.lambda_a, min=1.0)
        q = (qxx_n / qs, qxy_n / qs, qyx_n / qs, qyy_n / qs)
    gpx = g00 * px_n + g01 * py_n
    gpy = g10 * px_n + g11 * py_n
    u_t = (u + params.tau_u * _div(gpx, gpy) - params.tau_u * lagr
           + params.tau_u * theta_inv * a_field) / (1.0 + params.tau_u * theta_inv)
    u_n = 2.0 * torch.clamp(u_t, 0.0, 1.0) - u
    if tgv:
        vx_t = vx + params.tau_v * (px_n + _div(q[0], q[1]))
        vy_t = vy + params.tau_v * (py_n + _div(q[2], q[3]))
        v = (2.0 * vx_t - vx, 2.0 * vy_t - vy)
    return u_n, v, (px_n, py_n), q


def tgv2_refine(u0: torch.Tensor, guide_gray: torch.Tensor, params: TGVParams = TGVParams(),
                ls_mask: torch.Tensor | None = None, tgv: bool = True) -> torch.Tensor:
    """TGV-2 (or TV if tgv=False) refinement of a [0, 1] field u0, on its
    device, with the anisotropic tensor of the guide image and the
    augmented-Lagrangian coupling to u0 (the 'd_a' field of
    AL_TGV_primalUpdate): `params.iterations` steps of
    `tgv_dual_primal_step`, then L += (u - a) theta_inv / 2 (.cu:4643-4655)
    if `params.lagrangian`."""
    g = diffusion_tensor(guide_gray, ls_mask, params.tensor_a, params.tensor_b)
    planes = g.unbind(-1)
    z = torch.zeros_like(u0)
    u, v, p, q, lagr = u0, (z, z), (z, z), (z, z, z, z), z
    for _ in range(params.iterations):
        u, v, p, q = tgv_dual_primal_step(u, v, p, q, lagr, u0, planes, params.theta_inv,
                                          params, tgv)
        if params.lagrangian:
            lagr = lagr + (u - u0) * 0.5 * params.theta_inv
    return u
