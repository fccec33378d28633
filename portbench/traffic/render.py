"""The benchmark's traffic generator: procedural stereo scenes with exact
subpixel ground truth, rendered on the card.

A frozen torch copy of the program's numpy renderer
(`stereomatch_tpu_torch/synthetic.py`: `render_scene`, `render_sequence`,
`scene_eval_mask`). The scene's parameters are drawn by numpy's generator
from the seed exactly as there; the per-pixel work (planes, z-buffers,
band-limited textures, the occlusion mask) runs in float64 on `device`.
A scene is a slanted background plane and `n_discs` fronto-ish discs in
front of it, each with its own texture (a sum of `n_waves` sinusoids
below 0.35 cycles/px); the right view inverts each plane in closed form.
In a sequence the discs translate by about `drift` px a frame and drift
in disparity, the background stays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Scene", "render_scene", "render_sequence", "scene_eval_mask"]


class Scene(NamedTuple):
    left: np.ndarray  # (H, W, 3) float32 BGR, 0..255
    right: np.ndarray  # (H, W, 3) float32 BGR, 0..255
    disp_left: np.ndarray  # (H, W) float32: exact left-view disparity
    occ_left: np.ndarray  # (H, W) bool: no right-view correspondence
    max_disp: float  # the scene's largest left disparity


class _Texture(NamedTuple):
    freq: np.ndarray  # (n_waves, 2)
    phase: np.ndarray  # (n_waves, 3)
    amp: np.ndarray  # (n_waves, 3)
    base: np.ndarray  # (3,)


def _texture(rng, n_waves: int, base: np.ndarray) -> _Texture:
    freq = rng.uniform(0.02, 0.35, (n_waves, 2)) * rng.choice([-1.0, 1.0], (n_waves, 2))
    phase = rng.uniform(0.0, 2.0 * np.pi, (n_waves, 3))
    amp = 1.0 / (0.15 + np.linalg.norm(freq, axis=1, keepdims=True))
    amp = amp / amp.sum() * rng.uniform(70.0, 110.0)
    amp = amp * rng.uniform(0.6, 1.4, (n_waves, 3))
    return _Texture(freq, phase, amp, base)


class _Surface(NamedTuple):
    a: float
    b: float
    c: float
    tex: _Texture
    disc: tuple[float, float, float] | None  # (cx, cy, r) in left coordinates
    shift: tuple[float, float] = (0.0, 0.0)  # texture offset of a moved disc


def _eval_texture(s: _Surface, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(P, 3) float32 texture values at the (P,) float64 points."""
    t = s.tex
    dev = x.device
    x = x - s.shift[0]
    y = y - s.shift[1]
    f = torch.as_tensor(t.freq, device=dev)
    ang = 2.0 * np.pi * (f[:, 0, None] * x[None, :] + f[:, 1, None] * y[None, :])
    amp = torch.as_tensor(t.amp, device=dev)
    phase = torch.as_tensor(t.phase, device=dev)
    v = torch.stack([(amp[:, c:c + 1] * torch.cos(ang + phase[:, c:c + 1])).sum(0)
                     for c in range(3)], dim=-1)
    out = torch.as_tensor(t.base, device=dev)[None, :] + v
    return torch.clamp(out, 0.0, 255.0).float()


def _plane_d(s: _Surface, x, y):
    return s.a * x + s.b * y + s.c


def _in_support(s: _Surface, x, y):
    if s.disc is None:
        return torch.ones_like(x, dtype=torch.bool)
    cx, cy, r = s.disc
    return (x - cx) ** 2 + (y - cy) ** 2 <= r * r


def _make_surfaces(rng, height: int, width: int, max_disp: int, n_discs: int, n_waves: int):
    lo, hi = 2.0, max_disp - 2.0
    span = hi - lo
    a = rng.uniform(-0.15, 0.15)
    b = rng.uniform(-0.08, 0.08)
    dx_range = np.array([0.0, a * (width - 1)])
    dy_range = np.array([0.0, b * (height - 1)])
    dmin_off = dx_range.min() + dy_range.min()
    dmax_off = dx_range.max() + dy_range.max()
    scale = min(1.0, 0.45 * span / max(dmax_off - dmin_off, 1e-6))
    a, b = a * scale, b * scale
    dmin_off, dmax_off = dmin_off * scale, dmax_off * scale
    c = lo - dmin_off
    bg_top = c + dmax_off
    surfaces = [_Surface(a, b, c, _texture(rng, n_waves, rng.uniform(60, 150, 3)), None)]
    for _ in range(n_discs):
        r = rng.uniform(0.08, 0.16) * min(height, width)
        cx = rng.uniform(r + max_disp, width - 1 - r)
        cy = rng.uniform(r, height - 1 - r)
        ad = rng.uniform(-0.05, 0.05)
        bd = rng.uniform(-0.05, 0.05)
        d_center = rng.uniform(bg_top + 2.0 + abs(ad) * r + abs(bd) * r, hi)
        cd = d_center - ad * cx - bd * cy
        surfaces.append(_Surface(ad, bd, cd, _texture(rng, n_waves, rng.uniform(60, 150, 3)),
                                 (cx, cy, r)))
    return surfaces, bg_top, hi


def _render(surfaces, height: int, width: int, device) -> Scene:
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=device),
                            torch.arange(width, dtype=torch.float64, device=device),
                            indexing="ij")

    def zbuffer(xq):
        """Per pixel of the right-view columns xq: the index of the surface
        seen there (-1: none) and the left-view x it is seen at."""
        best = torch.full_like(xs, -np.inf)
        x_win = torch.zeros_like(xs)
        top = torch.full(xs.shape, -1, dtype=torch.int32, device=device)
        for i, s in enumerate(surfaces):
            x_i = (xq + s.b * ys + s.c) / (1.0 - s.a)
            d_i = x_i - xq
            vis = _in_support(s, x_i, ys) & (d_i > best)
            best = torch.where(vis, d_i, best)
            x_win = torch.where(vis, x_i, x_win)
            top = torch.where(vis, i, top)
        return top, x_win

    def paint(top, x_at):
        img = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
        for i, s in enumerate(surfaces):
            m = top == i
            if bool(m.any()):
                img[m] = _eval_texture(s, x_at[m], ys[m])
        return img

    d_left = torch.full_like(xs, -np.inf)
    top_left = torch.zeros(xs.shape, dtype=torch.int32, device=device)
    for i, s in enumerate(surfaces):
        d = _plane_d(s, xs, ys)
        vis = _in_support(s, xs, ys) & (d > d_left)
        d_left = torch.where(vis, d, d_left)
        top_left = torch.where(vis, i, top_left)
    left = paint(top_left, xs)
    top_right, x_win = zbuffer(xs)
    right = paint(top_right, x_win)
    u = xs - d_left
    occ = (u < 0.0) | (u >= width)
    win_at_u, _ = zbuffer(u)
    occ |= win_at_u != top_left
    return Scene(left=left.cpu().numpy(), right=right.cpu().numpy(),
                 disp_left=d_left.float().cpu().numpy(), occ_left=occ.cpu().numpy(),
                 max_disp=float(d_left.max()))


def render_scene(seed: int, height: int, width: int, max_disp: int, n_discs: int = 3,
                 n_waves: int = 24, device="cuda") -> Scene:
    """One scene; all disparities land in [2, max_disp - 2]."""
    rng = np.random.default_rng(seed)
    surfaces, _, _ = _make_surfaces(rng, height, width, max_disp, n_discs, n_waves)
    return _render(surfaces, height, width, device)


def _shifted(s: _Surface, dx: float, dy: float, dd: float) -> _Surface:
    if s.disc is None:
        return s if dd == 0.0 else s._replace(c=s.c + dd)
    cx, cy, r = s.disc
    return _Surface(s.a, s.b, s.c - s.a * dx - s.b * dy + dd, s.tex, (cx + dx, cy + dy, r),
                    (s.shift[0] + dx, s.shift[1] + dy))


def render_sequence(seed: int, n_frames: int, height: int, width: int, max_disp: int,
                    n_discs: int = 3, n_waves: int = 24, drift: float = 2.0,
                    device="cuda") -> list[Scene]:
    """A temporally coherent sequence with exact GT in every frame; frame 0
    is the scene `render_scene(seed, ...)` renders."""
    rng = np.random.default_rng(seed)
    surfaces, bg_top, hi = _make_surfaces(rng, height, width, max_disp, n_discs, n_waves)
    horizon = max(1, n_frames - 1)
    motions = []
    for s in surfaces:
        if s.disc is None:
            motions.append((0.0, 0.0, 0.0))
            continue
        ang = rng.uniform(0.0, 2.0 * np.pi)
        vx, vy = drift * np.cos(ang), drift * np.sin(ang)
        cx, cy, r = s.disc
        vx = float(np.clip(vx, (r + max_disp - cx) / horizon, (width - 1.0 - r - cx) / horizon))
        vy = float(np.clip(vy, (r - cy) / horizon, (height - 1.0 - r - cy) / horizon))
        d_c = s.a * cx + s.b * cy + s.c
        slope_r = (abs(s.a) + abs(s.b)) * r
        lo_b = (bg_top + 2.0 + slope_r - d_c) / horizon
        hi_b = max(lo_b, (hi - slope_r - d_c) / horizon)
        dd = float(np.clip(rng.uniform(-0.5, 0.5), lo_b, hi_b))
        motions.append((vx, vy, dd))
    return [_render([_shifted(s, vx * t, vy * t, dd * t) for s, (vx, vy, dd) in
                     zip(surfaces, motions)], height, width, device) for t in range(n_frames)]


def scene_eval_mask(scene: Scene, margin: int = 8) -> np.ndarray:
    """Scored pixels: non-occluded left pixels away from the border and
    from the columns whose match would leave the image."""
    m = ~scene.occ_left
    m[:margin] = False
    m[-margin:] = False
    m[:, :margin] = False
    m[:, -margin:] = False
    m[:, : int(np.ceil(scene.max_disp)) + margin] = False
    return m
