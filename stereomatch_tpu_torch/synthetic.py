"""Procedural ground-truth stereo scenes (dataset-free accuracy battery).

The port's own copy of `stereomatch_tpu/synthetic.py` (numpy only): the
same code, so a seed gives the same pixels in either package, and the
port and the JAX package are gated on the very same scenes
(tests/test_torch_config.py holds the two byte-equal).

The reference repo validates by eyeballing imshow windows (SURVEY.md §4)
and the BASELINE north star asks for ≤1% D1 on KITTI/Middlebury — datasets
that cannot be shipped here. This module makes the accuracy clause
falsifiable IN-REPO: it renders stereo pairs with analytically EXACT
subpixel ground truth, so every engine can be gated on absolute EPE/D1
(tests/test_gt_battery.py), not just cross-engine consistency.

Construction (all closed-form, no resampling):

  * A scene is a set of opaque planar surfaces in disparity space. Each
    surface i carries a plane d_i(x, y) = a_i x + b_i y + c_i over a
    support region defined in LEFT-view coordinates (the background
    supports everywhere; foreground discs support inside a circle), plus
    its own band-limited texture T_i(x, y) — a sum of random sinusoids,
    evaluable at any real (x, y).
  * Left view: z-buffer over surfaces covering (x, y) — the top surface
    is the one with the largest disparity. left(x,y) = T_top(x,y),
    disp_left(x,y) = d_top(x,y).
  * Right view: a left point x on surface i lands at u = x - d_i(x, y),
    which inverts in closed form (x_i = (u + b_i y + c_i) / (1 - a_i),
    valid for |a_i| < 1). The right-view z-buffer takes, among surfaces
    whose inverse projection lands in their support, the one with the
    largest disparity; right(u,y) = T_win(x_win, y) — note a surface can
    be visible in the right view where the left view occludes it (the
    revealed zone right of each disc), and the parametric texture is
    still exact there.
  * Left occlusion mask: (x, y) on top surface s is occluded iff the
    right-view winner at u = x - d_s(x,y) is a different surface, or u
    falls outside the right image. Exact by construction.

Textures are band-limited below ~0.35 cycles/px so window matchers see
alias-free structure at every subpixel shift.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "StereoScene",
    "render_scene",
    "render_sequence",
    "scene_eval_mask",
]


class StereoScene(NamedTuple):
    left: np.ndarray  # (H, W, 3) float32, 0..255
    right: np.ndarray  # (H, W, 3) float32, 0..255
    disp_left: np.ndarray  # (H, W) float32: exact left-view disparity
    disp_right: np.ndarray  # (H, W) float32: exact right-view disparity
    occ_left: np.ndarray  # (H, W) bool: no right-view correspondence
    max_disp: float  # scene-wide disparity bound (< requested max_disp)


def _texture(rng, n_waves: int, base: np.ndarray):
    """Band-limited RGB texture: per-channel sums of random sinusoids over
    continuous (x, y), plus a per-surface DC color so segmentation-driven
    engines (3DMST) see region structure. Returns f(x, y) -> (..., 3)."""
    freq = rng.uniform(0.02, 0.35, (n_waves, 2)) * rng.choice(
        [-1.0, 1.0], (n_waves, 2)
    )
    phase = rng.uniform(0.0, 2.0 * np.pi, (n_waves, 3))
    # 1/f-ish amplitude spectrum, normalized to keep values inside [0,255]
    amp = 1.0 / (0.15 + np.linalg.norm(freq, axis=1, keepdims=True))
    amp = amp / amp.sum() * rng.uniform(70.0, 110.0)
    amp = amp * rng.uniform(0.6, 1.4, (n_waves, 3))

    def f(x, y):
        ang = (
            2.0 * np.pi * (freq[:, 0, None] * x.ravel() + freq[:, 1, None] * y.ravel())
        )  # (n_waves, P)
        v = np.empty((ang.shape[1], 3))
        for c in range(3):
            v[:, c] = (amp[:, c : c + 1] * np.cos(ang + phase[:, c : c + 1])).sum(0)
        out = base[None, :] + v
        return np.clip(out, 0.0, 255.0).reshape(x.shape + (3,)).astype(np.float32)

    return f


class _Surface(NamedTuple):
    a: float
    b: float
    c: float
    tex: object
    disc: tuple[float, float, float] | None  # (cx, cy, r) in left coords


def _plane_d(s: _Surface, x, y):
    return s.a * x + s.b * y + s.c


def _in_support(s: _Surface, x, y):
    if s.disc is None:
        return np.ones_like(np.asarray(x), bool)
    cx, cy, r = s.disc
    return (x - cx) ** 2 + (y - cy) ** 2 <= r * r


def _make_surfaces(rng, height: int, width: int, max_disp: int,
                   n_discs: int, n_waves: int):
    """Draw the scene's surfaces (shared by render_scene and
    render_sequence so frame 0 of a sequence is bitwise the single-frame
    scene). Returns (surfaces, bg_top, hi)."""
    lo, hi = 2.0, max_disp - 2.0
    span = hi - lo

    # background slanted plane: small slopes, disparity in the lower band
    a = rng.uniform(-0.15, 0.15)
    b = rng.uniform(-0.08, 0.08)
    # choose c so bg disparity spans [lo, lo + 0.45*span] over the image
    dx_range = np.array([0.0, a * (width - 1)])
    dy_range = np.array([0.0, b * (height - 1)])
    dmin_off = dx_range.min() + dy_range.min()
    dmax_off = dx_range.max() + dy_range.max()
    scale = min(1.0, 0.45 * span / max(dmax_off - dmin_off, 1e-6))
    a, b = a * scale, b * scale
    dmin_off, dmax_off = dmin_off * scale, dmax_off * scale
    c = lo - dmin_off
    bg_top = c + dmax_off  # max bg disparity anywhere
    surfaces = [
        _Surface(a, b, c, _texture(rng, n_waves, rng.uniform(60, 150, 3)), None)
    ]

    # foreground discs: strictly in front of the background under their
    # support, fronto-ish planes in the upper disparity band
    for _ in range(n_discs):
        r = rng.uniform(0.08, 0.16) * min(height, width)
        cx = rng.uniform(r + max_disp, width - 1 - r)
        cy = rng.uniform(r, height - 1 - r)
        ad = rng.uniform(-0.05, 0.05)
        bd = rng.uniform(-0.05, 0.05)
        d_center = rng.uniform(bg_top + 2.0 + abs(ad) * r + abs(bd) * r, hi)
        cd = d_center - ad * cx - bd * cy
        surfaces.append(
            _Surface(
                ad, bd, cd, _texture(rng, n_waves, rng.uniform(60, 150, 3)),
                (cx, cy, r),
            )
        )
    return surfaces, bg_top, hi


def _render_surfaces(surfaces, height: int, width: int) -> StereoScene:
    """Exact two-view render of a surface list (left/right z-buffers +
    closed-form occlusion mask — see module docstring)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)

    # ---- left view z-buffer ----
    d_left = np.full((height, width), -np.inf)
    top_left = np.zeros((height, width), np.int32)
    for i, s in enumerate(surfaces):
        d = _plane_d(s, xs, ys)
        vis = _in_support(s, xs, ys) & (d > d_left)
        d_left = np.where(vis, d, d_left)
        top_left = np.where(vis, i, top_left)
    left = np.zeros((height, width, 3), np.float32)
    for i, s in enumerate(surfaces):
        m = top_left == i
        if m.any():
            left[m] = s.tex(xs[m], ys[m])

    # ---- right view z-buffer (closed-form inverse projection) ----
    us = xs  # right-view column coordinate
    d_right = np.full((height, width), -np.inf)
    x_win = np.zeros((height, width))
    top_right = np.full((height, width), -1, np.int32)
    for i, s in enumerate(surfaces):
        x_i = (us + s.b * ys + s.c) / (1.0 - s.a)
        d_i = x_i - us  # disparity of that surface point
        vis = _in_support(s, x_i, ys) & (d_i > d_right)
        d_right = np.where(vis, d_i, d_right)
        x_win = np.where(vis, x_i, x_win)
        top_right = np.where(vis, i, top_right)
    right = np.zeros((height, width, 3), np.float32)
    for i, s in enumerate(surfaces):
        m = top_right == i
        if m.any():
            right[m] = s.tex(x_win[m], ys[m])

    # ---- exact left occlusion mask: winner at the matching right pixel
    # must be the same surface (evaluated at the REAL-valued u) ----
    u_match = xs - d_left
    occ = (u_match < 0.0) | (u_match >= width)
    win_at_u = np.full((height, width), -1, np.int32)
    d_at_u = np.full((height, width), -np.inf)
    for i, s in enumerate(surfaces):
        x_i = (u_match + s.b * ys + s.c) / (1.0 - s.a)
        d_i = x_i - u_match
        vis = _in_support(s, x_i, ys) & (d_i > d_at_u)
        d_at_u = np.where(vis, d_i, d_at_u)
        win_at_u = np.where(vis, i, win_at_u)
    occ |= win_at_u != top_left

    return StereoScene(
        left=left,
        right=right,
        disp_left=d_left.astype(np.float32),
        disp_right=d_right.astype(np.float32),
        occ_left=occ,
        max_disp=float(d_left.max()),
    )


def render_scene(
    seed: int,
    height: int,
    width: int,
    max_disp: int,
    n_discs: int = 3,
    n_waves: int = 24,
) -> StereoScene:
    """Render one textured slanted-plane + occluding-discs scene with exact
    subpixel ground truth. All disparities land in [2, max_disp - 2]."""
    rng = np.random.default_rng(seed)
    surfaces, _, _ = _make_surfaces(rng, height, width, max_disp, n_discs, n_waves)
    return _render_surfaces(surfaces, height, width)


def _shifted_surface(s: _Surface, dx: float, dy: float, dd: float) -> _Surface:
    """The surface translated by (dx, dy) in the image plane with its
    texture riding along, and its disparity plane offset by dd — the
    closed-form render stays exact for any shift."""
    if s.disc is None:
        return s if dd == 0.0 else _Surface(s.a, s.b, s.c + dd, s.tex, None)
    cx, cy, r = s.disc

    def moved(x, y, _f=s.tex, _dx=dx, _dy=dy):
        return _f(x - _dx, y - _dy)

    # plane moves with the disc: d'(x, y) = d(x - dx, y - dy) + dd
    return _Surface(
        s.a, s.b, s.c - s.a * dx - s.b * dy + dd, moved, (cx + dx, cy + dy, r)
    )


def render_sequence(
    seed: int,
    n_frames: int,
    height: int,
    width: int,
    max_disp: int,
    n_discs: int = 3,
    n_waves: int = 24,
    drift: float = 2.0,
) -> list[StereoScene]:
    """A temporally coherent scene sequence with exact per-frame GT: the
    discs translate by ~`drift` px/frame along random directions and drift
    in disparity, the background stays put (static-camera video). Frame 0
    is bitwise identical to render_scene(seed, ...). This is the absolute
    oracle for the temporal-seeding video mode
    (models/sgbm_mst.py::sgbm_mst_video): frame-to-frame disparity changes
    are real but bounded, like consecutive frames of the reference's FLIR
    capture (the reference re-solves every frame from scratch,
    src/stereo_Yin.cpp:207)."""
    rng = np.random.default_rng(seed)
    surfaces, bg_top, hi = _make_surfaces(
        rng, height, width, max_disp, n_discs, n_waves
    )
    horizon = max(1, n_frames - 1)
    motions = []
    for s in surfaces:
        if s.disc is None:
            motions.append((0.0, 0.0, 0.0))
            continue
        ang = rng.uniform(0.0, 2.0 * np.pi)
        vx, vy = drift * np.cos(ang), drift * np.sin(ang)
        cx, cy, r = s.disc
        # keep the disc inside its valid placement box for every frame
        vx = float(np.clip(vx, (r + max_disp - cx) / horizon,
                           (width - 1.0 - r - cx) / horizon))
        vy = float(np.clip(vy, (r - cy) / horizon,
                           (height - 1.0 - r - cy) / horizon))
        # disparity drift, clamped so the disc stays strictly in front of
        # the background and below the scene bound at every frame
        d_c = s.a * cx + s.b * cy + s.c
        slope_r = (abs(s.a) + abs(s.b)) * r
        lo_b = (bg_top + 2.0 + slope_r - d_c) / horizon
        hi_b = max(lo_b, (hi - slope_r - d_c) / horizon)
        dd = float(np.clip(rng.uniform(-0.5, 0.5), lo_b, hi_b))
        motions.append((vx, vy, dd))
    frames = []
    for t in range(n_frames):
        shifted = [
            _shifted_surface(s, vx * t, vy * t, dd * t)
            for s, (vx, vy, dd) in zip(surfaces, motions)
        ]
        frames.append(_render_surfaces(shifted, height, width))
    return frames


def scene_eval_mask(scene: StereoScene, margin: int = 8) -> np.ndarray:
    """Evaluation mask: non-occluded left pixels away from the border (the
    usual 'noc' protocol; border excluded because window matchers have no
    data there and the scene has no padding semantics)."""
    h, w = scene.disp_left.shape
    m = ~scene.occ_left
    m[:margin] = False
    m[-margin:] = False
    m[:, :margin] = False
    m[:, -margin:] = False
    # columns whose match would need out-of-image left context
    m[:, : int(np.ceil(scene.max_disp)) + margin] = False
    return m
