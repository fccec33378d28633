"""3DMST model entries and helpers (port of `stereomatch_tpu/models/mst.py`):
the flat random-init frame on the host or the device forest
(`mst_stereo`), its device-forest twin (`mst_stereo_fused`), the
coarse-to-fine frame (`mst_stereo_c2f`) and the seeded frame the SGBM
compositions run.

Per view: median prefilter, L1 colour edge weights and the segment
forest, MST_PMS label optimization, the disparity map; then the
smoothness prior and the LR check of the left map.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import MSTConfig
from .. import random as trandom
from ..ops.filters import median3x3
from ..ops.mst import (
    ForestArrays,
    aggregation_norm_inv,
    forest_arrays,
    label_cost,
    labels_to_disparity,
    mst_pms_optimize,
    plane_labels_from_disparity,
    tree_filter,
)
from ..ops.postprocess import lr_consistency

__all__ = ["MSTOutput", "build_view_forest", "mst_stereo", "mst_stereo_c2f",
           "mst_stereo_fused", "mst_stereo_seeded"]


class MSTOutput(NamedTuple):
    left_disp: torch.Tensor
    right_disp: torch.Tensor
    left_valid: torch.Tensor


def _next_pow2(x: int) -> int:
    return 1 << max(1, int(x - 1)).bit_length()


def _fused_capacities(h: int, w: int, cfg: MSTConfig) -> tuple[int, int]:
    """Static (tmax, adj_cap) of the device forest: components are at least
    ~min_cc_size after the merge phase, with 4x headroom (as JAX, so the
    tree_start / adj_* padding compares equal)."""
    tmax = _next_pow2(max(256, 4 * (h * w) // max(cfg.min_cc_size, 1)))
    return tmax, 8 * tmax


def _apply_smoothness(disp: torch.Tensor, bgr, cfg: MSTConfig) -> torch.Tensor:
    """The smoothness prior selected by the reference's string surface
    ("NL2TGV"/"NLTV"/"2TGV"/"TV"/"NONE", src/PatchMatchStereoGPU.cu:6819;
    its refinement loop is dead at .cu:7328, these are the live
    equivalents), run for cfg.smoothness_iters iterations on the
    [0, 1]-normalised disparity like the reference's u fields
    (.cu:6941-6952), on disp's device."""
    prior = cfg.smoothness_prior.upper()
    if prior in ("NONE", ""):
        return disp
    span = float(cfg.max_disp - 1)
    u0 = torch.clamp(disp / span, 0.0, 1.0)
    bgr = torch.as_tensor(bgr, dtype=torch.float32).to(disp.device)
    if prior in ("2TGV", "TV"):
        from ..ops.tgv import TGVParams, tgv2_refine

        gray = (0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]) * (1.0 / 255.0)
        u = tgv2_refine(u0, gray, TGVParams(iterations=cfg.smoothness_iters),
                        tgv=(prior == "2TGV"))
    elif prior in ("NL2TGV", "NLTV"):
        from ..ops.nltgv import NL2TGVParams, nl2tgv_refine

        u = nl2tgv_refine(u0, bgr, NL2TGVParams(iterations=cfg.smoothness_iters))
    else:
        raise ValueError(f"smoothness_prior must be NL2TGV/NLTV/2TGV/TV/NONE, got {prior!r}")
    return u * span


def _lr_checked(disp_l, disp_r, left_bgr, right_bgr, cfg: MSTConfig) -> MSTOutput:
    """Smoothness prior on both maps, then the LR check of the left one."""
    disp_l = _apply_smoothness(disp_l, left_bgr, cfg)
    disp_r = _apply_smoothness(disp_r, right_bgr, cfg)
    disp_l_checked, valid = lr_consistency(disp_l, disp_r, float(cfg.max_disp), fill=False)
    return MSTOutput(disp_l_checked, disp_r, valid)


def _seed_min_cost(vol, a0, b0, c0, fa, cfg: MSTConfig) -> torch.Tensor:
    """True aggregated cost of the seed labels, so the seed is sticky
    against the optimizer's per-pixel min updates."""
    mc0 = tree_filter(label_cost(vol, a0, b0, c0, fa, cfg.max_disp), fa, cfg.carry_iters)
    if cfg.normalize_aggregation:
        mc0 = mc0 * aggregation_norm_inv(fa, cfg.carry_iters)
    return mc0


def _refine_seeded_view(k, vol, fa: ForestArrays, seed_disp, cfg: MSTConfig, iterations: int,
                        refine_start, max_neighbors: int) -> torch.Tensor:
    """The seeded refine of one view on its forest: plane labels fit to the
    seed map (pixels) at their true aggregated cost, `iterations` MST_PMS
    refinements with the ladder entered at `refine_start`, and the
    disparity map in pixels."""
    a0, b0, c0 = plane_labels_from_disparity(seed_disp, fa)
    mc0 = _seed_min_cost(vol, a0, b0, c0, fa, cfg)
    a, b, c, _ = mst_pms_optimize(
        k, vol, fa, cfg, max_neighbors=max_neighbors, iterations=iterations,
        init_state=(a0, b0, c0, mc0), refine_start=refine_start,
    )
    return labels_to_disparity(a, b, c, fa, cfg.max_disp) * (cfg.max_disp - 1.0)


def build_view_forest(bgr, cfg: MSTConfig, device: torch.device | str = "cuda") -> ForestArrays:
    """The forest of one view on `device`. cfg.forest_backend="host": the
    median prefilter on `device`, one copy of the image to the host, then
    the edge weights and the native builder there and one upload of the
    forest. "device": _view_forest's device forest at the tree capacity of
    _fused_capacities, its capacities checked."""
    img = torch.as_tensor(bgr, dtype=torch.float32).to(device)
    if cfg.forest_backend == "host":
        from ..native import build_forest, color_edge_weights

        if cfg.median_prefilter:
            img = median3x3(img)
        wr, wd = color_edge_weights(img.cpu().numpy())
        forest = build_forest(wr, wd, cfg.c, cfg.min_cc_size, cfg.gamma, cfg.max_log_range)
        return forest_arrays(forest, device)
    if cfg.forest_backend != "device":
        raise ValueError(f"forest_backend must be 'host' or 'device', got {cfg.forest_backend!r}")
    from ..ops.device_forest import device_forest_arrays
    from .sgbm_mst import _view_forest

    h, w = img.shape[0], img.shape[1]
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    return device_forest_arrays(_view_forest(img, cfg, tmax, adj_cap), h, w, tmax, check=False)


def mst_stereo(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    max_neighbors: int = 8,
    device: torch.device | str = "cuda",
) -> MSTOutput:
    """The flat 3DMST frame on a rectified BGR pair and its (H, W, D) cost
    volumes (lower is better): per view the forest of cfg.forest_backend,
    cfg.iterations of random-init MST_PMS and the disparity map, then the
    smoothness prior and the LR check of the left map. Disparities in
    pixels, at most cfg.max_disp - 1. The views take the two halves of the
    seed's key: the same RNG stream as the JAX function."""
    kl, kr = trandom.split(trandom.PRNGKey(seed, device))

    def view(k, bgr, vol):
        fa = build_view_forest(bgr, cfg, device)
        a, b, c, _ = mst_pms_optimize(k, torch.as_tensor(vol).to(device), fa, cfg,
                                      max_neighbors=max_neighbors)
        return labels_to_disparity(a, b, c, fa, cfg.max_disp) * (cfg.max_disp - 1.0)

    disp_l = view(kl, left_bgr, left_vol)
    disp_r = view(kr, right_bgr, right_vol)
    return _lr_checked(disp_l, disp_r, left_bgr, right_bgr, cfg)


def mst_stereo_fused(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    max_neighbors: int = 8,
    device: torch.device | str = "cuda",
) -> MSTOutput:
    """mst_stereo on the device forest, whatever cfg.forest_backend says:
    the whole frame stays on `device`, with no host round trip between its
    stages but the forest's capacity check. Same RNG stream as mst_stereo
    with forest_backend="device", and as the JAX function."""
    return mst_stereo(left_bgr, right_bgr, left_vol, right_vol,
                      dataclasses.replace(cfg, forest_backend="device"), seed, max_neighbors,
                      device)


def _c2f_coarse(key, bgr_c, vol_c, cfg_c: MSTConfig, max_neighbors: int, device):
    """Random-init MST_PMS at the coarse scale (cfg_c.iterations), its
    node-order labels scattered to (hc, wc) pixel maps (pixel_of_node is a
    permutation, so the scatter writes every pixel once). Returns the
    (a, b, c) maps."""
    fa_c = build_view_forest(bgr_c, cfg_c, device)
    labels = mst_pms_optimize(key, vol_c, fa_c, cfg_c, max_neighbors=max_neighbors)[:3]
    hc, wc = bgr_c.shape[:2]
    return tuple(torch.zeros(hc * wc, device=device).index_put_((fa_c.pixel_of_node,), v)
                 .reshape(hc, wc) for v in labels)


def _c2f_fine(key, bgr, vol, cfg: MSTConfig, k: int, coarse_maps, fine_iters: int,
              max_neighbors: int, device) -> torch.Tensor:
    """The full-scale stage: each pixel seeded with its coarse cell's plane
    rescaled as (a, b, k c) (d_f(x, y) = k d_c(x/k, y/k)) at the seed's
    true aggregated cost, then `fine_iters` iterations. Returns the
    disparity map in pixels."""
    a_img, b_img, c_img = coarse_maps
    hc, wc = a_img.shape
    w = vol.shape[1]
    fa = build_view_forest(bgr, cfg, device)
    pix = fa.pixel_of_node
    ys = torch.clamp((pix // w) // k, 0, hc - 1)
    xs = torch.clamp((pix % w) // k, 0, wc - 1)
    a0, b0 = a_img[ys, xs], b_img[ys, xs]
    c0 = c_img[ys, xs] * float(k)
    mc0 = _seed_min_cost(vol, a0, b0, c0, fa, cfg)
    a, b, c, _ = mst_pms_optimize(key, vol, fa, cfg, max_neighbors=max_neighbors,
                                  iterations=fine_iters, init_state=(a0, b0, c0, mc0))
    return labels_to_disparity(a, b, c, fa, cfg.max_disp) * (cfg.max_disp - 1.0)


def _c2f_view(key, bgr, vol, cfg: MSTConfig, k: int, coarse_iters: int, fine_iters: int,
              max_neighbors: int, device) -> torch.Tensor:
    """Coarse-to-fine label optimization for one view: `coarse_iters`
    random-init iterations on the volume and image strided by k (the
    disparity axis too, dc = ceil(D / k) slices), then the full-scale stage
    from the upsampled labels. The key splits into the coarse and the fine
    stage's, as in the JAX package."""
    vol = torch.as_tensor(vol).to(device)
    if cfg.volume_dtype != "float32":
        vol = vol.to(getattr(torch, cfg.volume_dtype))  # one cast shared by both scales
    d = vol.shape[2]
    dc = max(2, -(-d // k))
    cfg_c = dataclasses.replace(cfg, max_disp=dc, iterations=coarse_iters)
    bgr = torch.as_tensor(bgr, dtype=torch.float32).to(device)
    kc, kf = trandom.split(key)
    coarse = _c2f_coarse(kc, bgr[::k, ::k], vol[::k, ::k, ::k][:, :, :dc], cfg_c, max_neighbors,
                         device)
    return _c2f_fine(kf, bgr, vol, cfg, k, coarse, fine_iters, max_neighbors, device)


def mst_stereo_c2f(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    k: int = 2,
    coarse_iterations: int | None = None,
    fine_iterations: int | None = None,
    max_neighbors: int = 8,
    device: torch.device | str = "cuda",
) -> MSTOutput:
    """Coarse-to-fine 3DMST: per view, `coarse_iterations` (default
    cfg.iterations) random-init iterations at 1/k scale on a volume k^3
    times smaller, the plane labels upsampled, and `fine_iterations`
    (default cfg.iterations // 4) at full scale; then the smoothness prior
    and the LR check of the left map, as mst_stereo. Below 2k disparities
    the coarse volume is too thin, and the flat mst_stereo runs both
    phases' iterations instead. Same RNG stream as the JAX function."""
    if cfg.max_disp < 2 * k:
        ci0 = coarse_iterations or cfg.iterations
        fi0 = fine_iterations or max(1, cfg.iterations // 4)
        return mst_stereo(left_bgr, right_bgr, left_vol, right_vol,
                          dataclasses.replace(cfg, iterations=ci0 + fi0), seed, max_neighbors,
                          device)
    ci = cfg.iterations if coarse_iterations is None else coarse_iterations
    fi = max(1, cfg.iterations // 4) if fine_iterations is None else fine_iterations
    kl, kr = trandom.split(trandom.PRNGKey(seed, device))
    disp_l = _c2f_view(kl, left_bgr, left_vol, cfg, k, ci, fi, max_neighbors, device)
    disp_r = _c2f_view(kr, right_bgr, right_vol, cfg, k, ci, fi, max_neighbors, device)
    return _lr_checked(disp_l, disp_r, left_bgr, right_bgr, cfg)


def mst_stereo_seeded(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    seed_disp_l,
    seed_disp_r,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    fine_iterations: int | None = None,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
    device: torch.device | str = "cuda",
) -> MSTOutput:
    """3DMST seeded from per-pixel disparity maps in pixels: per view, plane
    labels fit to the seed with their true aggregated cost, then
    `fine_iterations` (default max(2, cfg.iterations // 10)) refinements
    with the ladder entered at `refine_start`; then the smoothness prior
    and the LR check of the left map. Same RNG stream as the JAX function."""
    fi = max(2, cfg.iterations // 10) if fine_iterations is None else fine_iterations
    kl, kr = trandom.split(trandom.PRNGKey(seed, device))

    def view(k, bgr, vol, seed_disp):
        vol = torch.as_tensor(vol).to(device)
        if cfg.volume_dtype != "float32":
            vol = vol.to(getattr(torch, cfg.volume_dtype))
        fa = build_view_forest(bgr, cfg, device)
        return _refine_seeded_view(k, vol, fa, torch.as_tensor(seed_disp).to(device), cfg, fi,
                                   refine_start, max_neighbors)

    disp_l = view(kl, left_bgr, left_vol, seed_disp_l)
    disp_r = view(kr, right_bgr, right_vol, seed_disp_r)
    return _lr_checked(disp_l, disp_r, left_bgr, right_bgr, cfg)
