"""SGBM-seeded 3DMST: the production frame, the temporal (video) frame and
the offline compositions (port of `stereomatch_tpu/models/sgbm_mst.py`).

Per frame: SGBM on the left view gives the left seed and, through its
disp12 min-cost projection, the right seed (or a second mirrored SGBM);
both are nearest-valid filled. Per view: median prefilter, edge weights
and the device forest, plane-fit seed labels with their true aggregated
cost, a short truncated-ladder refinement, and the disparity map. The
temporal frame takes the previous frame's maps as its seeds instead of
running SGBM.
"""

from __future__ import annotations

import torch

from ..config import MSTConfig, SGBMConfig
from .. import random as trandom
from ..ops.device_forest import build_forest_device, check_forest_capacity, device_forest_arrays
from ..ops.filters import median3x3
from ..ops.mst import labels_to_disparity, mst_pms_optimize, plane_labels_from_disparity
from ..ops.postprocess import nearest_valid_fill
from ..ops.segmentation import channel_l1
from ..ops.sgbm import sgbm_disparity
from ..utils.timing import span
from .mst import MSTOutput, _fused_capacities, _lr_checked, _seed_min_cost, mst_stereo_seeded

__all__ = [
    "sgbm_seed_disparities",
    "sgbm_mst_stereo",
    "sgbm_mst_stereo_fused",
    "mst_stereo_temporal_fused",
    "sgbm_mst_video",
]


def _gray_from_bgr(bgr: torch.Tensor) -> torch.Tensor:
    arr = bgr.float()
    if arr.ndim == 2:
        return arr
    # BT.601 luma on BGR channel order
    return 0.114 * arr[..., 0] + 0.587 * arr[..., 1] + 0.299 * arr[..., 2]


def _seed_pair(gl: torch.Tensor, gr: torch.Tensor, cfg: SGBMConfig, right_seed: str = "disp2"):
    """(left, right) SGBM disparities with invalid pixels filled.
    "disp2": the right map is the free min-cost projection of the same
    aggregated volume; "mirror": a second SGBM on the mirrored swapped pair."""
    with span("sm.sgbm"):
        out_l = sgbm_disparity(gl, gr, cfg)
        dl = nearest_valid_fill(out_l.disparity, out_l.valid)
        if right_seed == "disp2" and out_l.right_disparity is not None:
            rd = out_l.right_disparity
            dr = nearest_valid_fill(rd, rd > cfg.min_disp - 0.5)
        elif right_seed in ("mirror", "disp2"):
            out_r = sgbm_disparity(gr.flip(1), gl.flip(1), cfg)
            dr = nearest_valid_fill(out_r.disparity, out_r.valid).flip(1)
        else:
            raise ValueError(f"right_seed must be 'disp2' or 'mirror', got {right_seed!r}")
    return dl, dr


def _default_sgbm_cfg(cfg: MSTConfig) -> SGBMConfig:
    """The seed's SGBM covers the MST label range (num_disp % 16 == 0) and
    inherits the volume dtype (bf16 costs for the bf16 production volume)."""
    nd = -(-cfg.max_disp // 16) * 16
    dt = "bfloat16" if cfg.volume_dtype == "bfloat16" else "float32"
    return SGBMConfig(min_disp=0, num_disp=nd, block_size=5, cost_dtype=dt)


def _view_forest(bgr: torch.Tensor, cfg: MSTConfig, tmax: int, adj_cap: int) -> dict:
    """Median prefilter + L1 colour edge weights + device forest of one view.
    Returns build_forest_device's raw dict, its capacities checked here,
    once: the build waits on the host every round anyway, and a forest the
    video server chains into later frames is then used without a sync."""
    with span("sm.forest"):
        img = median3x3(bgr) if cfg.median_prefilter else bgr
        im = img if img.ndim == 3 else img[..., None]
        wr = channel_l1(im[:, 1:] - im[:, :-1])
        wd = channel_l1(im[1:] - im[:-1])
        raw = build_forest_device(
            wr, wd, c=cfg.c, min_size=cfg.min_cc_size, gamma=cfg.gamma,
            delta=cfg.max_log_range, tmax=tmax, adj_cap=adj_cap,
        )
        check_forest_capacity(raw, tmax)
    return raw


def _refine_view_given_forest(raw, vol, seed_disp, k, cfg: MSTConfig, h: int, w: int,
                              tmax: int, fine_iterations: int, refine_start,
                              max_neighbors: int) -> torch.Tensor:
    """Plane-fit seed labels + truncated-ladder refinement on a built forest
    (raw, from _view_forest: possibly a previous keyframe's); returns the
    (H, W) disparity in pixels. Enqueues without a host sync."""
    top = float(cfg.max_disp - 1)
    with span("sm.refine"):
        vol = vol.to(getattr(torch, cfg.volume_dtype))
        fa = device_forest_arrays(raw, h, w, tmax=tmax, check=False)
        a0, b0, c0 = plane_labels_from_disparity(torch.clamp(seed_disp, 0.0, top), fa)
        mc0 = _seed_min_cost(vol, a0, b0, c0, fa, cfg)
        a, b, c, _ = mst_pms_optimize(
            k, vol, fa, cfg, max_neighbors=max_neighbors, iterations=fine_iterations,
            init_state=(a0, b0, c0, mc0), refine_start=refine_start,
        )
        return labels_to_disparity(a, b, c, fa, cfg.max_disp) * top


def _fused_refine_view(bgr, vol, seed_disp, k, cfg: MSTConfig, h: int, w: int, tmax: int,
                       adj_cap: int, fine_iterations: int, refine_start,
                       max_neighbors: int) -> torch.Tensor:
    raw = _view_forest(bgr, cfg, tmax, adj_cap)
    return _refine_view_given_forest(
        raw, vol, seed_disp, k, cfg, h, w, tmax, fine_iterations, refine_start, max_neighbors,
    )


def _sgbm_mst_frame_fused(left_bgr, right_bgr, left_vol, right_vol, key, cfg: MSTConfig,
                          sgbm_cfg: SGBMConfig, fine_iterations: int, refine_start,
                          max_neighbors: int, h: int, w: int, tmax: int, adj_cap: int,
                          right_seed: str = "disp2"):
    """The whole frame on the inputs' device: (left, right) disparity maps
    before the LR check."""
    seed_l, seed_r = _seed_pair(_gray_from_bgr(left_bgr), _gray_from_bgr(right_bgr),
                                sgbm_cfg, right_seed)
    kl, kr = trandom.split(key)
    disp_l = _fused_refine_view(left_bgr, left_vol, seed_l, kl, cfg, h, w, tmax, adj_cap,
                                fine_iterations, refine_start, max_neighbors)
    disp_r = _fused_refine_view(right_bgr, right_vol, seed_r, kr, cfg, h, w, tmax, adj_cap,
                                fine_iterations, refine_start, max_neighbors)
    return disp_l, disp_r


def _mst_refine_frame_fused(left_bgr, right_bgr, left_vol, right_vol, seed_l, seed_r, key,
                            cfg: MSTConfig, fine_iterations: int, refine_start,
                            max_neighbors: int, h: int, w: int, tmax: int, adj_cap: int):
    """The temporal (video) frame: _sgbm_mst_frame_fused with the seed maps
    as inputs (the previous frame's refined maps) instead of an SGBM pass."""
    kl, kr = trandom.split(key)
    disp_l = _fused_refine_view(left_bgr, left_vol, seed_l, kl, cfg, h, w, tmax, adj_cap,
                                fine_iterations, refine_start, max_neighbors)
    disp_r = _fused_refine_view(right_bgr, right_vol, seed_r, kr, cfg, h, w, tmax, adj_cap,
                                fine_iterations, refine_start, max_neighbors)
    return disp_l, disp_r


def _on(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype).to(device)


def sgbm_seed_disparities(left_bgr, right_bgr, cfg: SGBMConfig, right_seed: str = "disp2",
                          device: torch.device | str = "cuda"):
    """(left, right) filled SGBM disparity maps in pixels, on `device`."""
    return _seed_pair(_gray_from_bgr(_on(left_bgr, device, torch.float32)),
                      _gray_from_bgr(_on(right_bgr, device, torch.float32)), cfg, right_seed)


def sgbm_mst_stereo(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    sgbm_cfg: SGBMConfig | None = None,
    seed: int = 0,
    fine_iterations: int | None = None,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
    right_seed: str = "disp2",
    device: torch.device | str = "cuda",
) -> MSTOutput:
    """SGBM seeds (clipped to [0, max_disp-1]) refined by mst_stereo_seeded:
    the unfused composition, with the forest built by build_view_forest."""
    if sgbm_cfg is None:
        sgbm_cfg = _default_sgbm_cfg(cfg)
    dl, dr = sgbm_seed_disparities(left_bgr, right_bgr, sgbm_cfg, right_seed, device)
    top = float(cfg.max_disp - 1)
    return mst_stereo_seeded(
        left_bgr, right_bgr, left_vol, right_vol, torch.clamp(dl, 0.0, top),
        torch.clamp(dr, 0.0, top), cfg, seed=seed, fine_iterations=fine_iterations,
        refine_start=refine_start, max_neighbors=max_neighbors, device=device,
    )


def sgbm_mst_stereo_fused(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    sgbm_cfg: SGBMConfig | None = None,
    seed: int = 0,
    fine_iterations: int = 4,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
    right_seed: str = "disp2",
    device: torch.device | str = "cuda",
) -> MSTOutput:
    """SGBM-seeded 3DMST on a rectified BGR pair + (H, W, D) cost volumes,
    run on `device`: the frame, the smoothness prior and the LR check of
    the left map. Same RNG stream as the JAX function for the same seed."""
    left_bgr = _on(left_bgr, device, torch.float32)
    right_bgr = _on(right_bgr, device, torch.float32)
    h, w = left_bgr.shape[:2]
    if sgbm_cfg is None:
        sgbm_cfg = _default_sgbm_cfg(cfg)
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    disp_l, disp_r = _sgbm_mst_frame_fused(
        left_bgr, right_bgr, _on(left_vol, device), _on(right_vol, device),
        trandom.PRNGKey(seed, device), cfg, sgbm_cfg,
        fine_iterations, refine_start, max_neighbors, h, w, tmax, adj_cap, right_seed,
    )
    return _lr_checked(disp_l, disp_r, left_bgr, right_bgr, cfg)


def mst_stereo_temporal_fused(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    prev_left_disp,
    prev_right_disp,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    fine_iterations: int = 4,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
    device: torch.device | str = "cuda",
) -> MSTOutput:
    """One video frame: the previous frame's maps (both views, clipped to
    [0, max_disp-1]) seed this frame's plane labels, then the smoothness
    prior and the LR check. Same RNG stream as the JAX function."""
    left_bgr = _on(left_bgr, device, torch.float32)
    right_bgr = _on(right_bgr, device, torch.float32)
    h, w = left_bgr.shape[:2]
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    top = float(cfg.max_disp - 1)
    disp_l, disp_r = _mst_refine_frame_fused(
        left_bgr, right_bgr, _on(left_vol, device), _on(right_vol, device),
        torch.clamp(_on(prev_left_disp, device), 0.0, top),
        torch.clamp(_on(prev_right_disp, device), 0.0, top),
        trandom.PRNGKey(seed, device), cfg, fine_iterations, refine_start, max_neighbors,
        h, w, tmax, adj_cap,
    )
    return _lr_checked(disp_l, disp_r, left_bgr, right_bgr, cfg)


def sgbm_mst_video(
    frames,
    volumes,
    cfg: MSTConfig = MSTConfig(),
    sgbm_cfg: SGBMConfig | None = None,
    reseed_every: int = 0,
    fine_iterations: int = 4,
    temporal_iterations: int | None = None,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
    right_seed: str = "disp2",
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> list[MSTOutput]:
    """Offline temporal composition over (left_bgr, right_bgr) frames and
    their (left_vol, right_vol) volumes. Frame 0, and frame i whenever
    i % reseed_every == 0 (if set), runs sgbm_mst_stereo; every other frame
    runs mst_stereo_seeded on the previous output: the LR-checked left map
    nearest-valid filled, and the dense right map, both clipped to
    [0, max_disp-1], with `temporal_iterations` (default:
    `fine_iterations`) refinements. Frame i uses seed + i."""
    top = float(cfg.max_disp - 1)
    ti = fine_iterations if temporal_iterations is None else temporal_iterations
    outs: list[MSTOutput] = []
    prev: MSTOutput | None = None
    for i, ((lb, rb), (lv, rv)) in enumerate(zip(frames, volumes)):
        if prev is None or (reseed_every and i % reseed_every == 0):
            out = sgbm_mst_stereo(
                lb, rb, lv, rv, cfg, sgbm_cfg, seed=seed + i, fine_iterations=fine_iterations,
                refine_start=refine_start, max_neighbors=max_neighbors, right_seed=right_seed,
                device=device,
            )
        else:
            seed_l = torch.clamp(nearest_valid_fill(prev.left_disp, prev.left_valid), 0.0, top)
            seed_r = torch.clamp(prev.right_disp, 0.0, top)
            out = mst_stereo_seeded(
                lb, rb, lv, rv, seed_l, seed_r, cfg, seed=seed + i, fine_iterations=ti,
                refine_start=refine_start, max_neighbors=max_neighbors, device=device,
            )
        outs.append(out)
        prev = out
    return outs
