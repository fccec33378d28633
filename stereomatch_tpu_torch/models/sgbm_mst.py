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

from dataclasses import dataclass, field

import torch

from ..config import MSTConfig, SGBMConfig
from .. import random as trandom
from ..ops.device_forest import build_forest_device, check_forest_capacity, device_forest_arrays
from ..ops.filters import median3x3
from ..ops.postprocess import nearest_valid_fill
from ..ops.segmentation import channel_l1
from ..ops.sgbm import sgbm_disparity
from ..utils.timing import span
from .mst import MSTOutput, _fused_capacities, _lr_checked, _refine_seeded_view, mst_stereo_seeded

__all__ = [
    "SeededMSTFrame",
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
    (raw, from _view_forest: possibly a previous keyframe's), the seed
    clamped to [0, max_disp-1]; returns the (H, W) disparity in pixels.
    Enqueues without a host sync."""
    with span("sm.refine"):
        vol = vol.to(getattr(torch, cfg.volume_dtype))
        fa = device_forest_arrays(raw, h, w, tmax=tmax, check=False)
        seed = torch.clamp(seed_disp, 0.0, float(cfg.max_disp - 1))
        return _refine_seeded_view(k, vol, fa, seed, cfg, fine_iterations, refine_start,
                                   max_neighbors)


@dataclass(frozen=True)
class SeededMSTFrame:
    """The SGBM-seeded 3DMST frame of HxW pairs, before the LR check: the
    one assembly of its stages that the pair server, the video server's
    keyframe and temporal frame and the fused offline entries share.
    `seeds` is the SGBM seed pair; `refine` refines both views from given
    seeds. sgbm_cfg defaults to _default_sgbm_cfg(cfg)."""

    cfg: MSTConfig
    h: int
    w: int
    sgbm_cfg: SGBMConfig | None = None
    max_neighbors: int = 2
    right_seed: str = "disp2"
    tmax: int = field(init=False)
    adj_cap: int = field(init=False)

    def __post_init__(self):
        if self.sgbm_cfg is None:
            object.__setattr__(self, "sgbm_cfg", _default_sgbm_cfg(self.cfg))
        tmax, adj_cap = _fused_capacities(self.h, self.w, self.cfg)
        object.__setattr__(self, "tmax", tmax)
        object.__setattr__(self, "adj_cap", adj_cap)

    def seeds(self, left_bgr: torch.Tensor, right_bgr: torch.Tensor):
        """(left, right) filled SGBM disparity maps of a float BGR pair."""
        return _seed_pair(_gray_from_bgr(left_bgr), _gray_from_bgr(right_bgr), self.sgbm_cfg,
                          self.right_seed)

    def refine(self, bgrs, vols, seeds, key, iterations: int, refine_start,
               forests=None, keep_forests: bool = False) -> tuple:
        """Both views, each a (BGR image, cost volume, seed map) of the
        pairs `bgrs`, `vols` and `seeds`, refined with the halves of `key`:
        (disp_l, disp_r), followed by the two forests if `keep_forests`.
        A view builds its forest unless `forests` hands it one."""
        keys = trandom.split(key)
        if forests is None and keep_forests:
            # forests that are kept outlive the frame anyway: build both, with
            # their host syncs, before either refine is enqueued. Forests that
            # are dropped are built one at a time, so one is alive at once
            forests = [_view_forest(bgr, self.cfg, self.tmax, self.adj_cap) for bgr in bgrs]
        disps = []
        for i, k in enumerate(keys):
            # a forest built here is only an argument, freed before the next view
            # builds its own; the refine is looked up in this module at call time,
            # so that a swap of it also reaches servers built before the swap
            disps.append(_refine_view_given_forest(
                _view_forest(bgrs[i], self.cfg, self.tmax, self.adj_cap) if forests is None
                else forests[i], vols[i], seeds[i], k, self.cfg, self.h, self.w, self.tmax,
                iterations, refine_start, self.max_neighbors))
        return (*disps, *forests) if keep_forests else tuple(disps)


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
    bgrs = (_on(left_bgr, device, torch.float32), _on(right_bgr, device, torch.float32))
    frame = SeededMSTFrame(cfg, *bgrs[0].shape[:2], sgbm_cfg, max_neighbors, right_seed)
    vols = (_on(left_vol, device), _on(right_vol, device))
    key = trandom.PRNGKey(seed, device)
    disp_l, disp_r = frame.refine(bgrs, vols, frame.seeds(*bgrs), key, fine_iterations,
                                  refine_start)
    return _lr_checked(disp_l, disp_r, *bgrs, cfg)


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
    bgrs = (_on(left_bgr, device, torch.float32), _on(right_bgr, device, torch.float32))
    frame = SeededMSTFrame(cfg, *bgrs[0].shape[:2], max_neighbors=max_neighbors)
    disp_l, disp_r = frame.refine(
        bgrs, (_on(left_vol, device), _on(right_vol, device)),
        (_on(prev_left_disp, device), _on(prev_right_disp, device)),
        trandom.PRNGKey(seed, device), fine_iterations, refine_start,
    )
    return _lr_checked(disp_l, disp_r, *bgrs, cfg)


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
