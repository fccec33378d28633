"""End-to-end pipeline entry points (port of `stereomatch_tpu/pipelines.py`):
host images in, RGB or gray, uint8 or float; numpy disparity maps out.
The census, BM, SGBM, cost-volume, 3DMST and PatchMatch pipelines are
all ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import (
    BMConfig, CensusConfig, CostVolumePipelineConfig, MSTConfig, PatchMatchConfig, SGBMConfig,
)

__all__ = [
    "SGBM_BAND_THRESHOLD_BYTES",
    "check_stereo_pair",
    "costvolume_pipeline",
    "census_pipeline",
    "bm_pipeline",
    "sgbm_pipeline",
    "mst_pipeline",
    "sgbm_mst_pipeline",
    "patchmatch_pipeline",
    "to_bgr255",
]


def check_stereo_pair(left, right) -> None:
    """Both images present, with the same spatial shape."""
    l, r = np.asarray(left), np.asarray(right)
    if l.size == 0 or r.size == 0:
        raise ValueError("stereo pair image data empty")
    if l.shape[:2] != r.shape[:2]:
        raise ValueError(f"stereo pair size mismatch: {l.shape} vs {r.shape}")


def to_bgr255(img, device: torch.device | str = "cuda") -> torch.Tensor:
    """RGB or gray host image (uint8 or float) -> (H, W, 3) BGR float32 in
    [0, 255] on `device`."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return torch.from_numpy(np.ascontiguousarray(arr[..., ::-1], np.float32)).to(device)


def _gray255(img, device: torch.device | str = "cuda") -> torch.Tensor:
    """Gray or RGB host image -> (H, W) float32 gray in [0, 255] on
    `device` (RGB: BT.601 luma, computed on the host as the JAX package
    does)."""
    arr = np.asarray(img).astype(np.float32)
    if arr.ndim == 3:
        arr = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _filter_speckles(disp: torch.Tensor, cfg) -> torch.Tensor:
    """OpenCV's StereoSGBM::compute and StereoBM::compute pass
    DISP_SCALE*speckleRange on their 1/16 fixed-point map: speckleRange
    whole disparities on a float map."""
    from .ops.speckle import filter_speckles

    return filter_speckles(disp, invalid=float(cfg.min_disp - 1),
                           max_size=cfg.speckle_window_size, max_diff=float(cfg.speckle_range))


def costvolume_pipeline(left, right, cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
                        denoise: bool = True, lr_check: bool = False,
                        device: torch.device | str = "cuda"):
    """AD+gradient volume -> guided filter -> WTA -> Huber denoise (ref
    executable: costVolumeStereoPlusVariationalDenoise,
    src/PatchMatchStereoGPU.cu:8776-9410). Returns (left_disp, right_disp)
    as numpy float32."""
    from .models.costvolume import cost_volume_stereo

    check_stereo_pair(left, right)
    out = cost_volume_stereo(to_bgr255(left, device), to_bgr255(right, device), cfg, denoise,
                             lr_check)
    return out.left_disp.cpu().numpy(), out.right_disp.cpu().numpy()


def census_pipeline(left, right, cfg: CensusConfig = CensusConfig(),
                    device: torch.device | str = "cuda"):
    """Ternary census + WTA right-view disparity (ref:
    StereoMatching::censusStereo, src/StereoMatching.cpp:27-114). Inputs
    gray or RGB in [0, 255], normalized to [0, 1] here. Returns int32."""
    from .ops.cost import census_stereo

    check_stereo_pair(left, right)
    l = _gray255(left, device) * (1.0 / 255.0)
    r = _gray255(right, device) * (1.0 / 255.0)
    return census_stereo(l, r, cfg).cpu().numpy()


def bm_pipeline(left, right, cfg: BMConfig | None = None, speckle: bool = True,
                device: torch.device | str = "cuda"):
    """StereoBM left-view disparity with the OpenCV parameter surface (ref:
    the legacy CLI's bm algorithm, src/stereo_opencv (copy).cpp:258-268).
    Returns float32 disparity; invalid pixels = cfg.min_disp - 1."""
    from .ops.bm import bm_disparity

    cfg = cfg or BMConfig()
    check_stereo_pair(left, right)
    disp = bm_disparity(_gray255(left, device), _gray255(right, device), cfg).disparity
    if speckle and cfg.speckle_window_size > 0:
        disp = _filter_speckles(disp, cfg)
    return disp.cpu().numpy()


# sgbm_pipeline streams the rows in bands (sgbm_disparity_banded) when the
# float32 aggregated volume H * W * num_disp * 4 would pass this many bytes,
# as the JAX package does: every 2048x1536 frame at 256 disparities
SGBM_BAND_THRESHOLD_BYTES = 2 << 30


def sgbm_pipeline(left, right, cfg: SGBMConfig = SGBMConfig(), speckle: bool = True,
                  device: torch.device | str = "cuda"):
    """8-path SGBM left-view disparity with the OpenCV parameter surface
    (ref: StereoMatching::SGBMStereo, src/StereoMatching.cpp:148-193); the
    aggregation is kernel K1, or above SGBM_BAND_THRESHOLD_BYTES its carry
    entry K1c in `sgbm_disparity_banded`'s bands of 128 rows. Returns
    float32 disparity; invalid pixels = cfg.min_disp - 1."""
    from .ops.sgbm import sgbm_disparity, sgbm_disparity_banded

    check_stereo_pair(left, right)
    gl, gr = _gray255(left, device), _gray255(right, device)
    if gl.shape[0] * gl.shape[1] * cfg.num_disp * 4 > SGBM_BAND_THRESHOLD_BYTES:
        disp = sgbm_disparity_banded(gl, gr, cfg, device=device).disparity
    else:
        disp = sgbm_disparity(gl, gr, cfg).disparity
    if speckle and cfg.speckle_window_size > 0:
        disp = _filter_speckles(disp, cfg)
    return disp.cpu().numpy()


def _volumes(left, right, left_vol, right_vol, max_disp: int, device):
    """The caller's volumes on `device`, or the built-in guided AD+gradient
    volumes of the RGB pair (the stand-in for an mc-cnn volume)."""
    if left_vol is not None and right_vol is not None:
        return torch.as_tensor(left_vol).to(device), torch.as_tensor(right_vol).to(device)
    from .apps.stereo_yin import builtin_cost_volumes

    rgb_l = torch.from_numpy(np.ascontiguousarray(left, np.float32)).to(device)
    rgb_r = torch.from_numpy(np.ascontiguousarray(right, np.float32)).to(device)
    return builtin_cost_volumes(rgb_l, rgb_r, max_disp)


def mst_pipeline(left, right, left_vol=None, right_vol=None, cfg: MSTConfig | None = None,
                 seed: int = 0, device: torch.device | str = "cuda"):
    """The Stereo3DMST pipeline (models.mst.mst_stereo) on an RGB pair, with
    the built-in volumes where none are given. Returns (left_disp,
    right_disp) as numpy float32, the left map LR-checked."""
    from .models.mst import mst_stereo

    cfg = cfg or MSTConfig()
    check_stereo_pair(left, right)
    lv, rv = _volumes(left, right, left_vol, right_vol, cfg.max_disp, device)
    out = mst_stereo(to_bgr255(left, device), to_bgr255(right, device), lv, rv, cfg, seed,
                     device=device)
    return out.left_disp.cpu().numpy(), out.right_disp.cpu().numpy()


def sgbm_mst_pipeline(left, right, left_vol=None, right_vol=None, cfg: MSTConfig | None = None,
                      seed: int = 0, fine_iterations: int | None = None,
                      device: torch.device | str = "cuda"):
    """SGBM-seeded 3DMST (models.sgbm_mst.sgbm_mst_stereo) on an RGB pair,
    with the built-in volumes where none are given. Returns (left_disp,
    right_disp) as numpy float32, the left map LR-checked."""
    from .models.sgbm_mst import sgbm_mst_stereo

    cfg = cfg or MSTConfig()
    check_stereo_pair(left, right)
    lv, rv = _volumes(left, right, left_vol, right_vol, cfg.max_disp, device)
    out = sgbm_mst_stereo(to_bgr255(left, device), to_bgr255(right, device), lv, rv, cfg,
                          seed=seed, fine_iterations=fine_iterations, device=device)
    return out.left_disp.cpu().numpy(), out.right_disp.cpu().numpy()


def patchmatch_pipeline(left, right, cfg: PatchMatchConfig | None = None, seed: int = 0,
                        postprocess: bool = True, device: torch.device | str = "cuda"):
    """Slanted-plane PatchMatch (ref executable: PatchMatchStereoGPU,
    src/PatchMatchStereoGPU.cu:2602-3023) on an RGB or gray pair, keyed by
    `seed` as the JAX package keys it. Returns (left_disp, right_disp) as
    numpy float32, post-processed unless `postprocess` is False."""
    from . import random as trandom
    from .models.patchmatch import patchmatch_pipeline as run_pm

    cfg = cfg or PatchMatchConfig()
    check_stereo_pair(left, right)
    out = run_pm(trandom.PRNGKey(seed, device), to_bgr255(left, device),
                 to_bgr255(right, device), cfg, postprocess=postprocess)
    return out.left_disp.cpu().numpy(), out.right_disp.cpu().numpy()
