"""End-to-end pipeline entry points of the 3DMST engines (port of part of
`stereomatch_tpu/pipelines.py`): host images in, RGB or gray, uint8 or
float; numpy disparity maps out. The census, BM, SGBM, cost-volume and
PatchMatch pipelines are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import MSTConfig

__all__ = ["check_stereo_pair", "to_bgr255", "mst_pipeline", "sgbm_mst_pipeline"]


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
