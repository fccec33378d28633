"""The benchmark's plain reference of what its cells serve, assembled from the
frozen copies in this folder (no kernel, nothing of the program):

- `mst_pair`: the SGBM-seeded 3DMST frame of the pair server (raw adgrad
  volumes, SGBM seed with its disp2 right seed, device forests, plane-fit
  seed labels, truncated-ladder refine), (left, right) maps before the LR
  check;
- `mst_video_group`: a keyframe with `reuse_forest` and the temporal frames
  refined on its forests that follow it, with the scene-cut rule of the
  video server as the benchmark's loop drives it;
- `sgbm_flir`: OpenCV-surface SGBM on the gray pair, band-streamed above
  the band threshold, then the speckle filter.

`lower=True` computes in the nearest precision below the configured one
(the precision control): the bfloat16 cost volume is stored in float8 e4m3
(its values lie in [0, 0.5]), the bfloat16 SGBM seed cost in float8 e5m2
(its block sums reach thousands, past e4m3's 448), and a float32 SGBM cost
in bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng
from .config import CostVolumeConfig, MSTConfig, SGBMConfig
from .cost import adgrad_bgr_volumes
from .device_forest import build_forest_device, check_forest_capacity, device_forest_arrays
from .filters import median3x3
from .mst import (
    aggregation_norm_inv, label_cost, labels_to_disparity, mst_pms_optimize,
    plane_labels_from_disparity, tree_filter,
)
from .postprocess import lr_consistency, nearest_valid_fill
from .segmentation import channel_l1
from .sgbm import sgbm_disparity, sgbm_disparity_banded
from .speckle import filter_speckles

__all__ = ["mst_config", "mst_pair", "mst_video_group", "sgbm_flir", "SGBM_BAND_THRESHOLD_BYTES"]

SGBM_BAND_THRESHOLD_BYTES = 2 << 30
_FP8 = torch.float8_e4m3fn


def _exact_matmuls() -> None:
    # the twins' block prefix is a float32 product: no TF32 in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mst_config(spec: dict) -> tuple[MSTConfig, SGBMConfig]:
    """The configuration file's MST recipe and the SGBM seed it derives
    (the seed covers the label range and inherits the volume dtype)."""
    m = spec["mst"]
    cfg = MSTConfig(max_disp=spec["max_disp"], gamma=m["gamma"], c=m["c"],
                    min_cc_size=m["min_cc_size"], median_prefilter=m["median_prefilter"],
                    max_log_range=m["max_log_range"], carry_iters=m["carry_iters"],
                    normalize_aggregation=m["normalize_aggregation"],
                    volume_dtype=m["volume_dtype"], forest_backend="device")
    nd = -(-cfg.max_disp // 16) * 16
    dt = "bfloat16" if cfg.volume_dtype == "bfloat16" else "float32"
    return cfg, SGBMConfig(min_disp=0, num_disp=nd, block_size=5, cost_dtype=dt)


def _capacities(h: int, w: int, cfg: MSTConfig) -> tuple[int, int]:
    tmax = 1 << max(1, int(max(256, 4 * (h * w) // max(cfg.min_cc_size, 1)) - 1)).bit_length()
    return tmax, 8 * tmax


def _gray(bgr: torch.Tensor) -> torch.Tensor:
    return 0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]


def _volumes(bgr_l: torch.Tensor, bgr_r: torch.Tensor, max_disp: int, lower: bool):
    vcfg = CostVolumeConfig(min_disp=0, max_disp=max_disp - 1)
    lvol, rvol = adgrad_bgr_volumes(bgr_l, bgr_r, vcfg)
    scale = 0.5 / float(vcfg.bad_cost)
    out = [torch.clamp(v * scale, max=0.5) for v in (lvol, rvol)]
    if lower:
        out = [v.to(_FP8).float() for v in out]
    return out


def _seeds(gl, gr, scfg: SGBMConfig):
    out = sgbm_disparity(gl, gr, scfg)
    dl = nearest_valid_fill(out.disparity, out.valid)
    rd = out.right_disparity
    return dl, nearest_valid_fill(rd, rd > scfg.min_disp - 0.5)


def _forest(bgr, cfg: MSTConfig, tmax: int, adj_cap: int) -> dict:
    img = median3x3(bgr) if cfg.median_prefilter else bgr
    wr = channel_l1(img[:, 1:] - img[:, :-1])
    wd = channel_l1(img[1:] - img[:-1])
    raw = build_forest_device(wr, wd, c=cfg.c, min_size=cfg.min_cc_size, gamma=cfg.gamma,
                              delta=cfg.max_log_range, tmax=tmax, adj_cap=adj_cap)
    check_forest_capacity(raw, tmax)
    return raw


def _refine(raw, vol, seed_disp, key, cfg: MSTConfig, h, w, tmax, iterations, start,
            max_neighbors: int) -> torch.Tensor:
    span = float(cfg.max_disp - 1)
    vol = vol.to(getattr(torch, cfg.volume_dtype))
    fa = device_forest_arrays(raw, h, w, tmax=tmax, check=False)
    a0, b0, c0 = plane_labels_from_disparity(torch.clamp(seed_disp, 0.0, span), fa)
    mc0 = tree_filter(label_cost(vol, a0, b0, c0, fa, cfg.max_disp), fa, cfg.carry_iters)
    if cfg.normalize_aggregation:
        mc0 = mc0 * aggregation_norm_inv(fa, cfg.carry_iters)
    a, b, c, _ = mst_pms_optimize(key, vol, fa, cfg, max_neighbors=max_neighbors,
                                  iterations=iterations, init_state=(a0, b0, c0, mc0),
                                  refine_start=start)
    return labels_to_disparity(a, b, c, fa, cfg.max_disp) * span


def _keyframe(left, right, seed: int, spec: dict, lower: bool, device):
    """(dl, dr, (forest_l, forest_r)) of one SGBM-seeded frame."""
    cfg, scfg = mst_config(spec)
    if lower:
        scfg = dataclasses.replace(scfg, cost_dtype="float8_e5m2")
    m = spec["mst"]
    bl = torch.as_tensor(left).to(device).float()
    br = torch.as_tensor(right).to(device).float()
    h, w = bl.shape[:2]
    tmax, adj = _capacities(h, w, cfg)
    vl, vr = _volumes(bl, br, cfg.max_disp, lower)
    sl, sr = _seeds(_gray(bl), _gray(br), scfg)
    kl, kr = rng.split(rng.PRNGKey(seed, device))
    fl, fr = _forest(bl, cfg, tmax, adj), _forest(br, cfg, tmax, adj)
    args = (cfg, h, w, tmax, m["fine_iterations"], m["refine_start"], m["max_neighbors"])
    dl = _refine(fl, vl, sl, kl, *args)
    dr = _refine(fr, vr, sr, kr, *args)
    return dl, dr, (fl, fr)


def _temporal(left, right, prev, forests, seed: int, spec: dict, lower: bool, device):
    cfg, _ = mst_config(spec)
    m = spec["mst"]
    span = float(cfg.max_disp - 1)
    bl = torch.as_tensor(left).to(device).float()
    br = torch.as_tensor(right).to(device).float()
    h, w = bl.shape[:2]
    tmax, _ = _capacities(h, w, cfg)
    vl, vr = _volumes(bl, br, cfg.max_disp, lower)
    kl, kr = rng.split(rng.PRNGKey(seed, device))
    args = (cfg, h, w, tmax, m["temporal_iterations"], m["temporal_refine_start"],
            m["max_neighbors"])
    dl = _refine(forests[0], vl, torch.clamp(prev[0], 0.0, span), kl, *args)
    dr = _refine(forests[1], vr, torch.clamp(prev[1], 0.0, span), kr, *args)
    return dl, dr


def _lr_valid_fraction(dl, dr, max_disp: int) -> float:
    _, valid = lr_consistency(dl, dr, float(max_disp), fill=False)
    return float(valid.float().mean())


def mst_pair(left, right, seed: int, spec: dict, lower: bool = False, device="cuda"):
    """(left, right) maps, numpy float32, of one pair-server frame keyed by
    `seed`."""
    _exact_matmuls()
    with torch.no_grad():
        dl, dr, _ = _keyframe(left, right, seed, spec, lower, device)
        return dl.cpu().numpy(), dr.cpu().numpy()


def mst_video_group(frames, seeds, delivered, spec: dict, scene_cut_ratio: float,
                    lower: bool = False, device="cuda") -> list:
    """Maps of a keyframe (frames[0]) and the temporal frames after it, as
    the video server delivers them when each frame is submitted before the
    one ahead of it is collected. The keyframe is computed from its inputs
    alone; temporal frame j refines, on the keyframe's forests, the maps
    the program delivered for frame j - 1 (`delivered[j - 1]`): a chained
    stream amplifies the rounding by which the kernels and these twins
    differ, so each frame is judged on the state it was handed. A temporal
    frame whose LR-valid fraction falls below scene_cut_ratio x the last
    keyframe's is delivered as a keyframe of its own key, while the next
    frame still refines on the maps it was submitted with, the frame's own
    temporal maps."""
    _exact_matmuls()
    cfg, _ = mst_config(spec)
    out = []
    with torch.no_grad():
        dl, dr, forests = _keyframe(*frames[0], seeds[0], spec, lower, device)
        key_frac = _lr_valid_fraction(dl, dr, cfg.max_disp)
        out.append((dl.cpu().numpy(), dr.cpu().numpy()))
        prev = tuple(torch.as_tensor(m).to(device) for m in delivered[0])
        for j, ((left, right), seed) in enumerate(zip(frames[1:], seeds[1:]), start=1):
            dl, dr = _temporal(left, right, prev, forests, seed, spec, lower, device)
            frac = _lr_valid_fraction(dl, dr, cfg.max_disp)
            cut = bool(scene_cut_ratio and key_frac and frac < scene_cut_ratio * key_frac)
            prev = (dl, dr) if cut or j >= len(delivered) else tuple(
                torch.as_tensor(m).to(device) for m in delivered[j])
            if cut:
                dl, dr, _ = _keyframe(left, right, seed, spec, lower, device)
                key_frac = _lr_valid_fraction(dl, dr, cfg.max_disp)
            out.append((dl.cpu().numpy(), dr.cpu().numpy()))
    return out


def sgbm_flir(left_rgb, right_rgb, spec: dict, lower: bool = False, device="cuda",
              band_threshold_bytes: int = SGBM_BAND_THRESHOLD_BYTES):
    """The left map, numpy float32 (invalid = min_disp - 1), of the
    OpenCV-surface SGBM with speckle filtering on an RGB pair."""
    _exact_matmuls()
    cfg = SGBMConfig(**spec["sgbm"])
    if lower:  # float32 stated: the control stores the cost in bfloat16
        cfg = dataclasses.replace(cfg, cost_dtype="bfloat16")
    with torch.no_grad():
        grays = []
        for img in (left_rgb, right_rgb):
            arr = np.asarray(img).astype(np.float32)
            arr = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
            grays.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
        gl, gr = grays
        if gl.shape[0] * gl.shape[1] * cfg.num_disp * 4 > band_threshold_bytes:
            disp = sgbm_disparity_banded(gl, gr, cfg, device=device).disparity
        else:
            disp = sgbm_disparity(gl, gr, cfg).disparity
        if cfg.speckle_window_size > 0:
            disp = filter_speckles(disp, invalid=float(cfg.min_disp - 1),
                                   max_size=cfg.speckle_window_size,
                                   max_diff=float(cfg.speckle_range))
        return disp.cpu().numpy()
