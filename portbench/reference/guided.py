"""The pair server's frame on its default guided-filtered volume, for the
benchmark's reference (plain PyTorch, nothing of the program):

- `guided_filter_volume`: a frozen copy of the port's
  `stereomatch_tpu_torch/ops/filters.py::guided_filter_volume`, on this
  folder's box filter. Do not edit;
- `guided_volumes`: the adgrad volumes of a BGR pair, each guided-filtered
  slab by slab with the view's gray image as the guide, rescaled to
  [0, 0.5] and clamped (`apps/stereo_yin.py::builtin_cost_volumes`);
- `mst_pair_guided`: the SGBM-seeded 3DMST frame of `compile_sgbm_mst_server`
  with `volume_guided=True`, (left, right) maps before the LR check. All
  but the volumes is `frames.py`'s keyframe.

`lower=True` stores the volumes in float8 e4m3 and the SGBM seed cost in
float8 e5m2, as `frames.py`'s control does; the guided filter itself runs
in float32 either way.
"""

from __future__ import annotations

import dataclasses

import torch

from . import rng
from .config import CostVolumeConfig
from .cost import adgrad_bgr_volumes
from .filters import box_filter
from .frames import _FP8, _capacities, _exact_matmuls, _forest, _gray, _refine, _seeds, mst_config

__all__ = ["guided_filter_volume", "guided_volumes", "mst_pair_guided"]


def guided_filter_volume(
    guide: torch.Tensor,
    volume: torch.Tensor,
    radius: int,
    eps: float,
    slab: int = 16,
    mode: str = "zero",
) -> torch.Tensor:
    """Guided-filter an (H, W, D) volume `slab` disparity slices at a time
    (guide statistics computed once), bounding peak memory to ~2 slabs of
    temporaries on top of the input and output volumes."""
    h, w, d = volume.shape
    g = guide
    mean_g = box_filter(g, radius, (0, 1), mode)
    var_g = box_filter(g * g, radius, (0, 1), mode) - mean_g * mean_g
    denom = (var_g + eps)[..., None]
    mg = mean_g[..., None]
    g3 = g[..., None]
    out = torch.empty_like(volume)
    for s0 in range(0, d, slab):
        # a ragged last slab filters exactly like a zero-padded one: every
        # op is per slice along D
        p = volume[:, :, s0 : s0 + slab]
        mean_p = box_filter(p, radius, (0, 1), mode)
        corr_gp = box_filter(g3 * p, radius, (0, 1), mode)
        a = (corr_gp - mg * mean_p) / denom
        b = mean_p - a * mg
        out[:, :, s0 : s0 + slab] = box_filter(a, radius, (0, 1), mode) * g3 + box_filter(
            b, radius, (0, 1), mode
        )
    return out


def guided_volumes(bgr_l: torch.Tensor, bgr_r: torch.Tensor, max_disp: int, guided: dict,
                   lower: bool = False):
    """(left, right) float32 volumes of a float BGR pair in [0, 255]:
    adgrad, guided-filtered with `guided` (radius, eps, slab), scaled to
    [0, 0.5] and clamped; with `lower`, rounded through float8 e4m3."""
    vcfg = CostVolumeConfig(min_disp=0, max_disp=max_disp - 1)
    vols = adgrad_bgr_volumes(bgr_l, bgr_r, vcfg)
    vols = [guided_filter_volume(_gray(bgr), v, int(guided["radius"]), float(guided["eps"]),
                                 int(guided["slab"]))
            for bgr, v in zip((bgr_l, bgr_r), vols)]
    scale = 0.5 / float(vcfg.bad_cost)
    out = [torch.clamp(v * scale, max=0.5) for v in vols]
    if lower:
        out = [v.to(_FP8).float() for v in out]
    return out


def mst_pair_guided(left, right, seed: int, spec: dict, lower: bool = False, device="cuda"):
    """(left, right) maps, numpy float32, of one pair-server frame on the
    guided volume keyed by `seed`."""
    _exact_matmuls()
    cfg, scfg = mst_config(spec)
    if lower:
        scfg = dataclasses.replace(scfg, cost_dtype="float8_e5m2")
    m = spec["mst"]
    with torch.no_grad():
        bl = torch.as_tensor(left).to(device).float()
        br = torch.as_tensor(right).to(device).float()
        h, w = bl.shape[:2]
        tmax, adj = _capacities(h, w, cfg)
        vl, vr = guided_volumes(bl, br, cfg.max_disp, spec["guided"], lower)
        sl, sr = _seeds(_gray(bl), _gray(br), scfg)
        kl, kr = rng.split(rng.PRNGKey(seed, device))
        fl, fr = _forest(bl, cfg, tmax, adj), _forest(br, cfg, tmax, adj)
        args = (cfg, h, w, tmax, m["fine_iterations"], m["refine_start"], m["max_neighbors"])
        dl = _refine(fl, vl, sl, kl, *args)
        dr = _refine(fr, vr, sr, kr, *args)
        return dl.cpu().numpy(), dr.cpu().numpy()
