"""The video server as it ships, for the benchmark's reference (plain
PyTorch, nothing of the program): `compile_mst_video_server` with its
default guided volume and without `reuse_forest`, so every frame, keyframe
and temporal frame alike, builds both forests from its own images.

- `mst_video_rebuild_group`: a keyframe and the temporal frames after it,
  with `frames.mst_video_group`'s semantics (the keyframe from its inputs
  alone, temporal frame j on the maps the program delivered for frame
  j - 1, the same scene-cut rule). It differs in two ways: every frame's
  volumes are `guided.guided_volumes`, and every temporal frame refines on
  forests built by `frames._forest` from its own images, not on the
  keyframe's.

`lower=True` is the control of the other references: the volumes stored in
float8 e4m3, the SGBM seed cost in float8 e5m2.
"""

from __future__ import annotations

import dataclasses

import torch

from . import rng
from .frames import (
    _capacities, _exact_matmuls, _forest, _gray, _lr_valid_fraction, _refine, _seeds, mst_config,
)
from .guided import guided_volumes

__all__ = ["mst_video_rebuild_group"]


def _frame(left, right, prev, seed: int, spec: dict, lower: bool, device):
    """(dl, dr) of one frame on the guided volume with both forests built
    from its own images: a keyframe from its SGBM seeds (`prev` None), or
    a temporal frame refining `prev`, clipped to [0, max_disp - 1]."""
    cfg, scfg = mst_config(spec)
    m = spec["mst"]
    bl = torch.as_tensor(left).to(device).float()
    br = torch.as_tensor(right).to(device).float()
    h, w = bl.shape[:2]
    tmax, adj = _capacities(h, w, cfg)
    vl, vr = guided_volumes(bl, br, cfg.max_disp, spec["guided"], lower)
    if prev is None:
        if lower:
            scfg = dataclasses.replace(scfg, cost_dtype="float8_e5m2")
        sl, sr = _seeds(_gray(bl), _gray(br), scfg)
        iters, start = m["fine_iterations"], m["refine_start"]
    else:
        span = float(cfg.max_disp - 1)
        sl, sr = (torch.clamp(p, 0.0, span) for p in prev)
        iters, start = m["temporal_iterations"], m["temporal_refine_start"]
    kl, kr = rng.split(rng.PRNGKey(seed, device))
    fl, fr = _forest(bl, cfg, tmax, adj), _forest(br, cfg, tmax, adj)
    args = (cfg, h, w, tmax, iters, start, m["max_neighbors"])
    return _refine(fl, vl, sl, kl, *args), _refine(fr, vr, sr, kr, *args)


def mst_video_rebuild_group(frames, seeds, delivered, spec: dict, scene_cut_ratio: float,
                            lower: bool = False, device="cuda") -> list:
    """Maps, numpy float32 (left, right) pairs before the LR check, of a
    keyframe (frames[0]) and the temporal frames after it, as the video
    server without `reuse_forest` delivers them. The keyframe is computed
    from its inputs alone; temporal frame j refines the maps the program
    delivered for frame j - 1 (`delivered[j - 1]`) on forests of its own
    images. A temporal frame whose LR-valid fraction falls below
    scene_cut_ratio x the last keyframe's is delivered as a keyframe of its
    own key, while the next frame still refines the maps it was submitted
    with, the frame's own temporal maps."""
    _exact_matmuls()
    cfg, _ = mst_config(spec)
    out = []
    with torch.no_grad():
        dl, dr = _frame(*frames[0], None, seeds[0], spec, lower, device)
        key_frac = _lr_valid_fraction(dl, dr, cfg.max_disp)
        out.append((dl.cpu().numpy(), dr.cpu().numpy()))
        prev = tuple(torch.as_tensor(m).to(device) for m in delivered[0])
        for j, ((left, right), seed) in enumerate(zip(frames[1:], seeds[1:]), start=1):
            dl, dr = _frame(left, right, prev, seed, spec, lower, device)
            frac = _lr_valid_fraction(dl, dr, cfg.max_disp)
            cut = bool(scene_cut_ratio and key_frac and frac < scene_cut_ratio * key_frac)
            prev = (dl, dr) if cut or j >= len(delivered) else tuple(
                torch.as_tensor(m).to(device) for m in delivered[j])
            if cut:
                dl, dr = _frame(left, right, None, seed, spec, lower, device)
                key_frac = _lr_valid_fraction(dl, dr, cfg.max_disp)
            out.append((dl.cpu().numpy(), dr.cpu().numpy()))
    return out
