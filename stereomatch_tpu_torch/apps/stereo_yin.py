"""StereoYin equivalent: rectify -> 3DMST -> clamp -> 3D point cloud (port
of `stereomatch_tpu/apps/stereo_yin.py`).

Mirrors src/stereo_Yin.cpp:53-266: rectifies the pair from calibration,
runs the 3DMST segment-tree pipeline with Dmax=100 and 100 iterations
(stereo3dmst call at stereo_Yin.cpp:207), clamps disparity to >= clamp_min
(=10, stereo_Yin.cpp:226-236), reprojects with Q and writes the cloud.

The reference shells out to mc-cnn via system() and mmaps left.bin /
right.bin (Stereo3DMST.cpp:742-775). Here:
  --mccnn-dir: read those files (the de-facto checkpoint format);
  otherwise a built-in cost volume (AD+gradient, guided-filtered and
  normalized to [0, 0.5]) stands in for the CNN cost.
Everything after the file reads runs on `device` (the 3DMST's scans are
kernels K2 and K2a on the card).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config import CostVolumeConfig, GuidedFilterConfig, MSTConfig
from ..geometry import rectified_geometry, reproject_image_to_3d
from ..io import (
    clean_mccnn,
    filter_cloud,
    load_mccnn_volume,
    load_stereo_calibration,
    save_disparity_png,
    save_ply,
)
from ..ops.cost import adgrad_bgr_volumes, bgr_to_gray
from ..ops.filters import guided_filter_volume
from ..utils import StageTimer, span
from .stereo_test import load_pair, rectify_pair


def builtin_cost_volumes(rl: torch.Tensor, rr: torch.Tensor, max_disp: int, guided: bool = True):
    """Stand-in for the mc-cnn volume: AD+gradient cost from an RGB pair,
    optionally guided-filtered, rescaled to [0, 0.5] (lower is better).
    guided=False is the raw adgrad volume."""
    vcfg = CostVolumeConfig(min_disp=0, max_disp=max_disp - 1)
    bgr_l, bgr_r = rl.flip(-1), rr.flip(-1)
    lvol, rvol = adgrad_bgr_volumes(bgr_l, bgr_r, vcfg)
    if guided:
        g = GuidedFilterConfig()
        with span("sm.volume.guided"):
            lvol = guided_filter_volume(bgr_to_gray(bgr_l), lvol, g.radius, g.eps, g.slab)
            rvol = guided_filter_volume(bgr_to_gray(bgr_r), rvol, g.radius, g.eps, g.slab)
    scale = 0.5 / float(vcfg.bad_cost)
    return torch.clamp(lvol * scale, max=0.5), torch.clamp(rvol * scale, max=0.5)


def run(
    data_dir: str,
    frame_id: int,
    calib: str,
    out_dir: str,
    max_disp: int = 100,
    iterations: int = 100,
    scale: float = 1.0,
    mccnn_dir: str | None = None,
    mccnn_arch: str = "acrt",
    clamp_min: float = 10.0,
    verbose: bool = True,
    device: torch.device | str = "cuda",
):
    """Returns (disparity (H, W), xyz (H, W, 3)) as numpy float32."""
    from ..models.mst import mst_stereo

    timer = StageTimer(verbose=verbose)
    left, right = load_pair(data_dir, frame_id, scale)
    h, w = left.shape[:2]

    cal = load_stereo_calibration(calib)
    if scale != 1.0:
        cal = cal.rescaled(scale)
    # alpha=0 valid-pixels-only zoom: the ACTIVE StereoYin rectification
    # (src/stereo_Yin.cpp:135 passes CALIB_ZERO_DISPARITY, 0, img_size)
    geom = rectified_geometry(cal, (w, h), alpha=0.0)
    rl, rr = timer.time("rectify", rectify_pair, left, right, geom, device)

    if mccnn_dir:
        lvol, rvol = (
            clean_mccnn(torch.from_numpy(load_mccnn_volume(os.path.join(mccnn_dir, name), h, w,
                                                           max_disp)).to(device), arch=mccnn_arch)
            for name in ("left.bin", "right.bin"))
    else:
        lvol, rvol = timer.time("cost volume", builtin_cost_volumes, rl, rr, max_disp)

    cfg = MSTConfig(max_disp=max_disp, iterations=iterations)
    out = timer.time("3dmst", mst_stereo, rl.flip(-1), rr.flip(-1), lvol, rvol, cfg,
                     device=device)

    disp = torch.clamp(out.left_disp, min=clamp_min)  # stereo_Yin.cpp:226-236
    xyz = timer.time("reproject", reproject_image_to_3d, disp, geom.Q)
    disp, xyz = disp.cpu().numpy(), xyz.cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    save_disparity_png(os.path.join(out_dir, f"mst_disp_{frame_id:06d}.png"), disp)
    pts, cols = filter_cloud(xyz, rl, z_max=0.8)
    save_ply(os.path.join(out_dir, f"mst_cloud_{frame_id:06d}.ply"), pts, cols)
    if verbose:
        print(timer.report())
    return disp, xyz


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default="/root/reference/build")
    ap.add_argument("--id", type=int, default=20)
    ap.add_argument("--calib", default="/root/reference/cam_stereo_pheno.yml")
    ap.add_argument("--out-dir", default="./out")
    ap.add_argument("--max-disp", type=int, default=100)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--mccnn-dir", default=None,
                    help="directory with mc-cnn left.bin/right.bin")
    ap.add_argument("--mccnn-arch", choices=["acrt", "fast"], default="acrt")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    a = ap.parse_args(argv)
    run(a.data_dir, a.id, a.calib, a.out_dir, a.max_disp, a.iterations,
        a.scale, a.mccnn_dir, a.mccnn_arch, device=a.device)


if __name__ == "__main__":
    main()
