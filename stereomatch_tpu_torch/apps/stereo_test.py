"""StereoTest equivalent: FLIR pair -> rectify -> SGBM -> 3D point cloud
(port of `stereomatch_tpu/apps/stereo_test.py`).

Mirrors src/stereo_opencv.cpp:47-225: loads the stereo pair by frame id
(cameras 191400042=left, 191400039=right), rectifies with the bundled
calibration (cam_stereo_pheno.yml), runs SGBM (numDisparities=16*16,
MODE_HH — StereoMatching.cpp:148-193 via stereo_opencv.cpp:150), reprojects
with Q, and writes the |Z| < z_clip cloud (the PCL viewer + test.pcd at
stereo_opencv.cpp:182-220 become PLY/PCD files). Rectification, SGBM (kernel
K1 on the card) and the reprojection run on `device`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import SGBMConfig
from ..geometry import rectified_geometry, remap_bilinear, reproject_image_to_3d
from ..io import (
    filter_cloud,
    load_image,
    load_stereo_calibration,
    save_disparity_png,
    save_pcd,
)
from ..utils import StageTimer


def load_pair(data_dir: str, frame_id: int, scale: float = 1.0):
    """The (left, right) RGB float32 frames of `frame_id` from the FLIR
    cameras' files, subsampled by round(1 / scale) when scale != 1."""
    left = load_image(os.path.join(data_dir, f"{frame_id:06d}_191400042.jpg"))
    right = load_image(os.path.join(data_dir, f"{frame_id:06d}_191400039.jpg"))
    if scale != 1.0:
        step = int(round(1.0 / scale))
        left, right = left[::step, ::step], right[::step, ::step]
    return left, right


def rectify_pair(left, right, geom, device: torch.device | str = "cuda"):
    """Both host frames remapped through the geometry's maps on `device`."""
    def remap(img, mx, my):
        return remap_bilinear(torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device),
                              torch.from_numpy(mx).to(device), torch.from_numpy(my).to(device))

    return remap(left, geom.map1x, geom.map1y), remap(right, geom.map2x, geom.map2y)


def run(
    data_dir: str,
    frame_id: int,
    calib: str,
    out_dir: str,
    num_disp_factor: int = 16,
    scale: float = 1.0,
    z_clip: float = 0.8,
    verbose: bool = True,
    device: torch.device | str = "cuda",
):
    """Returns (disparity (H, W), xyz (H, W, 3)) as numpy float32."""
    from ..ops.sgbm import sgbm_disparity

    timer = StageTimer(verbose=verbose)
    left, right = load_pair(data_dir, frame_id, scale)
    h, w = left.shape[:2]

    cal = load_stereo_calibration(calib)
    if scale != 1.0:
        cal = cal.rescaled(scale)
    geom = rectified_geometry(cal, (w, h))
    rl, rr = timer.time("rectify", rectify_pair, left, right, geom, device)

    gray_l = 0.299 * rl[..., 0] + 0.587 * rl[..., 1] + 0.114 * rl[..., 2]
    gray_r = 0.299 * rr[..., 0] + 0.587 * rr[..., 1] + 0.114 * rr[..., 2]

    cfg = SGBMConfig(min_disp=16, num_disp=16 * num_disp_factor)
    disp = timer.time("sgbm", lambda: sgbm_disparity(gray_l, gray_r, cfg).disparity)
    xyz = timer.time("reproject", reproject_image_to_3d, disp, geom.Q)
    disp, xyz = disp.cpu().numpy(), xyz.cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    save_disparity_png(os.path.join(out_dir, f"disp_{frame_id:06d}.png"), disp)
    with timer.stage("cloud"):
        pts, cols = filter_cloud(xyz, rl, z_max=z_clip)
        save_pcd(os.path.join(out_dir, f"cloud_{frame_id:06d}.pcd"), pts, cols)
    if verbose:
        print(timer.report())
        print(f"wrote {out_dir}/disp_{frame_id:06d}.png and cloud ({len(pts)} pts)")
    return disp, xyz


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default="/root/reference/build")
    ap.add_argument("--id", type=int, default=20)
    ap.add_argument(
        "--calib", default="/root/reference/cam_stereo_pheno.yml"
    )
    ap.add_argument("--out-dir", default="./out")
    ap.add_argument("--num-disp-factor", type=int, default=16,
                    help="numDisparities = 16 * factor (ref uses 16)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--z-clip", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    a = ap.parse_args(argv)
    run(a.data_dir, a.id, a.calib, a.out_dir, a.num_disp_factor, a.scale, a.z_clip,
        device=a.device)


if __name__ == "__main__":
    main()
