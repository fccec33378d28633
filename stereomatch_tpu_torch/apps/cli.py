"""Legacy-style stereo CLI (port of `stereomatch_tpu/apps/cli.py`: the
reference's full command-line tool, src/stereo_opencv (copy).cpp:47-349:
--algorithm / --blocksize / --max-disparity / --scale / -i / -e / -o / -p),
extended with the framework's additional engines. Every engine runs on
--device (default: the card).

Algorithms:
  bm        block matching with the full cv::StereoBM parameter surface:
            x-Sobel prefilter, window SAD, textureThreshold, uniqueness,
            disp12 and speckle post (src/stereo_opencv (copy).cpp:258-268,
            src/StereoMatching.cpp BMStereo)
  sgbm|hh|sgbm3way
            semi-global matching; hh = full 8-path (MODE_HH, the reference's
            production setting); sgbm/sgbm3way = the 5-direction
            single-pass set (cv2 MODE_SGBM parity ~0.05% D1)
  census    ternary census + WTA (src/StereoMatching.cpp:27-114)
  costvolume
            AD+gradient volume + guided filter + WTA + Huber denoise
            (costVolumeStereoPlusVariationalDenoise)
  mst       Stereo3DMST segment-tree pipeline (src/Stereo3DMST.cpp)
  sgbm_mst  SGBM-seeded 3DMST — the north-star composition as one
            pipeline (models/sgbm_mst.py)
  pm        slanted-plane PatchMatch (src/pm.cpp adgrad metric + LR/fill/
            median post; src/PatchMatchStereoGPU.cu:2602-3023)
  coupled   coupled PatchMatch<->Huber-ROF alternation over the built-in
            cost volume (the reference's Family-E scheme, live —
            models/coupled.py)

Outputs: -o disparity PNG, -p point cloud (.ply/.pcd/.xyz), requires -i
(intrinsics+extrinsics FileStorage) for rectification/reprojection unless
--no-rectify.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _engine(alg: str, left, right, nd: int, blocksize, geom, device, timer):
    """The left disparity map of `alg` on the (rectified) RGB pair, numpy
    float32."""
    from .. import pipelines

    def gray(img):
        img = np.asarray(img, np.float32)
        return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
                if img.ndim == 3 else img)

    def host(x):
        return x.cpu().numpy()

    if alg in ("sgbm", "hh", "sgbm3way"):
        from ..config import SGBMConfig
        from ..ops.sgbm import sgbm_disparity

        cfg = SGBMConfig(
            min_disp=0,
            num_disp=nd,
            block_size=5 if blocksize is None else blocksize,
            num_paths=8 if alg == "hh" else 5,
        )
        gl, gr = (torch.from_numpy(np.ascontiguousarray(gray(x))).to(device) for x in (left, right))
        return timer.time("sgbm", lambda: host(sgbm_disparity(gl, gr, cfg).disparity))
    if alg == "bm":
        from ..config import BMConfig

        cfg = BMConfig(
            min_disp=0,
            num_disp=nd,
            block_size=9 if blocksize is None else blocksize,
            # the rectification valid-pixel ROIs, like the reference's
            # bm->setROI1/2 (src/stereo_opencv (copy).cpp:258-268)
            roi1=geom.roi1 if geom is not None else None,
            roi2=geom.roi2 if geom is not None else None,
        )
        return timer.time("bm", pipelines.bm_pipeline, left, right, cfg, device=device)
    if alg == "census":
        from ..config import CensusConfig

        return pipelines.census_pipeline(left, right, CensusConfig(d_max=nd - 1),
                                         device=device).astype(np.float32)
    if alg == "costvolume":
        from ..config import CostVolumeConfig, CostVolumePipelineConfig

        cfg = CostVolumePipelineConfig(volume=CostVolumeConfig(min_disp=0, max_disp=nd - 1))
        return timer.time("costvolume", lambda: pipelines.costvolume_pipeline(
            left, right, cfg, lr_check=True, device=device)[0])
    if alg == "pm":
        from ..config import PatchMatchConfig

        cfg = PatchMatchConfig(max_disp=float(nd - 1), iterations=10, metric="adgrad")
        return timer.time("pm", lambda: pipelines.patchmatch_pipeline(left, right, cfg,
                                                                      device=device)[0])

    from .stereo_yin import builtin_cost_volumes

    def volumes():
        rl, rr = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
                  for x in (left, right))
        return builtin_cost_volumes(rl, rr, nd)

    if alg == "coupled":
        from .. import random as trandom
        from ..config import CoupledConfig
        from ..models.coupled import coupled_patchmatch_stereo

        def coupled():
            lvol, _ = volumes()
            out = coupled_patchmatch_stereo(trandom.PRNGKey(0, device),
                                            pipelines.to_bgr255(left, device), lvol,
                                            CoupledConfig(max_disp=nd - 1))
            return host(out.smoothed)

        return timer.time("coupled", coupled)
    # mst / sgbm_mst
    from ..config import MSTConfig
    from ..models.mst import mst_stereo
    from ..models.sgbm_mst import sgbm_mst_stereo

    def mst():
        lvol, rvol = volumes()
        # sgbm_mst is the north-star composition: SGBM seeds the MST planes
        engine = sgbm_mst_stereo if alg == "sgbm_mst" else mst_stereo
        out = engine(pipelines.to_bgr255(left, device), pipelines.to_bgr255(right, device),
                     lvol, rvol, MSTConfig(max_disp=nd), device=device)
        return host(out.left_disp)

    return timer.time(alg, mst)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("--algorithm", default="hh",
                    choices=["bm", "sgbm", "hh", "sgbm3way", "census",
                             "costvolume", "mst", "sgbm_mst", "pm",
                             "coupled"])
    ap.add_argument("--blocksize", type=int, default=None,
                    help="matching block size (default: 5 for sgbm modes, "
                         "9 for bm, like the reference CLI)")
    ap.add_argument("--max-disparity", type=int, default=128)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("-i", "--calib", default=None,
                    help="FileStorage with M1,D1,M2,D2,R,T (XML/YAML)")
    ap.add_argument("-o", "--disparity-out", default=None)
    ap.add_argument("-p", "--cloud-out", default=None)
    ap.add_argument("--no-rectify", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    a = ap.parse_args(argv)
    if a.blocksize is not None and (a.blocksize < 1 or a.blocksize % 2 == 0):
        ap.error(f"--blocksize must be a positive odd number, got {a.blocksize}")

    from ..io import load_image, save_disparity_png
    from ..utils import StageTimer

    timer = StageTimer(verbose=True)
    left = load_image(a.left)
    right = load_image(a.right)
    if a.scale != 1.0:
        step = int(round(1.0 / a.scale))
        left, right = left[::step, ::step], right[::step, ::step]
    h, w = left.shape[:2]

    geom = None
    if a.calib and not a.no_rectify:
        from ..geometry import rectified_geometry
        from ..io import load_stereo_calibration
        from .stereo_test import rectify_pair

        cal = load_stereo_calibration(a.calib)
        if a.scale != 1.0:
            cal = cal.rescaled(a.scale)
        geom = rectified_geometry(cal, (w, h))
        left, right = (x.cpu().numpy() for x in timer.time(
            "rectify", rectify_pair, left, right, geom, a.device))

    nd = a.max_disparity
    disp = _engine(a.algorithm, left, right, nd, a.blocksize, geom, a.device, timer)

    print(timer.report())
    if a.disparity_out:
        save_disparity_png(a.disparity_out, disp, max_disp=nd)
        print(f"wrote {a.disparity_out}")
    if a.cloud_out:
        if geom is None:
            print("point cloud needs -i calibration", file=sys.stderr)
            return 1
        from ..geometry import reproject_image_to_3d
        from ..io import filter_cloud, save_pcd, save_ply, save_xyz

        xyz = reproject_image_to_3d(torch.from_numpy(disp).to(a.device), geom.Q)
        pts, cols = filter_cloud(xyz, left)
        if a.cloud_out.endswith(".ply"):
            save_ply(a.cloud_out, pts, cols)
        elif a.cloud_out.endswith(".pcd"):
            save_pcd(a.cloud_out, pts, cols)
        else:
            save_xyz(a.cloud_out, pts)
        print(f"wrote {a.cloud_out} ({len(pts)} pts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
