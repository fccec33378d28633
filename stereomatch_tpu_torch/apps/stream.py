"""Streaming-sequence app: the FLIR series frame after frame (port of
`stereomatch_tpu/apps/stream.py`).

The reference processes one hard-coded frame per run (stereo_opencv.cpp
loads a single id). This app runs the whole bundled sequence
(ids 20, 40, 60, 61, 80): `run` through the cost-volume pipeline split over
a mesh of the process group's ranks, frames data-parallel over its "frame"
axis and rows tiled over "tile" (parallel/tiled.py; one rank alone when no
launcher started more, SURVEY.md §5's streaming-video config), and
`run_mst` through the streaming 3DMST.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import random as trandom
from ..config import CostVolumeConfig, CostVolumePipelineConfig, GuidedFilterConfig, MSTConfig
from ..geometry import rectified_geometry
from ..io import load_stereo_calibration, save_disparity_png
from ..utils import StageTimer
from .stereo_test import load_pair, rectify_pair

DEFAULT_IDS = (20, 40, 60, 61, 80)


def _remaining(ids, out_dir: str, prefix: str):
    """The ids whose output PNG does not exist yet."""
    os.makedirs(out_dir, exist_ok=True)
    return tuple(fid for fid in ids
                 if not os.path.exists(os.path.join(out_dir, f"{prefix}_{fid:06d}.png")))


def run(
    data_dir: str,
    calib: str,
    out_dir: str,
    ids=DEFAULT_IDS,
    scale: float = 0.25,
    max_disp: int = 63,
    n_frame: int | None = None,
    verbose: bool = True,
    resume: bool = False,
    device: torch.device | str = "cuda",
):
    """resume=True skips frames whose output PNG already exists — the
    streaming checkpoint/restart story (the per-frame artifacts ARE the
    checkpoints; a killed run restarts where it stopped). The reference
    has no recovery at all (SURVEY §5). The mesh takes the process group's
    ranks (one alone, `parallel.distributed_init` joins a torchrun world):
    `n_frame` of them on the frame axis (default: half the ranks, at most
    one a frame), the rest on the tile axis; rank 0 prints and writes the
    maps. Returns the (B, H, W) left maps on every rank of the mesh (None
    on a rank outside it)."""
    import torch.distributed as dist

    from ..parallel import make_mesh, tiled_cost_volume_batch
    from ..parallel.mesh import process_group_device

    process_group_device(device)  # a one-rank group when no launcher started more
    world, lead = dist.get_world_size(), dist.get_rank() == 0
    verbose = verbose and lead
    timer = StageTimer(verbose=verbose)
    if resume:
        remaining = _remaining(ids, out_dir, "stream_disp")
        if verbose and len(remaining) < len(ids):
            print(f"resume: {len(ids) - len(remaining)} frames already done")
        ids = remaining
        if not ids:
            return np.zeros((0,), np.float32)
    pairs = [load_pair(data_dir, fid, scale) for fid in ids]
    h, w = pairs[0][0].shape[:2]

    cal = load_stereo_calibration(calib).rescaled(scale)
    geom = rectified_geometry(cal, (w, h))
    rect = timer.time("rectify batch", lambda: [rectify_pair(l, r, geom, device) for l, r in pairs])

    nf = n_frame or max(1, min(len(ids), world // 2))
    nt = max(1, world // nf)
    mesh = make_mesh(n_tile=nt, n_frame=nf, device=device)
    if verbose:
        print(f"mesh: frame={nf} x tile={nt} over {nf * nt} ranks")
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=max_disp),
        guided=GuidedFilterConfig(slab=16),
    )
    fn = tiled_cost_volume_batch(mesh, cfg)

    # BGR batches, padded to a multiple of the frame axis and the rows to
    # one of the tile axis
    b = len(rect)
    pad = (0, 0, 0, 0, 0, (-h) % nt, 0, (-b) % nf)
    lb, rb = (torch.nn.functional.pad(torch.stack([p[i] for p in rect]).flip(-1), pad)
              for i in (0, 1))
    with timer.stage("pipeline batch"):
        out = fn(lb, rb)
        dl = None if out is None else out[0][:b, :h].cpu().numpy()
    if dl is None:  # a rank outside the mesh
        return None

    if lead:
        os.makedirs(out_dir, exist_ok=True)
        for fid, disp in zip(ids, dl):
            save_disparity_png(
                os.path.join(out_dir, f"stream_disp_{fid:06d}.png"), disp, max_disp
            )
    if verbose:
        print(timer.report())
        print(f"wrote {len(ids)} disparity maps to {out_dir}")
    return dl


def run_mst(
    data_dir: str,
    calib: str,
    out_dir: str,
    ids=DEFAULT_IDS,
    scale: float = 0.125,
    max_disp: int = 48,
    iterations: int = 20,
    verbose: bool = True,
    resume: bool = False,
    forest_backend: str = "host",
    sgbm_seed: bool = False,
    temporal_reseed: int | None = None,
    temporal_iterations: int = 2,
    temporal_refine_start: float = 4.0,
    scene_cut_ratio: float = 0.0,
    device: torch.device | str = "cuda",
):
    """Streaming 3DMST with the forest build OFF the critical path: frame
    N+1's forests are built by a worker thread (the host builder releases
    the GIL; the device builder only enqueues work) while the device
    optimizes frame N. Returns (disparities, forest_wait_seconds): the
    per-frame time spent blocked on forest futures.

    sgbm_seed=True is the streaming north-star composition
    (models/sgbm_mst.py): SGBM both views (kernel K1) seeds the plane labels
    and `iterations` becomes the short refinement budget (pass e.g. 4).

    temporal_reseed (with sgbm_seed) turns on VIDEO mode: SGBM seeds only
    frame 0 (and every temporal_reseed-th frame if > 0); every other frame
    seeds from the PREVIOUS frame's refined maps, with `temporal_iterations`
    at `temporal_refine_start` (the annealed ladder must cover the expected
    inter-frame motion in pixels). Keyframes keep the single-frame recipe
    (full `iterations` budget, refine_start=2.0).

    scene_cut_ratio (video mode, 0 disables) arms quality-triggered
    reseed: a temporal frame whose LR-valid fraction falls below
    ratio x the last keyframe's is redone as a keyframe (0.6 is the JAX
    package's validated threshold). Frames are keyed by
    `random.PRNGKey(frame id)`, split into the two views' keys, as the JAX
    app keys them."""
    from ..models.mst import _seed_min_cost, build_view_forest
    from ..models.sgbm_mst import _default_sgbm_cfg, sgbm_seed_disparities
    from ..ops.mst import labels_to_disparity, mst_pms_optimize, plane_labels_from_disparity
    from ..ops.postprocess import lr_consistency
    from .stereo_yin import builtin_cost_volumes

    timer = StageTimer(verbose=verbose)
    if resume:
        ids = _remaining(ids, out_dir, "stream_mst")
        if not ids:
            return np.zeros((0,), np.float32), []
    # forest_backend="device" runs segmentation + forest construction on
    # the device (ops/device_forest.py); the lookahead thread then only
    # enqueues device work
    cfg = MSTConfig(max_disp=max_disp, iterations=iterations, forest_backend=forest_backend)

    cal = load_stereo_calibration(calib).rescaled(scale)
    frames = []
    with timer.stage("load+rectify"):
        geom = None
        for fid in ids:
            l, r = load_pair(data_dir, fid, scale)
            if geom is None:
                geom = rectified_geometry(cal, (l.shape[1], l.shape[0]))
            rl, rr = rectify_pair(l, r, geom, device)
            frames.append((rl.flip(-1), rr.flip(-1)))  # BGR on the device

    def build_pair(i):
        bl, br = frames[i]
        return build_view_forest(bl, cfg, device), build_view_forest(br, cfg, device)

    span = float(max_disp - 1)
    disps, waits = [], []
    prev_maps = None  # (dense left, dense right) refined maps for temporal seeding
    key_frac = None  # last keyframe's LR-valid fraction (scene-cut ref)
    scene_cuts = []  # frame ids reseeded by the quality trigger
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = {0: ex.submit(build_pair, 0)}
        for i, fid in enumerate(ids):
            if i + 1 < len(ids):
                futs[i + 1] = ex.submit(build_pair, i + 1)  # lookahead
            t0 = time.time()
            fa_l, fa_r = futs.pop(i).result()
            waits.append(time.time() - t0)
            bl, br = frames[i]
            with timer.stage("frame device"):
                lv, rv = builtin_cost_volumes(bl.flip(-1), br.flip(-1), max_disp)
                kl, kr = trandom.split(trandom.PRNGKey(int(fid), device))
                if sgbm_seed:
                    temporal_frame = (
                        temporal_reseed is not None
                        and prev_maps is not None
                        and not (temporal_reseed and i % temporal_reseed == 0)
                    )

                    def solve(sdl, sdr, it_i, rs_i):
                        out = []
                        for k, sd, fa, vol in ((kl, sdl, fa_l, lv), (kr, sdr, fa_r, rv)):
                            a0, b0, c0 = plane_labels_from_disparity(
                                torch.clamp(sd, 0.0, span), fa)
                            init = (a0, b0, c0, _seed_min_cost(vol, a0, b0, c0, fa, cfg))
                            a, b, c, _ = mst_pms_optimize(k, vol, fa, cfg, init_state=init,
                                                          iterations=it_i, refine_start=rs_i)
                            out.append(labels_to_disparity(a, b, c, fa, max_disp) * span)
                        return out

                    def solve_keyframe():
                        sdl, sdr = sgbm_seed_disparities(bl, br, _default_sgbm_cfg(cfg),
                                                         device=device)
                        return solve(sdl, sdr, None, 2.0)

                    if temporal_frame:
                        # the measured video recipe: short budget + a
                        # ladder that covers the motion
                        dl, dr = solve(*prev_maps, temporal_iterations, temporal_refine_start)
                        if scene_cut_ratio and key_frac:
                            frac = lr_consistency(dl, dr, float(max_disp),
                                                  fill=False)[1].float().mean().item()
                            if frac < scene_cut_ratio * key_frac:
                                # quality-triggered reseed: the temporal
                                # ladder cannot absorb a hard scene cut
                                scene_cuts.append(fid)
                                temporal_frame = False
                                dl, dr = solve_keyframe()
                    else:
                        dl, dr = solve_keyframe()
                    prev_maps = (dl, dr)
                else:
                    temporal_frame = False
                    dl, dr = (
                        labels_to_disparity(*mst_pms_optimize(k, vol, fa, cfg)[:3], fa, max_disp)
                        * (max_disp - 1.0)
                        for k, vol, fa in ((kl, lv, fa_l), (kr, rv, fa_r)))
                dl, valid = lr_consistency(dl, dr, float(max_disp), fill=False)
                if not temporal_frame:  # keyframe (or reseeded frame)
                    key_frac = valid.float().mean().item()
                dl = dl.cpu().numpy()
            disps.append(dl)
            save_disparity_png(
                os.path.join(out_dir, f"stream_mst_{fid:06d}.png"), dl, max_disp
            )
    if verbose:
        print(timer.report())
        print(
            "forest wait per frame (s):",
            " ".join(f"{wt:.3f}" for wt in waits),
        )
        if scene_cuts:
            print("scene cuts (reseeded frames):",
                  " ".join(f"{fid:06d}" for fid in scene_cuts))
    return np.stack(disps), waits


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default="/root/reference/build")
    ap.add_argument("--calib", default="/root/reference/cam_stereo_pheno.yml")
    ap.add_argument("--out-dir", default="./out")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--max-disp", type=int, default=63)
    ap.add_argument("--engine", choices=("costvolume", "mst", "sgbm_mst"),
                    default="costvolume")
    ap.add_argument("--iterations", type=int, default=None,
                    help="mst engines: label-optimization iterations "
                    "(default 20 flat / 4 sgbm-seeded)")
    ap.add_argument("--resume", action="store_true",
                    help="skip frames whose output already exists")
    ap.add_argument("--forest-backend", choices=("host", "device"),
                    default="host",
                    help="mst engine: host C++ builder (lookahead-hidden) "
                    "or the on-device builder")
    ap.add_argument("--temporal-reseed", type=int, default=None,
                    help="sgbm_mst engine: VIDEO mode — SGBM seeds only "
                    "frame 0 (and every N-th frame if N > 0); other "
                    "frames seed from the previous refined maps")
    ap.add_argument("--temporal-iterations", type=int, default=2,
                    help="video mode: refinement iterations on temporal "
                    "frames (measured recipe: 2)")
    ap.add_argument("--temporal-refine-start", type=float, default=4.0,
                    help="video mode: annealed-ladder entry (px) on "
                    "temporal frames — set >= expected inter-frame motion")
    ap.add_argument("--scene-cut-ratio", type=float, default=0.0,
                    help="video mode: reseed a temporal frame whose "
                    "LR-valid fraction drops below this ratio of the "
                    "last keyframe's (0 disables; 0.6 validated)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    a = ap.parse_args(argv)
    if a.engine in ("mst", "sgbm_mst"):
        seeded = a.engine == "sgbm_mst"
        iters = a.iterations or (4 if seeded else 20)
        run_mst(a.data_dir, a.calib, a.out_dir, scale=a.scale,
                max_disp=a.max_disp, iterations=iters, resume=a.resume,
                forest_backend=a.forest_backend, sgbm_seed=seeded,
                temporal_reseed=a.temporal_reseed,
                temporal_iterations=a.temporal_iterations,
                temporal_refine_start=a.temporal_refine_start,
                scene_cut_ratio=a.scene_cut_ratio, device=a.device)
    else:
        run(a.data_dir, a.calib, a.out_dir, scale=a.scale, max_disp=a.max_disp,
            resume=a.resume, device=a.device)


if __name__ == "__main__":
    main()
