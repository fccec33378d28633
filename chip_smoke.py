"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Builds the port's Hopper kernels and its host forest builder (g++) from
this checkout, checks each kernel against its plain PyTorch twin at the
shapes the production frame gives it (K1 on the frame's own SGBM cost
within float32 reassociation, and bit for bit on the same cost rounded to
integers, and twice on the same cost bit for bit; K2's node-order and
Euler scans and its fused ancestor sum on a real device forest at 7 rows,
and on the host forest of the flat path at its 18 rows, at max_log_range
4 and 40, within rtol 1e-5 / atol 1e-4; K3's threefry split, fold_in and
uniform bit for bit at the refine's tree count and at one draw a node, both
at 2048x1536; K4's guided filter of a 1536x2048x100 volume within 1e-4 of
its eager twin, one device kernel a call), times each beside its bound (the
ancestor sum also beside the composition it replaces, with the share of
K2's tiles whose look-back went past the tile before, and holds each K2
call and each K3 draw to one device kernel in torch.profiler's events), then serves 3
frames of a 960x1280 pair at 128 disparities through
`stereomatch_tpu_torch.serving.compile_sgbm_mst_server`, with the guided
and the raw cost volume, and gates the LR-checked left maps on the
scene's exact ground truth. Then the video path at the same size,
through `compile_mst_video_server`: the headline deployment (raw volume,
`reuse_forest`, `reseed_every=3`, scene cuts armed) on a 6-frame moving
sequence, the guided rebuild-per-frame server on 3 frames, and one hard
cut (the mirrored scene), whose replay must equal a fresh keyframe. Then
the paths of the host forest and random init at the same size:
`pipelines.mst_pipeline` (the flat frame, 100 random-init iterations),
`pipelines.sgbm_mst_pipeline` (the seeded frame on the host forest), and
`models.mst.mst_stereo_fused` (30 random-init iterations on the device
forest, the built-in guided volume), each gated on GT. Last, the four
classical pipelines on the first frame (`pipelines.costvolume_pipeline`
with the LR fill, `sgbm_pipeline` with speckle, `bm_pipeline`,
`census_pipeline`): one warm call each, its launches counted (K1 once for
SGBM, nothing for the others), three timed calls, peak device memory, and
the GT digits gated as tests/test_gt_battery.py scores each engine;
whether SGBM's maps of the same frame are bit-equal call to call. Then,
last, the two PatchMatch engines in the CLI's configurations on the same
frame (`pipelines.patchmatch_pipeline`, 10 rounds of the adgrad metric
with the plane fill and weighted median; `models.coupled.
coupled_patchmatch_stereo` on the built-in guided left volume): one warm
call each, counted (no kernel), one timed call, peak device memory,
whether the two calls' maps are bit-equal, the GT digits gated, and the
window cost each runs (`plane_cost`, `hybrid_plane_cost`) timed at full
size with its device kernels a call and its calls an engine call. After
them, the band-streamed SGBM at the 2048x1536 FLIR frame and 256
disparities (`pipelines.sgbm_pipeline` with `SGBMConfig()` and speckle,
which streams 12 bands of 128 rows through K1's carry entry K1c: one warm
call counted, 3 timed, peak memory, GT, bit-equality), the banded SGBM
against the whole frame (ties flipped under 0.2%, both peaks), K1 at D = 256 on
the whole frame's cost and K1c on one band with its neighbours' carries
against their twins (bitwise on integer costs, timed beside the bound);
then `models.mst.mst_stereo_c2f` on the first frame with 2TGV and with no
prior (gated, its K2 / K2a launches held), the NL2TGV and TV priors at
full size (timed, device kernels a call), and
`models.coupled.coupled_wta_stereo` on the guided left volume (gated,
bit-equality). Last, the apps as users run them, on files the script
writes (frames as 8-bit PNG under the FLIR cameras' names, an identity rig
and a distorted one as YAML and XML FileStorage): `apps.stereo_test.run`
on the 2048x1536 frame at 256 disparities (its map held to
`ops.sgbm.sgbm_disparity` on the same gray, GT gated, stages, peak memory,
the cloud's points), `apps.stereo_yin.run` at 2048x1536 with 20 of its 100
iterations and both of its volume routes at a quarter scale (the mc-cnn
files hold the built-in volumes: bit-equal maps), `apps.stream.run_mst`
in video mode on 5 frames at scale 0.5 with the device forest, `stream.run`
and a resumed `run_mst` that skips every frame, and `apps.cli.main` for all
ten algorithms at 480x640 with -i, -o and -p. Then, last, the port's
parallel/ on the card as one NCCL rank (no machine with more than one GPU
is on record): the frame-parallel SGBM (K1), the row-tiled and (tile_y,
tile_x, dslab) cost-volume pipelines, the slab WTA, the band-pipelined SGBM
(K1c) at 2048x1536x256 and both 3DMST meshes (K2, K2a), each held to its
one-process counterpart (`parallel_paths`). Every path's K1 / K1c / K2 /
K2a / K3 / K4 launches are counted and held to its frame mix (K3: the draws of
its engines' key chains; K4: 2 a guided frame or call). Also reports whether the server gives
the same maps twice for the same frame and seed. The band check holds
the band-streamed SGBM equal to the whole frame on every pixel of the
integer gray. Fails (non-zero exit,
no result line) on any fault, when the host forest builder cannot be
built, and when no CUDA device is present. Imports nothing of jax or of the JAX package, and asserts that
no module of either was loaded. The last stdout line is {"ok": true,
"device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (960, 1280)
MAX_DISP = 128
FRAMES = 3
SCENE_SEED = 0
DEVICE = "cuda"
VIDEO_FRAMES = 6
RESEED_EVERY = 3
# GT gates of tests/test_mst_seeded.py (production-config test)
GATES = {"valid": 0.35, "epe": 1.2, "bad2": 0.08}
# temporal frames absorb one frame of motion (tests/test_mst_video.py:96-98)
TEMPORAL_GATES = {"valid": 0.35, "epe": 1.5, "bad2": 0.08}
# launches per keyframe: K1 once (one SGBM seed, all 8 directions in one
# launch), K2 2 views x (1 + 4 iterations) x 4 scans, half of them the
# node-order scan (K2) and half the fused ancestor sum (K2a); per temporal
# frame at 2 iterations: no SGBM, K2 2 x (1 + 2) x 4
KEY_LAUNCHES = {"K1": 1, "K1c": 0, "K2": 20, "K2a": 20}
TEMPORAL_LAUNCHES = {"K1": 0, "K1c": 0, "K2": 12, "K2a": 12}
# the host forest and random init (MSTConfig's defaults but for these:
# the GT battery's c and min_cc_size, tests/test_gt_battery.py)
FLAT_CFG = dict(max_disp=MAX_DISP, iterations=100, min_cc_size=100, c=2000.0)
# launches per frame at carry_iters=2 (3 node scans and 3 ancestor sums a
# tree filter): flat, 2 views x 100 iterations; seeded, 2 views x (the
# seed's cost + 10 iterations) and one SGBM seed; fused, 2 views x 30
FLAT_LAUNCHES = {"K1": 0, "K1c": 0, "K2": 600, "K2a": 600}
SEEDED_HOST_LAUNCHES = {"K1": 1, "K1c": 0, "K2": 66, "K2a": 66}
FUSED_ITERS = 30
FUSED_LAUNCHES = {"K1": 0, "K1c": 0, "K2": 180, "K2a": 180}
# tests/test_device_forest.py::test_mst_stereo_device_backend_absolute_gt
FUSED_GATES = {"valid": 0.35, "epe": 1.5, "bad2": 0.10}
# the classical engines on the first frame, each scored as
# tests/test_gt_battery.py scores it and held to its gates; where the JAX
# package itself misses one on this 960x1280x128 scene (its pipelines on
# the CPU), the gate is the JAX package's own number plus 10%: BM EPE
# 1.0333 -> 1.1366, census EPE 8.7517 -> 9.6269
CLASSIC_GATES = {
    "costvolume": {"epe": 0.5, "d1_all": 0.01},
    "sgbm": {"epe": 0.35, "d1_all": 0.01},
    "bm": {"epe": 1.1366, "d1_all": 0.03},
    "census": {"epe": 9.6269, "bad2": 0.30},
}
CLASSIC_TIMED = 3  # timed calls after one warm call
# the CLI's PatchMatch engines (apps/cli.py's `pm` and `coupled`): the JAX
# package meets tests/test_gt_battery.py's PatchMatch gates on this scene
# (jax_classic_gt.py pm coupled, on the CPU: EPE 0.0376 / bad2 0.00024 and
# EPE 0.1541 / bad2 0.00111), so both are gated there
PM_CFG = dict(max_disp=float(MAX_DISP - 1), iterations=10, metric="adgrad")
PM_GATES = {"epe": 0.2, "bad2": 0.02}
# the band-streamed SGBM at the reference's 2048x1536 FLIR frame with
# SGBMConfig()'s 256 disparities (above the 2 GiB band threshold), in bands
# of 128 rows: 12 bands, 11 up-sweep launches of K1c (the top band's
# outgoing carry is never read) and 12 down-sweep ones a call. The JAX
# package misses tests/test_gt_battery.py's SGBM gates on this scene (its
# pipeline on the CPU, jax_classic_gt.py sgbm_banded: EPE 0.69884, D1
# 0.014728; min_disp 16 and the 272 unevaluated columns count as errors),
# so the gates are its own digits plus 10%
BAND_SHAPE = (1536, 2048, 256)
BAND_LAUNCHES = {"K1": 0, "K1c": 23, "K2": 0, "K2a": 0}
BAND_GATES = {"epe": 0.76872, "d1_all": 0.016201}
BAND_TIMED = 3
# c2f at the first frame as tests/test_engine_gates.py runs it, with the
# battery's c and min_cc_size, on the built-in guided volumes; launches at
# carry_iters=2: 2 views x (30 coarse + 1 seed cost + 10 fine) x 3. The
# JAX package meets the battery's MST gates there (jax_classic_gt.py c2f
# c2f_none: valid 0.4024 / EPE 0.4002 / bad2 0.00507 with 2TGV, 0.4385 /
# 0.8225 / 0.00925 without), so both are gated there
C2F_CFG = dict(max_disp=MAX_DISP, iterations=30, smoothness_prior="2TGV",
               smoothness_iters=60, min_cc_size=100, c=2000.0)
C2F_RUN = dict(seed=0, k=2, coarse_iterations=30, fine_iterations=10)
C2F_LAUNCHES = {"K1": 0, "K1c": 0, "K2": 246, "K2a": 246}
# coupled_wta_stereo (CoupledConfig(max_disp=127), TGVParams()) on the
# built-in guided left volume: JAX's digits (jax_classic_gt.py
# coupled_wta: EPE 0.20924, bad2 0.00088137) plus 10%
CWTA_GATES = {"epe": 0.23017, "bad2": 0.00096951}
# the apps phase (apps/: what users run), after every other path, on files
# written as 8-bit PNG under the FLIR cameras' names with an identity rig
# (rectification maps every pixel onto itself, so the scenes' exact GT
# holds). stereo_test runs uncut on the band scene (2048x1536, SGBM at
# min_disp 16 and 256 disparities, K1 on the whole frame). Its GT gates are
# the JAX package's digits on the same 8-bit frame plus 10% (it misses
# tests/test_gt_battery.py's SGBM gates there: min_disp 16 and the 272
# unevaluated columns count as errors): jax_classic_gt.py
# stereo_test_banded, the app's SGBM through the JAX package's band driver
# (its whole frame would hold about 30 GB of host memory; the two routes'
# digits agree in every printed digit at 768x1024): EPE 0.80800, D1 0.015391
STEREO_TEST_GATES = {"epe": 0.88880, "d1_all": 0.016930}
STEREO_TEST_LAUNCHES = {"K1": 1, "K1c": 0, "K2": 0, "K2a": 0}
# stereo_yin at 2048x1536 and its 100 disparities with 20 of its 100
# iterations (cut, for time), gated as the flat frame; its mc-cnn route at a
# quarter scale (scale=0.25, 512x384) beside the built-in route at the same
# scale. Each run: 2 views x 20 iterations x 3 scans of each kind
YIN_SHAPE = (1536, 2048)
YIN_RUN = dict(max_disp=100, iterations=20)
YIN_LAUNCHES = {"K1": 0, "K1c": 0, "K2": 120, "K2a": 120}
# stream.run_mst on the app's 5 ids at scale 0.5 (1024x768) in video mode,
# the main path's composition: SGBM-seeded keyframes (frames 0 and 3), the
# device forest, 4 iterations; temporal frames 2 iterations. The frames are
# a 768x1024 sequence, each pixel written as a 2x2 block, so the app's
# subsampling gives the rendered frames back. Per keyframe one SGBM seed
# and 2 views x (1 seed cost + 4 iterations) x 3 scans, per temporal frame
# 2 x (1 + 2) x 3
STREAM_IDS = (20, 40, 60, 61, 80)
STREAM_SHAPE = (768, 1024, 128)
STREAM_MST = dict(scale=0.5, max_disp=128, iterations=4, sgbm_seed=True,
                  forest_backend="device", temporal_reseed=3, scene_cut_ratio=0.6)
STREAM_KEY = {"K1": 1, "K1c": 0, "K2": 30, "K2a": 30}
STREAM_TEMPORAL = {"K1": 0, "K1c": 0, "K2": 18, "K2a": 18}
# the CLI's ten algorithms at 480x640 (cut: each engine runs at full size in
# an earlier phase) with the distorted rig (-i), -o and -p; launches per call
CLI_SHAPE = (480, 640, 64)
CLI_ALGORITHMS = ("bm", "sgbm", "hh", "sgbm3way", "census", "costvolume", "mst", "sgbm_mst",
                  "pm", "coupled")
CLI_CLOUDS = (".ply", ".pcd", ".xyz")
CLI_K1 = ("sgbm", "hh", "sgbm3way", "sgbm_mst")
# the CLI's algorithms on guided-filtered volumes (K4 once a view)
CLI_GUIDED = ("costvolume", "mst", "sgbm_mst", "coupled")
# mst: MSTConfig(max_disp=64)'s 100 iterations; sgbm_mst: the seed's cost +
# its 10 fine iterations; 2 views and 3 scans of each kind a tree filter
CLI_K2 = {"mst": 600, "sgbm_mst": 66}
# K3 (random.py's threefry draws), launches a call: the 3DMST key chain in
# k3_optimize, PatchMatch's and the coupled engine's in k3_patchmatch and
# k3_coupled; every other engine draws nothing. K4 (the guided filter of a
# volume, ops/filters.py::guided_filter_volume) launches once a view whose
# built-in or cost-volume-pipeline volume is guided-filtered inside the
# count: 2 a guided frame or call, 0 elsewhere
K3_K4_NONE = {"K3": 0, "K4": 0}
# K3 beside its int64 twin at the 3DMST cells' 2048x1536: the refine's draws
# (a tree each, the tree capacity) and one draw a node, as init_labels makes them
K3_FRAME = (1536, 2048)
K3_NODES = K3_FRAME[0] * K3_FRAME[1]
K3_RANGES = ((0.0, 1.0), (-1.0, 1.0), (0.0, 100.0), (2.0, 9.5))
# K4 beside its eager twin at the guided cell's 1536x2048x100, the left view
# of the band scene, held to the twin run in float64 within
# tests/test_torch_guided_volume.py's ATOL_COST
K4_SHAPE = (1536, 2048, 100)
K4_ATOL = 1e-4
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 outside the
# tensor cores; a kernel's bound is the larger of its bytes (each input
# read once, each output written once) and its operations over these
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1 against its twin on non-integer costs: both sum the same n <= 8
# non-negative Lr in different orders, which differ by at most
# 2 (n - 1) 2^-24 of the sum (8.3e-7)
K1_RTOL = 1e-6


def log(*a):
    print(*a, flush=True)


def write_calibration(path: str, **mats) -> None:
    """An OpenCV FileStorage of `mats` (name -> float64 matrix) as
    opencv-matrix nodes: XML where `path` ends in .xml, else YAML. Values
    are written with repr, so they read back exactly."""
    nodes = {k: np.atleast_2d(np.asarray(v, np.float64)) for k, v in mats.items()}
    if path.endswith(".xml"):
        body = "".join(
            f'<{k} type_id="opencv-matrix">\n  <rows>{m.shape[0]}</rows>\n  <cols>{m.shape[1]}'
            f"</cols>\n  <dt>d</dt>\n  <data>\n    {' '.join(map(repr, m.ravel().tolist()))}"
            f"</data></{k}>\n" for k, m in nodes.items())
        text = f'<?xml version="1.0"?>\n<opencv_storage>\n{body}</opencv_storage>\n'
    else:
        text = "%YAML:1.0\n---\n" + "".join(
            f"{k}: !!opencv-matrix\n   rows: {m.shape[0]}\n   cols: {m.shape[1]}\n   dt: d\n"
            f"   data: [ {', '.join(map(repr, m.ravel().tolist()))} ]\n"
            for k, m in nodes.items())
    with open(path, "w") as f:
        f.write(text)


def identity_calibration(h: int, w: int, f: float = 1800.0) -> dict:
    """Two equal pinhole cameras without distortion, side by side (baseline
    0.1 along -x), principal points at the image centres: rectification
    maps every pixel onto itself, at this size and rescaled."""
    m = np.array([[f, 0.0, (w - 1) / 2.0], [0.0, f, (h - 1) / 2.0], [0.0, 0.0, 1.0]])
    return dict(M1=m, D1=np.zeros((1, 5)), M2=m.copy(), D2=np.zeros((1, 5)), R=np.eye(3),
                T=np.array([[-0.1], [0.0], [0.0]]))


def distorted_calibration(h: int, w: int) -> dict:
    """A rig that rectification has to warp: radial and tangential
    distortion, unequal focal lengths and a small rotation between the
    cameras."""
    m1 = np.array([[0.92 * w, 0.0, 0.51 * w], [0.0, 0.92 * w, 0.49 * h], [0.0, 0.0, 1.0]])
    m2 = np.array([[0.93 * w, 0.0, 0.49 * w], [0.0, 0.93 * w, 0.505 * h], [0.0, 0.0, 1.0]])
    a, b = 0.01, -0.006  # radians about y, then about z
    ry = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
    rz = np.array([[np.cos(b), -np.sin(b), 0.0], [np.sin(b), np.cos(b), 0.0], [0.0, 0.0, 1.0]])
    return dict(M1=m1, D1=np.array([[-0.08, 0.03, 0.001, -0.0005, 0.0]]), M2=m2,
                D2=np.array([[-0.07, 0.02, -0.0008, 0.0004, 0.0]]), R=rz @ ry,
                T=np.array([[-0.1], [0.002], [0.001]]))


def write_frame_pair(data_dir: str, fid: int, left_bgr, right_bgr) -> None:
    """The pair as 8-bit PNG files (lossless) under the FLIR cameras' file
    names, `{fid:06d}_191400042.jpg` (left) and `_191400039.jpg` (right);
    the readers pick the format from the file's signature."""
    import os

    from PIL import Image

    for cam, img in (("191400042", left_bgr), ("191400039", right_bgr)):
        rgb = np.clip(np.round(np.asarray(img)[..., ::-1]), 0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(data_dir, f"{fid:06d}_{cam}.jpg"), format="PNG")


def cuda_time_ms(fn, reps: int) -> float:
    fn()  # warm up
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_trace(fn) -> tuple[int, float]:
    """(device kernels, their summed device ms) of one call of fn, from
    torch.profiler's CUDA events. A trace with no device event at all lost
    its events (it happened once in a run of a dozen traces on the H100):
    it is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time in ms the card could take for `nbytes` moved and
    `nops` float32 operations, and which of the two bounds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k3_optimize(iterations, neighbours, start=None, max_disp=MAX_DISP, random_init=False) -> int:
    """K3 launches of one mst_pms_optimize: split(key) and split(key,
    iterations); a random init's split and 3 uniform draws; per iteration
    split(key_i, 3) and the base node's draw, 4 a neighbour candidate
    (fold_in, split, 2 uniform) and 2 a refinement level (fold_in,
    uniform)."""
    from stereomatch_tpu_torch.ops.mst import refine_deltas

    levels = int(refine_deltas(max_disp, start, device="cpu")[0].shape[0])
    return 2 + 4 * random_init + iterations * (2 + 4 * neighbours + 2 * levels)


def k3_frame(*args, **kw) -> int:
    """K3 launches of a 3DMST frame: split(key) into the views' keys, then
    each view's k3_optimize(*args, **kw)."""
    return 1 + 2 * k3_optimize(*args, **kw)


def k3_patchmatch(cfg) -> int:
    """K3 launches of patchmatch_stereo: split(key, 3), each view's random
    planes (split, 3 uniform), split(kloop, iterations), per round
    split(key_i) and per view 2 a refinement level (fold_in, uniform)."""
    from stereomatch_tpu_torch.ops.patchmatch import _refine_ladder

    return 10 + cfg.iterations * (1 + 4 * len(_refine_ladder(cfg.max_disp)))


def k3_coupled(cfg) -> int:
    """K3 launches of coupled_patchmatch_stereo: split(key), per round
    fold_in(kloop, it) and 2 a refinement level (fold_in, uniform)."""
    from stereomatch_tpu_torch.ops.patchmatch import _refine_ladder

    return 1 + cfg.outer_iterations * (1 + 2 * len(_refine_ladder(cfg.max_disp)))


def gate(dl, dr, scene, gates, tag, max_disp=MAX_DISP):
    """LR-check the left map and hold it to the scene's exact GT."""
    from stereomatch_tpu_torch.eval import disparity_metrics
    from stereomatch_tpu_torch.ops.postprocess import lr_consistency
    from stereomatch_tpu_torch.synthetic import scene_eval_mask

    shape = scene.disp_left.shape
    if dl.shape != shape or dr.shape != shape or not (
            np.isfinite(dl).all() and np.isfinite(dr).all()):
        raise AssertionError(f"{tag}: bad output shape or non-finite values")
    dlc, valid = lr_consistency(torch.from_numpy(dl), torch.from_numpy(dr),
                                float(max_disp), fill=False)
    scored = valid & torch.from_numpy(scene_eval_mask(scene))
    mm = disparity_metrics(dlc, torch.from_numpy(scene.disp_left), scored)
    share = scored.double().mean().item()
    msg = f"valid {share:.3f}, epe {mm['epe']:.3f}, bad2 {mm['bad2']:.4f}"
    if not (share > gates["valid"] and mm["epe"] < gates["epe"] and mm["bad2"] < gates["bad2"]):
        raise AssertionError(f"{tag} misses the GT gates {gates}: {msg}")
    return msg


def k2_cases(fr, rows, tag, dev, g):
    """K2's node scan (rows, N), Euler scan (rows, 2N) and fused ancestor
    sum (rows, N) on the forest `fr` (a mapping with seg_root, euler_reset,
    euler_src, euler_is_in and in_pos): each held to its twin, timed beside
    its bound and its twin, its look-back depth counted and held to one
    device kernel a call. Returns {case: (ms, twin ms, bound ms, bound_by,
    max |diff|)}."""
    from stereomatch_tpu_torch.ops.mst_scan_cuda import (
        ancestor_sums, ancestor_sums_twin, lookback_counts, segmented_cumsum,
        segmented_cumsum_twin,
    )

    euler = [fr[key] for key in ("euler_src", "euler_is_in", "euler_reset", "in_pos")]
    n = fr["in_pos"].shape[0]

    def deep_share(fn):
        """(deep look-backs, tiles) of one call: the look-backs (row 0 of
        each tile) that went past the tile before."""
        torch.cuda.synchronize()
        ids0, _, deep0 = lookback_counts(dev)
        fn()
        torch.cuda.synchronize()
        ids1, _, deep1 = lookback_counts(dev)
        return deep1 - deep0, ids1 - ids0

    def composition(v):
        """What the fused ancestor sum replaces: gather, sign, K2, gather."""
        ev = v.index_select(-1, euler[0])
        q = segmented_cumsum(torch.where(euler[1], ev, -ev), euler[2])
        return q.index_select(-1, euler[3])

    out = {}
    cases = (("nodes", segmented_cumsum, segmented_cumsum_twin, fr["seg_root"], 1),
             ("euler", segmented_cumsum, segmented_cumsum_twin, fr["euler_reset"], 1),
             ("ancestor", ancestor_sums, ancestor_sums_twin, None, 0))
    for name, kernel, twin, reset, scan in cases:
        x = torch.rand((rows, reset.shape[0] if scan else n), device=dev, generator=g) - 0.3
        args = (x, reset) if scan else (x, *euler)
        got = kernel(*args)
        want = twin(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        err = (got - want).abs().max().item()
        if not scan:  # and against the composition it replaces, on the card
            torch.testing.assert_close(got, composition(x), rtol=1e-5, atol=1e-4)
        del got, want
        deep, tiles = deep_share(lambda: kernel(*args))
        nk, _ = device_trace(lambda: kernel(*args))
        if nk != 1:
            raise AssertionError(f"K2 {name} ({tag}): {nk} device kernels a call, not one")
        ms = cuda_time_ms(lambda: kernel(*args), 20)
        plain = cuda_time_ms(lambda: twin(*args), 5)
        comp = None if scan else cuda_time_ms(lambda: composition(x), 20)
        if scan:  # x and the resets read once, the scan written once; one add a value
            nbytes, nops = x.numel() * 8 + reset.numel(), x.numel()
        else:  # v, euler_src, euler_is_in, euler_reset read once, out written once
            m = euler[0].numel()
            nbytes, nops = x.numel() * 8 + m * (8 + 1 + 1), rows * m
        bms, by = bound(nbytes, nops)
        out[name] = (ms, plain, bms, by, err)
        log(f"K2 {name} {tuple(x.shape)} on the {tag}: within rtol 1e-5 / atol 1e-4 of its twin "
            f"(max |diff| {err:.3g}); kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}, "
            f"{bms / ms:.1%} of it), twin {plain:.3f} ms"
            + ("" if comp is None else f", the composition it replaces {comp:.4f} ms")
            + f"; look-back past the tile before in {deep} of {tiles} tiles ({deep / tiles:.1%}); "
            f"one device kernel a call (profiler)")
    return out


def k3_cases(tmax, dev) -> dict:
    """K3's split, fold_in and uniform on the card against their int64 twins
    (random.split_twin, fold_in_twin, uniform_twin, run on the same CUDA
    key) at the refine's shapes at K3_FRAME: every bit equal, uniform in each of
    K3_RANGES at (tmax,), (4, tmax) and (K3_NODES,). Each draw held to one
    device kernel (profiler) and timed beside its twin: CUDA events over
    back-to-back draws, the kernel's own device time, the host's enqueue
    time a draw, and the bound of its output written once. Returns the
    kernel line's K3 entry, its `ms` the (K3_NODES,) draw."""
    from stereomatch_tpu_torch import random as trandom

    key = trandom.split(trandom.PRNGKey(7, dev), 3)[1]
    draws = {  # (K3's call, its twin's, the bytes it writes)
        "split3": (lambda: trandom.split(key, 3), lambda: trandom.split_twin(key, 3), 3 * 16),
        "fold_in": (lambda: trandom.fold_in(key, 2**32 - 1),
                    lambda: trandom.fold_in_twin(key, 2**32 - 1), 16),
    }
    for lo, hi in K3_RANGES:
        for name, shape in (("trees", (tmax,)), ("trees4", (4, tmax)), ("nodes", (K3_NODES,))):
            got = trandom.uniform(key, shape, lo, hi)
            want = trandom.uniform_twin(key, shape, lo, hi)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                n = int((got.view(torch.int32) != want.view(torch.int32)).sum())
                raise AssertionError(f"K3 uniform {shape} in [{lo}, {hi}): {n} draws differ "
                                     f"from the twin's bits")
            if (lo, hi) == ((-1.0, 1.0) if name == "trees4" else (0.0, 1.0)):
                draws[name] = (lambda s=shape, a=lo, b=hi: trandom.uniform(key, s, a, b),
                               lambda s=shape, a=lo, b=hi: trandom.uniform_twin(key, s, a, b),
                               4 * int(np.prod(shape)))
    for num in (1, 3, 1000):
        if not torch.equal(trandom.split(key, num), trandom.split_twin(key, num)):
            raise AssertionError(f"K3 split({num}) != its twin")
    for data in (0, 1, 2**31, 2**32 - 1):
        if not torch.equal(trandom.fold_in(key, data), trandom.fold_in_twin(key, data)):
            raise AssertionError(f"K3 fold_in({data}) != its twin")

    def host_us(fn, reps):
        """Host time a call to enqueue `reps` calls, no sync inside."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sec = time.perf_counter() - t0
        torch.cuda.synchronize()
        return sec / reps * 1e6

    rows = {}
    for name, (fn, twin, nbytes) in draws.items():
        nk, busy = device_trace(fn)
        if nk != 1:
            raise AssertionError(f"K3 {name}: {nk} device kernels a draw, not one")
        bms, by = bound(nbytes, 0.0)
        rows[name] = {"ms": cuda_time_ms(fn, 200), "kernel_ms": busy,
                      "plain_ms": cuda_time_ms(twin, 20), "host_us": host_us(fn, 200),
                      "plain_host_us": host_us(twin, 20), "bound_ms": bms, "bound_by": by}
        r = rows[name]
        log(f"K3 {name}: bit for bit its twin's; one device kernel a draw, "
            f"{r['kernel_ms'] * 1e3:.2f} us of it (profiler; bound {bms * 1e3:.3f} us, the "
            f"output written once); {r['ms'] * 1e3:.2f} us a draw back to back (CUDA events), "
            f"host {r['host_us']:.1f} us a draw; twin {r['plain_ms'] * 1e3:.1f} us, host "
            f"{r['plain_host_us']:.1f} us a draw")
    nodes = rows["nodes"]
    return {"name": "threefry_kernel", "route": "cuda",
            "source": "stereomatch_tpu_torch/csrc/threefry.cu",
            "replaces": "jax.random's threefry2x32 (split, fold_in, uniform)",
            "max_abs_err": 0.0, "ms": nodes["ms"], "plain_ms": nodes["plain_ms"],
            "bound_ms": nodes["bound_ms"], "bound_by": nodes["bound_by"], "library_ms": None,
            "shape": [K3_NODES], "draws": rows}


K4_PROFILE = f"""
import json
import torch
from torch.profiler import ProfilerActivity, profile
from stereomatch_tpu_torch.ops.filters import guided_filter_volume
dev = torch.device("cuda")
h, w, d = {K4_SHAPE}
g = torch.rand((h, w), device=dev) * 255
v = torch.rand((h, w, d), device=dev) * 3
guided_filter_volume(g, v, 9, 6.5025)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    guided_filter_volume(g, v, 9, 6.5025)
    torch.cuda.synchronize()
ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
print(json.dumps([[e.name, e.time_range.elapsed_us()] for e in ev]))
"""


def k4_kernels_a_call() -> tuple[list[str], float]:
    """(names of the device kernels, their summed device ms) of one K4 call
    at K4_SHAPE, from torch.profiler in a fresh process: late in a long
    process, and now and then early, a short trace has held no device
    event on the H100 (tests/test_torch_kernels_cuda.py::_kernels_a_call)."""
    out = subprocess.run([sys.executable, "-c", K4_PROFILE], capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"K4's profile failed: {out.stderr[-3000:]}")
    events = json.loads(out.stdout.strip().splitlines()[-1])
    return [n for n, _ in events], sum(us for _, us in events) / 1e3


def k4_cases(scene, dev) -> dict:
    """K4 on the left view of `scene` at K4_SHAPE: the adgrad volume and
    gray guide, as the servers' guided volume filters them, within K4_ATOL
    of its eager twin run in float64 (and beside the float32 twin, whose
    cumsum differences round by more at this size); one device kernel a call
    (profiler, in a fresh process); timed by CUDA events beside its bound (the
    volume and guide read once, the filtered volume written once) and beside
    the float32 twin. Returns the kernel line's K4 entry."""
    from stereomatch_tpu_torch.config import CostVolumeConfig, GuidedFilterConfig
    from stereomatch_tpu_torch.ops.cost import adgrad_bgr_volumes, bgr_to_gray
    from stereomatch_tpu_torch.ops.filters import guided_filter_volume, guided_filter_volume_twin

    h, w, d = K4_SHAPE
    g = GuidedFilterConfig()
    bl, br = (torch.from_numpy(np.ascontiguousarray(x[:h, :w])).float().to(dev)
              for x in (scene.left, scene.right))
    vol = adgrad_bgr_volumes(bl, br, CostVolumeConfig(min_disp=0, max_disp=d - 1))[0]
    guide = bgr_to_gray(bl)
    del br

    def kernel():
        return guided_filter_volume(guide, vol, g.radius, g.eps, g.slab)

    def twin():
        return guided_filter_volume_twin(guide, vol, g.radius, g.eps, g.slab)

    got = kernel()
    exact = guided_filter_volume_twin(guide.double(), vol.double(), g.radius, g.eps, g.slab)
    err = (got.double() - exact).abs().max().item()
    twin_err = (twin().double() - exact).abs().max().item()
    del exact
    f32 = (got - twin()).abs().max().item()
    del got
    if not err <= K4_ATOL:
        raise AssertionError(f"K4 {K4_SHAPE}: max |diff| {err:.3g} from its twin in float64, "
                             f"over {K4_ATOL}")
    names, busy = k4_kernels_a_call()
    if len(names) != 1 or "guided_filter_kernel" not in names[0]:
        raise AssertionError(f"K4: device kernels of a call {names}, not one K4")
    ms, plain = cuda_time_ms(kernel, 20), cuda_time_ms(twin, 3)
    # about 26 float operations an element: the vertical and horizontal
    # slides of p and g p, a and b, the slides of a and b, the output
    bms, by = bound((2 * d + 1) * h * w * 4, 26.0 * h * w * d)
    log(f"K4 {K4_SHAPE} guided filter (radius {g.radius}, eps {g.eps}): within {K4_ATOL} of its "
        f"twin in float64 (max |diff| {err:.3g}; the float32 twin's {twin_err:.3g}, K4 against "
        f"the float32 twin {f32:.3g}); one device kernel a call, {busy:.3f} ms of it (profiler); "
        f"kernel {ms:.3f} ms (CUDA events), bound {bms:.3f} ms ({by}, {bms / ms:.1%} of it), "
        f"twin {plain:.3f} ms")
    return {"name": "guided_filter_kernel", "route": "cuda",
            "source": "stereomatch_tpu_torch/csrc/guided_filter.cu",
            "replaces": "none: the eager box filters of ops/filters.py::guided_filter_volume_twin",
            "max_abs_err": err, "twin_f32_err": twin_err, "vs_twin_f32": f32,
            "ms": ms, "kernel_ms": busy, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None, "shape": list(K4_SHAPE)}


def counted(run):
    """Run one path with every launch counter set to 0 just before it;
    returns (its result, the counts just after it)."""
    from stereomatch_tpu_torch import random as trandom
    from stereomatch_tpu_torch.ops.filters import guided_filter_volume
    from stereomatch_tpu_torch.ops.mst_scan_cuda import ancestor_sums, segmented_cumsum
    from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda, aggregate_paths_cuda

    draws = (trandom.split, trandom.fold_in, trandom.uniform)
    for fn in (aggregate_8path_cuda, aggregate_paths_cuda, segmented_cumsum, ancestor_sums,
               guided_filter_volume, *draws):
        fn.launches = 0
    out = run()
    return out, {"K1": aggregate_8path_cuda.launches, "K1c": aggregate_paths_cuda.launches,
                 "K2": segmented_cumsum.launches, "K2a": ancestor_sums.launches,
                 "K3": sum(fn.launches for fn in draws), "K4": guided_filter_volume.launches}


def expect_launches(tag, got, keys, temporals, guided=0):
    """The servers' frames: a keyframe refines 4 iterations from 2 px, a
    temporal frame 2 from 4 px, 2 neighbour trees each; `guided` of them
    on the guided volume (K4 once a view)."""
    key = {**KEY_LAUNCHES, "K3": k3_frame(4, 2, 2.0), "K4": 0}
    temporal = {**TEMPORAL_LAUNCHES, "K3": k3_frame(2, 2, 4.0), "K4": 0}
    want = {k: keys * key[k] + temporals * temporal[k] for k in got}
    want["K4"] = 2 * guided
    expect_exact(tag, got, want, f"{keys} keyframes + {temporals} temporal frames")


def expect_exact(tag, got, want, mix):
    """`want` gives K1, K1c, K2 and K2a; K3 where the path draws and K4
    where it guided-filters volumes (else 0)."""
    want = {**K3_K4_NONE, **want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want} for {mix}")
    log(f"{tag}: launches {got} (K2 calls {got['K2'] + got['K2a']}) = {mix}")


def serve_video(srv, scenes):
    """Serve `scenes` one frame at a time; per frame (maps, seconds, keyframe?)."""
    out = []
    for sc in scenes:
        t0 = time.perf_counter()
        t = srv.submit_pair(sc.left, sc.right)
        is_key = srv._queue[-1].is_key
        dl, dr = srv.collect(t)
        out.append((dl, dr, time.perf_counter() - t0, is_key))
    return out


def video_path(cfg, dev) -> dict:
    """The video server at full width; returns each path's launch counts."""
    from stereomatch_tpu_torch.serving import compile_mst_video_server
    from stereomatch_tpu_torch.synthetic import render_sequence

    h, w = SHAPE
    t_video = time.perf_counter()
    t0 = time.perf_counter()
    seq = render_sequence(SCENE_SEED, VIDEO_FRAMES, h, w, MAX_DISP)
    log(f"render: {time.perf_counter() - t0:.1f} s ({VIDEO_FRAMES} frames, drift 2.0 px/frame)")
    headline = dict(cfg=cfg, device=dev, reuse_forest=True, volume_guided=False)
    servers = {
        "video_headline": compile_mst_video_server(
            h, w, reseed_every=RESEED_EVERY, scene_cut_ratio=0.6, **headline),
        "video_guided_rebuild": compile_mst_video_server(h, w, cfg=cfg, device=dev),
        "video_cut": compile_mst_video_server(h, w, scene_cut_ratio=0.6, **headline),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    for name, scenes in (("video_headline", seq), ("video_guided_rebuild", seq[:3])):
        srv = servers[name]
        frames, launches[name] = counted(lambda: serve_video(srv, scenes))
        for i, (dl, dr, sec, is_key) in enumerate(frames):
            kind = "keyframe" if is_key else "temporal"
            msg = gate(dl, dr, scenes[i], GATES if is_key else TEMPORAL_GATES,
                       f"{name} frame {i} ({kind})")
            log(f"{name} frame {i}: {kind}, {sec:.3f} s, {msg}")
        if srv.scene_cuts:
            raise AssertionError(f"{name}: {srv.scene_cuts} scene cuts on a smooth sequence")
        kinds = [f[3] for f in frames]
        want = [i % RESEED_EVERY == 0 if name == "video_headline" else i == 0
                for i in range(len(scenes))]
        if kinds != want:
            raise AssertionError(f"{name}: keyframes at {kinds}, expected {want}")
        expect_launches(name, launches[name], sum(kinds), len(kinds) - sum(kinds),
                        guided=len(kinds) if name == "video_guided_rebuild" else 0)

    # one hard cut: the mirrored scene after scene 0
    srv = servers["video_cut"]
    sc0 = seq[0]
    cut_l, cut_r = sc0.left[:, ::-1].copy(), sc0.right[:, ::-1].copy()

    def cut_run():
        t0 = time.perf_counter()
        ta = srv.submit_pair(sc0.left, sc0.right, seed=0)
        tb = srv.submit_pair(cut_l, cut_r, seed=1)
        srv.collect(ta)
        out = srv.collect(tb)
        return out, time.perf_counter() - t0

    ((cl, cr), sec), launches["video_cut"] = counted(cut_run)
    if srv.scene_cuts != 1:
        raise AssertionError(f"the mirrored scene fired {srv.scene_cuts} scene cuts, not 1")
    expect_launches("video_cut", launches["video_cut"], 2, 1)  # key, temporal, replay
    fresh = compile_mst_video_server(h, w, **headline)
    fl, fr = fresh.collect(fresh.submit_pair(cut_l, cut_r, seed=1))
    same = min(float(np.mean(np.abs(cl - fl) <= 0.5)), float(np.mean(np.abs(cr - fr) <= 0.5)))
    if not same > 0.99:
        raise AssertionError(f"the replayed cut frame equals a fresh keyframe on {same:.4f} of pixels")
    log(f"video_cut: 1 scene cut in {sec:.3f} s (2 frames); the replayed frame equals a fresh "
        f"keyframe within 0.5 px on {same:.5f} of pixels")
    log(f"video: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"section wall time {time.perf_counter() - t_video:.1f} s")
    return launches


def host_forest_paths(scene, dev) -> dict:
    """The paths of the host forest and random init, on `scene`: the flat
    frame and the seeded frame through pipelines.py, with a stage
    breakdown of the flat frame's left view, then mst_stereo_fused; each
    gated on GT. Returns each path's launch counts."""
    from stereomatch_tpu_torch import pipelines
    from stereomatch_tpu_torch import random as trandom
    from stereomatch_tpu_torch.config import MSTConfig
    from stereomatch_tpu_torch.models.mst import mst_stereo_fused
    from stereomatch_tpu_torch.native import build_forest, color_edge_weights
    from stereomatch_tpu_torch.ops.filters import median3x3
    from stereomatch_tpu_torch.ops.mst import forest_arrays, mst_pms_optimize

    t_section = time.perf_counter()
    cfg = MSTConfig(**FLAT_CFG)
    rgb_l, rgb_r = scene.left[..., ::-1], scene.right[..., ::-1]  # the scenes are BGR
    launches = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (maps, sec), launches["flat"] = counted(lambda: timed(
        lambda: pipelines.mst_pipeline(rgb_l, rgb_r, cfg=cfg, seed=0, device=dev)))
    log(f"flat frame (mst_pipeline, {cfg.iterations} random-init iterations, host forest): "
        f"{sec:.3f} s, {gate(*maps, scene, GATES, 'flat frame')}")
    expect_exact("flat", launches["flat"],
                 {**FLAT_LAUNCHES, "K3": k3_frame(cfg.iterations, 8, random_init=True), "K4": 2},
                 f"2 views x {cfg.iterations} iterations x 3")

    # the flat frame's left view, stage by stage (host clock + sync)
    stages = {}
    left = torch.from_numpy(scene.left).to(dev)
    img, stages["median3x3"] = timed(lambda: median3x3(left))
    host, stages["image_to_host"] = timed(lambda: img.cpu().numpy())
    (wr, wd), stages["edge_weights_host"] = timed(lambda: color_edge_weights(host))
    forest, stages["forest_build_host"] = timed(
        lambda: build_forest(wr, wd, cfg.c, cfg.min_cc_size, cfg.gamma, cfg.max_log_range))
    fa, stages["forest_arrays"] = timed(lambda: forest_arrays(forest, dev))
    vl, _ = pipelines._volumes(rgb_l, rgb_r, None, None, MAX_DISP, dev)
    kl = trandom.split(trandom.PRNGKey(0, dev))[0]
    _, stages["optimize_left"] = timed(lambda: mst_pms_optimize(kl, vl, fa, cfg))
    log("flat_stages_ms " + json.dumps({k: round(v * 1e3, 3) for k, v in stages.items()})
        + f" ({forest.num_trees} trees, {forest.num_segments} segments)")
    del left, img, host, fa, vl

    (maps, sec), launches["seeded_host"] = counted(lambda: timed(
        lambda: pipelines.sgbm_mst_pipeline(rgb_l, rgb_r, cfg=cfg, seed=0, device=dev)))
    log(f"seeded frame on the host forest (sgbm_mst_pipeline, 10 iterations): {sec:.3f} s, "
        f"{gate(*maps, scene, GATES, 'seeded host frame')}")
    expect_exact("seeded_host", launches["seeded_host"],
                 {**SEEDED_HOST_LAUNCHES, "K3": k3_frame(10, 2, 2.0), "K4": 2},
                 "1 SGBM seed + 2 views x (1 seed cost + 10 iterations) x 3")

    # the built-in guided volumes, as mst_pipeline makes them, outside the count
    lv, rv = pipelines._volumes(rgb_l, rgb_r, None, None, MAX_DISP, dev)
    fcfg = dataclasses.replace(cfg, iterations=FUSED_ITERS)
    (out, sec), launches["fused_random"] = counted(lambda: timed(lambda: mst_stereo_fused(
        scene.left, scene.right, lv, rv, fcfg, seed=0, device=dev)))
    maps = (out.left_disp.cpu().numpy(), out.right_disp.cpu().numpy())
    del lv, rv, out
    log(f"fused random-init frame (mst_stereo_fused, {FUSED_ITERS} iterations, device forest, "
        f"its default 8 neighbour trees): {sec:.3f} s, "
        f"{gate(*maps, scene, FUSED_GATES, 'fused frame')}")
    expect_exact("fused_random", launches["fused_random"],
                 {**FUSED_LAUNCHES, "K3": k3_frame(FUSED_ITERS, 8, random_init=True)},
                 f"2 views x {FUSED_ITERS} iterations x 3")
    log(f"host forest and random-init section wall time {time.perf_counter() - t_section:.1f} s")
    return launches


def classic_paths(scene, dev) -> dict:
    """The four classical pipelines on `scene` (RGB in, numpy out): the
    cost-volume pipeline (guided radius 9, 100 denoise iterations, LR
    check and fill), SGBM (f32 cost, speckle 100 / 32), BM and census. Per
    pipeline: one warm call, whose launches are counted (K1 once for SGBM,
    no kernel for the others), then CLASSIC_TIMED calls on the host clock
    around synchronize, the peak device memory over the calls, and the GT
    digits of the warm call's map, gated. Reports whether SGBM's maps of
    the same frame are bit-equal call to call. Returns each path's
    launch counts."""
    from stereomatch_tpu_torch import pipelines
    from stereomatch_tpu_torch.config import (
        BMConfig, CensusConfig, CostVolumeConfig, CostVolumePipelineConfig, SGBMConfig,
    )
    from stereomatch_tpu_torch.eval import disparity_metrics
    from stereomatch_tpu_torch.synthetic import scene_eval_mask

    t_section = time.perf_counter()
    rgb_l, rgb_r = scene.left[..., ::-1], scene.right[..., ::-1]  # the scenes are BGR
    d = MAX_DISP
    cv_cfg = CostVolumePipelineConfig(volume=CostVolumeConfig(min_disp=0, max_disp=d - 1))
    runs = {  # (one call, the map tests/test_gt_battery.py scores)
        "costvolume": (lambda: pipelines.costvolume_pipeline(
            rgb_l, rgb_r, cv_cfg, lr_check=True, device=dev)[0], lambda x: x),
        "sgbm": (lambda: pipelines.sgbm_pipeline(
            rgb_l, rgb_r, SGBMConfig(min_disp=0, num_disp=d, block_size=5), device=dev),
            lambda x: x),
        "bm": (lambda: pipelines.bm_pipeline(
            rgb_l, rgb_r, BMConfig(num_disp=d, block_size=9), device=dev),
            lambda x: np.where(x < 0, 0, x)),
        "census": (lambda: pipelines.census_pipeline(
            rgb_l, rgb_r, CensusConfig(d_max=d - 1), device=dev), lambda x: x),
    }
    mask = torch.from_numpy(scene_eval_mask(scene))
    gt = torch.from_numpy(scene.disp_left)
    launches = {}
    for name, (run, score) in runs.items():
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        maps = []
        t0 = time.perf_counter()
        path = f"{name}_pipeline"
        _, launches[path] = counted(lambda: maps.append(run()))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        expect_exact(path, launches[path],
                     {"K1": int(name == "sgbm"), "K1c": 0, "K2": 0, "K2a": 0,
                      "K4": 2 * (name == "costvolume")}, "one call")
        secs = []
        for _ in range(CLASSIC_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps.append(run())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        est = np.asarray(score(maps[0]), np.float32)
        if est.shape != gt.shape or not np.isfinite(est).all():
            raise AssertionError(f"{name}: bad output shape or non-finite values")
        mm = disparity_metrics(torch.from_numpy(est), gt, mask)
        digits = ", ".join(f"{k} {mm[k]:.4f}" for k in ("epe", "bad2", "d1_all"))
        gates = CLASSIC_GATES[name]
        if not all(mm[k] < limit for k, limit in gates.items()):
            raise AssertionError(f"{name} misses its GT gates {gates}: {digits}")
        same = all(np.array_equal(maps[0], m) for m in maps[1:])
        repeat = f"maps of the {len(maps)} calls bit-equal: {same}"
        if not same:
            n_diff = max(int(np.count_nonzero(maps[0] != m)) for m in maps[1:])
            big = max(float(np.abs(maps[0] - m).max()) for m in maps[1:])
            repeat += f" (at most {n_diff} pixels differ from the first call's, max |diff| {big:.3g})"
        log(f"{path} {'x'.join(map(str, est.shape))}x{d}: warm {warm:.3f} s, then "
            f"{['%.4f' % s for s in secs]} s; peak device memory {peak / 1e9:.2f} GB "
            f"({(peak - resident) / 1e9:.2f} GB above the {resident / 1e9:.2f} GB resident); "
            f"GT {digits} (gates {gates}); {repeat}")
        del maps
    log(f"classical engines section wall time {time.perf_counter() - t_section:.1f} s")
    return launches


def patchmatch_paths(scene, dev) -> dict:
    """The two PatchMatch engines on `scene` as the CLI runs them: the
    PatchMatch pipeline (RGB in, numpy out, seed 0; its left map scored) and
    the coupled engine from the built-in guided volumes (key 0; its
    smoothed field scored). Per engine: one warm call, whose launches are
    counted (no kernel), one call timed on the host clock around
    synchronize, the peak device memory over both above the resident, the
    GT digits of the warm call's map, gated, and whether the two calls'
    maps are bit-equal. Then the window cost each engine runs, timed at full
    size by CUDA events on the left view's random initial planes, with its
    device kernels a call and their summed device time (profiler) and its
    calls an engine call. Returns each path's launch counts."""
    from stereomatch_tpu_torch import pipelines
    from stereomatch_tpu_torch import random as trandom
    from stereomatch_tpu_torch.apps.stereo_yin import builtin_cost_volumes
    from stereomatch_tpu_torch.config import CoupledConfig, PatchMatchConfig
    from stereomatch_tpu_torch.eval import disparity_metrics
    from stereomatch_tpu_torch.models.coupled import coupled_patchmatch_stereo
    from stereomatch_tpu_torch.ops.coupled import hybrid_plane_cost
    from stereomatch_tpu_torch.ops.patchmatch import _rand_init, _refine_ladder, _Views
    from stereomatch_tpu_torch.synthetic import scene_eval_mask

    t_section = time.perf_counter()
    rgb_l, rgb_r = scene.left[..., ::-1], scene.right[..., ::-1]  # the scenes are BGR
    pm_cfg = PatchMatchConfig(**PM_CFG)
    c_cfg = CoupledConfig(max_disp=MAX_DISP - 1)

    def coupled():
        """apps/cli.py's coupled engine: the volumes, then the engine."""
        rl, rr = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                  for x in (rgb_l, rgb_r))
        lvol, _ = builtin_cost_volumes(rl, rr, MAX_DISP)
        out = coupled_patchmatch_stereo(trandom.PRNGKey(0, dev), pipelines.to_bgr255(rgb_l, dev),
                                        lvol, c_cfg)
        return out.smoothed.cpu().numpy()

    k3_draws = {"patchmatch_pipeline": k3_patchmatch(pm_cfg),
                "coupled_patchmatch": k3_coupled(c_cfg)}
    runs = {
        "patchmatch_pipeline": lambda: pipelines.patchmatch_pipeline(rgb_l, rgb_r, pm_cfg,
                                                                     device=dev)[0],
        "coupled_patchmatch": coupled,
    }
    mask = torch.from_numpy(scene_eval_mask(scene))
    gt = torch.from_numpy(scene.disp_left)
    launches = {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        maps = []
        t0 = time.perf_counter()
        _, launches[name] = counted(lambda: maps.append(run()))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        expect_exact(name, launches[name], {"K1": 0, "K1c": 0, "K2": 0, "K2a": 0,
                                            "K3": k3_draws[name],
                                            "K4": 2 * (name == "coupled_patchmatch")}, "one call")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps.append(run())
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        est = np.asarray(maps[0], np.float32)
        if est.shape != gt.shape or not np.isfinite(est).all():
            raise AssertionError(f"{name}: bad output shape or non-finite values")
        mm = disparity_metrics(torch.from_numpy(est), gt, mask)
        digits = ", ".join(f"{k} {mm[k]:.4f}" for k in ("epe", "bad2", "d1_all"))
        if not all(mm[k] < limit for k, limit in PM_GATES.items()):
            raise AssertionError(f"{name} misses its GT gates {PM_GATES}: {digits}")
        same = np.array_equal(maps[0], maps[1])
        repeat = f"the two calls' maps bit-equal: {same}"
        if not same:
            repeat += (f" ({int(np.count_nonzero(maps[0] != maps[1]))} pixels differ, max |diff| "
                       f"{float(np.abs(maps[0] - maps[1]).max()):.3g})")
        log(f"{name} {'x'.join(map(str, est.shape))}x{MAX_DISP}: warm {warm:.3f} s, then "
            f"{sec:.3f} s; peak device memory {peak / 1e9:.2f} GB "
            f"({(peak - resident) / 1e9:.2f} GB above the {resident / 1e9:.2f} GB resident); "
            f"GT {digits} (gates {PM_GATES}); {repeat}")
        del maps

    # the window costs at full size, on the left view's random initial planes
    h, w = SHAPE
    left = torch.from_numpy(scene.left.astype(np.float32)).to(dev)
    right = torch.from_numpy(scene.right.astype(np.float32)).to(dev)
    views = _Views(left, right, pm_cfg)
    planes = _rand_init(trandom.PRNGKey(0, dev), h, w, pm_cfg)
    lvol, _ = builtin_cost_volumes(left.flip(-1), right.flip(-1), MAX_DISP)
    # a PatchMatch round costs 8 spatial, 1 view and the refinement candidates
    # a view; a coupled round the current label, 8 neighbours and the refinements
    pm_calls = 2 + 2 * pm_cfg.iterations * (9 + len(_refine_ladder(pm_cfg.max_disp)))
    c_calls = c_cfg.outer_iterations * (9 + len(_refine_ladder(c_cfg.max_disp)))
    costs = {
        "plane_cost": (lambda: views.cost(planes, 0), pm_calls),
        "hybrid_plane_cost": (lambda: hybrid_plane_cost(left, lvol, planes, c_cfg, -1), c_calls),
    }
    taps = len(range(0, pm_cfg.window_size, pm_cfg.tap_stride)) ** 2
    for name, (fn, calls) in costs.items():
        ms = cuda_time_ms(fn, 5)
        nk, busy = device_trace(fn)
        log(f"{name} {h}x{w} ({taps} taps): {ms:.3f} ms a call (CUDA events), {nk} device "
            f"kernels a call busy {busy:.3f} ms (profiler), {calls} calls an engine call "
            f"({ms * calls / 1e3:.2f} s of them)")
    del views, planes, lvol, left, right
    log(f"PatchMatch engines section wall time {time.perf_counter() - t_section:.1f} s")
    return launches


def banded_sgbm_path(sc, dev) -> tuple[dict, dict]:
    """The band-streamed SGBM on `sc`, the scene rendered at BAND_SHAPE:
    `pipelines.sgbm_pipeline` with SGBMConfig() and speckle, which takes the band
    branch; one warm call (its launches counted and held to
    BAND_LAUNCHES), BAND_TIMED timed calls, the peak device memory above
    the resident, the GT digits gated, whether the maps are bit-equal call
    to call. Then the banded SGBM against the whole-frame sgbm_disparity
    (both peaks): validity or a disparity step flipped on under 0.2% of
    the frame's pixels, and on the same gray rounded to integers no pixel
    differing at all (every SGBM sum is exact there); K1 at D = 256 on the
    whole frame's cost against its twin, and K1c against its twin on one
    band with the carries the bands around it hand it. Returns (each path's
    launch counts, the kernel rows of K1 at D = 256 and of K1c)."""
    from stereomatch_tpu_torch import pipelines
    from stereomatch_tpu_torch.config import SGBMConfig
    from stereomatch_tpu_torch.eval import disparity_metrics
    from stereomatch_tpu_torch.ops.sgbm import (
        SGBM_DIRECTIONS, _band_cost, aggregate_8path, aggregate_paths, sgbm_cost_volume,
        sgbm_disparity, sgbm_disparity_banded,
    )
    from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda, aggregate_paths_cuda
    from stereomatch_tpu_torch.synthetic import scene_eval_mask

    t_section = time.perf_counter()
    h, w, d = BAND_SHAPE
    rgb_l, rgb_r = sc.left[..., ::-1], sc.right[..., ::-1]  # the scenes are BGR
    cfg = SGBMConfig()
    if h * w * cfg.num_disp * 4 <= pipelines.SGBM_BAND_THRESHOLD_BYTES:
        raise AssertionError(f"{h}x{w}x{cfg.num_disp} is below the band threshold")
    launches = {}

    def run():
        return pipelines.sgbm_pipeline(rgb_l, rgb_r, cfg, speckle=True, device=dev)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    maps = []
    t0 = time.perf_counter()
    _, launches["sgbm_banded_pipeline"] = counted(lambda: maps.append(run()))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    expect_exact("sgbm_banded_pipeline", launches["sgbm_banded_pipeline"], BAND_LAUNCHES,
                 "one call: 12 bands of 128 rows, 11 up-sweep + 12 down-sweep K1c launches")
    secs = []
    for _ in range(BAND_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps.append(run())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak_band = torch.cuda.max_memory_allocated() - resident
    est = np.asarray(maps[0], np.float32)
    if est.shape != (h, w) or not np.isfinite(est).all():
        raise AssertionError("sgbm_banded: bad output shape or non-finite values")
    mm = disparity_metrics(torch.from_numpy(est), torch.from_numpy(sc.disp_left),
                           torch.from_numpy(scene_eval_mask(sc)))
    digits = ", ".join(f"{k} {mm[k]:.5f}" for k in ("epe", "bad2", "d1_all"))
    if not all(mm[k] < limit for k, limit in BAND_GATES.items()):
        raise AssertionError(f"sgbm_banded misses its GT gates {BAND_GATES}: {digits}")
    same = all(np.array_equal(maps[0], m) for m in maps[1:])
    log(f"sgbm_banded_pipeline {h}x{w}x{cfg.num_disp} (SGBMConfig(), speckle): warm "
        f"{warm:.3f} s, then {['%.4f' % x for x in secs]} s; peak device memory "
        f"{peak_band / 1e9:.2f} GB above the {resident / 1e9:.2f} GB resident; GT {digits} "
        f"(gates {BAND_GATES}); maps of the {len(maps)} calls bit-equal: {same}")
    del maps

    # the banded SGBM against the whole frame, on the same gray
    gl, gr = pipelines._gray255(rgb_l, dev), pipelines._gray255(rgb_r, dev)
    peaks = {}

    def peak_of(name, fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0)
        return out

    band = peak_of("banded", lambda: sgbm_disparity_banded(gl, gr, cfg, device=dev))
    mono, launches["sgbm_monolithic_2048"] = counted(
        lambda: peak_of("monolithic", lambda: sgbm_disparity(gl, gr, cfg)))
    expect_exact("sgbm_monolithic_2048", launches["sgbm_monolithic_2048"],
                 {"K1": 1, "K1c": 0, "K2": 0, "K2a": 0}, "one whole-frame call")

    def flip_share(a, b, tol):
        return ((a.valid != b.valid) | ((a.disparity - b.disparity).abs() > tol)).double().mean()

    # On the float luma the block sums' cumsum prefixes run over 1536 rows
    # in the whole frame and over 134 in a band strip, so the costs differ
    # in their last bits (the JAX package's docstring says so, and its own
    # two functions differ the same way), and the subpixel offset divides
    # S's differences by a denominator as small as 1: the maps differ in
    # their subpixel bits on many pixels, while only a cost tie resolved
    # the other way moves a disparity by a step or flips validity. On the
    # same gray rounded to integers every sum is exact, so the two maps
    # must be equal on every pixel.
    jitter, ties = flip_share(mono, band, 1e-5).item(), flip_share(mono, band, 0.1).item()
    del band, mono
    band_i = sgbm_disparity_banded(gl.round(), gr.round(), cfg, device=dev)
    mono_i = sgbm_disparity(gl.round(), gr.round(), cfg)
    exact = flip_share(mono_i, band_i, 0.0).item()
    del band_i, mono_i
    log(f"sgbm_disparity_banded vs sgbm_disparity {h}x{w}x{cfg.num_disp}: the float luma's maps "
        f"differ by more than 1e-5 px or in validity on {jitter:.6f} of pixels, by more than "
        f"0.1 px or in validity on {ties:.6f}; the integer gray's differ at all on {exact:.6f}; "
        f"peak device "
        f"memory above the start {peaks['banded'][0] / 1e9:.2f} GB banded "
        f"({peaks['banded'][1]:.3f} s), {peaks['monolithic'][0] / 1e9:.2f} GB whole frame "
        f"({peaks['monolithic'][1]:.3f} s)")
    if not (ties < 0.002 and exact == 0):
        raise AssertionError(f"banded vs whole-frame SGBM: {ties:.5f} of the float luma's pixels "
                             f"flip, and {exact:.6f} of the integer gray's differ")
    if not peaks["banded"][0] < peaks["monolithic"][0]:
        raise AssertionError("the banded SGBM's peak is not below the whole frame's")

    p1, p2 = (float(p) for p in cfg.resolved_p1p2())
    margin = cfg.min_disp + cfg.num_disp
    rows = {}
    # ---- K1 at D = 256 on the whole frame's cost, as the K1 block at D = 128 ----
    c = sgbm_cost_volume(gl, gr, cfg)[:, margin:].contiguous()
    got = aggregate_8path_cuda(c, p1, p2, cfg.num_paths)
    want = aggregate_8path(c, p1, p2, cfg.num_paths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=0.0)
    err = (got - want).abs().max().item()
    del got, want
    ci = c.round()
    if not torch.equal(aggregate_8path_cuda(ci, p1, p2, cfg.num_paths),
                       aggregate_8path(ci, p1, p2, cfg.num_paths)):
        raise AssertionError("K1 != twin on integer costs at D = 256")
    del ci
    ms = cuda_time_ms(lambda: aggregate_8path_cuda(c, p1, p2, cfg.num_paths), 5)
    plain = cuda_time_ms(lambda: aggregate_8path(c, p1, p2, cfg.num_paths), 1)
    bms, by = bound(c.numel() * 8, 8.0 * cfg.num_paths * c.numel())
    rows["K1_d256"] = {"shape": list(c.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain,
                       "bound_ms": bms, "bound_by": by}
    log(f"K1 float32 {tuple(c.shape)}: within rtol {K1_RTOL} of the twin (max |diff| {err:.3g}); "
        f"integer costs bitwise equal; kernel {ms:.3f} ms, twin {plain:.1f} ms, bound "
        f"{bms:.3f} ms ({by})")
    del c

    # ---- K1c on band 1 of the frame, with the carries its neighbours hand it ----
    rows_idx = torch.clamp(torch.arange(-3, 4 * 128 + 3, device=dev), 0, h - 1)
    lp, rp = gl.index_select(0, rows_idx), gr.index_select(0, rows_idx)
    dirs = SGBM_DIRECTIONS[cfg.num_paths]
    k1c_err = 0.0
    for integer in (False, True):
        band_c = [_band_cost(lp, rp, b, 128, h, margin, cfg) for b in range(3)]
        if integer:
            band_c = [x.round() for x in band_c]
        down = torch.empty((3,) + band_c[0].shape[1:], device=dev)
        aggregate_paths_cuda(band_c[0], p1, p2, dirs[:3], None, down, with_s=False)
        up = torch.empty_like(down)
        aggregate_paths_cuda(band_c[2], p1, p2, dirs[3:6], None, up, with_s=False)
        carry = torch.cat([down, up])
        out, out_twin = torch.empty_like(carry), torch.empty_like(carry)
        got = aggregate_paths_cuda(band_c[1], p1, p2, dirs, carry, out)
        want = aggregate_paths(band_c[1], p1, p2, dirs, carry, out_twin)
        torch.cuda.synchronize()
        if not torch.equal(out, out_twin):
            raise AssertionError(f"K1c's carry != twin's (integer costs: {integer})")
        if integer:
            if not torch.equal(got, want):
                raise AssertionError("K1c != twin on integer costs")
        else:
            torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=0.0)
            k1c_err = (got - want).abs().max().item()
    cb = band_c[1]
    ms = cuda_time_ms(lambda: aggregate_paths_cuda(cb, p1, p2, dirs, carry, out), 10)
    plain = cuda_time_ms(lambda: aggregate_paths(cb, p1, p2, dirs, carry, out_twin), 1)
    up_ms = cuda_time_ms(lambda: aggregate_paths_cuda(cb, p1, p2, dirs[3:6], up, down,
                                                      with_s=False), 10)
    # the band's C read once, S written once, the carries read and written once
    bms, by = bound(cb.numel() * 8 + carry.numel() * 8, 8.0 * len(dirs) * cb.numel())
    rows["K1c"] = {"shape": list(cb.shape), "max_abs_err": k1c_err, "ms": ms, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "up_sweep_ms": up_ms}
    log(f"K1c {tuple(cb.shape)} (band 1 of {-(-h // 128)}, 8 directions, 6 carried): carries "
        f"bitwise equal "
        f"to the twin's, S within rtol {K1_RTOL} (max |diff| {k1c_err:.3g}), integer costs "
        f"bitwise equal; kernel {ms:.3f} ms (the up sweep's 3 directions without S "
        f"{up_ms:.3f} ms), twin {plain:.1f} ms, bound {bms:.4f} ms ({by})")
    del band_c, carry, out, out_twin, got, want, lp, rp, gl, gr
    log(f"band-streamed SGBM section wall time {time.perf_counter() - t_section:.1f} s")
    return launches, rows


def c2f_prior_paths(scene, dev) -> dict:
    """The coarse-to-fine 3DMST on `scene` as tests/test_engine_gates.py
    runs it (C2F_CFG, C2F_RUN, host forest, the built-in guided volumes),
    with 2TGV and then with no prior, each counted, timed and gated; then
    the two other priors (NL2TGV, TV) through `_apply_smoothness` on the
    prior-free (LR-checked) left map, timed with their device kernels a call
    (profiler); then `coupled_wta_stereo` on the guided left volume: one
    warm call and one timed, bit-equality, GT digits gated. Returns each
    path's launch counts."""
    from stereomatch_tpu_torch import pipelines
    from stereomatch_tpu_torch.config import CoupledConfig, MSTConfig
    from stereomatch_tpu_torch.eval import disparity_metrics
    from stereomatch_tpu_torch.models.coupled import coupled_wta_stereo
    from stereomatch_tpu_torch.models.mst import _apply_smoothness, mst_stereo_c2f
    from stereomatch_tpu_torch.ops.tgv import TGVParams
    from stereomatch_tpu_torch.synthetic import scene_eval_mask

    t_section = time.perf_counter()
    rgb_l, rgb_r = scene.left[..., ::-1], scene.right[..., ::-1]  # the scenes are BGR
    lv, rv = pipelines._volumes(rgb_l, rgb_r, None, None, MAX_DISP, dev)
    bl, br = pipelines.to_bgr255(rgb_l, dev), pipelines.to_bgr255(rgb_r, dev)
    launches, left_none = {}, None
    for prior in ("2TGV", "NONE"):
        cfg = MSTConfig(**{**C2F_CFG, "smoothness_prior": prior})
        path = f"c2f_{prior.lower()}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches[path] = counted(lambda: mst_stereo_c2f(bl, br, lv, rv, cfg, **C2F_RUN,
                                                             device=dev))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        maps = (out.left_disp.cpu().numpy(), out.right_disp.cpu().numpy())
        log(f"{path} (mst_stereo_c2f, k {C2F_RUN['k']}, {C2F_RUN['coarse_iterations']} coarse + "
            f"{C2F_RUN['fine_iterations']} fine iterations, host forest, {prior} at "
            f"{cfg.smoothness_iters} iterations): {sec:.3f} s, "
            f"{gate(*maps, scene, GATES, path)}")
        # each view: split into the coarse and fine keys, the coarse random
        # init at max_disp / k, the fine stage from its labels
        k3 = 1 + k3_optimize(C2F_RUN["coarse_iterations"], 8, max_disp=MAX_DISP // C2F_RUN["k"],
                             random_init=True) + k3_optimize(C2F_RUN["fine_iterations"], 8)
        expect_exact(path, launches[path], {**C2F_LAUNCHES, "K3": 1 + 2 * k3},
                     "2 views x (30 coarse + 1 seed cost + 10 fine iterations) x 3")
        if prior == "NONE":
            left_none = out.left_disp
        del out

    # the other two priors at full size, on the prior-free left map
    for prior in ("NL2TGV", "TV"):
        cfg = MSTConfig(**{**C2F_CFG, "smoothness_prior": prior})

        def refine():
            return _apply_smoothness(left_none, bl, cfg)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = refine()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if u.shape != left_none.shape or not torch.isfinite(u).all():
            raise AssertionError(f"{prior}: bad output shape or non-finite values")
        nk, busy = device_trace(refine)
        log(f"_apply_smoothness {prior} {tuple(u.shape)} ({cfg.smoothness_iters} iterations): "
            f"{sec:.3f} s, {nk} device kernels a call busy {busy:.3f} ms (profiler)")
    del left_none, rv, bl, br

    # coupled_wta_stereo, the left luma its guide
    rgb = np.asarray(rgb_l, np.float32)
    luma = torch.from_numpy(0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
    c_cfg = CoupledConfig(max_disp=MAX_DISP - 1)

    def cwta():
        return coupled_wta_stereo(lv, luma, c_cfg, TGVParams(), device=dev).disparity

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first, launches["coupled_wta"] = counted(cwta)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    expect_exact("coupled_wta", launches["coupled_wta"], {"K1": 0, "K1c": 0, "K2": 0, "K2a": 0},
                 "one call")
    t0 = time.perf_counter()
    second = cwta()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    est = first.cpu()
    if est.shape != scene.disp_left.shape or not torch.isfinite(est).all():
        raise AssertionError("coupled_wta: bad output shape or non-finite values")
    mm = disparity_metrics(est, torch.from_numpy(scene.disp_left),
                           torch.from_numpy(scene_eval_mask(scene)))
    digits = ", ".join(f"{k} {mm[k]:.5f}" for k in ("epe", "bad2", "d1_all"))
    if not all(mm[k] < limit for k, limit in CWTA_GATES.items()):
        raise AssertionError(f"coupled_wta misses its GT gates {CWTA_GATES}: {digits}")
    log(f"coupled_wta {tuple(est.shape)}x{MAX_DISP} ({c_cfg.outer_iterations} rounds of "
        f"{c_cfg.smooth_iters} TGV steps): warm {warm:.3f} s, then {sec:.3f} s; peak device "
        f"memory {peak / 1e9:.2f} GB above the {resident / 1e9:.2f} GB resident; GT {digits} "
        f"(gates {CWTA_GATES}); the two calls' maps bit-equal: {torch.equal(first, second)}")
    del lv, first, second
    log(f"c2f, priors and coupled-WTA section wall time {time.perf_counter() - t_section:.1f} s")
    return launches


def scored_digits(est, gt, scored) -> dict:
    """The GT digits of a map on the `scored` pixels (numpy in)."""
    from stereomatch_tpu_torch.eval import disparity_metrics

    if est.shape != gt.shape or not np.isfinite(est).all():
        raise AssertionError("bad output shape or non-finite values")
    mm = disparity_metrics(torch.from_numpy(est), torch.from_numpy(gt), torch.from_numpy(scored))
    return {"valid": float(scored.mean()), **mm}


def check_gates(tag, mm, gates) -> str:
    """Hold `mm` under each gate (over it for "valid"); returns the digits."""
    digits = ", ".join(f"{k} {mm[k]:.5f}" for k in ("valid", "epe", "bad2", "d1_all"))
    ok = all(mm[k] > v if k == "valid" else mm[k] < v for k, v in gates.items())
    if not ok:
        raise AssertionError(f"{tag} misses its GT gates {gates}: {digits}")
    return f"GT {digits} (gates {gates})"


def upsampled2(img):
    """Each pixel as a 2x2 block: [::2, ::2] of the result is `img`."""
    return np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)


def apps_paths(band_scene, dev) -> dict:
    """The four apps through their run / main on files this phase writes
    (frames as 8-bit PNG under the FLIR names, the identity rig as YAML and
    XML FileStorage, the distorted rig as XML), in a temporary directory
    under build/. stereo_test on `band_scene` (uncut): its map held to
    ops.sgbm.sgbm_disparity on the same gray, GT gated, stages, peak memory
    and the cloud's points. stereo_yin at YIN_SHAPE (built-in volumes), then
    at a quarter scale both routes, the mc-cnn one reading the built-in
    volumes written with save_mccnn_volume. stream.run_mst in video mode,
    stream.run, and run_mst again with resume. The CLI's ten algorithms.
    Each run's launches are counted and held. Returns them by path."""
    import os
    import tempfile

    from stereomatch_tpu_torch.apps import cli, stereo_test, stereo_yin, stream
    from stereomatch_tpu_torch.config import CoupledConfig, PatchMatchConfig, SGBMConfig
    from stereomatch_tpu_torch.io import (
        clean_mccnn, load_image, load_mccnn_volume, save_mccnn_volume,
    )
    from stereomatch_tpu_torch.ops.sgbm import sgbm_disparity
    from stereomatch_tpu_torch.synthetic import render_scene, render_sequence, scene_eval_mask

    t_section = time.perf_counter()
    launches = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_apps_", dir=root)
    tmp = tmp_dir.name
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    os.makedirs(data)

    def timed(fn):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - resident

    # ---- stereo_test: the 2048x1536 FLIR frame at 256 disparities, uncut ----
    h, w = band_scene.disp_left.shape
    rig = os.path.join(data, "identity.yml")
    write_calibration(rig, **identity_calibration(h, w))
    write_calibration(os.path.join(data, "identity.xml"), **identity_calibration(h, w))
    t0 = time.perf_counter()
    write_frame_pair(data, 20, band_scene.left, band_scene.right)
    log(f"apps: wrote frame 20 ({w}x{h} PNG pair) in {time.perf_counter() - t0:.1f} s")
    ((disp, xyz), sec, peak), launches["stereo_test"] = counted(lambda: timed(
        lambda: stereo_test.run(data, 20, rig, out, device=dev)))
    expect_exact("stereo_test", launches["stereo_test"], STEREO_TEST_LAUNCHES,
                 "one whole-frame SGBM at D = 256")
    with open(os.path.join(out, "cloud_000020.pcd")) as f:
        points = int(next(line for line in f if line.startswith("POINTS")).split()[1])
    # the same gray (the files' pixels: the rig is the identity) through
    # sgbm_disparity: the app's map must be the same map
    rgb = [torch.from_numpy(load_image(os.path.join(data, f"000020_{cam}.jpg"))).to(dev)
           for cam in ("191400042", "191400039")]
    gl, gr = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2] for x in rgb)
    ref = sgbm_disparity(gl, gr, SGBMConfig(min_disp=16, num_disp=256)).disparity.cpu().numpy()
    del rgb, gl, gr
    if np.array_equal(disp, ref):
        same = "bit for bit"
    else:  # K1's float sums land in any order (ROADMAP queue 3)
        if not (np.array_equal(disp >= 16, ref >= 16) and np.abs(disp - ref).max() <= 1e-3):
            raise AssertionError("stereo_test's map differs from sgbm_disparity's beyond 1e-3 px "
                                 "or in validity")
        same = (f"within {np.abs(disp - ref).max():.3g} px, validity equal, "
                f"{np.mean(disp != ref):.6f} of pixels not bit-equal")
    mm = scored_digits(disp, band_scene.disp_left, scene_eval_mask(band_scene))
    log(f"stereo_test.run {w}x{h}x256 (SGBM min_disp 16, identity rig): {sec:.3f} s, peak device "
        f"memory {peak / 1e9:.2f} GB above the resident; map equal to sgbm_disparity's {same}; "
        f"{check_gates('stereo_test', mm, STEREO_TEST_GATES)}; PCD {points} points; "
        f"xyz {xyz.shape}")
    del disp, xyz, ref

    # ---- stereo_yin at 2048x1536, then both routes at a quarter scale ----
    yh, yw = YIN_SHAPE
    t0 = time.perf_counter()
    ysc = render_scene(SCENE_SEED + 1, yh, yw, YIN_RUN["max_disp"])
    write_frame_pair(data, 21, ysc.left, ysc.right)
    log(f"apps: rendered and wrote frame 21 ({yw}x{yh}, max_disp {YIN_RUN['max_disp']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    rig_xml = os.path.join(data, "identity.xml")
    ((disp, _), sec, peak), launches["stereo_yin"] = counted(lambda: timed(
        lambda: stereo_yin.run(data, 21, rig_xml, out, **YIN_RUN, device=dev)))
    yin_k3 = {**YIN_LAUNCHES, "K3": k3_frame(YIN_RUN["iterations"], 8, max_disp=YIN_RUN["max_disp"],
                                            random_init=True)}
    expect_exact("stereo_yin", launches["stereo_yin"], {**yin_k3, "K4": 2},
                 f"2 views x {YIN_RUN['iterations']} iterations x 3")
    # the LR check zeroes what it rejects and the app clamps to 10: score
    # the pixels above the clamp
    mm = scored_digits(disp, ysc.disp_left, (disp > 10.0) & scene_eval_mask(ysc))
    log(f"stereo_yin.run {yw}x{yh}x{YIN_RUN['max_disp']} ({YIN_RUN['iterations']} of the app's "
        f"100 iterations, built-in guided volumes, host forest): {sec:.3f} s, peak device "
        f"memory {peak / 1e9:.2f} GB above the resident; {check_gates('stereo_yin', mm, GATES)}")
    del disp
    quarter = {}
    for route in ("builtin", "mccnn"):
        mc_dir = None
        if route == "mccnn":  # the quarter frame's built-in volumes as mc-cnn files
            mc_dir = os.path.join(tmp, "mccnn")
            os.makedirs(mc_dir)
            left, right = stereo_test.load_pair(data, 21, 0.25)
            vols = stereo_yin.builtin_cost_volumes(torch.from_numpy(left).to(dev),
                                                   torch.from_numpy(right).to(dev),
                                                   YIN_RUN["max_disp"])
            qh, qw = left.shape[:2]
            for name, vol in zip(("left.bin", "right.bin"), vols):
                path = os.path.join(mc_dir, name)
                save_mccnn_volume(path, vol)
                back = clean_mccnn(torch.from_numpy(
                    load_mccnn_volume(path, qh, qw, YIN_RUN["max_disp"])).to(dev))
                if not torch.equal(back, vol):
                    raise AssertionError(f"the mc-cnn file {name} does not read back equal")
            del vols, back
        path = f"stereo_yin_quarter_{route}"
        ((disp, _), sec, _), launches[path] = counted(lambda: timed(
            lambda: stereo_yin.run(data, 21, rig_xml, out, **YIN_RUN, scale=0.25,
                                   mccnn_dir=mc_dir, verbose=False, device=dev)))
        expect_exact(path, launches[path], {**yin_k3, "K4": 2 * (route == "builtin")},
                     f"2 views x {YIN_RUN['iterations']} iterations x 3")
        quarter[route] = (disp, sec)
    if not np.array_equal(quarter["builtin"][0], quarter["mccnn"][0]):
        n = int(np.count_nonzero(quarter["builtin"][0] != quarter["mccnn"][0]))
        raise AssertionError(f"stereo_yin's mc-cnn route differs from the built-in one on {n} "
                             f"pixels of equal volumes")
    log(f"stereo_yin at scale 0.25 ({quarter['builtin'][0].shape}): built-in route "
        f"{quarter['builtin'][1]:.3f} s, mc-cnn route {quarter['mccnn'][1]:.3f} s on the same "
        f"volumes written and read back equal; the two maps bit-equal")

    # ---- stream: run_mst in video mode on 5 ids, run, then resume ----
    sh, sw, sd = STREAM_SHAPE
    t0 = time.perf_counter()
    seq = render_sequence(SCENE_SEED, len(STREAM_IDS), sh, sw, sd)
    sdata = os.path.join(tmp, "stream")
    os.makedirs(sdata)
    for fid, sc in zip(STREAM_IDS, seq):
        write_frame_pair(sdata, fid, upsampled2(sc.left), upsampled2(sc.right))
    log(f"apps: rendered {len(STREAM_IDS)} frames {sw}x{sh} and wrote them at {2 * sw}x{2 * sh} "
        f"in {time.perf_counter() - t0:.1f} s")
    srig = os.path.join(sdata, "identity.yml")
    write_calibration(srig, **identity_calibration(2 * sh, 2 * sw))
    sout = os.path.join(tmp, "stream_out")
    ((disps, waits), sec, peak), launches["stream_run_mst"] = counted(lambda: timed(
        lambda: stream.run_mst(sdata, srig, sout, ids=STREAM_IDS, **STREAM_MST, device=dev)))
    keys = [i % STREAM_MST["temporal_reseed"] == 0 for i in range(len(STREAM_IDS))]
    want = {k: sum(STREAM_KEY[k] if key else STREAM_TEMPORAL[k] for key in keys)
            for k in STREAM_KEY}
    # 8 neighbour trees; keyframes 4 iterations from 2 px, temporal 2 from 4 px
    want["K3"] = sum(k3_frame(4, 8, 2.0) if key else k3_frame(2, 8, 4.0) for key in keys)
    want["K4"] = 2 * len(keys)  # the built-in guided volumes of every frame
    expect_exact("stream_run_mst", launches["stream_run_mst"], want,
                 f"{sum(keys)} keyframes + {len(keys) - sum(keys)} temporal frames, no scene cut")
    digits = []
    for i, (d, sc) in enumerate(zip(disps, seq)):
        mm = scored_digits(d, sc.disp_left, (d > 0) & scene_eval_mask(sc))
        digits.append(check_gates(f"stream_run_mst frame {i}", mm,
                                  GATES if keys[i] else TEMPORAL_GATES))
    log(f"stream.run_mst {len(STREAM_IDS)} ids at {sw}x{sh}x{sd} (video mode, device forest, "
        f"keyframes {keys}): {sec:.3f} s, peak device memory {peak / 1e9:.2f} GB above the "
        f"resident; forest waits {['%.3f' % x for x in waits]} s; " + "; ".join(
            f"frame {i} {g}" for i, g in enumerate(digits)))
    (maps, sec, _), launches["stream_run"] = counted(lambda: timed(
        lambda: stream.run(sdata, srig, sout, ids=STREAM_IDS, device=dev)))
    expect_exact("stream_run", launches["stream_run"], {"K1": 0, "K1c": 0, "K2": 0, "K2a": 0},
                 "cost-volume frames")
    # scale 0.25 of the written frames is scale 0.5 of the rendered ones:
    # every other pixel, at half the disparity
    for i, (d, sc) in enumerate(zip(maps, seq)):
        gt = sc.disp_left[::2, ::2] / 2.0
        scored = scene_eval_mask(sc)[::2, ::2]
        digits[i] = check_gates(f"stream_run frame {i}", scored_digits(d, gt, scored),
                                CLASSIC_GATES["costvolume"])
    log(f"stream.run {len(STREAM_IDS)} ids at scale 0.25 ({maps.shape[2]}x{maps.shape[1]}, the "
        f"app's defaults; parallel.tiled_cost_volume_batch on the process group's one rank): "
        f"{sec:.3f} s; "
        + "; ".join(f"frame {i} {g}" for i, g in enumerate(digits)))
    (again, sec, _), launches["stream_resume"] = counted(lambda: timed(
        lambda: stream.run_mst(sdata, srig, sout, ids=STREAM_IDS, **STREAM_MST, resume=True,
                               device=dev)))
    expect_exact("stream_resume", launches["stream_resume"], {"K1": 0, "K1c": 0, "K2": 0, "K2a": 0},
                 "every frame already written")
    if again[0].size or again[1]:
        raise AssertionError("stream.run_mst with resume recomputed frames")
    log(f"stream.run_mst with resume: skipped all {len(STREAM_IDS)} frames in {sec:.3f} s")
    del disps, maps, seq

    # ---- the CLI's ten algorithms at 480x640 with -i, -o and -p ----
    ch, cw, cd = CLI_SHAPE
    csc = render_scene(SCENE_SEED, ch, cw, cd)
    cdata = os.path.join(tmp, "cli")
    os.makedirs(cdata)
    write_frame_pair(cdata, 0, csc.left, csc.right)
    crig = os.path.join(cdata, "distorted.xml")
    write_calibration(crig, **distorted_calibration(ch, cw))
    lp, rp = (os.path.join(cdata, f"000000_{cam}.jpg") for cam in ("191400042", "191400039"))
    cli_k3 = {"mst": k3_frame(100, 8, max_disp=cd, random_init=True),
              "sgbm_mst": k3_frame(10, 2, 2.0, max_disp=cd),
              "pm": k3_patchmatch(PatchMatchConfig(max_disp=float(cd - 1), iterations=10)),
              "coupled": k3_coupled(CoupledConfig(max_disp=cd - 1))}
    secs = {}
    for i, alg in enumerate(CLI_ALGORITHMS):
        png = os.path.join(cdata, f"{alg}.png")
        cloud = os.path.join(cdata, alg + CLI_CLOUDS[i % len(CLI_CLOUDS)])
        path = f"cli_{alg}"
        (rc, secs[alg], _), launches[path] = counted(lambda: timed(lambda: cli.main(
            [lp, rp, "--algorithm", alg, "--max-disparity", str(cd), "-i", crig, "-o", png,
             "-p", cloud, "--device", str(dev)])))
        k2 = CLI_K2.get(alg, 0)
        expect_exact(path, launches[path], {"K1": int(alg in CLI_K1), "K1c": 0, "K2": k2,
                                            "K2a": k2, "K3": cli_k3.get(alg, 0),
                                            "K4": 2 * (alg in CLI_GUIDED)}, "one call")
        if rc != 0 or not os.path.exists(cloud) or os.path.getsize(cloud) == 0:
            raise AssertionError(f"cli {alg}: rc {rc}, cloud file missing or empty")
        if load_image(png, gray=True).shape != (ch, cw):
            raise AssertionError(f"cli {alg}: the disparity PNG does not decode to {cw}x{ch}")
    log(f"cli.main at {cw}x{ch}, --max-disparity {cd}, the distorted rig: rc 0, PNG {cw}x{ch} and "
        f"a cloud for every algorithm; seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    tmp_dir.cleanup()
    log(f"apps section wall time {time.perf_counter() - t_section:.1f} s")
    return launches


def parallel_paths(scenes, band_scene, cfg, dev) -> dict:
    """The port's parallel/ on the card as one NCCL rank at full width (no
    machine with more than one GPU is on record, and NCCL takes one rank a
    card), every collective through NCCL: the group's backend must be
    nccl. sgbm_batch_mesh on the first 2 frames with the servers' seed
    config (K1 twice; maps bit-equal to sgbm_disparity frame by frame);
    tiled_cost_volume_batch (frame 1 x tile 1) and tiled2d_cost_volume_stereo
    (1, 1, 1) with lr_check on the first frame, guided and denoised, held to
    models.costvolume.cost_volume_stereo on the eager guided filter the
    tiles run, as the CPU tests hold tiled to whole (at most 1% of pixels
    beyond 0.02 px), and beside it on K4; wta_disparity_dslab on one slab
    of the first frame's guided volume, bit-equal to wta_disparity;
    sgbm_pipeline_mesh on the band scene (SGBMConfig(); one band: rank 0
    skips its up-sweep launch, so one K1c launch), held to sgbm_disparity
    as banded_sgbm_path holds the band driver; mst_pms_optimize_mesh and
    mst_pms_optimize_mesh_sharded (1 x 1) on the first frame's seeded left
    view (the server's recipe: device forest, guided volume, 2 neighbours,
    4 iterations from refine_start 2.0), also with normalize_aggregation,
    equal to mst_pms_optimize with the same key. Each path is counted on
    its first call, which also sets up its groups' NCCL communicators, and
    timed on the host clock around synchronize on that call and on a second
    one, beside its one-process counterpart. Returns each path's launch
    counts."""
    import torch.distributed as dist

    from stereomatch_tpu_torch import parallel, pipelines
    from stereomatch_tpu_torch import random as trandom
    from stereomatch_tpu_torch.apps.stereo_yin import builtin_cost_volumes
    from stereomatch_tpu_torch.config import CostVolumeConfig, CostVolumePipelineConfig, SGBMConfig
    from stereomatch_tpu_torch.models import costvolume
    from stereomatch_tpu_torch.models.costvolume import cost_volume_stereo
    from stereomatch_tpu_torch.models.mst import _fused_capacities, _seed_min_cost
    from stereomatch_tpu_torch.ops.filters import guided_filter_volume, guided_filter_volume_twin
    from stereomatch_tpu_torch.models.sgbm_mst import (
        _default_sgbm_cfg, _gray_from_bgr, _seed_pair, _view_forest,
    )
    from stereomatch_tpu_torch.ops.device_forest import device_forest_arrays
    from stereomatch_tpu_torch.ops.mst import mst_pms_optimize, plane_labels_from_disparity
    from stereomatch_tpu_torch.ops.select import wta_disparity
    from stereomatch_tpu_torch.ops.sgbm import sgbm_disparity
    from stereomatch_tpu_torch.parallel import mst_mesh

    t_section = time.perf_counter()
    launches, secs = {}, {}
    none = {"K1": 0, "K1c": 0, "K2": 0, "K2a": 0}

    def timed(path, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
        return out

    def run(path, fn, want, mix):
        """The path counted and timed, then timed again: its first call also
        sets up the NCCL communicators of the mesh's groups."""
        out, launches[path] = counted(lambda: timed(path + " first", fn))
        expect_exact(path, launches[path], {**none, **want}, mix)
        timed(path, fn)
        return out

    mesh = timed("make_mesh", lambda: parallel.make_mesh(n_tile=1, n_frame=1, device=dev))
    mesh3 = parallel.make_mesh3(1, 1, 1, device=dev)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"the process group runs {dist.get_backend()} on "
                             f"{dist.get_world_size()} ranks, not NCCL on one")
    h, w = SHAPE

    # ---- frames in data parallel: K1 once a frame ----
    sgbm_cfg = _default_sgbm_cfg(cfg)
    bgr = [(torch.from_numpy(sc.left).to(dev), torch.from_numpy(sc.right).to(dev))
           for sc in scenes[:2]]
    gl, gr = (torch.stack([_gray_from_bgr(p[i]) for p in bgr]) for i in (0, 1))
    disp, valid = run("mesh_sgbm_batch", lambda: parallel.sgbm_batch_mesh(mesh, sgbm_cfg)(gl, gr),
                      {"K1": 2}, "2 frames, one K1 launch each")
    singles = timed("mesh_sgbm_batch_single",
                    lambda: [sgbm_disparity(gl[k], gr[k], sgbm_cfg) for k in range(2)])
    if not all(torch.equal(disp[k], o.disparity) and torch.equal(valid[k], o.valid)
               for k, o in enumerate(singles)):
        raise AssertionError("sgbm_batch_mesh's maps differ from sgbm_disparity's")
    del disp, valid, singles, gl, gr

    # ---- the cost-volume pipelines, row tiles and (tile_y, tile_x, dslab) ----
    cv_cfg = CostVolumePipelineConfig(volume=CostVolumeConfig(min_disp=0, max_disp=MAX_DISP - 1))
    bl, br = bgr[0]
    shares, k4_shares = {}, {}
    for path, lr in (("mesh_tiled_batch", False), ("mesh_tiled2d_lr", True)):
        if lr:
            fn = parallel.tiled2d_cost_volume_stereo(mesh3, (h, w), cv_cfg, lr_check=True)
            got = run(path, lambda: fn(bl, br), {}, "no kernel")
        else:
            fn = parallel.tiled_cost_volume_batch(mesh, cv_cfg)
            got = [x[0] for x in run(path, lambda: fn(bl[None], br[None]), {}, "no kernel")]
        whole = timed(path + "_single", lambda: cost_volume_stereo(bl, br, cv_cfg, lr_check=lr))
        # the tiles filter with the eager box filters (parallel/tiled.py),
        # the whole frame with K4, which rounds its window sums otherwise:
        # the tiles are held to the whole frame on the filter they run
        costvolume.guided_filter_volume = guided_filter_volume_twin
        try:
            eager = cost_volume_stereo(bl, br, cv_cfg, lr_check=lr)
        finally:
            costvolume.guided_filter_volume = guided_filter_volume
        for view, g, wv, k4v in zip(("left", "right"), got, eager[:2], whole[:2]):
            if g.shape != (h, w) or not torch.isfinite(g).all():
                raise AssertionError(f"{path}: bad output shape or non-finite values")
            shares[f"{path} {view}"] = share = ((g - wv).abs() > 0.02).double().mean().item()
            k4_shares[f"{path} {view}"] = ((g - k4v).abs() > 0.02).double().mean().item()
            if share > 0.01:
                raise AssertionError(f"{path} {view}: {share:.4f} of pixels beyond 0.02 px")
        del got, whole, eager

    # ---- the WTA over disparity slabs, one slab ----
    vl, _ = builtin_cost_volumes(bl.flip(-1), br.flip(-1), MAX_DISP, guided=True)
    got = run("mesh_dslab", lambda: parallel.wta_disparity_dslab(vl, 0, mesh3), {}, "no kernel")
    if not torch.equal(got, timed("mesh_dslab_single", lambda: wta_disparity(vl, 0))):
        raise AssertionError("wta_disparity_dslab != wta_disparity")

    # ---- the band-pipelined SGBM on the band scene: one band ----
    bh, bw, _ = BAND_SHAPE
    bcfg = SGBMConfig()
    pipe = parallel.sgbm_pipeline_mesh(mesh, bcfg)
    bgl, bgr_ = (pipelines._gray255(x[..., ::-1], dev) for x in (band_scene.left,
                                                                  band_scene.right))
    pd, pv = run("mesh_sgbm_pipeline", lambda: pipe(bgl[None], bgr_[None]), {"K1c": 1},
                 "one frame in one band: its down-sweep launch (rank 0 skips its up sweep)")
    mono = timed("mesh_sgbm_pipeline_single", lambda: sgbm_disparity(bgl, bgr_, bcfg))

    def flips(d, v, ref, tol):
        return ((v[0] != ref.valid) | ((d[0] - ref.disparity).abs() > tol)).double().mean().item()

    jitter, ties = flips(pd, pv, mono, 1e-5), flips(pd, pv, mono, 0.1)
    del pd, pv, mono
    pdi, pvi = pipe(bgl.round()[None], bgr_.round()[None])
    exact = flips(pdi, pvi, sgbm_disparity(bgl.round(), bgr_.round(), bcfg), 0.0)
    if not (ties < 0.002 and exact == 0):
        raise AssertionError(f"sgbm_pipeline_mesh vs sgbm_disparity: {ties:.5f} of the float "
                             f"luma's pixels flip, {exact:.6f} of the integer gray's differ")
    del pdi, pvi, bgl, bgr_

    # ---- 3DMST over candidates, and over candidates and nodes ----
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    fa = device_forest_arrays(_view_forest(bl, cfg, tmax, adj_cap), h, w, tmax=tmax, check=False)
    seed_l, _ = _seed_pair(_gray_from_bgr(bl), _gray_from_bgr(br), sgbm_cfg)
    planes = plane_labels_from_disparity(torch.clamp(seed_l, 0.0, float(cfg.max_disp - 1)), fa)
    kl = trandom.split(trandom.PRNGKey(0, dev))[0]
    vl = vl.to(getattr(torch, cfg.volume_dtype))  # as the server's refine holds it
    cmesh = mst_mesh.make_cand_mesh(1, device=dev)
    nmesh = mst_mesh.make_cand_node_mesh(1, 1, device=dev)
    mst_equal = {}
    for norm in (False, True):
        ncfg = dataclasses.replace(cfg, normalize_aggregation=norm)
        kw = dict(max_neighbors=2, iterations=4, refine_start=2.0,
                  init_state=(*planes, _seed_min_cost(vl, *planes, fa, ncfg)))
        tag = "_norm" if norm else ""
        k2 = 2 * (4 + norm)  # carry_iters 1: 2 scans of each kind a tree filter
        want = timed(f"mesh_mst{tag}_single", lambda: mst_pms_optimize(kl, vl, fa, ncfg, **kw))
        for path, fn in (
                (f"mesh_mst_cand{tag}",
                 lambda: mst_mesh.mst_pms_optimize_mesh(kl, vl, fa, cmesh, ncfg, **kw)),
                (f"mesh_mst_node{tag}", lambda: mst_mesh.mst_pms_optimize_mesh_sharded(
                    kl, mst_mesh.volume_in_node_order(vl, fa), fa, nmesh, ncfg, **kw))):
            got = run(path, fn, {"K2": k2, "K2a": k2, "K3": k3_optimize(4, 2, 2.0)},
                      f"4 iterations{' and the normalization' if norm else ''}: one tree filter "
                      f"each")
            mst_equal[path] = all(torch.equal(g, x) for g, x in zip(got, want))
            if not mst_equal[path]:
                raise AssertionError(f"{path} != mst_pms_optimize: max |diff| " + ", ".join(
                    f"{(g - x).abs().max().item():.3g}" for g, x in zip(got, want)))
    del vl, fa, planes, seed_l, bgr, bl, br
    log(f"parallel: one NCCL rank ({dist.get_backend()}, world {dist.get_world_size()}); "
        f"sgbm_batch_mesh 2x{h}x{w}x{sgbm_cfg.num_disp} bit-equal to sgbm_disparity; tiled vs "
        f"whole shares beyond 0.02 px {json.dumps({k: round(v, 6) for k, v in shares.items()})} "
        f"(on K4's whole frame {json.dumps({k: round(v, 6) for k, v in k4_shares.items()})}); "
        f"wta_disparity_dslab bit-equal; sgbm_pipeline_mesh {bh}x{bw}x{bcfg.num_disp} vs the "
        f"whole frame: beyond 1e-5 px or validity {jitter:.6f}, beyond 0.1 px {ties:.6f}, the "
        f"integer gray's {exact:.6f}; the 3DMST meshes equal mst_pms_optimize: {mst_equal}")
    log("parallel seconds " + json.dumps({k: round(v, 4) for k, v in secs.items()}))
    log(f"parallel section wall time {time.perf_counter() - t_section:.1f} s")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stereomatch_tpu_torch._build import load_kernels
    from stereomatch_tpu_torch.config import MSTConfig, production_mst_config
    from stereomatch_tpu_torch.native.build import build as build_native
    from stereomatch_tpu_torch.synthetic import render_scene, render_sequence
    from stereomatch_tpu_torch.models.mst import _fused_capacities, build_view_forest
    from stereomatch_tpu_torch.ops.mst import refine_deltas
    from stereomatch_tpu_torch.models.sgbm_mst import (
        _default_sgbm_cfg, _gray_from_bgr, _seed_pair, _view_forest,
        _refine_view_given_forest,
    )
    from stereomatch_tpu_torch.apps.stereo_yin import builtin_cost_volumes
    from stereomatch_tpu_torch.ops.sgbm import aggregate_8path, sgbm_cost_volume
    from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda
    from stereomatch_tpu_torch import random as trandom
    from stereomatch_tpu_torch.serving import compile_sgbm_mst_server

    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("card:", card)

    t0 = time.perf_counter()
    load_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s (every kernel, from csrc/)")
    t0 = time.perf_counter()
    lib = build_native()
    log(f"build: {time.perf_counter() - t0:.1f} s (the host forest builder, g++: {lib})")

    h, w = SHAPE
    t0 = time.perf_counter()
    scenes = render_sequence(SCENE_SEED, FRAMES, h, w, MAX_DISP)
    log(f"render: {time.perf_counter() - t0:.1f} s ({FRAMES} frames {h}x{w}, max_disp {MAX_DISP})")
    sc0 = scenes[0]
    cfg = production_mst_config(MAX_DISP, forest_backend="device")
    sgbm_cfg = _default_sgbm_cfg(cfg)
    p1, p2 = (float(p) for p in sgbm_cfg.resolved_p1p2())
    left0 = torch.from_numpy(sc0.left).to(dev)
    right0 = torch.from_numpy(sc0.right).to(dev)
    kernels = {}

    # ---- K1: the aggregation on the frame's own SGBM cost (H, W', D) ----
    # The float BT.601 luma makes the cost non-integer, so K1's reductions,
    # which land in any order, agree with the twin's ordered sum to float32
    # reassociation (K1_RTOL); on the same cost rounded to integers every
    # partial sum is exact and they agree bit for bit.
    npaths = sgbm_cfg.num_paths
    k1_err, k1_rows, k1_twice = 0.0, {}, {}
    for dt in ("float32", "bfloat16"):
        c = sgbm_cost_volume(_gray_from_bgr(left0), _gray_from_bgr(right0),
                             dataclasses.replace(sgbm_cfg, cost_dtype=dt))
        margin = sgbm_cfg.min_disp + sgbm_cfg.num_disp
        c = c[:, margin:].contiguous()
        got = aggregate_8path_cuda(c, p1, p2, npaths)
        want = aggregate_8path(c, p1, p2, npaths)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=0.0)
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        same = torch.equal(got, want)
        # the same cost twice: does K1 give the same S bit for bit?
        k1_twice[dt] = torch.equal(got, aggregate_8path_cuda(c, p1, p2, npaths))
        del got, want
        ci = c.float().round().to(c.dtype)
        got = aggregate_8path_cuda(ci, p1, p2, npaths)
        want = aggregate_8path(ci, p1, p2, npaths)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != twin on integer costs ({dt}): max |diff| "
                                 f"{(got - want).abs().max().item()}")
        del got, want, ci
        ms = cuda_time_ms(lambda: aggregate_8path_cuda(c, p1, p2, npaths), 10)
        plain = cuda_time_ms(lambda: aggregate_8path(c, p1, p2, npaths), 1)
        # C read once, S written once; about 8 float32 operations per
        # direction per cost (the DP's adds and mins, the add into S)
        bms, by = bound(c.numel() * (c.element_size() + 4), 8.0 * npaths * c.numel())
        k1_rows[dt] = (ms, plain, bms, by)
        log(f"K1 {dt} {tuple(c.shape)}: the frame's cost within rtol {K1_RTOL} of the twin "
            f"(max |diff| {err:.3g}, bitwise: {same}); integer costs bitwise equal; "
            f"kernel {ms:.3f} ms, twin {plain:.1f} ms, bound {bms:.3f} ms ({by})")
        del c
    kernels["K1"] = {
        "name": "sgbm_aggregate_8path", "route": "cuda",
        "source": "stereomatch_tpu_torch/csrc/sgbm_aggregate.cu",
        "replaces": "stereomatch_tpu/ops/sgbm_pallas.py:255",
        "max_abs_err": k1_err, "ms": k1_rows["bfloat16"][0],
        "plain_ms": k1_rows["bfloat16"][1], "bound_ms": k1_rows["bfloat16"][2],
        "bound_by": k1_rows["bfloat16"][3], "library_ms": None,
    }

    # ---- K2: the scans on a real forest's resets, (7, N) and (7, 2N) ----
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    k2_rows = k2_cases(_view_forest(left0, cfg, tmax, adj_cap), 7, "device forest", dev, g)

    # ---- K2 on the host forest at the flat path's row count ----
    flat_cfg = MSTConfig(**FLAT_CFG)
    rows = 8 + int(refine_deltas(MAX_DISP, device=dev)[0].shape[0])  # mst_stereo's 8 neighbours
    host_rows = {}
    for delta in (flat_cfg.max_log_range, 40.0):
        t0 = time.perf_counter()
        fa = build_view_forest(left0, dataclasses.replace(flat_cfg, max_log_range=delta), dev)
        torch.cuda.synchronize()
        starts = torch.nonzero(fa.seg_root)[:, 0]
        seg_len = torch.diff(starts, append=starts.new_tensor([fa.seg_root.numel()]))
        log(f"host forest at max_log_range {delta}: {time.perf_counter() - t0:.2f} s, "
            f"{fa.num_trees} trees, {starts.numel()} segments, longest {int(seg_len.max())} nodes")
        host_rows[delta] = k2_cases(fa._asdict(), rows, f"host forest, max_log_range {delta}",
                                    dev, g)
        del fa, starts, seg_len

    def k2_entry(name, row):
        ms, plain, bms, by, err = k2_rows[row]
        host = host_rows[flat_cfg.max_log_range][row]
        return {"name": name, "route": "cuda", "source": "stereomatch_tpu_torch/csrc/seg_scan.cu",
                "replaces": "stereomatch_tpu/ops/mst_scan_pallas.py:118",
                "max_abs_err": max([err] + [r[row][4] for r in host_rows.values()]),
                "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
                f"host_forest_{rows}_rows": {"ms": host[0], "plain_ms": host[1],
                                             "bound_ms": host[2], "bound_by": host[3]}}

    kernels["K2"] = k2_entry("segmented_cumsum", "euler")
    kernels["K2"]["max_abs_err"] = max(kernels["K2"]["max_abs_err"],
                                       k2_entry("segmented_cumsum", "nodes")["max_abs_err"])
    kernels["K2a"] = k2_entry("ancestor_sums", "ancestor")
    kernels["K3"] = k3_cases(_fused_capacities(*K3_FRAME, cfg)[0], dev)
    # K4 on the band scene's left view, here and not after the paths: late in
    # a long process torch.profiler's short traces can hold no device event
    t0 = time.perf_counter()
    band_scene = render_scene(SCENE_SEED, *BAND_SHAPE)
    log(f"render: {time.perf_counter() - t0:.1f} s (one frame {BAND_SHAPE[0]}x{BAND_SHAPE[1]}, "
        f"max_disp {BAND_SHAPE[2]})")
    kernels["K4"] = k4_cases(band_scene, dev)

    # ---- the slice: the server's main path, counted ----
    servers = {
        mode: compile_sgbm_mst_server(h, w, cfg=cfg, device=dev, volume_guided=(mode == "guided"))
        for mode in ("guided", "raw")
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_s = {}
    outputs = {}

    def serve_fused():
        for mode, srv in servers.items():
            frame_s[mode] = []
            for i, sc in enumerate(scenes):
                t0 = time.perf_counter()
                outputs[(mode, i)] = srv.collect(srv.submit_pair(sc.left, sc.right))
                frame_s[mode].append(time.perf_counter() - t0)

    _, launches = counted(serve_fused)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for (mode, i), (dl, dr) in outputs.items():
        msg = gate(dl, dr, scenes[i], GATES, f"{mode} frame {i}")
        log(f"{mode} frame {i}: {frame_s[mode][i]:.3f} s, {msg}")
    expect_launches("fused server", launches, 2 * FRAMES, 0, guided=FRAMES)
    log(f"launches on the fused server path: {launches}; peak device memory {peak_gb:.2f} GB")
    for mode, ts in frame_s.items():
        log(f"{mode}: seconds per frame {['%.3f' % t for t in ts]}, "
            f"steady {len(ts[1:]) / sum(ts[1:]):.3f} frames/s")
    # the same frame and seed twice through one server: the same maps?
    srv = servers["guided"]
    twice = [srv.collect(srv.submit_pair(sc0.left, sc0.right, seed=0)) for _ in range(2)]
    maps_same = all(np.array_equal(x, y) for x, y in zip(*twice))
    maps_diff = max(float(np.abs(x - y).max()) for x, y in zip(*twice))
    log(f"determinism: K1 twice on the same cost bitwise equal {k1_twice}; the guided server's "
        f"maps for the same frame and seed twice equal: {maps_same} (max |diff| {maps_diff:.3g})")
    del twice

    # ---- one guided frame again, stage by stage (host clock + sync) ----
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    vl, vr = stage("cost_volumes_guided", lambda: builtin_cost_volumes(
        left0.flip(-1), right0.flip(-1), MAX_DISP, guided=True))
    stage("cost_volumes_raw", lambda: builtin_cost_volumes(
        left0.flip(-1), right0.flip(-1), MAX_DISP, guided=False))
    seed_l, _ = stage("sgbm_seed_pair", lambda: _seed_pair(
        _gray_from_bgr(left0), _gray_from_bgr(right0), sgbm_cfg))
    raw = stage("forest_left", lambda: _view_forest(left0, cfg, tmax, adj_cap))
    kl = trandom.split(trandom.PRNGKey(0, dev))[0]
    stage("refine_left", lambda: _refine_view_given_forest(
        raw, vl, seed_l, kl, cfg, h, w, tmax, 4, 2.0, 2))
    log("stages_ms " + json.dumps(stages))
    del vl, vr, seed_l, raw
    by_path = {"fused_server": launches, **video_path(cfg, dev)}
    by_path.update(host_forest_paths(sc0, dev))
    # the classical engines last, so every path before them runs as it did
    # without them
    by_path.update(classic_paths(sc0, dev))
    # the PatchMatch engines after them, for the same reason
    by_path.update(patchmatch_paths(sc0, dev))
    # then the band-streamed SGBM, c2f with the priors and the coupled WTA
    band_launches, band_rows = banded_sgbm_path(band_scene, dev)
    by_path.update(band_launches)
    by_path.update(c2f_prior_paths(sc0, dev))
    # the apps on files, stereo_test on the band scene
    by_path.update(apps_paths(band_scene, dev))
    # last, parallel/ on one NCCL rank
    by_path.update(parallel_paths(scenes, band_scene, cfg, dev))
    del band_scene
    import torch.distributed as dist

    dist.destroy_process_group()  # the one-rank NCCL group the mesh paths started

    # the port imports nothing of jax and nothing of the JAX package
    from_jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "stereomatch_tpu"))
    if from_jax:
        raise AssertionError(f"jax or the JAX package was imported: {from_jax}")
    # every path was held to its frame mix's launches above (K1 runs only
    # where a frame takes an SGBM seed); each kernel must have run
    kernels["K1"]["max_abs_err"] = max(kernels["K1"]["max_abs_err"],
                                       band_rows["K1_d256"]["max_abs_err"])
    kernels["K1"]["d256_whole_frame"] = band_rows["K1_d256"]
    k1c = band_rows["K1c"]
    kernels["K1c"] = {
        "name": "sgbm_aggregate_carry", "route": "cuda",
        "source": "stereomatch_tpu_torch/csrc/sgbm_aggregate.cu",
        "replaces": "stereomatch_tpu/ops/sgbm_pallas.py:122",
        "max_abs_err": k1c["max_abs_err"], "ms": k1c["ms"], "plain_ms": k1c["plain_ms"],
        "bound_ms": k1c["bound_ms"], "bound_by": k1c["bound_by"], "library_ms": None,
        "shape": k1c["shape"], "up_sweep_ms": k1c["up_sweep_ms"],
    }
    for k in ("K1", "K1c", "K2", "K2a", "K3", "K4"):
        counts = {path: c[k] for path, c in by_path.items()}
        if sum(counts.values()) <= 0:
            raise AssertionError(f"{k} was launched on no path: {counts}")
        kernels[k]["launches"] = sum(counts.values())
        kernels[k]["launches_by_path"] = counts
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [kernels[k] for k in ("K1", "K1c", "K2", "K2a", "K3", "K4")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
