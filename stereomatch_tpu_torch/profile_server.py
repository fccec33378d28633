"""Where a served frame's time goes: sequential and pipelined frame times,
a `torch.profiler` trace of one frame per volume mode, and stage times.

    python3 -m stereomatch_tpu_torch.profile_server [--out FILE] [--video]

At the default size (960x1280, 128 disparities, the production frame of
`compile_sgbm_mst_server`) it needs one CUDA device. For each volume mode
(guided, raw) it serves one warm-up frame, then 3 frames one at a
time (submit -> collect, host clock), then the same frames pipelined
(`capacity=2`: submit all, then drain), then one frame under the profiler.
From the trace it reports the frame's device events, their summed device
time, the union of their intervals (the time the device was busy), and the
top kernels by device time. Last, each stage of one guided frame runs 3
times, timed on the host clock around `torch.cuda.synchronize()`.

`--video` does the same for the steady-state temporal frame of the video
server's headline deployment (`compile_mst_video_server` with the raw
volume and `reuse_forest`): after the keyframe and one warm-up temporal
frame, every frame it serves and traces is a temporal frame, which
refines on the keyframe's forests and builds none. Its stage times are the
raw cost volumes and one view's 2-iteration refine on a built forest.

A summary goes to stdout; everything, with the top kernels, goes to
`--out` as JSON. `--device cpu` with a small `--shape` rehearses the script
on the CPU, where the trace holds no device events.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

TOP = 25
FRAMES = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_events(prof):
    """(name, start_us, end_us) of every device event in the trace."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_mode(srv, warm, seq_frames, pipe_frames, prof_frame, dev) -> dict:
    """Serve the `warm` scenes, then `seq_frames` one at a time, then
    `pipe_frames` submitted together and drained, then `prof_frame` under
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for sc in warm:
        srv.collect(srv.submit_pair(sc.left, sc.right))
    seq = []
    for sc in seq_frames:
        t0 = time.perf_counter()
        srv.collect(srv.submit_pair(sc.left, sc.right))
        seq.append(time.perf_counter() - t0)
    _sync(dev)
    t0 = time.perf_counter()
    for sc in pipe_frames:
        srv.submit_pair(sc.left, sc.right)
    srv.drain()
    pipelined = (time.perf_counter() - t0) / len(pipe_frames)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        srv.collect(srv.submit_pair(prof_frame.left, prof_frame.right))
        profiled_wall = time.perf_counter() - t0
    events = _device_events(prof)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    return {
        "sequential_s": seq,
        "pipelined_s_per_frame": pipelined,
        "profiled_wall_s": profiled_wall,
        "device_events": len(events),
        "device_time_sum_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "device_busy_ms": _busy_us((s, e) for _, s, e in events) / 1e3,
        "launches_of_kernels_run_over_3000_times": sum(e.count for e in kernels if e.count > 3000),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top[:TOP]],
    }


def _timer(dev, out: dict, ms: dict):
    def timed(name, fn, reps=3):
        ms[name] = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            out[name] = fn()
            _sync(dev)
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return timed


def video_stage_times(scenes, cfg, dev) -> dict:
    """The temporal frame's stages: raw cost volumes, then one view's
    refine on the keyframe's forest, seeded with the keyframe's map."""
    from .apps.stereo_yin import builtin_cost_volumes
    from .models.mst import _fused_capacities
    from .models.sgbm_mst import _refine_view_given_forest, _view_forest
    from . import random as trandom

    h, w = scenes[0].left.shape[:2]
    left0 = torch.from_numpy(scenes[0].left).to(dev).float()
    left1 = torch.from_numpy(scenes[1].left).to(dev).float()
    right1 = torch.from_numpy(scenes[1].right).to(dev).float()
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    forest = _view_forest(left0, cfg, tmax, adj_cap)
    seed = torch.from_numpy(scenes[0].disp_left).to(dev)
    out, ms = {}, {}
    timed = _timer(dev, out, ms)
    timed("cost_volumes_raw", lambda: builtin_cost_volumes(
        left1.flip(-1), right1.flip(-1), cfg.max_disp, guided=False))
    kl = trandom.split(trandom.PRNGKey(1, dev))[0]
    timed("temporal_refine_left", lambda: _refine_view_given_forest(
        forest, out["cost_volumes_raw"][0], seed, kl, cfg, h, w, tmax, 2, 4.0, 2))
    return {"stages_ms": ms}


def stage_times(scene, cfg, dev) -> dict:
    from .apps.stereo_yin import builtin_cost_volumes
    from .models.mst import _fused_capacities
    from .models.sgbm_mst import (
        _default_sgbm_cfg, _gray_from_bgr, _refine_view_given_forest, _seed_pair, _view_forest,
    )
    from . import random as trandom

    h, w = scene.left.shape[:2]
    d = cfg.max_disp
    left = torch.from_numpy(scene.left).to(dev).float()
    right = torch.from_numpy(scene.right).to(dev).float()
    sgbm_cfg = _default_sgbm_cfg(cfg)
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    out, ms = {}, {}
    timed = _timer(dev, out, ms)
    timed("cost_volumes_guided", lambda: builtin_cost_volumes(
        left.flip(-1), right.flip(-1), d, guided=True))
    timed("cost_volumes_raw", lambda: builtin_cost_volumes(
        left.flip(-1), right.flip(-1), d, guided=False))
    timed("sgbm_seed_pair", lambda: _seed_pair(
        _gray_from_bgr(left), _gray_from_bgr(right), sgbm_cfg))
    timed("forest_left", lambda: _view_forest(left, cfg, tmax, adj_cap))
    timed("forest_right", lambda: _view_forest(right, cfg, tmax, adj_cap))
    (vl, vr), (sl, sr) = out["cost_volumes_guided"], out["sgbm_seed_pair"]
    kl, kr = trandom.split(trandom.PRNGKey(0, dev))
    timed("refine_left", lambda: _refine_view_given_forest(
        out["forest_left"], vl, sl, kl, cfg, h, w, tmax, 4, 2.0, 2))
    timed("refine_right", lambda: _refine_view_given_forest(
        out["forest_right"], vr, sr, kr, cfg, h, w, tmax, 4, 2.0, 2))
    forest = out["forest_left"]
    return {"stages_ms": ms, "forest_left": {
        "trees": int(forest["num_trees_actual"]), "segments": int(forest["seg_root"].sum()),
        "tree_capacity": tmax}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_server.json")
    ap.add_argument("--shape", type=int, nargs=3, default=(960, 1280, 128),
                    metavar=("H", "W", "D"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--video", action="store_true",
                    help="profile the video server's steady-state temporal frame")
    args = ap.parse_args(argv)

    from ._build import load_kernels
    from .config import production_mst_config
    from .serving import compile_mst_video_server, compile_sgbm_mst_server
    from .synthetic import render_sequence

    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    if dev.type == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print("card:", report["card"], flush=True)
        load_kernels()
    h, w, d = args.shape
    cfg = production_mst_config(d, forest_backend="device")
    if args.video:
        # one moving sequence: the keyframe, a warm-up temporal frame, then
        # every measured frame is the next frame of the sequence
        n = 2 + 2 * FRAMES + 1
        scenes = render_sequence(0, n, h, w, d)
        srv = compile_mst_video_server(h, w, cfg=cfg, device=dev, capacity=2,
                                       reuse_forest=True, volume_guided=False)
        report["video_temporal"] = profile_mode(
            srv, scenes[:2], scenes[2:2 + FRAMES], scenes[2 + FRAMES:n - 1], scenes[-1], dev)
        if srv._since_key != n:
            raise AssertionError("a frame after the keyframe was not a temporal frame")
        modes = ["video_temporal"]
        report.update(video_stage_times(scenes, cfg, dev))
    else:
        scenes = render_sequence(0, FRAMES, h, w, d)
        for mode in ("guided", "raw"):
            srv = compile_sgbm_mst_server(h, w, cfg=cfg, device=dev, capacity=2,
                                          volume_guided=(mode == "guided"))
            report[mode] = profile_mode(srv, scenes[:1], scenes, scenes, scenes[1], dev)
        modes = ["guided", "raw"]
        report.update(stage_times(scenes[0], cfg, dev))
    for mode in modes:
        summary = {k: v for k, v in report[mode].items() if k != "top_kernels"}
        print(mode, json.dumps(summary), flush=True)
    print("stages_ms", json.dumps(report["stages_ms"]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("wrote", out, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
