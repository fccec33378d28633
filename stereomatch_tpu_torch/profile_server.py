"""Where a served frame's time goes: sequential and pipelined frame times,
and a `torch.profiler` trace of one frame per volume mode, read by the
program's own spans.

    python3 -m stereomatch_tpu_torch.profile_server [--out FILE] [--video]

At the default size (960x1280, 128 disparities, the production frame of
`compile_sgbm_mst_server`) it needs one CUDA device. For each volume mode
(guided, raw) it serves one warm-up frame, then 3 frames one at a
time (submit -> collect, host clock), then the same frames pipelined
(`capacity=2`: submit all, then drain), then one frame under the profiler.
From the trace it reports the frame's device events, their summed device
time, the union of their intervals (the time the device was busy), the
top kernels by device time, and a table of the program's spans
(`utils.timing.span`): for each span name, its host self time (the span's
time not inside a nested span), the kernel launches and host syncs the
runtime made with it as the innermost span, and the device's idle time
while it was. The rules are those of the benchmark's `portbench/spans.py`.

`--video` does the same for the steady-state temporal frame of the video
server's headline deployment (`compile_mst_video_server` with the raw
volume and `reuse_forest`): after the keyframe and one warm-up temporal
frame, every frame it serves and traces is a temporal frame, which
refines on the keyframe's forests and builds none.

A summary goes to stdout; everything, with the top kernels, goes to
`--out` as JSON. `--device cpu` with a small `--shape` rehearses the script
on the CPU, where the trace holds no device events.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path

import torch

TOP = 25
FRAMES = 3
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


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


def _innermost(spans) -> list[tuple[float, float, str]]:
    """The timeline of (start, end, name) spans cut into disjoint pieces,
    each named by the shortest span that holds it."""
    events = sorted(ev for i, (s, e, _) in enumerate(spans) if e > s
                    for ev in ((s, 1, i), (e, 0, i)))
    out, active, prev = [], set(), None
    for t, starts, i in events:
        if active and t > prev:
            j = min(active, key=lambda k: (spans[k][1] - spans[k][0], k))
            out.append((prev, t, spans[j][2]))
        prev = t
        (active.add if starts else active.discard)(i)
    return out


def span_table(prof) -> dict:
    """Per span name: how many, host self ms, launches and syncs charged at
    their start to it as the innermost span, and device idle ms under it
    (None: in no span)."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        (device if e.device_type == DeviceType.CUDA else host).append(row)
    spans = sorted((s, e, n) for n, s, e in host if n.startswith("sm."))
    pieces = _innermost(spans)
    starts = [s for s, _, _ in pieces]

    def at(t):
        k = bisect_right(starts, t) - 1
        return pieces[k][2] if k >= 0 and t < pieces[k][1] else None

    table = defaultdict(lambda: {"count": 0, "self_ms": 0.0, "launches": 0, "syncs": 0,
                                 "idle_ms": 0.0})
    for _, _, n in spans:
        table[n]["count"] += 1
    for s, e, n in pieces:
        table[n]["self_ms"] += (e - s) / 1e3
    for n, s, _ in host:
        if n in LAUNCHES:
            table[at(s)]["launches"] += 1
        elif n in SYNCS:
            table[at(s)]["syncs"] += 1
    if device and host:
        # each idle gap of the device, split over the innermost spans
        end = min(s for _, s, _ in host)
        gaps = []
        for s, e in sorted((s, e) for _, s, e in device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        gaps.append((end, max(e for _, _, e in host)))
        for a, b in gaps:
            covered = 0.0
            for s, e, n in pieces[max(bisect_right(starts, a) - 1, 0):]:
                if s >= b:
                    break
                overlap = min(e, b) - max(s, a)
                if overlap > 0:
                    table[n]["idle_ms"] += overlap / 1e3
                    covered += overlap
            if b - a > covered:
                table[None]["idle_ms"] += (b - a - covered) / 1e3
    return {str(k): v for k, v in sorted(table.items(), key=lambda kv: -kv[1]["self_ms"])}


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
        "spans": span_table(prof),
    }


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
    else:
        scenes = render_sequence(0, FRAMES, h, w, d)
        for mode in ("guided", "raw"):
            srv = compile_sgbm_mst_server(h, w, cfg=cfg, device=dev, capacity=2,
                                          volume_guided=(mode == "guided"))
            report[mode] = profile_mode(srv, scenes[:1], scenes, scenes, scenes[1], dev)
        modes = ["guided", "raw"]
    for mode in modes:
        summary = {k: v for k, v in report[mode].items() if k not in ("top_kernels", "spans")}
        print(mode, json.dumps(summary), flush=True)
        for name, row in report[mode]["spans"].items():
            print(f"  {name:22s} {json.dumps(row)}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("wrote", out, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
