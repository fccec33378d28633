"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json `workloads`) names a
configuration (`portbench/configs/<name>.json` with its system in
`<name>.py`) and a traffic mix (`portbench/traffic/<name>.json`); per-layer
metrics are read by `portbench/metrics/<name>.py`. The run renders its
frames on the card, builds the program's system and warms it on the
cell's own frames (set-up), then serves frames in a closed loop for
`--seconds` (the window), then, with `--trace 1`, serves a few more under
the profiler. After the window the program's state is freed and a sample
of the window's frames, drawn from the seed, is recomputed by the plain
reference (`portbench/reference/`) and compared. The last stdout line is
one JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`
(and `breakdown` with `--trace 1`); the compared numbers and their limits
end stderr and the line (`check`).

`--device cpu --rehearse` runs the cell on the CPU at the configuration's
`rehearsal` size, for tests; the benchmark itself refuses to run without
a card.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is timed from here: imports, render, build, warm-up

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stereomatch_tpu")
PROGRAM = "stereomatch_tpu_torch"


def forbidden_modules(names=FORBIDDEN) -> list[str]:
    """Loaded modules whose top-level name is one of `names`, compared whole
    (the program's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(names))


def _environment() -> None:
    """Set before torch is imported. The program builds its kernels in
    build/torch_ext of the checkout; every other compiler cache goes beside
    it, at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end-to-end or per-layer metrics: those whose `workloads`
    list the cell, or that have none."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def serve(system, traffic, start: int, n: int | None = None, seconds: float | None = None,
          at_least: int = 0):
    """Closed loop from frame `start`: submit a frame, then collect the
    oldest in flight once `system.depth` frames are. Stops submitting after
    `n` frames or once `seconds` have passed and `at_least` frames were
    submitted, then collects what is in flight. Returns (frame records,
    seconds from the first submit to the last collect)."""
    from collections import deque

    recs, pending = [], deque()

    def finish(rec):
        rec["maps"] = system.collect(rec.pop("ticket"))
        rec["latency_s"] = time.perf_counter() - rec["t_submit"]
        recs.append(rec)

    t0 = time.perf_counter()
    i = start
    while (n is None or i - start < n) and (
            seconds is None or time.perf_counter() - t0 < seconds or i - start < at_least):
        sc = traffic.scene(i)
        ks = traffic.key_seed(i)
        ts = time.perf_counter()
        ticket = system.submit(i, sc.left, sc.right, ks)
        pending.append({"i": i, "key_seed": ks, "t_submit": ts, "ticket": ticket,
                        "is_key": system.is_key.get(i, True)})
        while len(pending) >= system.depth:
            finish(pending.popleft())
        i += 1
    while pending:
        finish(pending.popleft())
    return recs, time.perf_counter() - t0


def gt_scores(frames: list, traffic, spec: dict, cfgmod,
              threshold: float = 2.0) -> tuple[int, int, float]:
    """Scoring against the scenes' exact ground truth: (bad, scored) pixels
    over every frame, where a bad pixel is invalid or off by more than
    `threshold` px, and the worst frame's bad share (%)."""
    from portbench.traffic import scene_eval_mask

    masks, bad, scored, worst = {}, 0, 0, 0.0
    for f in frames:
        k = traffic.scene_index(f["i"])
        if k not in masks:
            masks[k] = scene_eval_mask(traffic.scenes[k])
        b, s = cfgmod.score(f["maps"], traffic.scenes[k], spec, masks[k], threshold)
        bad, scored = bad + b, scored + s
        worst = max(worst, 100.0 * b / max(s, 1))
    return bad, scored, worst


def check_numbers(frames: list, sample: list, want: list, traffic, spec: dict,
                  cfgmod) -> dict:
    """The numbers that decide `correct`: the program's sampled frames
    against the reference's, and the worst frame of the window against
    exact ground truth."""
    numbers = cfgmod.compare([f["maps"] for f in sample], want, spec)
    numbers["gt_worst_pct"] = gt_scores(frames, traffic, spec, cfgmod,
                                        float(spec["check"]["gt_px"]))[2]
    return numbers


def check_limits(spec: dict, cfgmod) -> dict:
    return {**cfgmod.limits(spec), "gt_worst_pct": float(spec["check"]["gt_worst_pct_limit"])}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rehearse", action="store_true",
                    help="the configuration's small rehearsal size (tests; with --device cpu)")
    args = ap.parse_args(argv)
    _environment()
    if args.device == "cpu" and not args.rehearse:
        print("portbench: --device cpu is only for --rehearse", file=sys.stderr)
        return 2

    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"portbench: the program ({PROGRAM}) is not in this checkout", file=sys.stderr)
        return 3

    from portbench.traffic import load_mix, make_traffic
    from portbench.tracing import traced
    from portbench.yardstick import percentile

    with open(BENCH / "configs" / f"{cell['config']}.json") as f:
        spec = json.load(f)
    if args.rehearse:
        spec.update(spec["rehearsal"])
    cfgmod = load_module(BENCH / "configs" / f"{cell['config']}.py", "portbench_config")
    mix = load_mix(cell["traffic"])
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(0)

    # ---- set-up: frames, system, warm-up on the cell's own frames ----
    traffic = make_traffic(mix, spec["rows"], spec["cols"], spec["max_disp"], args.seed, device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    system = cfgmod.System(spec, mix, device)
    warm = int(mix["warm_frames"])
    serve(system, traffic, start=-warm, n=warm)
    system.reset()
    _sync(device)
    setup_s = time.perf_counter() - _T0

    # ---- the window ----
    # the window holds at least the frames that the check samples
    frames, window_s = serve(system, traffic, start=0, seconds=args.seconds,
                             at_least=int(mix["check_frames"]))
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace = None
    if args.trace:
        system.reset()
        n = int(mix["trace_frames"])
        trace = traced(lambda: serve(system, traffic, start=len(frames), n=n)[0], n,
                       lambda recs: sum(bool(r["is_key"]) for r in recs))
    attempted = len(frames)
    failed = min(system.failures(), attempted)
    counters = system.counters()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- scoring against exact GT, then the check against the reference ----
    bad, scored, _ = gt_scores(frames, traffic, spec, cfgmod)
    sample = cfgmod.check_sample(frames, traffic)
    want = cfgmod.reference(sample, traffic, spec, device)
    numbers = check_numbers(frames, sample, want, traffic, spec, cfgmod)
    limits = check_limits(spec, cfgmod)
    correct = all(numbers[k] <= limits[k] for k in limits)

    # ---- metrics ----
    metrics = {}
    if not args.trace:
        lat = [f["latency_s"] for f in frames]
        values = {
            "setup_s": setup_s,
            "frames_per_s": (attempted - failed) / window_s,
            "frame_ms_p90": percentile(lat, 90.0) * 1e3,
            "peak_mem_gib": peak / 2**30,
            "bad2_pct": 100.0 * bad / max(scored, 1),
        }
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from types import SimpleNamespace

        run = SimpleNamespace(spec=spec, mix=mix, frames=frames, trace=trace)
        for i, m in enumerate(cell_metrics(bench, args.workload, "per_layer")):
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py", f"portbench_metric_{i}")
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    print(json.dumps({"frames": attempted, "window_s": window_s, "setup_s": setup_s,
                      "scored_pixels": scored, **counters}), file=sys.stderr)
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k, v in check.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    result["check"] = check
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
