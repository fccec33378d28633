"""Readings that set a cell's correctness limits, in one process on the card.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 .. --control-seeds 3 --seconds 6
    python3 -m portbench.control --workload <cell> --fault half_left_out --seeds 1 2 3 --control-seeds 0

For each seed: the cell's system (built and warmed once) serves the cell's
closed loop for `--seconds`, the run's sample of frames is drawn as a run
draws it, and the plain reference recomputes it. The sound reading is the
program against the reference, and its window's worst frame against exact
ground truth, as a run reads them. For the first `--control-seeds` seeds
the control, the reference computed in the nearest precision below the
configured one, is held to the reference by the same comparison: its
reading has to land above the limit. With `--fault` the program runs with
that fault planted (`portbench/faults.py`) and its readings are the
fault's. One JSON line a seed, then a summary line with the largest sound
and the smallest control reading of each compared number. The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench.run import (
    BENCH, check_limits, check_numbers, gt_scores, load_benchmark, load_module, serve,
)

GAPS_PX = (0.0, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 4.0)
GT_PX = (0.5, 1.0, 2.0)


def profile(got: list, want: list) -> dict:
    """Beside the compared numbers, to choose them: the share of pixels
    beyond each gap in GAPS_PX and the mean gap (px), worst map."""
    out = {f"beyond_{g}": 0.0 for g in GAPS_PX}
    out["mean_px"] = 0.0
    for g_maps, w_maps in zip(got, want, strict=True):
        for g, w in zip(g_maps, w_maps, strict=True):
            d = np.abs(np.nan_to_num(g.astype(np.float64), nan=1e9) - w)
            for gap in GAPS_PX:
                out[f"beyond_{gap}"] = max(out[f"beyond_{gap}"], float(np.mean(d > gap)))
            out["mean_px"] = max(out["mean_px"], float(d.mean()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--fault", default=None, help="plant this fault of portbench/faults.py")
    args = ap.parse_args(argv)

    import torch

    from portbench.traffic import Traffic, load_mix, make_traffic

    cell = {w["name"]: w for w in load_benchmark()["workloads"]}[args.workload]
    with open(BENCH / "configs" / f"{cell['config']}.json") as f:
        spec = json.load(f)
    if args.rehearse:
        spec.update(spec["rehearsal"])
    cfgmod = load_module(BENCH / "configs" / f"{cell['config']}.py", "portbench_cfg")
    mix = load_mix(cell["traffic"])
    device = torch.device(args.device)
    if args.fault:
        from portbench.faults import plant

        plant(spec, args.fault)
    base = make_traffic(mix, spec["rows"], spec["cols"], spec["max_disp"], args.seeds[0], device)
    system = cfgmod.System(spec, mix, device)
    warm = int(mix["warm_frames"])
    serve(system, base, start=-warm, n=warm)
    worst_sound, least_control = {}, {}
    for j, seed in enumerate(args.seeds):
        traffic = Traffic(mix, seed, base.scenes)
        system.reset()
        t0 = time.perf_counter()
        frames, _ = serve(system, traffic, start=0, seconds=args.seconds,
                          at_least=int(mix["check_frames"]))
        sample = cfgmod.check_sample(frames, traffic)
        want = cfgmod.reference(sample, traffic, spec, device)
        ref_s = time.perf_counter() - t0
        got = [f["maps"] for f in sample]
        sound = check_numbers(frames, sample, want, traffic, spec, cfgmod)
        line = {"seed": seed, "fault": args.fault, "frames": len(frames), "sampled": [f["i"] for f in sample],
                "sound": sound, "sound_profile": profile(got, want),
                "gt_profile": {f"worst_beyond_{px}": gt_scores(frames, traffic, spec, cfgmod, px)[2]
                               for px in GT_PX},
                "serve_and_reference_s": ref_s}
        for k, v in sound.items():
            worst_sound[k] = max(worst_sound.get(k, v), v)
        if j < args.control_seeds:
            t1 = time.perf_counter()
            lower = cfgmod.reference(sample, traffic, spec, device, lower=True)
            ctl = cfgmod.compare(lower, want, spec)
            judged = [dict(f, maps=m) for f, m in zip(sample, lower)]
            ctl["gt_worst_pct"] = gt_scores(judged, traffic, spec, cfgmod,
                                            float(spec["check"]["gt_px"]))[2]
            line["control"] = ctl
            line["control_profile"] = profile(lower, want)
            line["control_s"] = time.perf_counter() - t1
            for k, v in ctl.items():
                least_control[k] = min(least_control.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "largest_sound": worst_sound, "smallest_control": least_control,
                      "limits": check_limits(spec, cfgmod)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
