"""Time kernel K1 (the SGBM path aggregation of the PyTorch port) on one
NVIDIA GPU at the production seed's shape, 960 x 1152 x 128, and print one
JSON line.

    python3 bench_k1.py [--root DIR]

`--root` names the repository checkout whose `stereomatch_tpu_torch` is
imported and built (default: this file's). To compare two commits in one
machine session, unpack the other one with `git archive` into a directory
that .gitignore lists and run this script in turns, a b b a:

    git archive <commit> | tar -x -C build/base
    for r in build/base . . build/base; do python3 bench_k1.py --root $r; done

The costs are integer-valued random costs from a fixed seed, made on the
card: K1's work does not depend on the data, and on integer-valued costs
every version of K1 gives its twin's S bit for bit, so the `checksum`
(float64 sum of S) must agree between the versions. Times are CUDA events
over 20 calls of `aggregate_8path_cuda` (the zero fill of S
included) after two warm-up calls, bf16 and f32 costs in turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
SHAPE = (960, 1152, 128)  # the seed's (H, W', D) at 960x1280, 128 disparities
REPS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("bench_k1: no CUDA device", file=sys.stderr)
        return 1
    import stereomatch_tpu_torch
    from stereomatch_tpu_torch._build import load_kernels
    from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda

    pkg = Path(stereomatch_tpu_torch.__file__).resolve()
    if root not in pkg.parents:
        raise AssertionError(f"imported {pkg}, not the package under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    load_kernels()
    h, w, d = SHAPE
    p1, p2 = 200.0, 800.0  # the production block size 5: 8 * 25, 32 * 25
    g = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randint(0, 4800, (h, w, d), generator=g, device="cuda").float()
    out = {"root": os.path.relpath(root), "card": card, "shape": [h, w, d], "reps": REPS}
    for dt in ("bfloat16", "float32"):
        c = base.to(getattr(torch, dt))
        for _ in range(2):
            s = aggregate_8path_cuda(c, p1, p2, 8)
        torch.cuda.synchronize()
        before = aggregate_8path_cuda.launches
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(REPS):
            aggregate_8path_cuda(c, p1, p2, 8)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / REPS
        bound_ms = (c.numel() * c.element_size() + s.numel() * 4) / HBM_BYTES_PER_S * 1e3
        out[dt] = {
            "ms": ms,
            "launches_per_call": (aggregate_8path_cuda.launches - before) / REPS,
            "bound_ms": bound_ms,
            "share_of_bound": bound_ms / ms,
            "checksum": s.double().sum().item(),
        }
        del c, s
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
