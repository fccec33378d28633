"""Time kernel K2 (the segmented scan of the PyTorch port's tree filter)
and the tree filter's ancestor sum on one NVIDIA GPU, on the forest of a
960x1280 frame, and print one JSON line.

    python3 bench_k2.py [--root DIR]

`--root` names the repository checkout whose `stereomatch_tpu_torch` is
imported and built (default: this file's). To compare two commits on one
card, unpack the other one with `git archive` into a directory
that .gitignore lists and run this script in turns, a b b a:

    git archive <commit> | tar -x -C build/base
    for r in build/base . . build/base; do python3 bench_k2.py --root $r; done

The resets are those of the forest `_view_forest` builds on the card for
the left view of `synthetic.render_sequence(0, 1, 960, 1280, 128)[0]`
(production config, device forest): N = 1,228,800 nodes, 2N Euler events.
Timed, with CUDA events over REPS calls after two warm-up calls:
- `nodes`: `segmented_cumsum` of x (7, N) with the node-order resets;
- `euler`: `segmented_cumsum` of x (7, 2N) with the Euler resets;
- `ancestor`: `ops.mst._ancestor_sums(v, forest)`, v (7, N), as the tree
  filter calls it (the fused kernel where the checkout has it);
- `composition`: the same sum as index_select, where, `segmented_cumsum`
  and index_select, in every checkout;
- `copy_nodes`, `copy_euler`: `copy_` of x (7, N) and (7, 2N) into a
  tensor of its shape, a yardstick of what moving the scan's bytes takes.
x and v are integer-valued in [-8, 8] from a fixed seed, so every partial
sum is exact and the float64 `checksum` of each output must agree between
versions. `kernels_per_call` counts the device kernels of one call in
torch.profiler's CUDA events; `bound_ms` is the call's bytes (inputs read
once, output written once) over 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
SHAPE = (960, 1280)
MAX_DISP = 128
ROWS = 7  # the production refine's candidates per tree filter
REPS = 50


def _time_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _kernels_per_call(torch, fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_k2: no CUDA device", file=sys.stderr)
        return 1
    import stereomatch_tpu_torch
    from stereomatch_tpu_torch._build import load_kernels
    from stereomatch_tpu_torch.config import production_mst_config
    from stereomatch_tpu_torch.models.mst import _fused_capacities
    from stereomatch_tpu_torch.models.sgbm_mst import _view_forest
    from stereomatch_tpu_torch.ops import mst_scan_cuda
    from stereomatch_tpu_torch.ops.device_forest import device_forest_arrays
    from stereomatch_tpu_torch.ops.mst import _ancestor_sums
    from stereomatch_tpu_torch.synthetic import render_sequence

    pkg = Path(stereomatch_tpu_torch.__file__).resolve()
    if root not in pkg.parents:
        raise AssertionError(f"imported {pkg}, not the package under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    load_kernels()
    dev = torch.device("cuda")
    h, w = SHAPE
    cfg = production_mst_config(MAX_DISP, forest_backend="device")
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    left = torch.from_numpy(render_sequence(0, 1, h, w, MAX_DISP)[0].left).to(dev)
    f = device_forest_arrays(_view_forest(left, cfg, tmax, adj_cap), h, w, tmax, check=False)
    n = f.in_pos.shape[0]
    rng = np.random.default_rng(0)

    def ints(shape):
        return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32)).to(dev)

    x_n, x_e, v = ints((ROWS, n)), ints((ROWS, 2 * n)), ints((ROWS, n))
    scan = mst_scan_cuda.segmented_cumsum

    def composition():
        ev = v.index_select(-1, f.euler_src)
        q = scan(torch.where(f.euler_is_in, ev, -ev), f.euler_reset)
        return q.index_select(-1, f.in_pos)

    euler_bytes = 2 * n * (8 + 1 + 1)  # euler_src, euler_is_in, euler_reset
    y_n, y_e = torch.empty_like(x_n), torch.empty_like(x_e)
    cases = {
        "nodes": (lambda: scan(x_n, f.seg_root), x_n.numel() * 8 + n),
        "euler": (lambda: scan(x_e, f.euler_reset), x_e.numel() * 8 + 2 * n),
        "ancestor": (lambda: _ancestor_sums(v, f), v.numel() * 8 + euler_bytes),
        "composition": (composition, v.numel() * 8 + euler_bytes),
        "copy_nodes": (lambda: y_n.copy_(x_n), x_n.numel() * 8),
        "copy_euler": (lambda: y_e.copy_(x_e), x_e.numel() * 8),
    }
    counters = [c for c in (scan, getattr(mst_scan_cuda, "ancestor_sums", None)) if c is not None]
    out = {"root": os.path.relpath(root), "card": card, "nodes_n": n, "rows": ROWS, "reps": REPS}
    for name, (fn, nbytes) in cases.items():
        result = fn()
        checksum = result.double().sum().item()
        del result
        before = sum(c.launches for c in counters)
        ms = _time_ms(torch, fn, REPS)
        calls = (sum(c.launches for c in counters) - before) / (REPS + 2)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "wrapper_calls_per_call": calls,
                     "kernels_per_call": _kernels_per_call(torch, fn), "bound_ms": bound_ms,
                     "share_of_bound": bound_ms / ms, "checksum": checksum}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
