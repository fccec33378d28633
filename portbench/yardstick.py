"""The benchmark's frozen arithmetic: the card's published peaks, the least
time of a kernel launch from the bytes it has to move, the byte counts of
the program's kernels K1, K1c, K2 and K2a from a cell's shapes, the union of
busy intervals, the percentile of frame latencies, and the scoring of a
left map against exact ground truth. Later changes to the program never
change these; a change here is a change of the benchmark.
"""

from __future__ import annotations

import math

import numpy as np

# H100 SXM (NVIDIA's data sheet, at the full 700 W power limit): HBM3 bytes/s
# and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, nops: float = 0.0) -> float:
    """The least time in seconds the card could take to move `nbytes`
    (each input read once, each output written once) and do `nops` float32
    operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


# ---- K1 and K1c: the SGBM path aggregation (csrc/sgbm_aggregate.cu) ----

def k1_bytes(rows: int, cols: int, num_disp: int, cost_bytes: int) -> int:
    """One K1 launch over the (rows, cols, D) cost: the cost read once and
    the float32 sum S written once."""
    return rows * cols * num_disp * (cost_bytes + 4)


def k1_ops(rows: int, cols: int, num_disp: int, paths: int) -> float:
    """About 8 float32 operations a cost value and path (the DP's min over
    four terms, adds and the running minimum)."""
    return 8.0 * paths * rows * cols * num_disp


def k1c_call_bytes(height: int, cols: int, num_disp: int, cost_bytes: int,
                   band_rows: int = 128, carried_down: int = 3,
                   carried_up: int = 3) -> tuple[int, int]:
    """(launches, bytes) of one band-streamed SGBM call: an upward sweep of
    nbands - 1 launches that read a band's cost and the carry from below and
    write the carry above (no S), then nbands launches that read the band's
    cost and both carries and write S and the downward carry."""
    nbands = -(-height // band_rows)
    band = band_rows * cols * num_disp
    plane = cols * num_disp * 4  # one direction's carry, float32
    up = band * cost_bytes + 2 * carried_up * plane
    down = band * (cost_bytes + 4) + 2 * (carried_down + carried_up) * plane
    return 2 * nbands - 1, (nbands - 1) * up + nbands * down


# ---- K2 and K2a: the segmented scans of the 3DMST tree filter (csrc/seg_scan.cu) ----

def k2_scan_bytes(rows: int, m: int) -> int:
    """One segmented scan of (rows, M) float32 with an (M,) reset mask:
    values read once, the scan written once, the mask read once."""
    return rows * m * 8 + m


def k2a_bytes(rows: int, n: int) -> int:
    """One ancestor sum of (rows, N) float32 over the 2N Euler events: the
    values read and the sums written once, and per event its int64 source
    node and two mask bytes."""
    return rows * n * 8 + 2 * n * (8 + 1 + 1)


def refine_ladder(max_disp: int, start: float | None) -> int:
    """Steps of the 3DMST refinement ladder: the disparity delta halving
    from `start` (or max_disp / 2) while above 0.1."""
    md = 0.5 * max_disp if start is None else float(start)
    n = 0
    while md > 0.1:
        n += 1
        md *= 0.5
    return n


def tree_filter_rows(max_disp: int, iterations: int, start: float | None,
                     max_neighbors: int) -> list[int]:
    """Rows of each tree-filter call of one view's refine: the seed
    labels' cost (1 row), then each iteration's candidates."""
    k = max_neighbors + refine_ladder(max_disp, start)
    return [1] + [k] * iterations


def k2_frame(n: int, rows: list[int], carry_iters: int, views: int = 2) -> dict:
    """Launches and bytes of K2 (node scans) and K2a (ancestor sums) in one
    frame: each tree-filter call scans 1 + carry_iters times and takes
    1 + carry_iters ancestor sums, of its rows over the N nodes."""
    per = 1 + carry_iters
    return {
        "k2_launches": views * per * len(rows),
        "k2_bytes": views * per * sum(k2_scan_bytes(r, n) for r in rows),
        "k2a_launches": views * per * len(rows),
        "k2a_bytes": views * per * sum(k2a_bytes(r, n) for r in rows),
    }


# ---- trace and latency arithmetic ----

def busy_s(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps in [lo, hi] that no interval covers, as (start, end)."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of all values, linear between the
    closest ranks (numpy's default)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


# ---- scoring against exact ground truth ----

def lr_valid(left: np.ndarray, right: np.ndarray, max_disp: float, max_diff: float = 1.0):
    """The left-view LR check: d = round(left(x)) (half to even) is valid
    iff x - d >= 0, 0 <= d < max_disp and |left(x) - right(x - d)| <= max_diff."""
    w = left.shape[1]
    d = np.rint(left).astype(np.int64)
    mx = np.arange(w)[None, :] - d
    ok = (mx >= 0) & (d >= 0) & (d < max_disp)
    right_at = np.take_along_axis(right, np.clip(mx, 0, w - 1), axis=1)
    return ok & (np.abs(left - right_at) <= max_diff)


def bad_counts(left: np.ndarray, valid: np.ndarray, gt: np.ndarray, scored: np.ndarray,
               threshold: float = 2.0) -> tuple[int, int]:
    """(bad, scored) pixels: a scored pixel is bad where the map is invalid
    there or off the exact ground truth by more than `threshold` px."""
    err = np.abs(left.astype(np.float32) - gt.astype(np.float32))
    bad = scored & (~valid | (err > threshold))
    return int(bad.sum()), int(scored.sum())
