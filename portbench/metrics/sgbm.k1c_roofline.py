"""sgbm.k1c_roofline: kernel K1c's share (%) of its roofline in the
traced calls of the band-streamed SGBM. A call launches K1c 2 nbands - 1
times (the upward sweep without S, then each band); the least time is the
sum over launches of its bytes (cost, carries, S) or its operations over
the card's peaks, whichever is longer. Left out where the trace's launches
are not a whole number of calls."""

from portbench.yardstick import bound_s, k1_ops, k1c_call_bytes


def read(run):
    tr, spec = run.trace, run.spec
    if tr is None or "sgbm" not in spec or not tr.frames:
        return None
    s = spec["sgbm"]
    rows, nd, band = spec["rows"], s["num_disp"], spec["band_rows"]
    cols = spec["cols"] - (s["min_disp"] + nd)
    cost_bytes = 4 if s["cost_dtype"] == "float32" else 2
    per_call, _ = k1c_call_bytes(rows, cols, nd, cost_bytes, band)
    n, t = tr.kernel_time_s(lambda name: "sgbm_aggregate_kernel" in name)
    if n != per_call * tr.frames or t <= 0:
        return None
    nbands = -(-rows // band)
    plane = cols * nd * 4
    cells = band * cols * nd
    up = bound_s(cells * cost_bytes + 2 * 3 * plane, k1_ops(band, cols, nd, 3))
    down = bound_s(cells * (cost_bytes + 4) + 2 * 6 * plane, k1_ops(band, cols, nd, 8))
    least = tr.frames * ((nbands - 1) * up + nbands * down)
    return 100.0 * least / t
