"""sgbm.k1_roofline: kernel K1's share (%) of its roofline in the traced
frames of a 3DMST cell. Each keyframe launches K1 once, over the SGBM
seed's (rows, cols - num_disp, num_disp) cost; the least time of a launch
is its bytes (cost read once, float32 sum written once) or its operations
over the card's peaks, whichever is longer. Left out where the trace's
launches are not one a keyframe."""

from portbench.yardstick import bound_s, k1_bytes, k1_ops


def read(run):
    tr, spec = run.trace, run.spec
    if tr is None or "mst" not in spec or not tr.keys:
        return None
    n, t = tr.kernel_time_s(lambda name: "sgbm_aggregate_kernel" in name)
    if n != tr.keys or t <= 0:
        return None
    nd = -(-spec["max_disp"] // 16) * 16
    cost_bytes = 2 if spec["mst"]["volume_dtype"] == "bfloat16" else 4
    rows, cols = spec["rows"], spec["cols"] - nd
    least = bound_s(k1_bytes(rows, cols, nd, cost_bytes), k1_ops(rows, cols, nd, 8))
    return 100.0 * n * least / t
