"""refine.k2_roofline: kernels K2 (the node scans) and K2a (the fused
ancestor sums) together, as a share (%) of their roofline in the traced
frames of a 3DMST cell. Each tree-filter call of a view's refine (the
seed labels' cost, then one a refine iteration over its candidates) scans
and sums 1 + carry_iters times over the frame's N = rows x cols nodes;
the least time is the bytes of every launch over the card's bandwidth.
K2 and K2a are told apart by the fused flag of their demangled name. Left
out where the trace's launches are not those of its frames."""

from portbench.yardstick import bound_s, k2_frame, tree_filter_rows


def read(run):
    tr, spec = run.trace, run.spec
    if tr is None or "mst" not in spec or not tr.frames:
        return None
    m = spec["mst"]
    n = spec["rows"] * spec["cols"]
    key = k2_frame(n, tree_filter_rows(spec["max_disp"], m["fine_iterations"], m["refine_start"],
                                       m["max_neighbors"]), m["carry_iters"])
    temporal = k2_frame(n, tree_filter_rows(spec["max_disp"], m["temporal_iterations"],
                                            m["temporal_refine_start"], m["max_neighbors"]),
                        m["carry_iters"])
    keys, temps = tr.keys, tr.frames - tr.keys
    want = {k: keys * key[k] + temps * temporal[k] for k in key}
    n2, t2 = tr.kernel_time_s(lambda name: "seg_scan_kernel" in name and "false>" in name)
    n2a, t2a = tr.kernel_time_s(lambda name: "seg_scan_kernel" in name and "true>" in name)
    if n2 != want["k2_launches"] or n2a != want["k2a_launches"] or t2 + t2a <= 0:
        return None
    least = bound_s(want["k2_bytes"]) + bound_s(want["k2a_bytes"])
    return 100.0 * least / (t2 + t2a)
